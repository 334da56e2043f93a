"""Tiled causal (optionally sliding-window) prefill attention: the CUDA
kernel's two entries and their plain PyTorch versions.

Counterpart of ``repro.kernels.flash_attention``. :func:`flash_attention`
launches ``csrc/flash_attention.cu`` for CUDA tensors (or raises) and runs
:func:`flash_attention_torch` for CPU tensors. The causal mask is
top-left aligned (``q_id >= kv_id``, both from 0), as in the reference;
query head ``h`` reads KV head ``h // G``. With ``lengths``, keys at or
past a request's length are masked as well: the model's prefill without
a prefix (serial, or a chunked prompt's first chunk).

:func:`flash_prefix_attention` is the same kernel's prefix-masked entry,
the prefill attention of the model's ``self_attn_seq`` over a prefix: the
masks of the reference's ``_mask_builder`` over ``[prefix || suffix]``
keys, with the prefix's padding masked, absolute query positions and
each request's length (:func:`flash_prefix_attention_torch` is its plain
version). It carries the suffix-only prefills of the prefix cache and
every chunk after a prompt's first. Its valid prefix length may be a
0-dim int32 tensor on the device, which the kernel reads when it runs: a
CUDA graph that captured the call then replays it at the length staged
for that replay.

Layout: ``q [B,Sq,H,hd]``; ``k/v [B,Skv,K,hd]`` (contiguous) ->
``[B,Sq,H,hd]`` in ``q.dtype``. ``block_q``/``block_s`` are the plain
version's tiles (the reference's defaults); the kernel tiles by its own
64x64.

The kernel has two bodies, picked by dtype (:func:`kernel_body`):
bfloat16 runs on the tensor cores (``wgmma``, head dims padded to 64 or
128 in shared memory), float32 on the CUDA cores (tensor cores would
round it to TF32). Neither falls back to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launches import (KernelCost, count_launch,
                                          counted_kernel)

NAME = "flash_attention"
NEG_INF = -0.7 * torch.finfo(torch.float32).max
KERNEL_HEAD_DIMS = (32, 64, 80, 96, 112, 128)
# each dtype's body, and the code the C entry point takes for it
_BODIES = {torch.float32: "cuda_core_f32", torch.bfloat16: "wgmma_bf16"}
_BODY_CODES = {"cuda_core_f32": 0, "wgmma_bf16": 1}


def kernel_body(dtype: torch.dtype, hd: int) -> str:
    """The kernel body a CUDA call of this dtype and head dim launches:
    bfloat16 on the tensor cores (hd padded to 64 or 128 in shared
    memory), float32 on the CUDA cores."""
    if dtype not in _BODIES:
        raise TypeError(f"dtypes must be one of float32/bfloat16, got "
                        f"{dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {KERNEL_HEAD_DIMS}")
    return _BODIES[dtype]


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          lengths: Optional[torch.Tensor] = None,
                          block_q: int = 128,
                          block_s: int = 128) -> torch.Tensor:
    """The plain version: the reference kernel's tiling, whole-tile skip
    test and masks, as a loop over (query tile, KV tile) with an f32
    online softmax; with ``lengths [B]``, keys at or past a request's
    length are masked too."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    bq, bs = min(block_q, Sq), min(block_s, Skv)
    scale = hd ** -0.5
    dev = q.device
    qf = q.float().reshape(B, Sq, K, G, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Sq, H, hd), device=dev)
    for q0 in range(0, Sq, bq):
        qs = qf[:, q0:q0 + bq]
        nq = qs.shape[1]
        q_ids = q0 + torch.arange(nq, device=dev)[:, None]
        m = torch.full((B, nq, K, G), NEG_INF, device=dev)
        l = torch.zeros((B, nq, K, G), device=dev)
        acc = torch.zeros((B, nq, K, G, hd), device=dev)
        for s0 in range(0, Skv, bs):
            if causal and s0 > q0 + bq - 1:
                continue
            if window is not None and s0 + bs - 1 <= q0 - window:
                continue
            kc, vc = kf[:, s0:s0 + bs], vf[:, s0:s0 + bs]
            s = torch.einsum("bqkgh,bskh->bqkgs", qs, kc) * scale
            kv_ids = s0 + torch.arange(kc.shape[1], device=dev)[None, :]
            mask = torch.ones((1, nq, kc.shape[1]), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_ids >= kv_ids
            if window is not None:
                mask &= q_ids - kv_ids < window
            if lengths is not None:
                mask = mask & (kv_ids < lengths.to(dev)[:, None, None])
            s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgs,bskh->bqkgh", p, vc)
            m = m_new
        out[:, q0:q0 + nq] = (acc / l.clamp_min(1e-30)[..., None]).reshape(
            B, nq, H, hd)
    return out.to(q.dtype)


PrefixLen = Union[int, torch.Tensor]


def prefix_kv_ids(prefix_pad: int, prefix_len: PrefixLen, s: int,
                  device=None) -> torch.Tensor:
    """Token ids of the keys ``[prefix (prefix_pad slots) || suffix (s)]``:
    ``j`` below ``prefix_len``, -1 in the prefix's padding, ``prefix_len +
    (j - prefix_pad)`` in the suffix (the reference's ``self_attn_seq``).
    ``prefix_len`` is an int or a 0-dim integer tensor."""
    j = torch.arange(prefix_pad + s, device=device)
    return torch.where(j < prefix_pad, torch.where(j < prefix_len, j, -1),
                       prefix_len + j - prefix_pad)


def flash_prefix_attention_torch(q: torch.Tensor, k_all: torch.Tensor,
                                 v_all: torch.Tensor, *, prefix_pad: int,
                                 prefix_len: PrefixLen,
                                 lengths: torch.Tensor,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """The plain version: one masked f32 softmax over every key. Query row
    ``i`` (id ``prefix_len + i``) sees key ids ``>= 0``, not after its own,
    below its request's ``lengths[b]`` and, with a window, closer than
    ``window``. ``prefix_len`` is an int or a 0-dim integer tensor. A row
    with no valid key is outside the contract."""
    B, Sq, H, hd = q.shape
    Skv, K = k_all.shape[1], k_all.shape[2]
    dev = q.device
    ids = prefix_kv_ids(prefix_pad, prefix_len, Skv - prefix_pad, dev)
    q_ids = prefix_len + torch.arange(Sq, device=dev)[:, None]
    mask = (ids >= 0) & (q_ids >= ids)                       # [Sq, Skv]
    if window is not None:
        mask &= q_ids - ids < window
    mask = mask[None] & (ids < lengths.to(dev)[:, None, None])   # [B,Sq,Skv]
    qf = q.float().reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("bqkgh,bskh->bqkgs", qf, k_all.float()) * hd ** -0.5
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskh->bqkgh", p, v_all.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


@functools.cache
def _entry(name: str = NAME):
    """The library's entry point ``name``: ``flash_attention`` or
    ``flash_prefix_attention``, bound with its argument types (five
    pointers, or six with the prefix length's, then 9 ints, then the
    stream)."""
    fn = getattr(_build.library(NAME), name)
    fn.argtypes = ([ctypes.c_void_p] * (5 if name == NAME else 6)
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_args(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B,Sq,H,hd] and k/v [B,Skv,K,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"do not match")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {KERNEL_HEAD_DIMS}")
    if q.dtype not in _BODIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes must be one of float32/bfloat16 and equal, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def attended_pairs(sq: int, skv: int, causal: bool, window: Optional[int],
                   offset: int = 0) -> int:
    """(query, key) pairs the masks keep at these shapes, lengths unread:
    query ``i`` at id ``offset + i`` over key ids ``0 .. skv - 1``,
    causal (``q_id >= kv_id``) and within ``window``."""
    ids = np.arange(offset, offset + sq, dtype=np.int64)
    hi = np.minimum(ids + 1, skv) if causal else np.full_like(ids, skv)
    lo = np.zeros_like(ids) if window is None else \
        np.maximum(ids - window + 1, 0)
    return int(np.maximum(hi - lo, 0).sum())


def _flash_bytes(q, k, v, lengths) -> float:
    return float(sum(t.numel() * t.element_size() for t in (q, k, v))
                 + q.numel() * q.element_size()
                 + (0 if lengths is None else 4 * lengths.numel()))


def flash_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: Optional[int] = None,
               lengths: Optional[torch.Tensor] = None, **_) -> KernelCost:
    """One launch at these shapes, lengths unread: q, k, v and the output
    once each; ``4 hd`` FLOPs a head and a pair the masks keep."""
    B, Sq, H, hd = q.shape
    return KernelCost(
        flops=4.0 * B * H * hd * attended_pairs(Sq, k.shape[1], causal,
                                                window),
        bytes=_flash_bytes(q, k, v, lengths))


@counted_kernel("flash_attention", flash_cost)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    lengths: Optional[torch.Tensor] = None,
                    block_q: int = 128, block_s: int = 128) -> torch.Tensor:
    """Prefill attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``lengths [B]`` (optional) masks each
    request's keys at or past its length, as the model's prefill does
    (the reference's ``_mask_builder``); a row with no valid key is
    outside the contract."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (or None), got {window}")
    if lengths is not None and lengths.shape != (q.shape[0],):
        raise ValueError(f"lengths must be [B] = [{q.shape[0]}], got "
                         f"{tuple(lengths.shape)}")
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     lengths=lengths, block_q=block_q,
                                     block_s=block_s)
    if q.device.type == "meta":
        _check_args(q, k, v)
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_args(q, k, v)
    lens = None if lengths is None else lengths.to(
        device=q.device, dtype=torch.int32).contiguous()
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), None if lens is None else
                      lens.data_ptr(), B, Sq, Skv, H, K, hd, int(causal),
                      window or 0, _BODY_CODES[kernel_body(q.dtype, hd)],
                      torch.cuda.current_stream().cuda_stream)
    _build.check(NAME, rc)
    count_launch(flash_attention)
    return out


# kernel launches since the last reset (counted only where the kernel runs)
flash_attention.launches = 0


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The function :func:`flash_attention` computes, as one masked
    softmax over every key in the inputs' dtype: the masks of
    ``kernels.ref.flash_attention_ref`` plus ``lengths``. Differentiable;
    :class:`FlashAttentionFn` takes its gradient in float32. Its scores
    are one ``[B, K, G * Sq, Skv]`` tensor (a KV head's ``G`` query heads
    stacked on its rows), the batched matmul's own layout, so no pass
    over them permutes it."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    dev = q.device
    qh = (q * hd ** -0.5).reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4) \
        .reshape(B, K, G * Sq, hd)
    s = qh @ k.permute(0, 2, 3, 1)                       # [B, K, G*Sq, Skv]
    q_ids = torch.arange(Sq, device=dev)[:, None]
    kv_ids = torch.arange(Skv, device=dev)[None, :]
    mask = torch.ones((1, Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (q_ids >= kv_ids)
    if window is not None:
        mask = mask & (q_ids - kv_ids < window)
    if lengths is not None:
        mask = mask & (kv_ids < lengths.to(dev)[:, None, None])
    s.view(B, K, G, Sq, Skv).masked_fill_(~mask[:, None, None], NEG_INF)
    o = torch.softmax(s, dim=-1) @ v.transpose(1, 2)     # [B, K, G*Sq, hd]
    return o.reshape(B, K, G, Sq, hd).permute(0, 3, 1, 2, 4).reshape(
        B, Sq, H, hd)


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with a gradient. The forward is that
    function (the kernel for CUDA tensors, or a raise; the plain version
    for CPU tensors): the same launch and the same bits, also under
    ``no_grad`` and inside a CUDA-graph capture, where nothing is saved.
    The backward recomputes attention from the saved ``q, k, v`` with
    :func:`dense_attention` in float32 and takes autograd's gradient of
    it, each cast to its input's dtype: recompute, then differentiate, as
    the reference's ``jax.checkpoint`` around its attention core does.
    The float32 scores of one call, ``B * H * Sq * Skv`` values, live only
    inside its backward.

    ``apply(q, k, v, causal, window, lengths, block_q, block_s)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, lengths, block_q, block_s):
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v, lengths)
        return flash_attention(q, k, v, causal=causal, window=window,
                               lengths=lengths, block_q=block_q,
                               block_s=block_s)

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths = ctx.saved_tensors
        with torch.enable_grad():
            qf, kf, vf = (t.detach().float().requires_grad_()
                          for t in (q, k, v))
            o = dense_attention(qf, kf, vf, causal=ctx.causal,
                                window=ctx.window, lengths=lengths)
            dq, dk, dv = torch.autograd.grad(o, (qf, kf, vf), do.float())
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def _check_prefix_args(q, k_all, prefix_pad, prefix_len, lengths, window):
    if isinstance(prefix_len, torch.Tensor):
        # its value is the caller's to keep in [0, prefix_pad]: reading it
        # here would wait for the device
        if prefix_len.dim() or prefix_len.dtype.is_floating_point \
                or prefix_len.device != q.device:
            raise ValueError(f"prefix_len must be an int or a 0-dim integer "
                             f"tensor on {q.device}, got "
                             f"{tuple(prefix_len.shape)} {prefix_len.dtype} "
                             f"on {prefix_len.device}")
        if not 0 <= prefix_pad <= k_all.shape[1]:
            raise ValueError(f"need 0 <= prefix_pad ({prefix_pad}) <= the "
                             f"keys ({k_all.shape[1]})")
    elif not 0 <= prefix_len <= prefix_pad <= k_all.shape[1]:
        raise ValueError(f"need 0 <= prefix_len ({prefix_len}) <= prefix_pad "
                         f"({prefix_pad}) <= the keys ({k_all.shape[1]})")
    if window is not None and prefix_pad:
        raise NotImplementedError(
            "a sliding window over a prefix: the gathered prefix has no "
            "ring arithmetic (the reference refuses it too)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (or None), got {window}")
    if lengths.shape != (q.shape[0],):
        raise ValueError(f"lengths must be [B] = [{q.shape[0]}], got "
                         f"{tuple(lengths.shape)}")


def flash_prefix_cost(q: torch.Tensor, k_all: torch.Tensor,
                      v_all: torch.Tensor, *, prefix_pad: int, prefix_len,
                      lengths: torch.Tensor,
                      window: Optional[int] = None) -> KernelCost:
    """One launch at these shapes, the prefix length and lengths unread
    (every prefix slot taken as valid): q, k, v and the output once each;
    ``4 hd`` FLOPs a head and a causal pair."""
    B, Sq, H, hd = q.shape
    return KernelCost(
        flops=4.0 * B * H * hd * attended_pairs(
            Sq, k_all.shape[1], True, window, offset=prefix_pad),
        bytes=_flash_bytes(q, k_all, v_all, lengths))


@counted_kernel("flash_prefix_attention", flash_prefix_cost)
def flash_prefix_attention(q: torch.Tensor, k_all: torch.Tensor,
                           v_all: torch.Tensor, *, prefix_pad: int,
                           prefix_len: PrefixLen, lengths: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """Causal prefill attention of a suffix over ``[prefix || suffix]``
    keys: the kernel for CUDA tensors, the plain version for CPU tensors,
    an output with no work for meta tensors.

    ``q [B,S,H,hd]`` holds the suffix's queries (ids ``prefix_len + i``);
    ``k_all/v_all [B, prefix_pad + S', K, hd]`` the prefix's
    ``prefix_pad`` slots (the first ``prefix_len`` valid) and then the
    suffix's; ``lengths [B]`` each request's total valid length in ids
    (prefix included). ``prefix_len`` is an int, checked here, or a 0-dim
    integer tensor on ``q``'s device (int32 for the kernel, which reads it
    when it runs), whose value the caller keeps in ``[0, prefix_pad]``.
    With ``prefix_pad = 0`` this is :func:`flash_attention` (causal, the
    same lengths), bit for bit on the card; the model takes that entry for
    a prefill without a prefix. It has no gradient (no training path
    reaches it): inputs that require one raise."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_all, v_all)):
        raise NotImplementedError(
            "flash_prefix_attention has no backward: a prefix is a serving "
            "path (train through flash_attention's FlashAttentionFn)")
    _check_prefix_args(q, k_all, prefix_pad, prefix_len, lengths, window)
    if q.device.type == "cpu":
        return flash_prefix_attention_torch(
            q, k_all, v_all, prefix_pad=prefix_pad, prefix_len=prefix_len,
            lengths=lengths, window=window)
    if q.device.type == "meta":
        _check_args(q, k_all, v_all)
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_args(q, k_all, v_all)
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if isinstance(prefix_len, torch.Tensor):
        if prefix_len.dtype != torch.int32:
            raise TypeError(f"prefix_len must be int32, got "
                            f"{prefix_len.dtype}")
        plen = prefix_len
    else:
        plen = torch.full((), prefix_len, dtype=torch.int32, device=q.device)
    B, Sq, H, hd = q.shape
    Skv, K = k_all.shape[1], k_all.shape[2]
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _entry("flash_prefix_attention")(
            q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), out.data_ptr(),
            lens.data_ptr(), plen.data_ptr(), B, Sq, Skv, H, K, hd,
            prefix_pad, window or 0, _BODY_CODES[kernel_body(q.dtype, hd)],
            torch.cuda.current_stream().cuda_stream)
    _build.check(NAME, rc)
    count_launch(flash_prefix_attention)
    return out


# kernel launches since the last reset (counted only where the kernel runs)
flash_prefix_attention.launches = 0
