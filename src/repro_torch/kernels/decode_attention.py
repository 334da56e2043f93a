"""Contiguous-cache GQA decode attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``repro.kernels.decode_attention``. The kernel
(``csrc/decode_attention.cu``) reads each request's dense ``[S, K, hd]``
cache in place through its strides, up to the request's length.
:func:`gqa_decode_attention` launches it for CUDA tensors (or raises) and
runs :func:`gqa_decode_attention_torch` for CPU tensors; nothing falls back
from the one to the other.

Layout: ``q [B,H,hd]``; ``k/v [B,S,K,hd]`` (last dimension contiguous);
``lengths [B]`` int32, each in ``[0, S]`` -> ``[B,H,hd]`` in ``q.dtype``.
A length-0 row gives what the TPU kernel gives, ``sum_{j<S} V[j] / Sp``
with ``Sp = ceil(S/bs)*bs`` and ``bs = min(block_s, S)`` (it never skips a
tile, so every padded slot of a fully masked row weighs 1); ``block_s``
matters for nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NAME = "decode_attention"
NEG_INF = -0.7 * torch.finfo(torch.float32).max
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 80, 96, 128)
MAX_GROUP = 8


def gqa_decode_attention_torch(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor, *,
                               block_s: int = 256) -> torch.Tensor:
    """The plain version: the reference kernel's formula, tile for tile —
    K/V zero-padded to ``Sp``, an f32 online softmax over ``Sp/bs`` tiles
    and no tile skipped (counterpart of ``_decode_kernel``)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    bs = min(block_s, S)
    pad = (-S) % bs
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, K, G, hd).float()
    lens = lengths.long()
    dev = q.device
    m = torch.full((B, K, G), NEG_INF, device=dev)
    l = torch.zeros((B, K, G), device=dev)
    acc = torch.zeros((B, K, G, hd), device=dev)
    for s0 in range(0, S + pad, bs):
        kc, vc = kf[:, s0:s0 + bs], vf[:, s0:s0 + bs]
        s = torch.einsum("bkgh,bskh->bkgs", qg, kc) * hd ** -0.5
        ids = s0 + torch.arange(bs, device=dev)
        valid = (ids[None, :] < lens[:, None])[:, None, None, :]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgs,bskh->bkgh", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


@functools.cache
def _entry():
    lib = _build.library(NAME)
    fn = getattr(lib, NAME)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_args(q, k, v, lengths):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B,H,hd] and k/v [B,S,K,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    _, S, K, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or H % K or S < 1:
        raise ValueError(f"shapes q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"do not match")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B] for B={B}, got "
                         f"{tuple(lengths.shape)}")
    if hd not in KERNEL_HEAD_DIMS or H // K > MAX_GROUP:
        raise ValueError(f"unsupported head shape: G={H // K}, hd={hd} "
                         f"(need G <= {MAX_GROUP}, hd in {KERNEL_HEAD_DIMS})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes must be one of float32/bfloat16 and equal, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    if any(t.device != q.device for t in (k, v, lengths)):
        raise ValueError("all inputs must be on one CUDA device")
    if not (q.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("q and lengths must be contiguous")
    # the kernel copies 16-byte pieces of each [hd] row
    isz = k.element_size()
    if k.stride(3) != 1 or v.stride() != k.stride() \
            or any(s * isz % 16 for s in k.stride()[:3]) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"k and v need equal strides, a contiguous head "
                         f"dim and 16-byte aligned rows; got strides "
                         f"{k.stride()} and {v.stride()}")


def gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *,
                         block_s: int = 256) -> torch.Tensor:
    """Contiguous-cache decode attention: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if block_s < 1:
        raise ValueError(f"block_s must be >= 1, got {block_s}")
    if q.device.type == "cpu":
        return gqa_decode_attention_torch(q, k, v, lengths, block_s=block_s)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_args(q, k, v, lengths)
    B, H, hd = q.shape
    _, S, K, _ = k.shape
    bs = min(block_s, S)
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lengths.data_ptr(), out.data_ptr(), B, S, K, H // K,
                      hd, *k.stride()[:3], -(-S // bs) * bs,
                      _DTYPES[q.dtype],
                      torch.cuda.current_stream().cuda_stream)
    _build.check(NAME, rc)
    gqa_decode_attention.launches += 1
    return out


# kernel launches since the last reset (counted only where the kernel runs)
gqa_decode_attention.launches = 0
