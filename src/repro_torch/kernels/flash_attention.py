"""Tiled causal (optionally sliding-window) prefill attention: the CUDA
kernel's wrapper and its plain blockwise PyTorch version.

Counterpart of ``repro.kernels.flash_attention``. :func:`flash_attention`
launches ``csrc/flash_attention.cu`` for CUDA tensors (or raises) and runs
:func:`flash_attention_torch` for CPU tensors. The causal mask is
top-left aligned (``q_id >= kv_id``, both from 0), as in the reference;
query head ``h`` reads KV head ``h // G``.

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
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
NEG_INF = -0.7 * torch.finfo(torch.float32).max
KERNEL_HEAD_DIMS = (32, 64, 80, 96, 128)
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
                          window: Optional[int] = None, block_q: int = 128,
                          block_s: int = 128) -> torch.Tensor:
    """The plain version: the reference kernel's tiling, whole-tile skip
    test and masks, as a loop over (query tile, KV tile) with an f32
    online softmax."""
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
            mask = torch.ones((nq, kc.shape[1]), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_ids >= kv_ids
            if window is not None:
                mask &= q_ids - kv_ids < window
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
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


@functools.cache
def _entry():
    lib = _build.library(NAME)
    fn = getattr(lib, NAME)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_s: int = 128) -> torch.Tensor:
    """Prefill attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (or None), got {window}")
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_s=block_s)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_args(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, Sq, Skv, H, K, hd, int(causal),
                      window or 0, _BODY_CODES[kernel_body(q.dtype, hd)],
                      torch.cuda.current_stream().cuda_stream)
    _build.check(NAME, rc)
    flash_attention.launches += 1
    return out


# kernel launches since the last reset (counted only where the kernel runs)
flash_attention.launches = 0
