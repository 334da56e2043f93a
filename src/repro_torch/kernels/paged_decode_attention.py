"""Paged GQA decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``repro.kernels.paged_decode_attention``. The kernel
(``csrc/paged_decode_attention.cu``) follows each request's block table
into the physical pool, so the pool is never gathered into a dense
``[B, S, K, hd]`` copy. :func:`paged_gqa_decode_attention` launches it for
CUDA tensors (or raises) and runs :func:`paged_gqa_decode_attention_torch`
for CPU tensors; nothing falls back from the one to the other.

Layout: ``q [B,H,hd]``; ``k_pool/v_pool [NB,BS,K,hd]`` (one layer of the
pool, contiguous); ``block_table [B,nb]`` int32; ``lengths [B]`` int32
-> ``[B,H,hd]`` in ``q.dtype``. A row reads its first
``min(ceil(length/BS), nb)`` table entries, which must be valid block ids;
a length-0 row (batch padding) gives exact zeros.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "paged_decode_attention"
NEG_INF = -0.7 * torch.finfo(torch.float32).max
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_gqa_decode_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     block_table: torch.Tensor,
                                     lengths: torch.Tensor) -> torch.Tensor:
    """The plain version: a loop over logical blocks, each gathering one
    ``[B, BS, K, hd]`` tile through the table, with an f32 online softmax
    (counterpart of ``paged_gqa_decode_attention_jax``)."""
    B, H, hd = q.shape
    NB, BS, K, _ = k_pool.shape
    nb = block_table.shape[1]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    tbl = block_table.long()
    lens = lengths.long()
    m = torch.full((B, K, G), NEG_INF, device=q.device)
    l = torch.zeros((B, K, G), device=q.device)
    acc = torch.zeros((B, K, G, hd), device=q.device)
    for i in range(nb):
        kb = k_pool[tbl[:, i]].float()                   # [B,BS,K,hd]
        vb = v_pool[tbl[:, i]].float()
        s = torch.einsum("bkgh,bskh->bkgs", qg, kb) * hd ** -0.5
        ids = i * BS + torch.arange(BS, device=q.device)
        valid = (ids[None, :] < lens[:, None])[:, None, None, :]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # explicit zero so a length-0 row (s == m_new == NEG_INF) adds
        # nothing and outputs zeros
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgs,bskh->bkgh", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


@functools.cache
def _entry():
    lib = _build.library(NAME)
    fn = getattr(lib, NAME)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_args(q, k_pool, v_pool, block_table, lengths):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be [B,H,hd] and k_pool [NB,BS,K,hd], got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, H, hd = q.shape
    NB, BS, K, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd or H % K:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)} do not match")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"block_table must be [B,nb] and lengths [B] for "
                         f"B={B}, got {tuple(block_table.shape)} and "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"dtypes must be one of float32/bfloat16 and equal, "
                        f"got q {q.dtype}, pools {k_pool.dtype}/{v_pool.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    G = H // K
    if hd > 128 or G > 64 or G * hd > 2048:
        raise ValueError(f"unsupported head shape: G={G}, hd={hd} "
                         f"(need hd <= 128, G <= 64, G*hd <= 2048)")
    ts = (q, k_pool, v_pool, block_table, lengths)
    if any(t.device != q.device for t in ts):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("all inputs must be contiguous (pass k_pool[l], a "
                         "contiguous layer of the pool)")


def paged_gqa_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Block-table decode attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return paged_gqa_decode_attention_torch(q, k_pool, v_pool,
                                                block_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_args(q, k_pool, v_pool, block_table, lengths)
    B, H, hd = q.shape
    _, BS, K, _ = k_pool.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _entry()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                      block_table.data_ptr(), lengths.data_ptr(),
                      out.data_ptr(), B, K, H // K, hd, BS,
                      block_table.shape[1], _DTYPES[q.dtype],
                      torch.cuda.current_stream().cuda_stream)
    _build.check(NAME, rc)
    paged_gqa_decode_attention.launches += 1
    return out


# kernel launches since the last reset (counted only where the kernel runs)
paged_gqa_decode_attention.launches = 0
