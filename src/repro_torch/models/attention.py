"""Self-attention for the dense decoder: projections, full-sequence
prefill attention and the zero-copy paged decode.

Counterparts of ``repro.models.attention`` ``qkv_project``,
``out_project``, ``self_attn_seq`` and ``paged_self_attn_decode``, with
the reference's weight layouts (``wq [d,h,hd]``, ``wk/wv [d,k,hd]``,
``wo [h,hd,d]``). Attention itself goes through ``kernels.ops``: the
hand-written CUDA kernels for CUDA tensors, their plain versions on the
CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rope

Params = Dict[str, torch.Tensor]


def qkv_project(p: Params, x: torch.Tensor, cfg: ArchConfig,
                positions: Optional[torch.Tensor]):
    """x: [B,S,D] -> q [B,S,K,G,hd], k,v [B,S,K,hd] (rope applied)."""
    B, S, D = x.shape
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"].reshape(D, h * hd)).reshape(B, S, h, hd)
    kk = (x @ p["wk"].reshape(D, k * hd)).reshape(B, S, k, hd)
    vv = (x @ p["wv"].reshape(D, k * hd)).reshape(B, S, k, hd)
    if cfg.qkv_bias:
        q = q + p["bq"]
        kk = kk + p["bk"]
        vv = vv + p["bv"]
    if cfg.pos == "rope" and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        kk = rope(kk, positions, cfg.rope_theta)
    return q.reshape(B, S, k, h // k, hd), kk, vv


def out_project(p: Params, o: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """o: [B,S,H*hd] -> [B,S,D]."""
    hhd = cfg.n_heads * cfg.hd
    return o.reshape(*o.shape[:2], hhd) @ p["wo"].reshape(hhd, -1)


def self_attn_seq(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                  positions: torch.Tensor, causal: bool
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal self-attention (prefill). Returns
    ``(out [B,S,D], (k, v))`` with ``k/v [B,S,K,hd]``.

    Attention runs through the tiled prefill kernel, whose causal mask
    is top-left aligned over the padded sequence. The reference also masks
    keys at or past each request's length; for every valid query row
    (``q < length``) causality already hides those keys, so valid rows
    agree. Padded query rows differ, but they only produce K/V at
    positions ``>= length``, which decode overwrites before it reads them.
    """
    B, S, _ = x.shape
    q, k, v = qkv_project(p, x, cfg, positions)
    o = ops.prefill_attention(
        q.reshape(B, S, cfg.n_heads, cfg.hd).contiguous(), k.contiguous(),
        v.contiguous(), causal=causal)
    return out_project(p, o.reshape(B, S, -1), cfg), (k, v)


def paged_self_attn_decode(p: Params, x: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, cfg: ArchConfig, *,
                           tables: torch.Tensor, lengths: torch.Tensor,
                           positions: torch.Tensor,
                           block_size: int) -> torch.Tensor:
    """Single-token decode straight against one layer of the physical pool.

    ``k_pool/v_pool [NB+1, BS, K, hd]`` (contiguous); ``tables [B, nb]``,
    ``lengths [B]`` (valid tokens including the one written now) and
    ``positions [B]`` (its write position) are int32. The new K/V row is
    written **in place** into its physical (block, slot) — where the
    reference threads a donated buffer through its jit — and attention
    runs the block-table kernel over the pool. Every ``positions //
    block_size`` must index inside ``tables``: the engine gives padding
    rows position 0 and length 0, and a table row of trash blocks.
    Returns ``[B,1,D]``.
    """
    B = x.shape[0]
    q, k_new, v_new = qkv_project(p, x, cfg, positions[:, None])
    pos = positions.long()
    phys = tables[torch.arange(B, device=x.device), pos // block_size].long()
    sib = pos % block_size
    k_pool.index_put_((phys, sib), k_new[:, 0].to(k_pool.dtype))
    v_pool.index_put_((phys, sib), v_new[:, 0].to(v_pool.dtype))
    o = ops.paged_decode_attention(
        q.reshape(B, cfg.n_heads, cfg.hd).contiguous(), k_pool, v_pool,
        tables, lengths)
    return out_project(p, o.reshape(B, 1, -1).to(x.dtype), cfg)
