"""Self-attention for the dense decoder: projections, full-sequence
prefill attention, decode against a dense cache and the zero-copy paged
decode.

Counterparts of ``repro.models.attention`` ``qkv_project``,
``out_project``, ``self_attn_seq``, ``self_attn_decode`` and
``paged_self_attn_decode``, with
the reference's weight layouts (``wq [d,h,hd]``, ``wk/wv [d,k,hd]``,
``wo [h,hd,d]``). Attention itself goes through ``kernels.ops``: the
hand-written CUDA kernels for CUDA tensors, their plain versions on the
CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

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


def self_attn_decode(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cfg: ArchConfig, *,
                     pos: Union[int, torch.Tensor],
                     window: Optional[int] = None,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token decode against one layer's dense cache.

    ``x [B,1,D]``; ``cache_k/v [B,Smax,K,hd]``; ``pos`` is one position
    for the whole batch (an int or a 0-d tensor: aligned batches, the
    static-batch loop) or a ``[B]`` tensor (the engine's gather fallback,
    each request at its own position). The new K/V row is written **in
    place** at ``pos`` (the reference returns an updated cache). Attention
    runs the contiguous decode kernel over each row's first
    ``lengths if given else pos + 1`` slots (ragged ``pos``) or
    ``min(pos + 1, lengths)`` slots (scalar ``pos``: the reference's
    causal mask ``slot <= pos`` and its length mask together). Returns
    ``[B,1,D]``.
    """
    if window is not None:
        raise NotImplementedError(
            "sliding-window ring decode is not ported yet (ROADMAP.md, "
            "next slices: non-dense families)")
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    ragged = pos.dim() == 1
    q, k_new, v_new = qkv_project(p, x, cfg,
                                  pos[:, None] if ragged else pos.reshape(1))
    if ragged:
        rows = torch.arange(B, device=x.device)
        cache_k.index_put_((rows, pos.long()), k_new[:, 0].to(cache_k.dtype))
        cache_v.index_put_((rows, pos.long()), v_new[:, 0].to(cache_v.dtype))
        eff = lengths if lengths is not None else pos + 1
    else:
        slot = pos.long().reshape(1)
        cache_k.index_copy_(1, slot, k_new.to(cache_k.dtype))
        cache_v.index_copy_(1, slot, v_new.to(cache_v.dtype))
        eff = (pos + 1).expand(B)
        if lengths is not None:
            eff = torch.minimum(eff, lengths)
    o = ops.decode_attention(
        q.reshape(B, cfg.n_heads, cfg.hd).contiguous(), cache_k, cache_v,
        eff.to(torch.int32).contiguous())
    return out_project(p, o.reshape(B, 1, -1).to(x.dtype), cfg)


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
