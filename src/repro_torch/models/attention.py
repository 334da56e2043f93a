"""Attention: projections, full-sequence self-attention (causal,
bidirectional or sliding-window), decode against a dense cache (a ring
of ``window`` slots under a sliding window), the zero-copy paged decode,
and cross-attention onto a request's image K/V.

Counterparts of ``repro.models.attention`` ``qkv_project``,
``out_project``, ``self_attn_seq``, ``self_attn_decode``,
``paged_self_attn_decode``, ``cross_attn_kv`` and ``cross_attn_apply``,
with the reference's weight layouts (``wq [d,h,hd]``, ``wk/wv
[d,k,hd]``, ``wo [h,hd,d]``). Attention itself goes through
``kernels.ops``: the hand-written CUDA kernels for CUDA tensors, their
plain versions on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import on_device
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
                  positions: torch.Tensor, causal: bool,
                  window: Optional[int] = None,
                  lengths: Optional[torch.Tensor] = None,
                  prefix_k: Optional[torch.Tensor] = None,
                  prefix_v: Optional[torch.Tensor] = None,
                  prefix_len: Union[int, torch.Tensor] = 0
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self-attention (prefill). Returns ``(out [B,S,D],
    (k, v))`` with ``k/v [B,S,K,hd]``, the suffix's own K/V.

    With ``lengths`` (each request's total valid length, prefix included)
    keys at or past it are masked, as the reference masks them, so padded
    query rows equal the reference's too. Without a prefix this is the
    flash kernel's plain entry (top-left causal, optional window). With
    ``prefix_k/v`` (``[B, P_pad, K, hd]``, gathered from the pool) the
    sequence is the *suffix* of a longer prompt: queries attend over
    ``[prefix || suffix]``, ``positions`` are absolute and the first
    ``prefix_len`` prefix rows are valid (it may land mid-block; an int,
    or a 0-dim int32 tensor on the device, which the kernel reads when it
    runs); that is the kernel's prefix-masked entry, whose masks are the
    reference's (``_mask_builder``) row for row.
    """
    B, S, _ = x.shape
    if prefix_k is not None and not causal:
        # the reference's model refuses it (a bidirectional suffix would
        # change the prefix's K/V after it was written)
        raise NotImplementedError(
            "prefix/chunked prefill requires causal attention: a "
            "bidirectional suffix would retroactively change the "
            "already-written prefix KV")
    q, k, v = qkv_project(p, x, cfg, positions)
    q = q.reshape(B, S, cfg.n_heads, cfg.hd).contiguous()
    if prefix_k is None:
        o = ops.prefill_attention(q, k.contiguous(), v.contiguous(),
                                  causal=causal, window=window,
                                  lengths=lengths)
    else:
        pad = prefix_k.shape[1]
        k_all = torch.cat([prefix_k.to(k.dtype), k], dim=1)
        v_all = torch.cat([prefix_v.to(v.dtype), v], dim=1)
        if lengths is None:
            total = prefix_len + S
            lengths = (total.reshape(1).expand(B)
                       if isinstance(total, torch.Tensor) else
                       torch.full((B,), total, device=x.device))
        o = ops.prefill_prefix_attention(
            q, k_all.contiguous(), v_all.contiguous(), prefix_pad=pad,
            prefix_len=prefix_len, lengths=lengths, window=window)
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

    With a ``window`` the cache is a ring of ``Smax <= window`` slots
    (scalar ``pos`` only, as in the reference): the row goes to slot
    ``pos % Smax``, and attention runs over the first ``min(pos + 1,
    Smax)`` slots, the slots the reference's token-id mask (``kv_id = pos
    - (pos - slot) mod Smax``, kept where ``>= 0`` and within the window)
    keeps, in another order, which attention does not see. With
    ``lengths`` too, its valid slots are a prefix only until the ring
    wraps: past that the call is refused.
    """
    B = x.shape[0]
    pos = on_device(pos, x.device)
    ragged = pos.dim() == 1
    if window is not None:
        _check_ring(cache_k.shape[1], window, ragged, pos, lengths)
    q, k_new, v_new = qkv_project(p, x, cfg,
                                  pos[:, None] if ragged else pos.reshape(1))
    if ragged:
        rows = torch.arange(B, device=x.device)
        cache_k.index_put_((rows, pos.long()), k_new[:, 0].to(cache_k.dtype))
        cache_v.index_put_((rows, pos.long()), v_new[:, 0].to(cache_v.dtype))
        eff = lengths if lengths is not None else pos + 1
    else:
        slot = pos.long().reshape(1)
        if window is not None:
            slot = slot % cache_k.shape[1]
        cache_k.index_copy_(1, slot, k_new.to(cache_k.dtype))
        cache_v.index_copy_(1, slot, v_new.to(cache_v.dtype))
        eff = (pos + 1).expand(B)
        if window is not None:
            eff = eff.clamp(max=cache_k.shape[1])
        if lengths is not None:
            eff = torch.minimum(eff, lengths)
    o = ops.decode_attention(
        q.reshape(B, cfg.n_heads, cfg.hd).contiguous(), cache_k, cache_v,
        eff.to(torch.int32).contiguous())
    return out_project(p, o.reshape(B, 1, -1).to(x.dtype), cfg)


def _check_ring(smax: int, window: int, ragged: bool, pos: torch.Tensor,
                lengths: Optional[torch.Tensor]):
    """Refuse what the ring decode does not reproduce: ragged positions
    (the reference asserts against them), a cache longer than the window
    (its valid slots would not be a prefix), and lengths once the ring
    has wrapped (neither would they)."""
    if ragged:
        raise NotImplementedError(
            "ragged decode does not support windows (the reference "
            "asserts it): a sliding-window ring takes one position for "
            "the batch")
    if smax > window:
        raise ValueError(f"a ring cache holds at most window={window} "
                         f"slots, got {smax}")
    if lengths is not None and int(pos) >= smax:
        raise NotImplementedError(
            f"lengths over a ring that has wrapped (pos {int(pos)} >= "
            f"{smax} slots): the valid slots are no longer a prefix of "
            f"the ring")


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


def cross_attn_kv(p: Params, img_embeds: torch.Tensor,
                  cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``CROSS`` layer's image K/V from (stubbed) image embeddings
    ``[B, n_img, D]``: ``k, v [B, n_img, K, hd]``, no bias and no RoPE
    (the reference's ``cross_attn_kv``)."""
    B, N, D = img_embeds.shape
    kh, hd = cfg.n_kv_heads, cfg.hd
    img = img_embeds.to(p["wk"].dtype)
    k = (img @ p["wk"].reshape(D, kh * hd)).reshape(B, N, kh, hd)
    v = (img @ p["wv"].reshape(D, kh * hd)).reshape(B, N, kh, hd)
    return k, v


def cross_attn_apply(p: Params, x: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, cfg: ArchConfig, *,
                     decode: bool) -> torch.Tensor:
    """Cross-attention of the text rows ``x [B,S,D]`` onto fixed image
    K/V ``k/v [B, n_img, K, hd]``, unmasked (the reference's
    ``cross_attn_apply``): ``q`` with ``bq`` under ``qkv_bias`` and no
    RoPE. A prefill (``decode=False``) runs the flash kernel's plain
    entry, not causal; a decode step (``S = 1``) the contiguous decode
    kernel with every length ``n_img``. Returns ``[B,S,D]``."""
    B, S, D = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"].reshape(D, h * hd)).reshape(B, S, h, hd)
    if cfg.qkv_bias:
        q = q + p["bq"]
    k, v = k.to(x.dtype), v.to(x.dtype)
    if decode:
        lens = torch.full((B,), k.shape[1], dtype=torch.int32,
                          device=x.device)
        o = ops.decode_attention(q.reshape(B, h, hd).contiguous(),
                                 k.contiguous(), v.contiguous(), lens)
    else:
        o = ops.prefill_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=False)
    return out_project(p, o.reshape(B, S, -1).to(x.dtype), cfg)
