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
plain versions on the CPU. Under tensor parallelism
(:mod:`repro_torch.distributed`) each function reads the rank's plan
(:class:`~repro_torch.sharding.Layout`): the projections yield the
rank's query heads and the KV heads it holds (a head-dim-sharded
``q/k/v`` all-gathered first, a row-parallel one all-reduced), attention
runs over the rank's heads, or over all of them where they fall back,
and ``wo``'s output goes back into the residual's layout; under FSDP
``wq/wk/wv`` and ``wo`` are gathered whole over the data axis just
before their matmuls (:func:`~repro_torch.models.layers.full_weights`).
Over a KV
sequence sharded on the model axis a decode step runs the paged
kernel's partials entry over the rows the rank holds, all-gathers every
rank's ``[B, H, hd + 2]`` float32 partials and combines them
(:func:`seq_sharded_attention`); a decode over a dense cache does the same
with the contiguous kernel's partials entry (:func:`seq_sharded_decode`),
and a prefill over a prefix first all-gathers every rank's rows of it
(:func:`whole_prefix`). Each part runs under the reference's scope
(:func:`~repro_torch.core.analysis.scope`: ``qkv_proj``, ``kv_update``,
``attn_core``, ``attn_out``, ``cross_kv``, ``cross_attn``) at the
reference's site.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.analysis import scope
from repro_torch.device import on_device
from repro_torch.distributed import (gather_last, gather_parts, layout,
                                     reduce_partial)
from repro_torch.kernels import ops
from repro_torch.models.layers import (full_weights, residual_in,
                                       residual_out, rope)

Params = Dict[str, torch.Tensor]


def _project(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    """``x [B,S,D_in] @ w [D_in, n, hd_w]`` -> ``[B,S,n,hd]``: a
    row-parallel product's partial sums all-reduced, a head-dim-sharded
    one's blocks all-gathered."""
    B, S, D = x.shape
    n = w.shape[1]
    y = x @ w.reshape(D, -1)
    if kind == "rows":
        y = reduce_partial(y)
    elif kind == "head_dim":
        y = gather_last(y.reshape(B, S, n, -1))
    return y.reshape(B, S, n, -1)


def _heads(t: torch.Tensor, have: Tuple[int, int], want: Tuple[int, int],
           dim: int = 2) -> torch.Tensor:
    """The heads ``want`` of ``t``, which holds heads ``have`` along
    ``dim`` (``[first, end)`` each)."""
    if have == want:
        return t
    return t.narrow(dim, want[0] - have[0], want[1] - want[0])


def _gather_heads(q: torch.Tensor) -> torch.Tensor:
    """Every rank's block of heads ``q [..., n, hd]`` all-gathered to
    ``[..., M * n, hd]``."""
    *lead, n, hd = q.shape
    return gather_last(q.reshape(*lead, n * hd)).reshape(*lead, -1, hd)


def qkv_project(p: Params, x: torch.Tensor, cfg: ArchConfig,
                positions: Optional[torch.Tensor], *,
                all_heads: bool = False):
    """x: [B,S,D] -> q [B,S,K,G,hd], k,v [B,S,K,hd] (rope applied).

    On one device every head. Under a rank's plan ``x`` is in the
    residual's layout; ``q`` holds the heads attention runs over
    (``attn_heads``, or every head with ``all_heads``: a decode over a
    sharded KV sequence) and ``k/v`` the KV heads the rank holds."""
    lay = layout()
    B, S, _ = x.shape
    hd = cfg.hd
    if lay is None:
        h, k = p["wq"].shape[1], p["wk"].shape[1]
        with scope("qkv_proj"):
            q = (x @ p["wq"].reshape(-1, h * hd)).reshape(B, S, h, hd)
            kk = (x @ p["wk"].reshape(-1, k * hd)).reshape(B, S, k, hd)
            vv = (x @ p["wv"].reshape(-1, k * hd)).reshape(B, S, k, hd)
            if cfg.qkv_bias:
                q = q + p["bq"]
                kk = kk + p["bk"]
                vv = vv + p["bv"]
            if cfg.pos == "rope" and positions is not None:
                q = rope(q, positions, cfg.rope_theta)
                kk = rope(kk, positions, cfg.rope_theta)
        return q.reshape(B, S, k, h // k, hd), kk, vv
    if lay.wq != "rows":
        x = residual_in(x)
    p = full_weights(p, ("wq", "wk", "wv"))
    every = (0, cfg.n_heads)
    everykv = (0, cfg.n_kv_heads)
    with scope("qkv_proj"):
        q = _project(x, p["wq"], lay.wq)
        q = _heads(q, every if lay.wq == "rows" else
                   (lay.heads if lay.wq == "heads" else every), lay.heads)
        wk, wv = p["wk"], p["wv"]
        if lay.wkv == "full":
            wk = _heads(wk, everykv, lay.kv_heads, 1)
            wv = _heads(wv, everykv, lay.kv_heads, 1)
        kk = _project(x, wk, lay.wkv)
        vv = _project(x, wv, lay.wkv)
        if lay.wkv in ("rows", "head_dim"):
            kk = _heads(kk, everykv, lay.kv_heads)
            vv = _heads(vv, everykv, lay.kv_heads)
        if cfg.qkv_bias:
            q = q + p["bq"]
            nk = lay.kv_heads[1] - lay.kv_heads[0]
            kk = kk + (p["bk"] if p["bk"].shape[0] == nk else
                       _heads(p["bk"], everykv, lay.kv_heads, 0))
            vv = vv + (p["bv"] if p["bv"].shape[0] == nk else
                       _heads(p["bv"], everykv, lay.kv_heads, 0))
        if cfg.pos == "rope" and positions is not None:
            q = rope(q, positions, cfg.rope_theta)
            kk = rope(kk, positions, cfg.rope_theta)
        want = every if all_heads else lay.attn_heads
        if want != lay.heads:
            q = _heads(_gather_heads(q), every, want)
    # the KV heads the query heads read
    k_read = kk.shape[2] if all_heads else lay.attn_kv[1] - lay.attn_kv[0]
    return q.reshape(B, S, k_read, q.shape[2] // k_read, hd), kk, vv


def attn_kv(lay, k: torch.Tensor) -> torch.Tensor:
    """The held KV heads ``k [..., K_held, hd]`` the rank's attention
    heads read (all of them on one device)."""
    if lay is None:
        return k
    return _heads(k, lay.kv_heads, lay.attn_kv, k.dim() - 2)


def out_project(p: Params, o: torch.Tensor, cfg: ArchConfig, *,
                heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """o: [B,S,n*hd] -> [B,S,D] (in the residual's layout). Under a
    rank's plan ``o`` holds heads ``heads`` (``attn_heads`` by default);
    ``wo`` is the rank's heads (partial sums, all-reduced or
    reduce-scattered), its head-dim block, its d_model block of the
    output, or all of it."""
    lay = layout()
    B, S = o.shape[:2]
    if lay is None:
        hhd = p["wo"].shape[0] * cfg.hd
        with scope("attn_out"):
            out = o.reshape(B, S, hhd) @ p["wo"].reshape(hhd, -1)
        return reduce_partial(out)
    o = o.reshape(B, S, -1, cfg.hd)
    have = heads or lay.attn_heads
    if lay.wo == "heads":
        o = _heads(o, have, lay.heads)
    else:
        o = _heads(o, have, (0, cfg.n_heads))
        if lay.wo == "head_dim":
            a, b = lay.block(cfg.hd)
            o = o[..., a:b]
    w = full_weights(p, ("wo",))["wo"]
    with scope("attn_out"):
        out = o.reshape(B, S, -1) @ w.reshape(-1, w.shape[-1])
    return residual_out(out, {"heads": "partial", "head_dim": "partial",
                              "d_model": "block", "full": "full"}[lay.wo])


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
    reference's (``_mask_builder``) row for row. The prefix is every
    rank's (:func:`whole_prefix` where the KV sequence is sharded).
    """
    B, S, _ = x.shape
    if prefix_k is not None and not causal:
        # the reference's model refuses it (a bidirectional suffix would
        # change the prefix's K/V after it was written)
        raise NotImplementedError(
            "prefix/chunked prefill requires causal attention: a "
            "bidirectional suffix would retroactively change the "
            "already-written prefix KV")
    lay = layout()
    q, k, v = qkv_project(p, x, cfg, positions)
    q = q.reshape(B, S, -1, cfg.hd).contiguous()
    ka, va = attn_kv(lay, k), attn_kv(lay, v)
    if prefix_k is None:
        with scope("attn_core"):
            o = ops.prefill_attention(q, ka.contiguous(), va.contiguous(),
                                      causal=causal, window=window,
                                      lengths=lengths)
    else:
        pad = prefix_k.shape[1]
        # a pool holding every KV head (a sharded KV sequence) gives them
        # all: the ones the rank's heads read
        k_all = torch.cat([attn_kv(lay, prefix_k).to(k.dtype), ka], dim=1)
        v_all = torch.cat([attn_kv(lay, prefix_v).to(v.dtype), va], dim=1)
        if lengths is None:
            total = prefix_len + S
            lengths = (total.reshape(1).expand(B)
                       if isinstance(total, torch.Tensor) else
                       torch.full((B,), total, device=x.device))
        with scope("attn_core"):
            o = ops.prefill_prefix_attention(
                q, k_all.contiguous(), v_all.contiguous(), prefix_pad=pad,
                prefix_len=prefix_len, lengths=lengths, window=window)
    return out_project(p, o.reshape(B, S, -1), cfg), (k, v)


def whole_prefix(k: torch.Tensor, v: torch.Tensor, block_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A prefix over a KV sequence sharded on the model axis made whole:
    each rank's ``k/v [B, nb * rows, K, hd]``, its ``rows = block_size /
    M`` rows of each block, all-gathered (one collective for both) and put
    back in position order, ``[B, nb * block_size, K, hd]``: block ``i``'s
    rows from rank 0, then rank 1's, ... So positions, the causal mask and
    the prefix pad are the unsharded ones."""
    parts = gather_parts(torch.stack([k, v]))      # [M, 2, B, nb*rows, ...]
    M, _, B, n = parts.shape[:4]
    rows = block_size // M
    parts = parts.reshape(M, 2, B, n // rows, rows, *k.shape[2:])
    whole = parts.permute(1, 2, 3, 0, 4, 5, 6).reshape(
        2, B, n * M, *k.shape[2:])
    return whole[0], whole[1]


def self_attn_decode(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cfg: ArchConfig, *,
                     pos: Union[int, torch.Tensor],
                     window: Optional[int] = None,
                     lengths: Optional[torch.Tensor] = None,
                     block_size: Optional[int] = None) -> torch.Tensor:
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

    Over a KV sequence sharded on the model axis the cache holds the
    rank's rows of each ``block_size`` block of the sequence (a paged
    pool's dense copy, :meth:`~repro_torch.kvcache.paged.PagedKVCache.
    gather_tables`), or without ``block_size`` its contiguous share of
    the slots (the reference's cache spec); the new row is written on the
    rank that holds it, and attention combines every rank's partials
    (:func:`seq_sharded_decode`).
    """
    B = x.shape[0]
    lay = layout()
    seq = lay is not None and lay.kv_seq
    pos = on_device(pos, x.device)
    ragged = pos.dim() == 1
    # the cache's slots, every rank's (a rank holds a contiguous share)
    smax = cache_k.shape[1] * (lay.size if seq else 1)
    if window is not None:
        _check_ring(smax, window, ragged, pos, lengths)
    q, k_new, v_new = qkv_project(p, x, cfg,
                                  pos[:, None] if ragged else pos.reshape(1),
                                  all_heads=seq)
    # the slots of the blocks the sequence is sharded in (one block of
    # every slot without block_size)
    block = block_size or smax
    with scope("kv_update"):
        if seq:
            _write_own_rows(cache_k, cache_v, k_new, v_new, pos, ragged,
                            window, lay, block)
        elif ragged:
            rows = torch.arange(B, device=x.device)
            cache_k.index_put_((rows, pos.long()),
                               k_new[:, 0].to(cache_k.dtype))
            cache_v.index_put_((rows, pos.long()),
                               v_new[:, 0].to(cache_v.dtype))
        else:
            slot = pos.long().reshape(1)
            if window is not None:
                slot = slot % cache_k.shape[1]
            cache_k.index_copy_(1, slot, k_new.to(cache_k.dtype))
            cache_v.index_copy_(1, slot, v_new.to(cache_v.dtype))
    if ragged:
        eff = lengths if lengths is not None else pos + 1
    else:
        eff = (pos + 1).expand(B)
        if window is not None:
            eff = eff.clamp(max=smax)
        if lengths is not None:
            eff = torch.minimum(eff, lengths)
    q = q.reshape(B, -1, cfg.hd).contiguous()
    if seq:
        local = local_lengths(eff, block, block // lay.size, lay.rank)
        o = seq_sharded_decode(q, cache_k, cache_v, local)
        return out_project(p, o.reshape(B, 1, -1).to(x.dtype), cfg,
                           heads=(0, cfg.n_heads))
    with scope("attn_core"):
        o = ops.decode_attention(q, cache_k, cache_v,
                                 eff.to(torch.int32).contiguous())
    return out_project(p, o.reshape(B, 1, -1).to(x.dtype), cfg)


def _write_own_rows(cache_k: torch.Tensor, cache_v: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    pos: torch.Tensor, ragged: bool, window: Optional[int],
                    lay, block: int):
    """The new rows into a dense cache whose slots are sharded on the
    model axis (rank ``r`` holds slots ``[r rows, (r + 1) rows)`` of each
    ``block``-slot block, ``rows = block / M``, in order): a row lands on
    the rank that holds its slot; elsewhere its slot's own value is
    written back (no host decision, so a graph can replay it)."""
    B = cache_k.shape[0]
    slot = pos.long() if ragged else pos.long().reshape(1).expand(B)
    if window is not None:
        slot = slot % (cache_k.shape[1] * lay.size)
    own, _, loc = own_rows(slot, block, block // lay.size, lay.rank)
    own = own[:, None, None]
    b = torch.arange(B, device=cache_k.device)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache[b, loc] = torch.where(own, new[:, 0].to(cache.dtype),
                                    cache[b, loc])


def local_lengths(lengths: torch.Tensor, block_size: int, rows: int,
                  rank: int) -> torch.Tensor:
    """Each request's valid rows on rank ``rank`` when every ``block_size``
    block's rows are sharded ``rows`` a rank (rank ``r`` holds rows ``[r
    rows, (r + 1) rows)`` of each block): a prefix of its own rows,
    ``full_blocks * rows + clamp(tail - r * rows, 0, rows)``. int32."""
    n = lengths.long()
    tail = (n % block_size - rank * rows).clamp(0, rows)
    return (n // block_size * rows + tail).to(torch.int32)


def own_rows(pos: torch.Tensor, block_size: int, rows: int, rank: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where positions ``pos`` lie when every ``block_size`` block's rows
    are sharded ``rows`` a rank (as :func:`local_lengths`): whether rank
    ``rank`` holds each, its row among the rank's rows of its block, and
    its row in a dense copy of the rank's rows of each block, ``block *
    rows + row`` (both clamped into the rank's rows where another rank
    holds the position)."""
    sib = pos % block_size - rank * rows
    row = sib.clamp(0, rows - 1)
    return (sib >= 0) & (sib < rows), row, pos // block_size * rows + row


def seq_sharded_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over a KV sequence sharded on the model axis:
    ``q [B,H,hd]`` (every head) against the rows this rank holds (its
    pool ``[NB,rows,K,hd]``, its ``lengths``), the paged kernel's
    unnormalised ``(acc, m, l)`` partials ``[B,H,hd+2]`` float32,
    all-gathered from every rank and combined. All-gathering the partials
    (one collective, every rank combining the same pieces in the same
    order) rather than all-reducing them (a max, then a sum of the
    rescaled partials: two) keeps the ranks' outputs bit-identical and
    issues one collective a layer. Returns ``[B,H,hd]`` in ``q``'s
    dtype."""
    with scope("attn_core"):
        part = ops.paged_decode_partials(q, k_pool, v_pool, tables,
                                         lengths)
    return _combine_pieces(part, q.dtype)


def seq_sharded_decode(q: torch.Tensor, cache_k: torch.Tensor,
                       cache_v: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """:func:`seq_sharded_attention` over a dense cache: ``q [B,H,hd]``
    against the rank's rows ``cache_k/v [B,n,K,hd]`` (its valid rows a
    prefix of them, ``lengths``), the contiguous kernel's partials entry,
    all-gathered from every rank and combined in the same order on each.
    Returns ``[B,H,hd]`` in ``q``'s dtype."""
    with scope("attn_core"):
        part = ops.decode_partials(q, cache_k, cache_v, lengths)
    return _combine_pieces(part, q.dtype)


def _combine_pieces(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Every rank's partials ``[B,H,hd+2]`` all-gathered and combined."""
    parts = gather_parts(part)
    with scope("attn_core"):
        return ops.paged_decode_combine(parts, dtype)


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
                           positions: torch.Tensor, block_size: int,
                           seq_lengths: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
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

    Over a KV sequence sharded on the model axis the pool holds the
    rank's ``BS / M`` rows of each block (``[NB+1, BS/M, K, hd]``): the
    new row is written on the rank that holds it (the trash block, the
    pool's last, on the others), and attention combines every rank's
    partials (:func:`seq_sharded_attention`) over ``seq_lengths``, the
    rank's valid rows (:func:`local_lengths`; computed here if not
    given).
    """
    B = x.shape[0]
    lay = layout()
    seq = lay is not None and lay.kv_seq
    q, k_new, v_new = qkv_project(p, x, cfg, positions[:, None],
                                  all_heads=seq)
    pos = positions.long()
    phys = tables[torch.arange(B, device=x.device), pos // block_size].long()
    sib = pos % block_size
    if seq:
        # each block's rows are sharded: a row lands on the rank that
        # holds its slot, the trash block (the pool's last) elsewhere
        rows = k_pool.shape[1]
        phys = torch.where(sib // rows == lay.rank, phys,
                           k_pool.shape[0] - 1)
        sib = sib % rows
    with scope("kv_update"):
        k_pool.index_put_((phys, sib), k_new[:, 0].to(k_pool.dtype))
        v_pool.index_put_((phys, sib), v_new[:, 0].to(v_pool.dtype))
    q = q.reshape(B, -1, cfg.hd).contiguous()
    if seq:
        if seq_lengths is None:
            seq_lengths = local_lengths(lengths, block_size, k_pool.shape[1],
                                        lay.rank)
        o = seq_sharded_attention(q, k_pool, v_pool, tables, seq_lengths)
        return out_project(p, o.reshape(B, 1, -1).to(x.dtype), cfg,
                           heads=(0, cfg.n_heads))
    with scope("attn_core"):
        o = ops.paged_decode_attention(q, k_pool, v_pool, tables, lengths)
    return out_project(p, o.reshape(B, 1, -1).to(x.dtype), cfg)


def cross_attn_kv(p: Params, img_embeds: torch.Tensor,
                  cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``CROSS`` layer's image K/V from (stubbed) image embeddings
    ``[B, n_img, D]``: ``k, v [B, n_img, K, hd]``, no bias and no RoPE
    (the reference's ``cross_attn_kv``)."""
    B, N, D = img_embeds.shape
    kh, hd = p["wk"].shape[1], cfg.hd
    with scope("cross_kv"):
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
    h, hd = p["wq"].shape[1], cfg.hd
    with scope("cross_attn"):
        q = (x @ p["wq"].reshape(D, h * hd)).reshape(B, S, h, hd)
        if cfg.qkv_bias:
            q = q + p["bq"]
    k, v = k.to(x.dtype), v.to(x.dtype)
    with scope("attn_core"):
        if decode:
            lens = torch.full((B,), k.shape[1], dtype=torch.int32,
                              device=x.device)
            o = ops.decode_attention(q.reshape(B, h, hd).contiguous(),
                                     k.contiguous(), v.contiguous(), lens)
        else:
            o = ops.prefill_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=False)
    return out_project(p, o.reshape(B, S, -1).to(x.dtype), cfg)
