"""Mixture-of-Experts FFN on one device (counterpart of
``repro.models.moe``).

The reference's ``moe_ffn`` runs the GShard pattern inside a
``shard_map`` (experts over the data axes, ``d_ff`` over the model
axis); on one card both axes have size 1 and what remains is its local
body, ported here step for step:

    top-k route in float32 -> capacity-bucketed dispatch buffer [E, C, d]
    -> the expert FFN over all E experts -> weighted combine

``C = max(1, ceil(capacity_factor * top_k * T / E))`` for the ``T`` rows
of a chunk (every row of a padded batch counts). An assignment's rank
within its expert is its position in the flat ``[T * k]`` token-major
order, so rows that come later (batch padding is always last) never
displace earlier ones, and an assignment past ``C`` is dropped: its
token gets nothing from that expert. The expert FFN reads every expert's
weights whatever the routing, as the reference's einsum does.

Ties in the top-k are broken towards the lower expert index, as
``lax.top_k`` breaks them: a stable descending sort.

With ``with_aux`` the block also returns the load-balance auxiliary loss
of training (GShard/Switch): ``E * sum_e f_e * p_e`` a chunk, ``f_e`` the
share of the chunk's rows whose first choice is expert ``e`` and ``p_e``
its mean router probability, averaged over the chunks and scaled by
``moe.aux_loss_weight``.

The router, the dispatch write, the experts and the combine run under
the reference's scopes (``router``, ``moe_dispatch``, ``expert_ffn``,
``moe_gather``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.analysis import scope
# the module, not its names: importing the core package (for ``scope``)
# imports this module's helpers back through the census
from repro_torch.models import layers

Params = Dict[str, torch.Tensor]

MOE_TOKEN_CHUNK = 8192   # most rows dispatched at once


def capacity(capacity_factor: float, top_k: int, T: int, E: int) -> int:
    """Slots an expert has for a chunk of ``T`` rows."""
    return max(1, math.ceil(capacity_factor * top_k * T / E))


def token_chunks(T: int) -> int:
    """Chunks the rows are dispatched in: halved while a chunk exceeds
    :data:`MOE_TOKEN_CHUNK` and the count still divides ``T``."""
    n = 1
    while T // n > MOE_TOKEN_CHUNK and T % (n * 2) == 0:
        n *= 2
    return n


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x [T, d]`` -> ``(probs [T, E] float32, weights [T, k] in x's
    dtype, expert ids [T, k])``: a float32 softmax over the router's
    logits, its top ``k`` (ties to the lower id) renormalised."""
    with scope("router"):
        probs = torch.softmax(x.float() @ router.float(), dim=-1)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, idx = w[:, :top_k], idx[:, :top_k]
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    return probs, w.to(x.dtype), idx


def _dispatch_indices(idx: torch.Tensor, E: int, C: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``idx [T, k]`` expert ids -> ``(slot [T, k] in [0, E*C), keep [T,
    k])``: each assignment's rank within its expert is the count of
    earlier assignments to it in the flat token-major order; ranks from
    ``C`` on are dropped (slot 0, keep False)."""
    flat = idx.reshape(-1)
    experts = torch.arange(E, device=idx.device)
    rank = torch.cumsum((flat[:, None] == experts).long(), dim=0) - 1
    mine = rank.gather(1, flat[:, None])[:, 0]
    keep = mine < C
    slot = torch.where(keep, flat * C + mine, torch.zeros_like(flat))
    return slot.reshape(idx.shape), keep.reshape(idx.shape)


def _expert_ffn(h: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                w3, act: str) -> torch.Tensor:
    """``h [E, C, d]`` through each expert's FFN (``w1/w3 [E, d, f]``,
    ``w2 [E, f, d]``): one batched GEMM an expert weight."""
    with scope("expert_ffn"):
        u = torch.bmm(h, w1)
        if act == "swiglu":
            u = F.silu(u.float()).to(h.dtype) * torch.bmm(h, w3)
        elif act == "gelu":
            u = F.gelu(u.float(), approximate="tanh").to(h.dtype)
        else:
            u = torch.clamp_min(u, 0)
        return torch.bmm(u, w2)


def _one_chunk(p: Params, xt: torch.Tensor, cfg: ArchConfig, C: int,
               with_aux: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One chunk's output and, ``with_aux``, its load-balance loss."""
    T, d = xt.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    probs, wts, idx = _route(xt, p["router"], k)
    slot, keep = _dispatch_indices(idx, E, C)
    # kept assignments have slots of their own; dropped ones go to a spare
    # last row, which nothing reads (the reference adds x * 0 to slot 0)
    dest = torch.where(keep, slot, torch.full_like(slot, E * C)).reshape(-1)
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    with scope("moe_dispatch"):
        buf.index_copy_(0, dest, xt.repeat_interleave(k, dim=0))
    y = _expert_ffn(buf[:E * C].view(E, C, d), p["w1"], p["w2"],
                    p.get("w3"), cfg.act).reshape(E * C, d)
    with scope("moe_gather"):
        picked = y.index_select(0, slot.reshape(-1)).view(T, k, d)
        picked = picked * (wts * keep.to(wts.dtype))[..., None]
        out = picked.float().sum(1).to(xt.dtype)
    if not with_aux:
        return out, None
    f_e = F.one_hot(idx[:, 0], E).float().mean(0)
    return out, E * (f_e * probs.mean(0)).sum()


def moe_ffn(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
            capacity_factor: float, with_aux: bool = False
            ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``x [B, S, d]`` -> ``[B, S, d]``: the routed experts over the
    ``B * S`` rows (in :func:`token_chunks` chunks), plus the dense
    residual branch when the config has one (``p["dense"]``). With
    ``with_aux``, ``(out, aux)``: the float32 load-balance loss, already
    scaled by ``moe.aux_loss_weight``."""
    B, S, d = x.shape
    moe = cfg.moe
    T = B * S
    n = token_chunks(T)
    C = capacity(capacity_factor, moe.top_k, T // n, moe.num_experts)
    parts = [_one_chunk(p, c, cfg, C, with_aux)
             for c in x.reshape(T, d).chunk(n)]
    out = torch.cat([o for o, _ in parts]) if n > 1 else parts[0][0]
    out = out.reshape(B, S, d)
    if moe.dense_residual:
        out = out + layers.mlp_apply(p["dense"], x, cfg)
    if not with_aux:
        return out
    aux = torch.stack([a for _, a in parts]).mean()
    return out, aux * moe.aux_loss_weight
