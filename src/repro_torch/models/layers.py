"""Norms, rotary embeddings, MLPs, embedding/unembedding.

Plain functions on tensors, one per reference function
(``repro.models.layers``), taking the same parameter dicts and layouts:
``w1/w3 [d,f]``, ``w2 [f,d]``, ``tok [Vp,d]``, ``pos [max_position,d]``,
``unemb [d,Vp]``. Under tensor parallelism (:mod:`repro_torch.
distributed`) each function reads the rank's plan
(:class:`~repro_torch.sharding.Layout`): the residual stream is
replicated (``act_replicated``) or the rank's block of d_model (the
default rules: a norm all-reduces its float32 row sums, the MLP and the
unembedding all-gather their input, and a row-parallel product's
partial sums are reduce-scattered where they would be all-reduced);
``w1/w3`` hold a rank's columns and ``w2`` its rows where d_ff divides
over the model axis (else the MLP is replicated); ``tok``/``unemb`` hold
its block of the vocab (a lookup masks the rows outside it and sums over
the ranks; the logits are all-gathered), or of d_model, or all of it.
Under FSDP (the plan's ``w_in``) a rank holds its data block of each
weight's ``W_IN`` dim, and each function gathers the weights it reads
whole over the data axis just before its matmul (:func:`full_weights`);
the gathered copy is a temporary, freed once the matmul has read it, so
a rank holds its shard plus the weights of the matmuls in flight. The
MLP, the embedding of a sequence's tokens and the unembedding run
under the reference's scopes (``mlp``, ``embed``, ``logits``); a decode
row's embedding runs under none, as the reference's ``_decode_embed``
does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.analysis import scope
from repro_torch.distributed import (gather_last, gather_weight, layout,
                                     reduce_partial, reduce_stats,
                                     scatter_last, vocab_block)

Params = Dict[str, torch.Tensor]


def _sharded() -> bool:
    """Is the residual stream the rank's block of d_model?"""
    lay = layout()
    return lay is not None and lay.residual


def residual_in(x: torch.Tensor) -> torch.Tensor:
    """A residual-layout activation at full width (all-gathered where the
    residual is d_model-sharded)."""
    return gather_last(x) if _sharded() else x


def residual_out(y: torch.Tensor, kind: str) -> torch.Tensor:
    """A block's output ``y`` into the residual's layout: ``kind``
    ``"partial"`` (a row-parallel product's partial sums: reduce-scattered
    to the rank's block, or all-reduced), ``"full"`` (the whole row,
    replicated: the rank's block taken) or ``"block"`` (already the
    rank's block of d_model)."""
    if kind == "block":
        return y
    if not _sharded():
        return reduce_partial(y) if kind == "partial" else y
    if kind == "partial":
        return scatter_last(y)
    a, b = layout().block(y.shape[-1])
    return y[..., a:b]


def full_weights(p: Params, names) -> Params:
    """``p`` with each weight of ``names`` whose ``W_IN`` block the rank
    holds (FSDP, the plan's ``w_in``) gathered whole over the data axis;
    ``p`` itself otherwise."""
    lay = layout()
    if lay is None or not lay.w_in:
        return p
    p = dict(p)
    for name in names:
        dim = lay.gathered(name)
        if dim is not None and name in p:
            p[name] = gather_weight(p[name], dim)
    return p


def norm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """LayerNorm (eps 1e-5) or RMSNorm (eps 1e-6), computed in float32.
    Over a d_model-sharded residual ``x`` is the rank's block: the row
    sums (``x`` and ``x**2`` for LayerNorm, ``x**2`` for RMSNorm) are
    all-reduced in float32 and the moments taken from them."""
    xf = x.float()
    if _sharded():
        d = x.shape[-1] * layout().size
        if cfg.norm == "layernorm":
            s = reduce_stats(torch.stack([xf.sum(-1), xf.square().sum(-1)],
                                         -1)) / d
            mu, ms = s[..., :1], s[..., 1:]
            y = (xf - mu) * torch.rsqrt((ms - mu.square()).clamp_min(0)
                                        + 1e-5)
            y = y * p["scale"].float() + p["bias"].float()
        else:
            ms = reduce_stats(xf.square().sum(-1, keepdim=True)) / d
            y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
        return y.to(x.dtype)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


def gated_rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor,
                        gate: torch.Tensor) -> torch.Tensor:
    """Mamba2's gated RMSNorm: ``norm(x * silu(gate))`` (eps 1e-6), the
    gate's SiLU in float32 and the product in ``x``'s dtype."""
    xf = (x * F.silu(gate.float()).to(x.dtype)).float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Split-half rotary embedding. x: [..., S, H, hd]; positions: [S] or
    [B, S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs          # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The MLP of ``x`` (in the residual's layout), returned in it."""
    lay = layout()
    x = residual_in(x)
    p = full_weights(p, ("w1", "w3", "w2"))
    with scope("mlp"):
        h = x @ p["w1"]
        if cfg.act == "swiglu":
            h = F.silu(h.float()).to(x.dtype) * (x @ p["w3"])
        elif cfg.act == "gelu":
            # the reference's jax.nn.gelu defaults to the tanh approximation
            h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        else:
            h = torch.clamp_min(h, 0)
        out = h @ p["w2"]
    return residual_out(out, "partial" if lay is None or lay.ffn else "full")


def _lookup(p: Params, tokens: torch.Tensor, positions: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """Token rows (and learned positions) in the residual's layout."""
    lay = layout()
    block = vocab_block(p["tok"].shape[0]) \
        if lay is None or lay.tok == "vocab" else None
    if block is None:
        # every row, or the rank's block of d_model of every row
        x = residual_out(p["tok"][tokens].to(cfg.activation_dtype),
                         "block" if lay is not None and lay.tok == "d_model"
                         else "full")
    else:
        # vocab-parallel: the rows this rank holds, zeros elsewhere, summed
        # over the ranks (one nonzero term a token: exact)
        local = tokens - block[0]
        held = (local >= 0) & (local < block[1])
        x = p["tok"][torch.where(held, local, 0)]
        x = residual_out(torch.where(held[..., None], x, 0).to(
            cfg.activation_dtype), "partial")
    if cfg.pos == "learned":
        x = x + p["pos"][positions].to(x.dtype)
    return x


def embed_apply(p: Params, tokens: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    with scope("embed"):
        return _lookup(p, tokens, positions, cfg)


def embed_inputs(p: Params, cfg: ArchConfig, positions: torch.Tensor,
                 tokens: Optional[torch.Tensor] = None,
                 embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A sequence's input rows (the reference's ``_embed_inputs``): a
    config with ``embedding_inputs`` takes ``embeds [B,S,D]`` (a
    modality frontend's output) plus its learned positions, any other
    its ``tokens [B,S]`` through :func:`embed_apply`."""
    if cfg.embedding_inputs:
        if embeds is None:
            raise ValueError(f"{cfg.name} takes embeddings, not token ids")
        x = residual_out(embeds.to(cfg.activation_dtype), "full")
        if cfg.pos == "learned":
            x = x + p["pos"][positions].to(x.dtype)
        return x
    if tokens is None:
        raise ValueError(f"{cfg.name} takes token ids")
    return embed_apply(p, tokens.long(), positions, cfg)


def decode_embed(p: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 positions: torch.Tensor,
                 embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode row a sequence, ``[B,1,D]`` (the reference's
    ``_decode_embed``): ``embeds [B,1,D]`` as given (no position added,
    as in the reference), else ``tokens [B]`` at ``positions`` (``[B,
    1]``, or ``[1]`` for one position shared by the batch)."""
    if embeds is not None:
        return residual_out(embeds.to(cfg.activation_dtype), "full")
    return _lookup(p, tokens.long()[:, None], positions, cfg)


def unembed_apply(p: Params, x: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """Float32 logits over the padded vocab; padded columns are -1e30.
    Under tensor parallelism the final norm's output ``x`` (in the
    residual's layout) meets the rank's block of the weight: its vocab
    columns (``x`` all-gathered, the logits all-gathered), its d_model
    rows (partial logits, all-reduced) or all of it."""
    lay = layout()
    kind = "vocab" if lay is None else lay.logits
    if kind != "d_model":
        x = residual_in(x)
    p = full_weights(p, ("unemb",))
    with scope("logits"):
        w = p["tok"].T if cfg.tie_embeddings else p["unemb"]
        logits = (x @ w.to(x.dtype)).float()
        if kind == "vocab":
            logits = gather_last(logits)
        elif kind == "d_model":
            logits = reduce_partial(logits)
        if cfg.padded_vocab != cfg.vocab_size:
            logits[..., cfg.vocab_size:].fill_(-1e30)
        return logits
