"""Norms, rotary embeddings, MLPs, embedding/unembedding.

Plain functions on tensors, one per reference function
(``repro.models.layers``), taking the same parameter dicts and layouts:
``w1/w3 [d,f]``, ``w2 [f,d]``, ``tok [Vp,d]``, ``pos [max_position,d]``,
``unemb [d,Vp]``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = Dict[str, torch.Tensor]


def norm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """LayerNorm (eps 1e-5) or RMSNorm (eps 1e-6), computed in float32."""
    xf = x.float()
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
    h = x @ p["w1"]
    if cfg.act == "swiglu":
        h = F.silu(h.float()).to(x.dtype) * (x @ p["w3"])
    elif cfg.act == "gelu":
        # the reference's jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    else:
        h = torch.clamp_min(h, 0)
    return h @ p["w2"]


def embed_apply(p: Params, tokens: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    x = p["tok"][tokens].to(cfg.activation_dtype)
    if cfg.pos == "learned":
        x = x + p["pos"][positions].to(x.dtype)
    return x


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
        x = embeds.to(cfg.activation_dtype)
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
        return embeds.to(cfg.activation_dtype)
    return embed_apply(p, tokens.long()[:, None], positions, cfg)


def unembed_apply(p: Params, x: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """Float32 logits over the padded vocab; padded columns are -1e30."""
    w = p["tok"].T if cfg.tie_embeddings else p["unemb"]
    logits = (x @ w.to(x.dtype)).float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits
