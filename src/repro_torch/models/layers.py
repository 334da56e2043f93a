"""Norms, rotary embeddings, MLPs, embedding/unembedding.

Plain functions on tensors, one per reference function
(``repro.models.layers``), taking the same parameter dicts and layouts:
``w1/w3 [d,f]``, ``w2 [f,d]``, ``tok [Vp,d]``, ``pos [max_position,d]``,
``unemb [d,Vp]``.
"""
from __future__ import annotations

from typing import Dict

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


def unembed_apply(p: Params, x: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """Float32 logits over the padded vocab; padded columns are -1e30."""
    w = p["tok"].T if cfg.tie_embeddings else p["unemb"]
    logits = (x @ w.to(x.dtype)).float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits
