"""The Mamba2 (SSD, arXiv:2405.21060) mixer (counterpart of
``repro.models.ssm``), with the reference's parameter layouts:
``in_proj [d, 2*d_in + 2*G*N + H]`` (``z``, then ``x B C`` through the
conv, then ``dt``), ``conv_w [W, conv_ch]``, ``conv_b``, ``a_log``,
``d_skip``, ``dt_bias`` (float32) ``[H]``, ``norm [d_in]`` and
``out_proj [d_in, d]``.

* :func:`ssd_chunked` is the chunked SSD scan: a loop over chunks of
  ``cfg.ssm.chunk`` rows (the sequence zero-padded to a whole chunk),
  each the intra-chunk quadratic form plus the inter-chunk state carried
  in float32, as the reference's ``lax.scan``.
* :func:`ssm_seq` is a prompt's mixer, optionally continuing from a state
  ``h0`` and a conv tail ``conv0``. It takes no lengths: like the
  reference's, the state it returns has scanned every row it was given,
  a prefill bucket's padding rows included, and its conv tail is the
  bucket's last ``W - 1`` rows.
* :func:`ssm_decode` is one token against the state ``{"h", "conv"}``.

The SSD einsums, the conv and the state update run as PyTorch operations
(the reference computes them outside any Pallas kernel).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import gated_rmsnorm_apply
from repro_torch.models.params import ssm_dims

Params = Dict[str, torch.Tensor]


def _split(zxbcdt: torch.Tensor, cfg: ArchConfig):
    d_in, nh, conv_ch = ssm_dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_ch],
            zxbcdt[..., -nh:])


def _conv_full(xbc: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time as shifted adds, in float32, then
    SiLU. ``xbc [B, S, C]``."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    acc = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(W):
        acc = acc + pad[:, i:i + S].float() * w[i].float()
    return F.silu(acc + b.float()).to(xbc.dtype)


def _conv_step(conv_state: torch.Tensor, xbc_new: torch.Tensor,
               w: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``conv_state [B, W-1, C]``, ``xbc_new [B, 1, C]`` -> ``(out [B, 1,
    C], new state)``."""
    window = torch.cat([conv_state, xbc_new], dim=1)             # [B,W,C]
    out = (window.float() * w.float()).sum(1) + b.float()
    return F.silu(out)[:, None].to(xbc_new.dtype), window[:, 1:]


def _expand(a: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    return a.repeat_interleave(rep, dim=dim) if rep > 1 else a


def ssd_chunked(xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_: torch.Tensor, C_: torch.Tensor, cfg: ArchConfig,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan. ``xs [B, S, H, P]``; ``dt [B, S, H]`` float32;
    ``A [H]`` float32 (negative); ``B_/C_ [B, S, G, N]``. Returns ``(y [B,
    S, H, P] in xs's dtype, h_final [B, H, P, N] float32)``."""
    Bn, S, H, P = xs.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(cfg.ssm.chunk, S)
    padlen = (-S) % Q
    if padlen:
        xs, dt, B_, C_ = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, padlen))
                          for a in (xs, dt, B_, C_))
    NC = (S + padlen) // Q
    rep = H // G
    xs_f = xs.float().reshape(Bn, NC, Q, H, P)
    dt_c = dt.reshape(Bn, NC, Q, H)
    Bc = B_.float().reshape(Bn, NC, Q, G, N)
    Cc = C_.float().reshape(Bn, NC, Q, G, N)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=xs.device))[None, :, :, None]
    h = h0.float() if h0 is not None else torch.zeros(
        (Bn, H, P, N), dtype=torch.float32, device=xs.device)
    ys = []
    for c in range(NC):
        x_c, d_c, B_c, C_c = xs_f[:, c], dt_c[:, c], Bc[:, c], Cc[:, c]
        dA = d_c * A                                            # [B,Q,H]
        cs = torch.cumsum(dA, dim=1)
        seg = cs[:, :, None, :] - cs[:, None, :, :]             # [B,Qi,Qj,H]
        L = torch.where(tri, torch.exp(seg), 0.0)
        CB = torch.einsum("bign,bjgn->bijg", C_c, B_c)
        M = _expand(CB, rep, -1) * L * d_c[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", M, x_c)
        w_last = torch.exp(cs[:, -1:, :] - cs) * d_c            # [B,Q,H]
        chunk_state = torch.einsum("bqh,bqhn,bqhp->bhpn", w_last,
                                   _expand(B_c, rep, -2), x_c)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", _expand(C_c, rep, -2),
                               h) * torch.exp(cs)[..., None]
        h = h * torch.exp(dA.sum(1))[:, :, None, None] + chunk_state
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bn, NC * Q, H, P)[:, :S]
    return y.to(xs.dtype), h


def _state_update(h: torch.Tensor, dt1: torch.Tensor, A: torch.Tensor,
                  xs: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's recurrence in float32 (the reference's
    ``ssm_state_update`` scope): ``h [B, H, P, N]`` decays by
    ``exp(dt * A)`` and takes ``dt * x B^T``; ``y = h C``. Returns ``(h,
    y [B, H, P])``."""
    h = h.float() * torch.exp(dt1 * A)[:, :, None, None] \
        + dt1[:, :, None, None] * xs.float()[..., None] * Bh[:, :, None, :]
    return h, torch.einsum("bhpn,bhn->bhp", h, Ch)


def _project(xbc_conv: torch.Tensor, cfg: ArchConfig):
    """The conv output's heads ``xs [..., H, P]`` and its ``B``/``C``
    ``[..., G, N]``."""
    s = cfg.ssm
    d_in, nh, _ = ssm_dims(cfg)
    gn = s.ngroups * s.d_state
    lead = xbc_conv.shape[:-1]
    return (xbc_conv[..., :d_in].reshape(*lead, nh, s.head_dim),
            xbc_conv[..., d_in:d_in + gn].reshape(*lead, s.ngroups,
                                                  s.d_state),
            xbc_conv[..., d_in + gn:].reshape(*lead, s.ngroups, s.d_state))


def ssm_seq(p: Params, x: torch.Tensor, cfg: ArchConfig,
            h0: Optional[torch.Tensor] = None,
            conv0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full-sequence mixer, ``x [B, S, d]`` -> ``(out [B, S, d],
    {"h": [B, H, P, N] float32, "conv": [B, W-1, conv_ch]})``; ``h0`` and
    ``conv0`` continue an earlier segment (its state and its last
    ``W - 1`` pre-conv rows)."""
    W = cfg.ssm.conv_width
    d_in = ssm_dims(cfg)[0]
    B, S, _ = x.shape
    z, xbc, dt = _split(x @ p["in_proj"], cfg)
    if conv0 is not None:
        ext = torch.cat([conv0.to(xbc.dtype), xbc], dim=1)
        xbc_conv = _conv_full(ext, p["conv_w"], p["conv_b"])[
            :, conv0.shape[1]:]
    else:
        xbc_conv = _conv_full(xbc, p["conv_w"], p["conv_b"])
    xs, B_, C_ = _project(xbc_conv, cfg)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    y, h_final = ssd_chunked(xs, dt, A, B_, C_, cfg, h0=h0)
    y = y + xs * p["d_skip"][None, None, :, None].to(xs.dtype)
    y = gated_rmsnorm_apply(p["norm"], y.reshape(B, S, d_in), z)
    tail = xbc[:, -(W - 1):] if S >= W - 1 else \
        F.pad(xbc, (0, 0, W - 1 - S, 0))
    return y @ p["out_proj"], {"h": h_final, "conv": tail}


def ssm_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
               cfg: ArchConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token, ``x [B, 1, d]`` against ``state`` ``{"h": [B, H, P, N],
    "conv": [B, W-1, conv_ch]}``; returns ``(out [B, 1, d], new state)``
    (``h`` float32, ``conv`` in the model's dtype)."""
    s = cfg.ssm
    d_in, nh, _ = ssm_dims(cfg)
    B = x.shape[0]
    z, xbc, dt = _split(x @ p["in_proj"], cfg)
    xbc_conv, conv_new = _conv_step(state["conv"].to(xbc.dtype), xbc,
                                    p["conv_w"], p["conv_b"])
    xs, B_, C_ = _project(xbc_conv[:, 0], cfg)         # [B,H,P], [B,G,N]
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])             # [B,H]
    A = -torch.exp(p["a_log"])
    rep = nh // s.ngroups
    Bh, Ch = _expand(B_, rep, 1).float(), _expand(C_, rep, 1).float()
    h, y = _state_update(state["h"], dt1, A, xs, Bh, Ch)
    y = (y + xs.float() * p["d_skip"][None, :, None]).to(x.dtype)
    y = gated_rmsnorm_apply(p["norm"], y.reshape(B, 1, d_in), z)
    return y @ p["out_proj"], {"h": h, "conv": conv_new}
