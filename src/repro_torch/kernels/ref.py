"""Naive O(S^2) torch oracles for the attention kernels (counterparts of
``repro.kernels.ref``). Results are float32."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def gqa_decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """q: [B,H,hd]; k/v: [B,S,K,hd]; lengths: [B] -> [B,H,hd] (f32)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, K, H // K, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * hd ** -0.5
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v.float()).reshape(B, H, hd)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k/v: [B,S,K,hd] -> [B,Sq,H,hd] (f32)."""
    B, Sq, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd).float()
    s = torch.einsum("bqkgh,bskh->bqkgs", qg, k.float()) * hd ** -0.5
    q_ids = torch.arange(Sq, device=q.device)[:, None]
    kv_ids = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((Sq, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_ids >= kv_ids
    if window is not None:
        mask &= q_ids - kv_ids < window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd)
