"""Dispatch for the model's attention kernels (counterpart of
``repro.kernels.ops``): a CUDA tensor launches the hand-written kernel, a
CPU tensor runs the kernel's plain PyTorch version."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import gqa_decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_decode_attention import \
    paged_gqa_decode_attention


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     block_s: int = 256) -> torch.Tensor:
    """Contiguous-cache GQA decode. q:[B,H,hd], k/v:[B,S,K,hd],
    lengths:[B] int32."""
    return gqa_decode_attention(q, k, v, lengths, block_s=block_s)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Block-table GQA decode. q:[B,H,hd], k/v_pool:[NB,BS,K,hd]."""
    return paged_gqa_decode_attention(q, k_pool, v_pool, block_table,
                                      lengths)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      block_q: int = 128, block_s: int = 128) -> torch.Tensor:
    """Tiled prefill attention. q:[B,Sq,H,hd], k/v:[B,Skv,K,hd]."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           block_q=block_q, block_s=block_s)
