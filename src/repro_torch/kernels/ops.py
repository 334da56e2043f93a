"""Dispatch for the model's attention kernels (counterpart of
``repro.kernels.ops``): a CUDA tensor launches the hand-written kernel, a
CPU tensor runs the kernel's plain PyTorch version."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.kernels.decode_attention import (decode_partials,
                                                  gqa_decode_attention)
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_prefix_attention)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_combine, paged_decode_partials, paged_gqa_decode_attention)


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
                      lengths: Optional[torch.Tensor] = None,
                      block_q: int = 128, block_s: int = 128) -> torch.Tensor:
    """Tiled prefill attention. q:[B,Sq,H,hd], k/v:[B,Skv,K,hd],
    lengths:[B] (optional: keys at or past it masked). Goes through
    :class:`FlashAttentionFn` on both devices: the kernel's (or plain
    version's) forward, differentiable."""
    return FlashAttentionFn.apply(q, k, v, causal, window, lengths, block_q,
                                  block_s)


def prefill_prefix_attention(q: torch.Tensor, k_all: torch.Tensor,
                             v_all: torch.Tensor, *, prefix_pad: int,
                             prefix_len: Union[int, torch.Tensor],
                             lengths: torch.Tensor,
                             window: Optional[int] = None) -> torch.Tensor:
    """Causal prefill over ``[prefix || suffix]`` keys with the model's
    masks. q:[B,S,H,hd], k/v_all:[B,prefix_pad+S,K,hd], lengths:[B],
    prefix_len an int or a 0-dim int32 tensor on the device."""
    return flash_prefix_attention(q, k_all, v_all, prefix_pad=prefix_pad,
                                  prefix_len=prefix_len, lengths=lengths,
                                  window=window)


def launch_counters() -> Dict[str, Callable]:
    """Each kernel's wrapper, by kernel name; its ``launches`` counts the
    launches made where the kernel runs (read from the kernel modules at
    call time)."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import paged_decode_attention as pg
    return {"paged_decode_attention": pg.paged_gqa_decode_attention,
            "paged_decode_partials": pg.paged_decode_partials,
            "paged_decode_combine": pg.paged_decode_combine,
            "flash_attention": fl.flash_attention,
            "flash_prefix_attention": fl.flash_prefix_attention,
            "decode_attention": dec.gqa_decode_attention,
            "decode_partials": dec.decode_partials}


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch count, by kernel name."""
    return {name: fn.launches for name, fn in launch_counters().items()}
