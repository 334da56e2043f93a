"""Zero-copy view of the paged KV pool (counterpart of
``repro.kvcache.view``)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class PagedCacheView:
    """What :meth:`repro_torch.kvcache.paged.PagedKVCache.view` hands the
    model for a decode step instead of a gathered ``[B, S_pad, ...]`` copy.

    pool       ``{"k", "v"}``, each ``[L, NB+1, BS, K, hd]`` physical blocks
               (block ``NB`` is the trash block). The model writes the new
               token's rows into it in place.
    tables     ``[B, nb]`` int32 — physical block id per logical block;
               entries past a request's allocation name the trash block.
    lengths    ``[B]`` int32 — valid tokens per request *including* the
               token written this step; 0 marks a batch-padding row.
    positions  ``[B]`` int32 — write position of this step's new token
               (0 for padding rows, whose table row is all trash).
    block_size tokens per physical block.

    The dense family keeps no per-request dense state, so the reference's
    ``slots`` field has no counterpart here.
    """
    pool: Dict[str, torch.Tensor]
    tables: torch.Tensor
    lengths: torch.Tensor
    positions: torch.Tensor
    block_size: int
