"""Token selection (counterpart of ``repro.models.sampler``).

Greedy rows (``temperature <= 0``) take the argmax of the float32 logits,
first index on ties, exactly as the reference. Sampled rows need the
reference's counter-based RNG (``fold_in(PRNGKey(seed), position)`` and
its Gumbel draw) reproduced bit for bit, which is a later slice
(ROADMAP.md); until then they raise.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seed,
                  positions) -> torch.Tensor:
    """One token per row; every argument after ``logits`` is ``[B]``.
    Returns ``[B]`` int32 token ids on the logits' device."""
    if bool(torch.as_tensor(temperature).gt(0).any()):
        raise NotImplementedError(
            "sampled decoding (temperature > 0) needs the reference's "
            "threefry RNG in torch (ROADMAP.md, next slices: bit-exact "
            "sampled decoding)")
    return logits.argmax(dim=-1).to(torch.int32)


def stack_sampling(samplings: Sequence, pad_to: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
    """Stack per-request ``SamplingParams`` into the ``[B]`` vectors
    :func:`sample_tokens` consumes. Padding rows are greedy with seed 0."""
    n = pad_to if pad_to is not None else len(samplings)
    temp = np.zeros((n,), np.float32)
    top_k = np.zeros((n,), np.int32)
    top_p = np.ones((n,), np.float32)
    seed = np.zeros((n,), np.uint32)
    for i, sp in enumerate(samplings):
        temp[i] = sp.temperature
        top_k[i] = sp.top_k
        top_p[i] = sp.top_p
        seed[i] = np.uint32(sp.seed)
    return temp, top_k, top_p, seed


def positions_array(positions: Sequence[int],
                    pad_to: Optional[int] = None) -> np.ndarray:
    """RNG-counter vector (``positions`` of :func:`sample_tokens`)."""
    n = pad_to if pad_to is not None else len(positions)
    pos = np.zeros((n,), np.int32)
    pos[:len(positions)] = np.asarray(list(positions), np.int32)
    return pos


__all__: List[str] = ["sample_tokens", "stack_sampling", "positions_array"]
