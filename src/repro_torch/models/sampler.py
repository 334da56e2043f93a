"""Token selection (counterpart of ``repro.models.sampler``).

Greedy rows (``temperature <= 0``) take the argmax of the float32 logits,
first index on ties, exactly as the reference. Sampled rows follow the
reference's ``_sample``: temperature, top-k with ties kept, a top-p cut
at ``top_p * cum[-1]``, then Gumbel-max with the counter-based key
``fold_in(PRNGKey(seed), position)``. That key and its Gumbel draw are
JAX's, reproduced bit for bit in torch integer ops: threefry2x32, the
partitionable random-bits scheme (``bits1 ^ bits2`` of threefry over a
2x32 counter, JAX's default since ``jax_threefry_partitionable``), and
the low-range Gumbel (``-log(-log(u))`` of a uniform in ``[tiny, 1)``).
The bits and the uniforms equal JAX's exactly; ``log`` may differ from
XLA's by an ULP, so the Gumbel values agree within 1e-6.

The draw runs on the logits' device and only the ``[B]`` ids come back.
The ``[B]`` keys are folded on the host in numpy (:func:`fold_keys`: a
few hundred operations on a handful of words, which on the card would
each be a launch). :func:`sample_tokens_device` is the draw on ``[B]``
vectors already on the device, with the greedy-or-sampled choice made by
the caller: it issues no host-to-device copy and reads nothing back, so
a CUDA graph can capture it (the reference's ``lax.cond`` on "any row
sampled" becomes that host decision, with the same tokens).
:func:`sample_tokens` is the entry for host vectors, which it uploads.
Torch has no ``<<`` on ``uint32`` on the CPU, so the 32-bit words are
held in ``int64`` and masked with ``0xFFFFFFFF``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1,
    x2)`` under the key ``(k1, k2)``; every argument holds 32-bit words
    in int64 (torch tensors, or numpy arrays for :func:`fold_keys`) and
    they broadcast together. JAX's ``threefry2x32_p``."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK32
    return x[0], x[1]


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of 32-bit seeds: ``[..., 2]`` words
    ``(0, seed)``."""
    seed = seed.long() & MASK32
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter ``(0, data)``
    under ``key`` (``[..., 2]``), ``data`` taken as uint32."""
    o1, o2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(key[..., 0]),
                          data.long() & MASK32)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` 32-bit words a key (``[..., 2]`` -> ``[..., n]``), JAX's
    partitionable scheme: ``bits1 ^ bits2`` of the hash of the 64-bit
    counter ``i`` split into its high and low words (``n < 2**32``, so
    the high word is 0)."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in ``[1, 2)``, less 1, scaled."""
    mant = (random_bits(key, n) >> 9) | 0x3F800000
    f = mant.to(torch.int32).view(torch.float32) - 1.0
    # float32 bounds as Python scalars: no host-to-device copy
    lo, hi = np.float32(minval), np.float32(maxval)
    return (f * float(hi - lo) + float(lo)).clamp_min(float(lo))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` in its default (low)
    range: ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, n, F32_TINY, 1.0)))


def fold_keys(seed, positions) -> np.ndarray:
    """``fold_in(PRNGKey(seed), position)`` of ``[B]`` host vectors, in
    numpy on the host: ``[B, 2]`` int64 words, equal to :func:`fold_in`'s
    (the same :func:`threefry2x32` on numpy ``int64``)."""
    seed = np.asarray(seed).astype(np.int64) & MASK32
    data = np.asarray(positions).astype(np.int64) & MASK32
    zero = np.zeros_like(seed)
    return np.stack(threefry2x32(zero, seed, np.zeros_like(data), data),
                    axis=-1)


def sample_tokens_device(logits: torch.Tensor, temperature: torch.Tensor,
                         top_k: torch.Tensor, top_p: torch.Tensor,
                         keys: torch.Tensor, sampled: bool) -> torch.Tensor:
    """One token per row from ``[B]`` vectors on the logits' device
    (``keys [B, 2]`` from :func:`fold_keys`). ``sampled`` is the host's
    choice: False when no row samples (one argmax), True otherwise
    (greedy rows, ``temperature <= 0``, still take the argmax). Returns
    ``[B]`` int32 token ids; nothing is copied to or from the host."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if not sampled:
        return greedy
    draw = _sample(logits, temperature, top_k.long(), top_p,
                   keys.long() & MASK32)
    return torch.where(temperature <= 0.0, greedy, draw)


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seed,
                  positions) -> torch.Tensor:
    """One token per row; every argument after ``logits`` is a ``[B]``
    host array (numpy, a list or a CPU tensor). ``positions[i]`` is the
    sequence position the token will occupy, the RNG counter. Returns
    ``[B]`` int32 token ids on the logits' device. An all-greedy batch is
    one argmax. The vectors go up in two copies and the draw is
    :func:`sample_tokens_device`'s."""
    temp = np.asarray(temperature, np.float32)
    if not (temp > 0).any():
        return sample_tokens_device(logits, None, None, None, None, False)
    ints = np.concatenate([np.asarray(top_k).astype(np.int64)[:, None],
                           fold_keys(seed, positions)], 1)
    floats = np.stack([temp, np.asarray(top_p, np.float32)])
    ints, floats = (torch.from_numpy(a).to(logits.device)
                    for a in (ints, floats))
    return sample_tokens_device(logits, floats[0], ints[:, 0], floats[1],
                                ints[:, 1:], True)


def _sample(logits, temperature, top_k, top_p, keys):
    """Categorical draw a row (greedy rows draw too and are overwritten
    by the caller), the reference's ``_sample`` step by step; ``keys``
    ``[B, 2]`` are each row's ``fold_in(PRNGKey(seed), position)``."""
    V = logits.shape[-1]
    x = logits.float() / temperature.clamp_min(1e-6)[:, None]
    # top-k: keep logits >= the k-th largest (ties survive; k <= 0 or
    # k >= V keeps all)
    desc = torch.sort(x, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k.clamp(1, V), V)
    kth = desc.gather(-1, (k - 1)[:, None])
    x = torch.where(x < kth, -torch.inf, x)
    # top-p over the k-truncated distribution, the cut against top_p
    # times the total mass (float32 cumsum can stop short of 1)
    probs = torch.softmax(x, dim=-1)
    psort = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(psort, dim=-1)
    cut = (cum >= top_p[:, None] * cum[:, -1:]).int().argmax(dim=-1)
    thr = psort.gather(-1, cut[:, None])
    thr = torch.where(top_p[:, None] >= 1.0, 0.0, thr)
    x = torch.where(probs < thr, -torch.inf, x)
    g = gumbel(keys, V)
    return (x + g).argmax(dim=-1).to(torch.int32)


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


__all__: List[str] = ["sample_tokens", "sample_tokens_device", "fold_keys",
                      "stack_sampling", "positions_array",
                      "threefry2x32", "prng_key", "fold_in", "random_bits",
                      "uniform", "gumbel"]
