"""Synthetic next-token data (counterpart of ``repro.training.data``).

A deterministic stream of numpy batches from a seed, the reference's
draws in the reference's order: tokens from a Zipf-flavoured unigram
distribution with next-token-shifted labels; for a config with
``embedding_inputs`` (the encoder), frame embeddings and a class label a
frame; for a VLM also image embeddings. The same seed gives the same
arrays as the reference.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


def synthetic_batches(cfg: ArchConfig, *, batch: int, seq: int,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        out: Dict[str, np.ndarray] = {}
        if cfg.embedding_inputs:
            out["embeds"] = rng.standard_normal(
                (batch, seq, cfg.d_model)).astype(np.float32) * 0.02
            out["labels"] = rng.integers(0, v, (batch, seq)).astype(np.int32)
        else:
            toks = rng.choice(v, size=(batch, seq + 1),
                              p=probs).astype(np.int32)
            out["tokens"] = toks[:, :-1]
            out["labels"] = toks[:, 1:].copy()
        if cfg.arch_type == "vlm":
            out["img_embeds"] = rng.standard_normal(
                (batch, cfg.n_img_tokens, cfg.d_model)).astype(
                    np.float32) * 0.02
        yield out
