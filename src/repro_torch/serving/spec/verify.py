"""The multi-token verify step (counterpart of ``repro.serving.spec.verify``).

One step verifies up to ``K_pad`` drafted tokens a request and samples one
correction or bonus token: ``K_pad + 1`` exact serial decode iterations,
each the same :meth:`~repro_torch.models.model.Model.decode_step` over a
:class:`~repro_torch.kvcache.view.PagedCacheView` and the same sampler the
plain paged step runs, with the acceptance gating of the reference's
``spec_verify_fn`` between them. Every accepted token is produced by the
same kernels at the same position with the same RNG counter as serial
decode at the same shapes.

Per iteration ``j`` (vectorised over the batch): feed ``tok`` at write
position ``pos`` (iteration 0: the request's next input token, exactly
the serial step); sample ``y`` with the counter ``pos + 1``; accept iff
the row is alive, a draft exists at ``j`` and ``y == drafts[:, j]``.
Accepted rows advance (``tok = draft``, ``pos += 1``, ``lens += 1``),
every other row freezes and re-runs its last iteration verbatim: the same
token at the same position writes the same K/V row to the same (block,
slot), whose address the model computes on the device from the staged
tables and the position, so the step never writes a garbage row and the
commit's rollback is a block-table truncation.

:func:`spec_verify_body` is a Python loop over device tensors with no
host read, no branch on a value and no allocation that depends on data,
so one CUDA graph captures it whole (:meth:`StepFunctions.verify
<repro_torch.serving.steps.StepFunctions.verify>`). The sampling keys of
the ``K_pad + 1`` counters a row may reach, ``pos0 + 1 .. pos0 + K_pad +
1``, are folded on the host into one ``[B, K_pad + 1, 2]`` block of the
step's packed upload, and iteration ``j`` gathers the key at offset
``pos - pos0``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kvcache.view import PagedCacheView
from repro_torch.models.sampler import fold_keys, sample_tokens_device


def spec_verify_body(model, pool, dev: Dict[str, torch.Tensor], K_pad: int,
                     sampled: bool) -> Tuple[torch.Tensor, ...]:
    """One verify step on the device fields ``dev`` of
    :func:`~repro_torch.kvcache.view.verify_fields` over the
    :class:`~repro_torch.kvcache.paged.PagedKVCache` ``pool``. ``drafts``
    is ``[B, K_pad]`` with each row's valid prefix ``draft_len`` (a row
    with ``draft_len == 0`` runs one plain decode iteration and freezes).
    Returns ``ys [B, K_pad + 1]`` int32, the sampled tokens, ``oks`` the
    acceptance mask (a True prefix a row), iteration 0's float32 logits
    ``[B, vocab]`` (the plain paged step's) and whether every
    iteration's logits were finite (a 0-dim bool). Padding rows (length
    0) start dead; their writes land in the trash block."""
    tables, drafts, draft_len = dev["tables"], dev["drafts"], dev["draft_len"]
    tok, pos, lens = dev["tokens"], dev["positions"], dev["lengths"]
    pos0 = pos
    alive = lens > 0
    ys: List[torch.Tensor] = []
    oks: List[torch.Tensor] = []
    first, finite = None, None
    for j in range(K_pad + 1):
        view = PagedCacheView(pool.pool, tables, lens, pos, pool.block_size)
        logits = model.decode_step(tok, view)
        fin = torch.isfinite(logits).all()
        finite = fin if finite is None else finite & fin
        key = None
        if sampled:
            key = dev["key_block"].gather(
                1, (pos - pos0).long()[:, None, None].expand(-1, 1, 2))[:, 0]
        y = sample_tokens_device(logits, dev["temperature"], dev["top_k"],
                                 dev["top_p"], key, sampled)
        d = drafts[:, min(j, K_pad - 1)]
        ok = alive & (draft_len > j) & (y == d)
        tok = torch.where(ok, d, tok)
        pos = torch.where(ok, pos + 1, pos)
        lens = torch.where(ok, lens + 1, lens)
        alive = ok
        ys.append(y)
        oks.append(ok)
        if first is None:
            first = logits
    return torch.stack(ys, 1), torch.stack(oks, 1), first, finite


def verify_keys(seed: np.ndarray, positions: np.ndarray,
                K_pad: int) -> np.ndarray:
    """The key block of a verify step: ``[B, K_pad + 1, 2]`` words, at
    offset ``o`` the key ``fold_in(PRNGKey(seed), positions + 1 + o)``
    (:func:`~repro_torch.models.sampler.fold_keys`)."""
    pos = np.asarray(positions, np.int64)[:, None] + 1 + np.arange(K_pad + 1)
    seed = np.broadcast_to(np.asarray(seed, np.int64)[:, None], pos.shape)
    return fold_keys(seed, pos)


def stack_drafts(drafts: Sequence[np.ndarray], batch_pad: int,
                 k_pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-row draft arrays into the padded ``[batch_pad, k_pad]``
    matrix and ``[batch_pad]`` valid-length vector the verify step
    consumes (padding rows and pad columns are zeros with length 0)."""
    mat = np.zeros((batch_pad, k_pad), np.int32)
    lens = np.zeros((batch_pad,), np.int32)
    for i, d in enumerate(drafts):
        k = min(len(d), k_pad)
        mat[i, :k] = d[:k]
        lens[i] = k
    return mat, lens


def accepted_prefix(oks_row: np.ndarray, draft_len: int) -> int:
    """Length of the accepted draft prefix of one row (host-side commit
    helper): ``oks`` is a True prefix by construction, but walk it so a
    malformed mask cannot over-commit."""
    n = 0
    for j in range(draft_len):
        if not oks_row[j]:
            break
        n += 1
    return n


__all__: List[str] = ["spec_verify_body", "verify_keys", "stack_drafts",
                      "accepted_prefix"]
