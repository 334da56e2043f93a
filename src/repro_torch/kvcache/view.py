"""Zero-copy view of the paged KV pool (counterpart of
``repro.kvcache.view``), and the packed layouts of a decode step's, a
verify step's and a prefill's inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

# a decode step's [B] input vectors, after its [B, nb] block table, in one
# packed int32 buffer; the float fields hold float32 bits
STEP_VECTORS = ("lengths", "positions", "slots", "tokens", "use_prev",
                "prev_rows", "top_k", "temperature", "top_p")
_FLOAT_FIELDS = ("temperature", "top_p")

Buffer = Union[np.ndarray, torch.Tensor]


def step_size(batch_pad: int, nb_pad: int) -> int:
    """int32 words of one step's packed inputs (:func:`step_fields`)."""
    return batch_pad * (nb_pad + len(STEP_VECTORS) + 2)


def step_fields(buf: Buffer, batch_pad: int,
                nb_pad: int) -> Dict[str, Buffer]:
    """Views of a decode step's inputs packed in the 1-D int32 ``buf``
    (numpy on the host, a tensor on the device; at least
    :func:`step_size` words), the same layout on both sides, so that one
    copy moves a step's inputs up: ``tables [batch_pad, nb_pad]``, then
    each of :data:`STEP_VECTORS` ``[batch_pad]`` (``temperature`` and
    ``top_p`` as float32), then ``keys [batch_pad, 2]`` (32-bit words,
    :func:`~repro_torch.models.sampler.fold_keys`)."""
    f32 = np.float32 if isinstance(buf, np.ndarray) else torch.float32
    n_tab = batch_pad * nb_pad
    out: Dict[str, Buffer] = {
        "tables": buf[:n_tab].reshape(batch_pad, nb_pad)}
    at = n_tab
    for name in STEP_VECTORS:
        v = buf[at:at + batch_pad]
        out[name] = v.view(f32) if name in _FLOAT_FIELDS else v
        at += batch_pad
    out["keys"] = buf[at:at + 2 * batch_pad].reshape(batch_pad, 2)
    return out


def verify_size(batch_pad: int, nb_pad: int, K_pad: int) -> int:
    """int32 words of one verify step's packed inputs
    (:func:`verify_fields`)."""
    return step_size(batch_pad, nb_pad) + batch_pad * (3 * K_pad + 3)


def verify_fields(buf: Buffer, batch_pad: int, nb_pad: int,
                  K_pad: int) -> Dict[str, Buffer]:
    """Views of a speculative verify step's inputs packed in the 1-D int32
    ``buf``, the same layout on the host and the device: the paged step's
    fields (:func:`step_fields`), then ``drafts [batch_pad, K_pad]``,
    ``draft_len [batch_pad]`` and ``key_block [batch_pad, K_pad + 1, 2]``,
    the sampling key of each counter a row may reach in the step
    (:func:`~repro_torch.serving.spec.verify.verify_keys`)."""
    out = step_fields(buf, batch_pad, nb_pad)
    at = step_size(batch_pad, nb_pad)
    out["drafts"] = buf[at:at + batch_pad * K_pad].reshape(batch_pad, K_pad)
    at += batch_pad * K_pad
    out["draft_len"] = buf[at:at + batch_pad]
    at += batch_pad
    out["key_block"] = buf[at:at + batch_pad * (K_pad + 1) * 2].reshape(
        batch_pad, K_pad + 1, 2)
    return out


def prefill_size(S: int, nb_pad: int) -> int:
    """int32 words of one prefill's packed inputs (:func:`prefill_fields`)."""
    return 3 * S + nb_pad + 3


def prefill_fields(buf: Buffer, S: int, nb_pad: int) -> Dict[str, Buffer]:
    """Views of one prefill's inputs (batch 1, ``S`` rows in its bucket)
    packed in the 1-D int32 ``buf``, the same layout on the host and the
    device: ``tokens [1, S]``; ``n [1]``, the valid rows; ``prefix_len``
    (0-dim), the prompt position of row 0 and the prefix's valid length;
    ``table [nb_pad]``, the prefix's blocks then the trash block; and
    ``blocks [S]``, ``slots [S]``, the (block, slot) each row's K/V is
    written to, padding rows' in the trash block; ``state_slot [1]``,
    the dense-state slot the prompt's final SSM state and its image K/V
    are written to."""
    out: Dict[str, Buffer] = {"tokens": buf[:S].reshape(1, S),
                              "n": buf[S:S + 1],
                              "prefix_len": buf[S + 1:S + 2].reshape(())}
    at = S + 2
    out["table"] = buf[at:at + nb_pad]
    at += nb_pad
    out["blocks"] = buf[at:at + S]
    out["slots"] = buf[at + S:at + 2 * S]
    out["state_slot"] = buf[at + 2 * S:at + 2 * S + 1]
    return out


@dataclasses.dataclass
class PagedCacheView:
    """What :meth:`repro_torch.kvcache.paged.PagedKVCache.view` hands the
    model for a decode step instead of a gathered ``[B, S_pad, ...]`` copy.

    pool       ``{"k", "v"}``, each ``[n_kv, NB+1, BS, K, hd]`` physical
               blocks (block ``NB`` is the trash block), and the
               dense-state slots (slot ``max_batch`` is the trash slot):
               for SSM layers ``{"h", "conv"}``, each ``[n_ssm,
               max_batch+1, ...]``, for ``CROSS`` layers the image K/V
               ``{"xk", "xv"}``, each ``[n_cross, max_batch+1, n_img, K,
               hd]``. The model writes the new token's rows and the new
               SSM state into it in place; the image K/V it only reads.
    tables     ``[B, nb]`` int32 — physical block id per logical block;
               entries past a request's allocation name the trash block.
    lengths    ``[B]`` int32 — valid tokens per request *including* the
               token written this step; 0 marks a batch-padding row.
    positions  ``[B]`` int32 — write position of this step's new token
               (0 for padding rows, whose table row is all trash).
    block_size tokens per physical block.
    slots      ``[B]`` int32 — dense-state slot per request (the trash
               slot for padding rows), staged for an SSM, hybrid or VLM
               plan alike; None where the pool holds no state.
    seq_lengths ``[B]`` int32 — over a KV sequence sharded on the model
               axis, the rows of each request this rank holds (the
               model computes them from ``lengths`` once a step); None
               otherwise.
    """
    pool: Dict[str, torch.Tensor]
    tables: torch.Tensor
    lengths: torch.Tensor
    positions: torch.Tensor
    block_size: int
    slots: Optional[torch.Tensor] = None
    seq_lengths: Optional[torch.Tensor] = None
