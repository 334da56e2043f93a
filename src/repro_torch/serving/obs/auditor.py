"""Memory-gap auditor: attribute every KV pool byte, every step (a copy
of ``repro.serving.obs.auditor`` over the port's engine and pool).

The paper's central observation is that large-batch decode stays
DRAM-bandwidth-bound while GPU memory is systematically *over-allocated*
— capacity is sized for the worst case and most of it never holds live
state. This module measures that gap at runtime by partitioning the
physical pool each engine step into an **exact** byte accounting:

* **used** — KV rows actually written (true use: the only bytes decode
  must stream),
* **block pad** — allocated-but-unwritten rows inside live block tables
  (block-granular allocation rounds every request up),
* **prefix held** — blocks only the prefix cache references (warm
  capacity, reclaimable under pressure),
* **free** — the free list, watermark reserve included.

``used + block_pad + prefix_held + free == pool_bytes`` holds exactly
(the tested invariant): every physical block is free, cache-only, or in
at least one request's table, and shared blocks are counted once.

Two further terms are *overlays* on top of the physical partition, not
part of it:

* **reserved unused** — the S³ memory gap (arXiv 2306.06000): the blocks
  a worst-case scheduler must assume each live request may still grow
  into (``prompt_len + max_new_tokens`` sizing) minus what it has
  actually allocated. This engine allocates lazily, so the commitment is
  virtual — but it is exactly the capacity admission control cannot hand
  to anyone else, and the dominant waste term under generous
  ``max_new_tokens``.
* **bucket pad** — trash-block entries in the captured step's padded
  ``[batch_pad, nb_pad]`` block table (power-of-two bucketing keeps the
  graph count small at the cost of padded shapes). A bandwidth/shape
  overhead, not pool memory.

:class:`MemoryGapAuditor` keeps the per-step :class:`WasteBreakdown`
series (bounded, decimating) plus peaks, and its :meth:`report` is the
end-of-run "memory gap report". The byte partition is integer-equal to
the reference's on the same workload (the port's ``pool_bytes`` and
``block_bytes`` are the reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.serving.obs.series import (DEFAULT_SERIES_MAXLEN,
                                            BoundedSeries)

# the physical partition, in report/series order
PHYSICAL_TERMS = ("used", "block_pad", "prefix_held", "free")
# overlays: commitments/shape overheads, not pool bytes
OVERLAY_TERMS = ("reserved_unused", "bucket_pad")
WASTE_TERMS = PHYSICAL_TERMS[1:-1] + OVERLAY_TERMS


@dataclasses.dataclass(frozen=True)
class WasteBreakdown:
    """One step's pool-byte attribution (all byte counts exact ints)."""
    step: int
    pool_bytes: int
    used_bytes: int
    block_pad_bytes: int
    prefix_held_bytes: int
    free_bytes: int
    watermark_bytes: int            # informational subset of free_bytes
    reserved_unused_bytes: int      # overlay (virtual commitment)
    bucket_pad_bytes: int           # overlay (bucket shape padding)
    used_tokens: int
    n_running: int
    n_prefilling: int

    @property
    def physical_bytes(self) -> int:
        """Sum of the physical partition — equals ``pool_bytes`` exactly
        (the accounting invariant the tests pin)."""
        return (self.used_bytes + self.block_pad_bytes
                + self.prefix_held_bytes + self.free_bytes)

    @property
    def gap_bytes(self) -> int:
        """The memory gap: pool capacity not holding live KV rows."""
        return self.pool_bytes - self.used_bytes

    def value(self, term: str) -> int:
        return getattr(self, f"{term}_bytes")


@dataclasses.dataclass
class MemoryGapStats:
    """Run-level memory-gap summary (rides on ``ServingMetrics``)."""
    pool_bytes: int = 0
    steps_audited: int = 0
    used_bytes_mean: float = 0.0
    block_pad_bytes_mean: float = 0.0
    prefix_held_bytes_mean: float = 0.0
    free_bytes_mean: float = 0.0
    reserved_unused_bytes_mean: float = 0.0
    bucket_pad_bytes_mean: float = 0.0
    peak_used_bytes: int = 0
    peak_used_step: int = 0
    peak_used_tokens_per_req: float = 0.0
    peak_reserved_unused_bytes: int = 0
    # mean fraction of the pool holding live KV rows / committed virtually
    used_fraction_mean: float = 0.0
    gap_fraction_mean: float = 0.0
    worst_term: str = ""            # largest mean waste term (pinpointed)

    def row(self) -> str:
        mb = 1.0 / 2**20
        return (f"pool={self.pool_bytes * mb:.1f}MiB "
                f"used={self.used_bytes_mean * mb:.1f} "
                f"resv_unused={self.reserved_unused_bytes_mean * mb:.1f} "
                f"blk_pad={self.block_pad_bytes_mean * mb:.1f} "
                f"pfx_held={self.prefix_held_bytes_mean * mb:.1f} "
                f"gap={self.gap_fraction_mean * 100:.1f}% "
                f"worst={self.worst_term}")


def committed_tokens(prompt_len: int, limit: int) -> int:
    """Worst-case KV token footprint a request can grow to: the prompt
    plus its output budget's written rows. The engine writes a token's
    KV when it is the *input* of a step, so the final generated token's
    row is never written — ``limit - 1`` decode rows past the prompt —
    but admission reserves ``prompt_len + 1``, whichever is larger."""
    return prompt_len + max(1, limit - 1)


def audit_engine(eng, *, n_decode: Optional[int] = None) -> WasteBreakdown:
    """One exact pool-byte attribution for an engine's current state.

    Pure read of engine/allocator state (no mutation, no device work):
    written-token counts come from the scheduler's own bookkeeping
    (``_pos`` for decoding, ``_prefilled`` for streaming prompts),
    block ownership from the :class:`~repro_torch.kvcache.paged.BlockManager`
    tables, and cache-held blocks from the prefix index. Shared blocks
    (prefix splices) are attributed once, at the deepest written
    overlap among their owners.
    """
    pool = eng.pool
    mgr = pool.manager
    bs = mgr.block_size
    bb = pool.block_bytes

    written: Dict[int, int] = {}
    for r in eng.running:
        written[r.req_id] = eng._pos.get(r.req_id, 0)
    for r in eng.prefilling:
        written[r.req_id] = eng._prefilled.get(r.req_id, 0)

    # tokens written per *physical* block: max overlap across owners
    # (shared prefix blocks hold identical rows — count them once)
    tok: Dict[int, int] = {}
    for rid, table in mgr.tables.items():
        w = written.get(rid, 0)
        for j, blk in enumerate(table):
            t = min(bs, max(0, w - j * bs))
            if t > tok.get(blk, -1):
                tok[blk] = t
    used_tokens = sum(tok.values())
    used_bytes = used_tokens * bb // bs
    block_pad_bytes = len(tok) * bb - used_bytes

    held = len(eng.prefix.held_blocks()) if eng.prefix is not None else 0

    # the S³ overlay: worst-case commitment minus actual allocation
    reserved_blocks = 0
    for r in list(eng.running) + list(eng.prefilling):
        commit = mgr.blocks_needed(
            committed_tokens(r.prompt_len, eng._limit(r)))
        have = len(mgr.tables.get(r.req_id, ()))
        reserved_blocks += max(0, commit - have)

    # bucketing overlay: trash entries in this step's padded table
    # (the engine stashes the bucket facts when an observer is attached)
    bucket_pad = 0
    lb = getattr(eng, "_last_buckets", None)
    if n_decode and lb is not None:
        batch_pad, nb_pad, live_entries = lb
        bucket_pad = max(0, batch_pad * nb_pad - live_entries) * bb

    return WasteBreakdown(
        step=eng.step_count,
        pool_bytes=pool.pool_bytes,
        used_bytes=used_bytes,
        block_pad_bytes=block_pad_bytes,
        prefix_held_bytes=held * bb,
        free_bytes=mgr.free_blocks * bb,
        watermark_bytes=mgr.watermark_blocks * bb,
        reserved_unused_bytes=reserved_blocks * bb,
        bucket_pad_bytes=bucket_pad,
        used_tokens=used_tokens,
        n_running=len(eng.running),
        n_prefilling=len(eng.prefilling))


class MemoryGapAuditor:
    """Per-replica per-step waste attribution with bounded history.

    ``on_step`` is called from the observer's ``end_step`` (so a
    detached engine pays nothing); the per-step cost is a host-side walk
    of the live block tables — O(allocated blocks), no device work.
    """

    def __init__(self, series_maxlen: int = DEFAULT_SERIES_MAXLEN):
        self.steps: BoundedSeries = BoundedSeries(series_maxlen)
        self.audits = 0
        self.pool_bytes = 0
        # running sums for exact means (the series may decimate)
        self._sums: Dict[str, float] = {t: 0.0 for t in
                                        PHYSICAL_TERMS + OVERLAY_TERMS}
        self.peak_used_bytes = 0
        self.peak_used_step = 0
        self.peak_used_tokens = 0
        self.peak_used_live = 0      # live requests at the used peak
        self.peak_reserved_unused_bytes = 0

    def on_step(self, eng, *, n_decode: int = 0) -> WasteBreakdown:
        wb = audit_engine(eng, n_decode=n_decode)
        self.steps.append(wb)
        self.audits += 1
        self.pool_bytes = wb.pool_bytes
        for t in PHYSICAL_TERMS + OVERLAY_TERMS:
            self._sums[t] += wb.value(t)
        if wb.used_bytes > self.peak_used_bytes:
            self.peak_used_bytes = wb.used_bytes
            self.peak_used_step = wb.step
            self.peak_used_tokens = wb.used_tokens
            self.peak_used_live = wb.n_running + wb.n_prefilling
        self.peak_reserved_unused_bytes = max(
            self.peak_reserved_unused_bytes, wb.reserved_unused_bytes)
        return wb

    def mean(self, term: str) -> float:
        return self._sums[term] / self.audits if self.audits else 0.0

    @property
    def peak_used_tokens_per_req(self) -> float:
        """Observed peak true-use context per live request — the number
        to hold against the context an offline batch sizing assumed."""
        return self.peak_used_tokens / max(self.peak_used_live, 1)

    def stats(self) -> MemoryGapStats:
        pool = max(self.pool_bytes, 1)
        waste_means = {t: self.mean(t) for t in WASTE_TERMS}
        worst = max(waste_means, key=waste_means.get) if self.audits else ""
        return MemoryGapStats(
            pool_bytes=self.pool_bytes,
            steps_audited=self.audits,
            used_bytes_mean=self.mean("used"),
            block_pad_bytes_mean=self.mean("block_pad"),
            prefix_held_bytes_mean=self.mean("prefix_held"),
            free_bytes_mean=self.mean("free"),
            reserved_unused_bytes_mean=self.mean("reserved_unused"),
            bucket_pad_bytes_mean=self.mean("bucket_pad"),
            peak_used_bytes=self.peak_used_bytes,
            peak_used_step=self.peak_used_step,
            peak_used_tokens_per_req=self.peak_used_tokens_per_req,
            peak_reserved_unused_bytes=self.peak_reserved_unused_bytes,
            used_fraction_mean=self.mean("used") / pool,
            gap_fraction_mean=1.0 - self.mean("used") / pool,
            worst_term=worst)

    def report(self) -> dict:
        """The end-of-run memory gap report (JSON-friendly)."""
        s = self.stats()
        return {
            "pool_bytes": s.pool_bytes,
            "steps_audited": s.steps_audited,
            "mean_bytes": {t: self.mean(t)
                           for t in PHYSICAL_TERMS + OVERLAY_TERMS},
            "peak_used_bytes": s.peak_used_bytes,
            "peak_used_step": s.peak_used_step,
            "peak_used_tokens_per_req": s.peak_used_tokens_per_req,
            "peak_reserved_unused_bytes": s.peak_reserved_unused_bytes,
            "used_fraction_mean": s.used_fraction_mean,
            "gap_fraction_mean": s.gap_fraction_mean,
            "worst_term": s.worst_term,
        }
