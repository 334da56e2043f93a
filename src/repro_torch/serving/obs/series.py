"""Bounded per-step telemetry series (a copy of
``repro.serving.obs.series``).

Every per-step series the engine keeps (ITL, KV occupancy, stall,
prefill/decode token counts, preemptions, and the observability layer's
phase/roofline samples) grows by one element per engine step. A soak run
at ~1 kHz of steps would grow host memory without limit; the serving
layer therefore stores them in :class:`BoundedSeries`, a ``list``
subclass with a hard length bound.

The bound is enforced by *decimation*, not a ring buffer: when the
series reaches ``maxlen`` it drops every other element in place and
doubles its append stride, so the retained samples always cover the
**whole** run at uniform spacing (a ring buffer would keep only the
recent tail, which is useless for "when did the pool start thrashing"
questions). Aggregates over the series (mean, percentiles) become
uniform subsamples of the true per-step population — statistically
consistent, just lower-resolution — while ``appended`` keeps the true
event count.

Being a real ``list`` keeps every existing consumer working unchanged:
slicing (``series[-32:]``), ``sum``/``np.mean``/``np.percentile``,
iteration, and ``list(series)`` snapshots.
"""
from __future__ import annotations

DEFAULT_SERIES_MAXLEN = 16384


class BoundedSeries(list):
    """A ``list`` that decimates itself instead of growing past ``maxlen``.

    ``append`` keeps one sample per ``stride`` calls; when the kept
    samples would exceed ``maxlen`` the series halves itself (every
    other element) and the stride doubles. ``appended`` counts every
    append ever made — the true series length — and ``stride`` tells a
    reader the current sampling period.
    """

    # a list subclass with __slots__ still carries the list header only
    __slots__ = ("maxlen", "stride", "appended", "_skip")

    def __init__(self, maxlen: int = DEFAULT_SERIES_MAXLEN, iterable=()):
        # maxlen=1 is the degenerate bound: the series keeps exactly one
        # sample (the run's first kept element at the current stride) and
        # decimation degenerates to stride doubling
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        super().__init__(iterable)
        self.maxlen = int(maxlen)
        self.stride = 1
        self.appended = len(self)
        self._skip = 0
        while len(self) > self.maxlen:
            self._decimate()

    def _decimate(self):
        # keep even indices (the oldest sample survives every halving,
        # so the series always anchors at the start of the run)
        self[:] = self[::2]
        self.stride *= 2

    def append(self, x):
        self.appended += 1
        if self._skip + 1 < self.stride:
            self._skip += 1
            return
        self._skip = 0
        if len(self) >= self.maxlen:
            self._decimate()
        if len(self) >= self.maxlen:
            # only reachable at maxlen=1: decimating [x0] keeps x0 (the
            # run anchor) and the incoming sample lands on a now-dropped
            # odd stride multiple — discard it, the stride has doubled
            return
        super().append(x)

    def extend(self, xs):
        for x in xs:
            self.append(x)

    def fresh(self) -> "BoundedSeries":
        """An empty series with the same bound (reset_stats helper)."""
        return BoundedSeries(self.maxlen)

    def __repr__(self):
        return (f"BoundedSeries(maxlen={self.maxlen}, stride={self.stride}, "
                f"appended={self.appended}, kept={len(self)})")
