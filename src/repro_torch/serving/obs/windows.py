"""Windowed telemetry aggregation and multi-window SLO burn-rate alerts
(a copy of ``repro.serving.obs.windows``).

The per-step :class:`~repro_torch.serving.obs.series.BoundedSeries` answer
"what happened over the whole run"; an operator watching a live fleet
needs the complementary view — "what is happening *right now*", at a
chosen horizon. :class:`WindowAggregator` folds timestamped sample
streams (step latencies, TTFT/ITL/e2e per request, KV occupancy, waste
terms, deadline-miss indicators) into **sliding** windows (rates, means,
percentiles over the trailing span) and **tumbling** windows
(consecutive non-overlapping spans for trend tables), pruning retained
samples past a horizon so memory stays bounded regardless of run length.

:class:`SLOMonitor` evaluates service-level objectives over those
windows using the multi-window **burn-rate** method (Google SRE
workbook, ch. 5): an SLO "95% of ITL samples under 50 ms" carries an
error budget of 5%; the burn rate of a window is

    ``burn = violating_fraction(window) / (1 - target)``

i.e. how many times faster than budget the window is consuming
violations. A **breach** fires when *both* a fast window (seconds — is
it happening now?) and a slow window (a minute — is it sustained, not a
blip?) burn above the threshold; **recovery** fires when both fall back
under. Events are emitted as Chrome-trace instants through the existing
:class:`~repro_torch.serving.obs.trace.Tracer` and counted for the metrics
registry, so breaches line up on the same timeline as engine steps.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

# stream names the observer feeds when windows are enabled
STREAM_ITL = "itl_s"                  # per-decode-step latency (seconds)
STREAM_TTFT = "ttft_s"                # per-request time to first token
STREAM_E2E = "e2e_s"                  # per-request end-to-end latency
STREAM_KV = "kv_used_fraction"        # pool occupancy at step end
STREAM_BATCH = "decode_batch"         # decode batch size per step
STREAM_TOKENS = "tokens"              # tokens produced per step (for rate)
STREAM_DEADLINE = "deadline_miss"     # 1.0 on deadline expiry, else 0.0
STREAM_WASTE_USED = "kv_used_bytes"
STREAM_WASTE_RESERVED = "kv_reserved_unused_bytes"


@dataclasses.dataclass(frozen=True)
class WindowStat:
    """Aggregates of one stream over one ``[t0, t1]`` window."""
    stream: str
    t0: float
    t1: float
    count: int
    mean: float
    total: float
    p50: float
    p95: float
    p99: float
    vmax: float
    rate: float           # samples per second over the span

    @classmethod
    def empty(cls, stream: str, t0: float, t1: float) -> "WindowStat":
        return cls(stream, t0, t1, 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    def row(self) -> str:
        if not self.count:
            return f"{self.stream}: (no samples)"
        return (f"{self.stream}: n={self.count} mean={self.mean:.4g} "
                f"p50={self.p50:.4g} p95={self.p95:.4g} "
                f"p99={self.p99:.4g} rate={self.rate:.3g}/s")


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank-with-interpolation percentile (numpy 'linear'),
    stdlib-only so the windows layer imports nothing heavy."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    if n == 1:
        return float(sorted_vals[0])
    pos = q / 100.0 * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac)


def aggregate(stream: str, samples: Sequence[Tuple[float, float]],
              t0: float, t1: float) -> WindowStat:
    """Fold ``(t, value)`` samples with ``t0 < t <= t1`` into a stat."""
    vals = sorted(v for t, v in samples if t0 < t <= t1)
    span = max(t1 - t0, 1e-12)
    if not vals:
        return WindowStat.empty(stream, t0, t1)
    return WindowStat(
        stream=stream, t0=t0, t1=t1, count=len(vals),
        mean=sum(vals) / len(vals), total=sum(vals),
        p50=_percentile(vals, 50), p95=_percentile(vals, 95),
        p99=_percentile(vals, 99), vmax=float(vals[-1]),
        rate=len(vals) / span)


class WindowAggregator:
    """Named timestamped sample streams with bounded retention.

    ``push`` is O(1) amortized (append plus horizon pruning from the
    left); ``window``/``tumbling``/``violation_fraction`` scan only the
    retained samples. Timestamps just need to share one monotonic clock
    — the tracer's, the serving clock's, whatever the caller feeds —
    and be non-decreasing per stream (the pruning assumes it).
    """

    def __init__(self, *, horizon_s: float = 300.0,
                 max_samples: int = 65536):
        self.horizon_s = float(horizon_s)
        self.max_samples = int(max_samples)
        self._streams: Dict[str, Deque[Tuple[float, float]]] = {}
        self.pushed = 0

    def push(self, stream: str, t: float, value: float = 1.0):
        buf = self._streams.get(stream)
        if buf is None:
            buf = self._streams[stream] = deque(maxlen=self.max_samples)
        buf.append((t, value))
        self.pushed += 1
        cutoff = t - self.horizon_s
        while buf and buf[0][0] < cutoff:
            buf.popleft()

    def push_series(self, stream: str, series, *, t0: float = 0.0,
                    dt: float = 1.0):
        """Fold a :class:`BoundedSeries` in: sample ``i`` is stamped
        ``t0 + i * stride * dt`` (decimation-aware — a decimated series
        keeps every ``stride``-th step, so retained sample ``i`` sits
        ``i * stride`` steps into the run)."""
        stride = getattr(series, "stride", 1)
        for i, v in enumerate(series):
            self.push(stream, t0 + i * stride * dt, float(v))

    def streams(self) -> List[str]:
        return sorted(self._streams)

    def samples(self, stream: str) -> List[Tuple[float, float]]:
        return list(self._streams.get(stream, ()))

    def latest(self, stream: str) -> Optional[Tuple[float, float]]:
        buf = self._streams.get(stream)
        return buf[-1] if buf else None

    def window(self, stream: str, *, t_now: float,
               span_s: float) -> WindowStat:
        """Sliding window: aggregates over ``(t_now - span_s, t_now]``."""
        buf = self._streams.get(stream, ())
        return aggregate(stream, buf, t_now - span_s, t_now)

    def tumbling(self, stream: str, *, span_s: float,
                 t_end: Optional[float] = None) -> List[WindowStat]:
        """Consecutive non-overlapping spans over retained samples."""
        buf = self._streams.get(stream)
        if not buf:
            return []
        t_end = buf[-1][0] if t_end is None else t_end
        t_start = buf[0][0]
        out: List[WindowStat] = []
        # align window edges to span multiples so repeated calls tile
        # identically as new samples arrive
        k0 = int(t_start // span_s)
        k1 = int(t_end // span_s)
        for k in range(k0, k1 + 1):
            out.append(aggregate(stream, buf, k * span_s, (k + 1) * span_s))
        return out

    def violation_fraction(self, stream: str, *, t_now: float,
                           span_s: float,
                           threshold: float) -> Optional[float]:
        """Fraction of windowed samples strictly over ``threshold``;
        ``None`` when the window holds no samples (distinct from 0.0 —
        an idle system is not a healthy-by-measurement system)."""
        buf = self._streams.get(stream, ())
        t0 = t_now - span_s
        n = bad = 0
        for t, v in buf:
            if t0 < t <= t_now:
                n += 1
                if v > threshold:
                    bad += 1
        return bad / n if n else None


# ---------------------------------------------------------------- SLOs ----

@dataclasses.dataclass(frozen=True)
class SLO:
    """One objective: ``target`` fraction of ``stream`` samples must be
    at or under ``threshold``. Indicator streams (deadline misses) work
    unchanged with ``threshold=0.5``: a pushed 1.0 violates, 0.0 meets.
    """
    name: str
    stream: str
    threshold: float
    target: float = 0.95
    fast_window_s: float = 2.0
    slow_window_s: float = 30.0
    burn_threshold: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0,1), got {self.target}")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast window must not exceed slow window")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


@dataclasses.dataclass(frozen=True)
class SLOEvent:
    t: float
    slo: str
    kind: str             # "breach" | "recover"
    burn_fast: float
    burn_slow: float

    def row(self) -> str:
        return (f"[{self.t:9.3f}s] {self.kind.upper():7s} {self.slo} "
                f"(burn fast={self.burn_fast:.1f}x slow="
                f"{self.burn_slow:.1f}x)")


class SLOMonitor:
    """Multi-window burn-rate evaluation with breach/recovery hysteresis.

    ``evaluate(t_now)`` computes each SLO's fast- and slow-window burn
    rates; a breach fires when both exceed ``burn_threshold`` (fast
    alone is a blip, slow alone is stale history), recovery when both
    drop back to or under it. Windows with no samples contribute burn 0
    — silence neither trips nor clears an alert on its own. Events are
    traced as instants and kept in ``events`` for the end-of-run report.
    """

    def __init__(self, slos: Sequence[SLO], windows: WindowAggregator, *,
                 tracer=None, pid: int = 0):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos = list(slos)
        self.windows = windows
        self.tracer = tracer
        self.pid = pid
        self.breached: Dict[str, bool] = {s.name: False for s in slos}
        self.events: List[SLOEvent] = []
        self.breaches = 0
        self.recoveries = 0
        self.evaluations = 0

    def burn_rates(self, slo: SLO, t_now: float) -> Tuple[float, float]:
        out = []
        for span in (slo.fast_window_s, slo.slow_window_s):
            frac = self.windows.violation_fraction(
                slo.stream, t_now=t_now, span_s=span,
                threshold=slo.threshold)
            out.append(0.0 if frac is None else frac / slo.budget)
        return out[0], out[1]

    def evaluate(self, t_now: float) -> List[SLOEvent]:
        self.evaluations += 1
        fired: List[SLOEvent] = []
        for slo in self.slos:
            bf, bs = self.burn_rates(slo, t_now)
            hot = bf > slo.burn_threshold and bs > slo.burn_threshold
            was = self.breached[slo.name]
            if hot and not was:
                kind = "breach"
                self.breaches += 1
            elif was and bf <= slo.burn_threshold \
                    and bs <= slo.burn_threshold:
                kind = "recover"
                self.recoveries += 1
            else:
                continue
            self.breached[slo.name] = kind == "breach"
            ev = SLOEvent(t_now, slo.name, kind, bf, bs)
            self.events.append(ev)
            fired.append(ev)
            if self.tracer is not None:
                self.tracer.instant(
                    f"slo_{kind}:{slo.name}", t_now, pid=self.pid,
                    args={"burn_fast": bf, "burn_slow": bs,
                          "threshold": slo.threshold,
                          "target": slo.target})
        return fired

    def status(self, t_now: float) -> List[dict]:
        """Per-SLO live state for the dashboard/report."""
        rows = []
        for slo in self.slos:
            bf, bs = self.burn_rates(slo, t_now)
            rows.append({
                "name": slo.name, "stream": slo.stream,
                "threshold": slo.threshold, "target": slo.target,
                "burn_fast": bf, "burn_slow": bs,
                "breached": self.breached[slo.name]})
        return rows

    def summary(self) -> dict:
        return {"breaches": self.breaches, "recoveries": self.recoveries,
                "evaluations": self.evaluations,
                "active": sorted(n for n, b in self.breached.items() if b),
                "events": [dataclasses.asdict(e) for e in self.events]}


def default_slos(*, ttft_s: Optional[float] = None,
                 itl_s: Optional[float] = None,
                 deadline_target: Optional[float] = None,
                 target: float = 0.95,
                 fast_window_s: float = 2.0,
                 slow_window_s: float = 30.0) -> List[SLO]:
    """The launcher's SLO set from plain CLI numbers (None = omit)."""
    slos: List[SLO] = []
    if ttft_s is not None:
        slos.append(SLO("ttft", STREAM_TTFT, ttft_s, target=target,
                        fast_window_s=fast_window_s,
                        slow_window_s=slow_window_s))
    if itl_s is not None:
        slos.append(SLO("itl", STREAM_ITL, itl_s, target=target,
                        fast_window_s=fast_window_s,
                        slow_window_s=slow_window_s))
    if deadline_target is not None:
        slos.append(SLO("deadline", STREAM_DEADLINE, 0.5,
                        target=deadline_target,
                        fast_window_s=fast_window_s,
                        slow_window_s=slow_window_s))
    return slos
