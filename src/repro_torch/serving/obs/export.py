"""Metrics export (counterpart of ``repro.serving.obs.export``):
registry-backed Prometheus text exposition, a stable JSON schema with
loss-free reload, and a periodic emitter.

The **registry** (:data:`SERVING_SPECS` / :data:`CLUSTER_SPECS`) is the
single mapping from Prometheus metric names to ``ServingMetrics`` /
``ClusterMetrics`` fields, with the reference's schema string and metric
names, so one scraper reads both packages. Three export surfaces:

* :func:`prometheus_text` — text exposition format (``# HELP`` /
  ``# TYPE`` + samples; percentile triples become ``summary`` quantile
  series, dict-valued counters become labeled series), linted by
  :func:`lint_prometheus`;
* :func:`metrics_to_json` / :func:`metrics_from_json` — versioned JSON
  round-trip of the dataclasses (nested ``Percentiles``, ``PrefixStats``,
  ``MemoryGapStats`` and per-replica ``ReplicaStats`` included);
* :class:`MetricsEmitter` — periodic file/stdout snapshots.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import sys
from typing import Callable, Dict, List, Optional, Union

from repro_torch.kvcache.prefix import PrefixStats
from repro_torch.serving.cluster.metrics import ClusterMetrics, ReplicaStats
from repro_torch.serving.metrics import Percentiles, ServingMetrics
from repro_torch.serving.obs.auditor import MemoryGapStats

SCHEMA = "repro.serving.metrics/v1"
PREFIX = "repro"


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One exported metric: Prometheus name <- metrics-object field.

    ``path`` is a dotted attribute path (``"prefix.hit_rate"``); ``kind``
    follows Prometheus conventions — ``summary`` paths must resolve to a
    :class:`Percentiles` (exported as quantile series), ``labeled``
    paths to a ``Dict[str, int]`` (exported with a ``reason=`` label).
    """
    name: str
    kind: str                    # counter | gauge | summary | labeled
    help: str
    path: str
    label: str = "reason"        # label key for kind == "labeled"


SERVING_SPECS: List[MetricSpec] = [
    MetricSpec("wall_seconds", "gauge", "Serving wall time", "wall_s"),
    MetricSpec("tokens_total", "counter",
               "Input + output tokens served (paper throughput unit)",
               "total_tokens"),
    MetricSpec("output_tokens_total", "counter", "Output tokens served",
               "output_tokens"),
    MetricSpec("requests_completed_total", "counter",
               "Requests finished (any reason)", "n_completed"),
    MetricSpec("throughput_tokens_per_second", "gauge",
               "Total-token throughput", "throughput"),
    MetricSpec("output_throughput_tokens_per_second", "gauge",
               "Output-token throughput", "output_throughput"),
    MetricSpec("itl_mean_seconds", "gauge", "Mean inter-token latency",
               "itl_s"),
    MetricSpec("itl_seconds", "summary", "Inter-token latency", "itl"),
    MetricSpec("ttft_mean_seconds", "gauge", "Mean time-to-first-token",
               "ttft_s"),
    MetricSpec("ttft_seconds", "summary", "Time-to-first-token", "ttft"),
    MetricSpec("e2e_mean_seconds", "gauge", "Mean request E2E latency",
               "e2e_s"),
    MetricSpec("e2e_seconds", "summary", "Request E2E latency", "e2e"),
    MetricSpec("stall_mean_seconds", "gauge",
               "Mean per-step scheduler stall (admission + prefill)",
               "stall_s_mean"),
    MetricSpec("stall_seconds", "summary", "Per-step scheduler stall",
               "stall"),
    MetricSpec("kv_used_fraction_mean", "gauge",
               "Mean KV pool occupancy", "kv_used_mean"),
    MetricSpec("kv_used_fraction_max", "gauge",
               "Peak KV pool occupancy", "max_kv_fraction"),
    MetricSpec("batch_size_mean", "gauge", "Mean decode batch",
               "avg_batch"),
    MetricSpec("prefill_tokens_per_step", "gauge",
               "Mean prompt tokens computed per mixed step",
               "prefill_tokens_per_step"),
    MetricSpec("decode_tokens_per_step", "gauge",
               "Mean tokens decoded per step", "decode_tokens_per_step"),
    MetricSpec("preemptions_total", "counter",
               "Recompute preemptions (pool pressure or redrive)",
               "preemptions"),
    MetricSpec("shed_total", "counter",
               "Requests rejected by admission control", "shed"),
    MetricSpec("shed_reasons_total", "labeled",
               "Admission-control rejections by policy", "shed_reasons"),
    MetricSpec("deadline_expired_total", "counter",
               "Requests finished by deadline expiry", "deadline_expired"),
    MetricSpec("queued_aborts_total", "counter",
               "Aborts caught in the arrival queue", "queued_aborts"),
    MetricSpec("finish_reasons_total", "labeled",
               "Completed requests by finish reason", "finish_reasons"),
    MetricSpec("prefix_hit_rate", "gauge",
               "Prefix-cache prompt-token hit rate", "prefix.hit_rate"),
    MetricSpec("prefix_hit_tokens_total", "counter",
               "Prefill tokens served from the prefix cache",
               "prefix.hit_tokens"),
    MetricSpec("prefix_blocks_evicted_total", "counter",
               "Prefix-cache blocks evicted back to the pool",
               "prefix.blocks_evicted"),
    # --- speculative decoding (all zero unless speculate was on) ---
    MetricSpec("spec_steps_total", "counter",
               "Speculative verify steps run", "spec_steps"),
    MetricSpec("spec_drafted_tokens_total", "counter",
               "Draft tokens proposed to verify steps", "spec_drafted"),
    MetricSpec("spec_accepted_tokens_total", "counter",
               "Draft tokens accepted (committed for free)",
               "spec_accepted"),
    MetricSpec("spec_rejected_tokens_total", "counter",
               "Draft tokens rejected (KV rolled back)", "spec_rejected"),
    MetricSpec("spec_acceptance_rate", "gauge",
               "Accepted fraction of all drafted tokens",
               "spec_acceptance_rate"),
    # --- SLO monitor (session-level; same counts on every replica) ---
    MetricSpec("slo_breaches_total", "counter",
               "SLO breach events (multi-window burn rate)",
               "slo_breaches"),
    MetricSpec("slo_recoveries_total", "counter",
               "SLO recovery events", "slo_recoveries"),
    # --- memory-gap auditor (None unless audit_memory was on) ---
    MetricSpec("memgap_pool_bytes", "gauge",
               "Accountable KV pool bytes (trash block excluded)",
               "memgap.pool_bytes"),
    MetricSpec("memgap_used_bytes_mean", "gauge",
               "Mean bytes holding written KV rows (true use)",
               "memgap.used_bytes_mean"),
    MetricSpec("memgap_reserved_unused_bytes_mean", "gauge",
               "Mean worst-case-commitment bytes not yet allocated",
               "memgap.reserved_unused_bytes_mean"),
    MetricSpec("memgap_block_pad_bytes_mean", "gauge",
               "Mean allocated-but-unwritten bytes in live block tables",
               "memgap.block_pad_bytes_mean"),
    MetricSpec("memgap_prefix_held_bytes_mean", "gauge",
               "Mean bytes held only by the prefix cache",
               "memgap.prefix_held_bytes_mean"),
    MetricSpec("memgap_bucket_pad_bytes_mean", "gauge",
               "Mean trash-entry bytes in the jitted step's padded table",
               "memgap.bucket_pad_bytes_mean"),
    MetricSpec("memgap_gap_fraction_mean", "gauge",
               "Mean fraction of the pool not holding live KV rows",
               "memgap.gap_fraction_mean"),
    MetricSpec("memgap_peak_used_bytes", "gauge",
               "Peak true-use bytes over the run", "memgap.peak_used_bytes"),
]

def _resolve(obj, path: str):
    for part in path.split("."):
        if obj is None:
            return None
        obj = getattr(obj, part)
    return obj


CLUSTER_SPECS: List[MetricSpec] = [
    MetricSpec("cluster_wall_seconds", "gauge", "Cluster wall time",
               "wall_s"),
    MetricSpec("cluster_replicas", "gauge", "Replica count", "n_replicas"),
    MetricSpec("cluster_requests_completed_total", "counter",
               "Requests finished across the cluster", "completed"),
    MetricSpec("cluster_tokens_total", "counter",
               "Input + output tokens across replicas", "total_tokens"),
    MetricSpec("cluster_throughput_tokens_per_second", "gauge",
               "Aggregate total-token throughput", "throughput"),
    MetricSpec("cluster_goodput_requests_per_second", "gauge",
               "Completed requests per second", "goodput_rps"),
    MetricSpec("cluster_ttft_seconds", "summary",
               "Time-to-first-token across replicas", "ttft"),
    MetricSpec("cluster_itl_seconds", "summary",
               "Pooled decode-step latency", "itl"),
    MetricSpec("cluster_e2e_seconds", "summary",
               "Request E2E latency across replicas", "e2e"),
    MetricSpec("cluster_queue_depth_mean", "gauge",
               "Mean summed queue depth", "mean_queue_depth"),
    MetricSpec("cluster_queue_depth_max", "gauge",
               "Peak summed queue depth", "max_queue_depth"),
    MetricSpec("cluster_kv_used_fraction_peak", "gauge",
               "Peak KV occupancy over replicas", "peak_kv_fraction"),
    MetricSpec("cluster_finish_reasons_total", "labeled",
               "Completed requests by finish reason", "finish_reasons"),
    # --- fault tolerance ---
    MetricSpec("cluster_faults_total", "counter",
               "Replica failures observed (injected or real)", "faults"),
    MetricSpec("cluster_redriven_total", "counter",
               "Stranded requests re-admitted on survivors", "redriven"),
    MetricSpec("cluster_lost_total", "counter",
               "Requests finished failed (redrive budget spent)", "lost"),
    MetricSpec("cluster_shed_total", "counter",
               "Admission-control rejections", "shed"),
    MetricSpec("cluster_deadline_expired_total", "counter",
               "Deadline expiries across replicas", "deadline_expired"),
    MetricSpec("cluster_watchdog_trips_total", "counter",
               "Wedged-replica detections", "watchdog_trips"),
    MetricSpec("cluster_availability", "gauge",
               "Mean per-replica availability", "availability"),
    # --- speculative decoding (summed across replicas) ---
    MetricSpec("cluster_spec_steps_total", "counter",
               "Speculative verify steps across replicas", "spec_steps"),
    MetricSpec("cluster_spec_drafted_tokens_total", "counter",
               "Draft tokens proposed across replicas", "spec_drafted"),
    MetricSpec("cluster_spec_accepted_tokens_total", "counter",
               "Draft tokens accepted across replicas", "spec_accepted"),
    MetricSpec("cluster_spec_rejected_tokens_total", "counter",
               "Draft tokens rejected across replicas", "spec_rejected"),
]


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    return repr(f) if not f.is_integer() else str(int(f))


def _emit_spec(lines: List[str], spec: MetricSpec, obj,
               labels: Dict[str, str]):
    val = _resolve(obj, spec.path)
    if val is None:
        return                      # e.g. prefix cache off
    name = f"{PREFIX}_{spec.name}"
    lab = "".join(f'{k}="{v}",' for k, v in labels.items())
    base = f"{name}{{{lab[:-1]}}}" if lab else name
    if spec.kind == "summary":
        assert isinstance(val, Percentiles), spec.path
        for q, v in (("0.5", val.p50), ("0.95", val.p95),
                     ("0.99", val.p99)):
            qlab = lab + f'quantile="{q}"'
            lines.append(f"{name}{{{qlab}}} {_fmt(v)}")
    elif spec.kind == "labeled":
        for key in sorted(val):
            klab = lab + f'{spec.label}="{key}"'
            lines.append(f"{name}{{{klab}}} {_fmt(val[key])}")
    else:
        lines.append(f"{base} {_fmt(val)}")


def prometheus_text(metrics: Union[ServingMetrics, ClusterMetrics]) -> str:
    """Render a metrics object in Prometheus text exposition format.

    A :class:`ClusterMetrics` exports its cluster-level registry plus
    every replica's :class:`ServingMetrics` with a ``replica="i"`` label,
    so per-replica imbalance survives the export.
    """
    lines: List[str] = []
    seen_types: set = set()

    def emit(specs, obj, labels):
        for spec in specs:
            if _resolve(obj, spec.path) is None:
                continue
            name = f"{PREFIX}_{spec.name}"
            if name not in seen_types:
                seen_types.add(name)
                kind = "summary" if spec.kind == "summary" else (
                    "counter" if spec.kind in ("counter", "labeled")
                    else "gauge")
                lines.append(f"# HELP {name} {spec.help}")
                lines.append(f"# TYPE {name} {kind}")
            _emit_spec(lines, spec, obj, labels)

    if isinstance(metrics, ClusterMetrics):
        emit(CLUSTER_SPECS, metrics, {})
        for rs in metrics.per_replica:
            emit(SERVING_SPECS, rs.metrics, {"replica": str(rs.replica)})
    elif isinstance(metrics, ServingMetrics):
        emit(SERVING_SPECS, metrics, {})
    else:
        raise TypeError(f"cannot export {type(metrics).__name__}")
    return "\n".join(lines) + "\n"


_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"              # metric name
    r"(\{[^{}]*\})?"                            # optional labels
    r" ([^ ]+)( [0-9]+)?$")                     # value, optional timestamp
_LABEL_RE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*"$')


def lint_prometheus(text: str) -> List[str]:
    """Structural lint of text exposition format; returns problems
    (empty = a Prometheus scraper parses it). Checks line grammar,
    label syntax, numeric values, ``# TYPE`` validity and uniqueness,
    and that samples follow their metric's TYPE declaration."""
    errs: List[str] = []
    typed: Dict[str, str] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                errs.append(f"line {ln}: malformed comment {line!r}")
                continue
            if parts[1] == "TYPE":
                name, kind = parts[2], (parts[3] if len(parts) > 3 else "")
                if kind not in ("counter", "gauge", "summary", "histogram",
                                "untyped"):
                    errs.append(f"line {ln}: bad TYPE {kind!r}")
                if name in typed:
                    errs.append(f"line {ln}: duplicate TYPE for {name}")
                typed[name] = kind
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errs.append(f"line {ln}: malformed sample {line!r}")
            continue
        name, labels, value = m.group(1), m.group(2), m.group(3)
        if labels:
            for pair in filter(None, labels[1:-1].split(",")):
                if not _LABEL_RE.match(pair):
                    errs.append(f"line {ln}: malformed label {pair!r}")
        if value not in ("NaN", "+Inf", "-Inf"):
            try:
                float(value)
            except ValueError:
                errs.append(f"line {ln}: non-numeric value {value!r}")
        base = name
        for suffix in ("_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in typed:
                base = name[:-len(suffix)]
        if typed and base not in typed:
            errs.append(f"line {ln}: sample {name!r} without TYPE")
    return errs


# ------------------------------------------------------------------ JSON --
def metrics_to_json(metrics: Union[ServingMetrics, ClusterMetrics]) -> dict:
    """Versioned, loss-free JSON form (``metrics_from_json`` inverts)."""
    return {"schema": SCHEMA, "type": type(metrics).__name__,
            "data": dataclasses.asdict(metrics)}


def _percentiles(d: dict) -> Percentiles:
    return Percentiles(**d)


def _serving_from(d: dict) -> ServingMetrics:
    d = dict(d)
    for key in ("ttft", "itl", "e2e", "stall"):
        d[key] = _percentiles(d[key])
    if d.get("prefix") is not None:
        d["prefix"] = PrefixStats(**d["prefix"])
    if d.get("memgap") is not None:
        d["memgap"] = MemoryGapStats(**d["memgap"])
    return ServingMetrics(**d)


def _cluster_from(d: dict) -> ClusterMetrics:
    d = dict(d)
    for key in ("ttft", "itl", "e2e"):
        d[key] = _percentiles(d[key])
    reps = []
    for rd in d["per_replica"]:
        rd = dict(rd)
        rd["metrics"] = _serving_from(rd["metrics"])
        reps.append(ReplicaStats(**rd))
    d["per_replica"] = reps
    return ClusterMetrics(**d)


def metrics_from_json(doc: Union[dict, str]
                      ) -> Union[ServingMetrics, ClusterMetrics]:
    """Reload a :func:`metrics_to_json` document (dict, JSON string, or
    file path) into the original dataclass. Fails loudly on unknown
    schema/type — a silent partial reload would poison downstream
    reports."""
    if isinstance(doc, str):
        if doc.lstrip().startswith("{"):
            doc = json.loads(doc)
        else:
            with open(doc) as f:
                doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"unknown metrics schema {doc.get('schema')!r} "
                         f"(expected {SCHEMA!r})")
    kind = doc.get("type")
    if kind == "ServingMetrics":
        return _serving_from(doc["data"])
    if kind == "ClusterMetrics":
        return _cluster_from(doc["data"])
    raise ValueError(f"unknown metrics type {kind!r}")


# --------------------------------------------------------------- emitter --
class MetricsEmitter:
    """Periodic metrics snapshots to a file (atomic overwrite) or stdout.

    ``tick(now, provider)`` emits at most once per ``interval_s`` —
    ``provider`` is only called when an emit is due, so collection cost
    (percentiles over the series) is paid per interval, not per step.
    """

    def __init__(self, path: Optional[str] = None, *,
                 interval_s: float = 10.0, fmt: str = "json",
                 provider: Optional[Callable[
                     [], Union[ServingMetrics, ClusterMetrics]]] = None):
        if fmt not in ("json", "prom"):
            raise ValueError(f"fmt must be 'json' or 'prom', got {fmt!r}")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.path = path
        self.interval_s = interval_s
        self.fmt = fmt
        # default provider for close()/`with`: lets the final snapshot
        # happen even when the run dies before handing metrics over
        self.provider = provider
        self.emits = 0
        self._last: Optional[float] = None

    def tick(self, now: float,
             provider: Callable[[], Union[ServingMetrics, ClusterMetrics]]
             ) -> bool:
        """Emit if an interval elapsed (``now`` is any monotonic clock —
        the serving timeline works). Returns whether it emitted."""
        if self._last is not None and now - self._last < self.interval_s:
            return False
        self._last = now
        self.emit(provider())
        return True

    def emit(self, metrics: Union[ServingMetrics, ClusterMetrics]):
        if self.fmt == "prom":
            payload = prometheus_text(metrics)
        else:
            payload = json.dumps(metrics_to_json(metrics)) + "\n"
        if self.path is None:
            sys.stdout.write(payload)
        else:
            tmp = f"{self.path}.tmp"
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path)
        self.emits += 1

    def close(self, metrics=None):
        """Final unconditional emit (end-of-run snapshot). Falls back to
        the configured ``provider`` when no metrics are handed in."""
        if metrics is None and self.provider is not None:
            metrics = self.provider()
        if metrics is not None:
            self.emit(metrics)

    # `with MetricsEmitter(path, provider=...):` guarantees a
    # final snapshot on disk however the block exits — same contract as
    # Tracer's autosave: a replica crash mid-run must still leave the
    # last known-good metrics behind.
    def __enter__(self) -> "MetricsEmitter":
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            self.close()
        except Exception:
            # the final snapshot is best-effort on the crash path: the
            # in-flight exception is the evidence that matters
            if exc_type is None:
                raise
        return False
