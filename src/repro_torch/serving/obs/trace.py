"""Chrome-trace / Perfetto JSON event collector (a copy of
``repro.serving.obs.trace``).

The serving layer's request-lifecycle and step-phase spans are recorded
as `Trace Event Format` objects (the JSON schema both ``chrome://tracing``
and https://ui.perfetto.dev load directly):

* one **process row per replica** (``pid`` = replica index, named
  ``replica<N>``),
* ``tid 0`` is the replica's *engine step* track — one ``X`` span per
  engine step with nested ``schedule`` / ``dispatch`` / ``device`` /
  ``host`` phase spans,
* every request gets its own thread row (``tid`` = ``req_id + 1``)
  carrying its lifecycle: ``queued`` span (submit -> admission),
  ``prefill`` / ``chunk`` compute spans, a ``first_token`` instant,
  a ``decode`` span (first token -> finish), and instants for
  ``preempt`` / ``redrive`` / ``shed`` / ``deadline`` / ``abort``.

Timestamps are microseconds on one shared ``time.perf_counter`` epoch
(fixed when the tracer is created), so spans recorded from different
replica threads land on one coherent timeline. Appends are plain
``list.append`` of a small dict — safe under the GIL from concurrent
replica threads and cheap enough to leave enabled.

The event buffer is bounded (``max_events``): once full, new events are
dropped and counted in ``dropped`` (exported as trace metadata), so a
soak run cannot grow host memory without limit — same policy as
:mod:`repro_torch.serving.obs.series`.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

DEFAULT_MAX_EVENTS = 1_000_000


class Tracer:
    """Collects Trace Event Format events; exports Perfetto-loadable JSON."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS,
                 epoch: Optional[float] = None,
                 autosave_path: Optional[str] = None):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.epoch = time.perf_counter() if epoch is None else epoch
        self.max_events = int(max_events)
        self.autosave_path = autosave_path
        self.events: List[dict] = []
        self.dropped = 0
        self._meta: Dict[tuple, dict] = {}   # (kind, pid, tid) -> event

    # ------------------------------------------------------------ clock --
    def now(self) -> float:
        """Seconds on the tracer timeline (perf_counter - epoch)."""
        return time.perf_counter() - self.epoch

    def _ts(self, t_s: float) -> float:
        return t_s * 1e6                     # trace events use microseconds

    # ----------------------------------------------------------- events --
    def _emit(self, ev: dict):
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def span(self, name: str, t0_s: float, t1_s: float, *, pid: int = 0,
             tid: int = 0, cat: str = "serving",
             args: Optional[dict] = None):
        """A complete ``X`` (duration) event over [t0_s, t1_s] seconds on
        the tracer timeline."""
        ev = {"name": name, "ph": "X", "ts": self._ts(t0_s),
              "dur": max(self._ts(t1_s - t0_s), 0.0),
              "pid": pid, "tid": tid, "cat": cat}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, t_s: float, *, pid: int = 0, tid: int = 0,
                cat: str = "serving", args: Optional[dict] = None):
        ev = {"name": name, "ph": "i", "ts": self._ts(t_s), "s": "t",
              "pid": pid, "tid": tid, "cat": cat}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, t_s: float, values: Dict[str, float], *,
                pid: int = 0):
        """A ``C`` (counter) event — Perfetto renders these as a stacked
        area track (e.g. KV occupancy, batch size)."""
        self._emit({"name": name, "ph": "C", "ts": self._ts(t_s),
                    "pid": pid, "tid": 0, "args": dict(values)})

    # --------------------------------------------------------- metadata --
    def name_process(self, pid: int, name: str):
        self._meta[("process", pid, 0)] = {
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name}}

    def name_thread(self, pid: int, tid: int, name: str):
        self._meta[("thread", pid, tid)] = {
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name}}

    # ----------------------------------------------------------- export --
    @property
    def n_events(self) -> int:
        return len(self.events)

    def to_dict(self) -> dict:
        """The Chrome-trace JSON object (metadata events first so the
        viewers pick up row names before any payload)."""
        return {
            "traceEvents": list(self._meta.values()) + self.events,
            "displayTimeUnit": "ms",
            "otherData": {"source": "repro_torch.serving.obs",
                          "dropped_events": self.dropped},
        }

    def export_chrome_trace(self, path: str) -> str:
        """Write the trace to ``path``; load it in ``chrome://tracing`` or
        https://ui.perfetto.dev. Returns the path."""
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)
        return path

    def flush(self) -> Optional[str]:
        """Export to ``autosave_path`` if one was configured (no-op
        otherwise). The crash-safe save point: everything recorded so
        far becomes a valid, loadable trace file."""
        if self.autosave_path is None:
            return None
        return self.export_chrome_trace(self.autosave_path)

    # ------------------------------------------------- exception safety --
    # `with Tracer(autosave_path="trace.json") as tr:` guarantees a valid
    # trace on disk however the block exits — a replica crash or a ^C
    # mid-run must not cost the evidence of what led up to it.
    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            self.flush()
        except Exception:
            # never mask the in-flight exception with an export failure
            if exc_type is None:
                raise
        return False


def validate_chrome_trace(trace) -> List[str]:
    """Structural lint of a Chrome-trace JSON object (or file path).

    Returns a list of problems (empty = loads in Perfetto). Checked:
    top-level shape, per-event required keys, phase-specific fields
    (``X`` needs ``dur``, metadata needs ``args.name``), numeric and
    non-negative timestamps.
    """
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    errs: List[str] = []
    if not isinstance(trace, dict):
        return [f"top level must be an object, got {type(trace).__name__}"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing traceEvents list"]
    for i, ev in enumerate(evs):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                errs.append(f"{where}: missing {key!r}")
        ph = ev.get("ph")
        if ph == "M":
            if not isinstance(ev.get("args", {}).get("name"), str):
                errs.append(f"{where}: metadata event without args.name")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X event with bad dur {dur!r}")
        elif ph == "C":
            if not isinstance(ev.get("args"), dict):
                errs.append(f"{where}: counter event without args dict")
        elif ph not in ("i", "I", "B", "E", "b", "e", "n", "s", "t", "f"):
            errs.append(f"{where}: unknown phase {ph!r}")
        if len(errs) > 50:
            errs.append("... (truncated)")
            break
    return errs
