"""The observability layer's engine-facing half (counterpart of
``repro.serving.obs.observer``).

:class:`Observability` is the session-scoped facade: one
:class:`~repro_torch.serving.obs.trace.Tracer` (one timeline), one
:class:`~repro_torch.serving.obs.roofline.StepCensusCache`, optional
windows and SLOs, and one :class:`EngineObserver` per attached engine.
A detached engine pays one ``self.obs is not None`` check per hook site
and creates no timing event.

:class:`EngineObserver` is the hook sink the engine calls:

* lifecycle hooks (``on_submit`` / ``on_admit`` / ``on_first_token`` /
  ``on_finish`` / ``on_preempt`` / ``on_shed``) become request-thread
  trace spans and instants;
* compute hooks (``on_prefill`` / ``on_decode``) carry the step's bucket
  census, its live attention work and its device-time marks into
  :class:`~repro_torch.serving.obs.roofline.LiveRoofline`;
* ``end_step`` (sync) and ``end_step_overlap`` (the executor's commit)
  close the per-step phase breakdown — **schedule** (admission and
  prefill before the decode launch), **dispatch** (host time to stage
  and launch the step), **device**, **host** — and emit the step span and
  the KV/batch counter tracks.

**Device time on the card.** The reference stamps the host clock around
``block_until_ready``. Here ``device_s`` is the elapsed time between two
CUDA events recorded on the engine's stream right before and right after
the step's graph replay (or eager body)
(:class:`~repro_torch.serving.steps.StepTiming`), read only once the
step's output has reached the host: in sync mode after its token copy,
under overlap at its commit. The observer adds no synchronisation and no
host wait: a prefill's marks, which no copy may have passed yet (a
chunk's logits are not read), are resolved when a later hook finds them
done. Under overlap ``gap_s`` is the device's own idle time between the
previous step's end mark and this step's start mark; the other phase
terms are computed as the reference computes them. A bucket's first use
(the eager warm-up, then the capture) is a ``capture`` span, not a
roofline sample. On the CPU the marks are host stamps around the body,
which runs at dispatch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core.census import LiveWork
from repro_torch.core.hardware import Hardware, for_device_name
from repro_torch.serving.obs.auditor import MemoryGapAuditor
from repro_torch.serving.obs.roofline import (LiveRoofline, StepCensus,
                                              StepCensusCache)
from repro_torch.serving.obs.series import (DEFAULT_SERIES_MAXLEN,
                                            BoundedSeries)
from repro_torch.serving.obs.trace import DEFAULT_MAX_EVENTS, Tracer
from repro_torch.serving.obs.windows import (
    SLO, STREAM_BATCH, STREAM_DEADLINE, STREAM_E2E, STREAM_ITL, STREAM_KV,
    STREAM_TOKENS, STREAM_TTFT, STREAM_WASTE_RESERVED, STREAM_WASTE_USED,
    SLOMonitor, WindowAggregator)
from repro_torch.serving.workload import FINISH_DEADLINE


@dataclasses.dataclass(frozen=True)
class StepPhases:
    """One engine step's time, attributed to its phases (seconds).

    Synchronous steps (``overlapped=False``): ``schedule + dispatch +
    device + host == total`` up to clock granularity: ``device`` is the
    event-timed device time, ``dispatch`` the host's launch time less the
    device time that must have run under it (on the CPU, where the body
    runs at dispatch, all of it), ``host`` the remainder; on a
    decode-less (prefill-only) step dispatch and device are zero and the
    prefill work sits inside schedule.

    Overlapped steps (``overlapped=True``, the executor's commit):
    attributions, not a partition of ``total_s`` (the dispatch cadence).
    ``device_s`` is the step's event-timed device time, ``gap_s`` the
    device's idle time before it (previous step's end mark to this one's
    start mark), ``dispatch_ahead_s`` how far before the previous step
    completed this one was dispatched (the reference's host estimate).
    """
    step: int
    schedule_s: float
    dispatch_s: float
    device_s: float
    host_s: float
    total_s: float
    overlapped: bool = False
    dispatch_ahead_s: float = 0.0
    gap_s: float = 0.0
    # prefill tokens admitted in the same iteration: 0 marks a pure
    # decode steady-state step
    n_prefill: int = 0


@dataclasses.dataclass
class _PendingPrefill:
    """A prefill's compute hook, held until its end mark has passed."""
    req_id: int
    tid: int
    variant: str
    sc: Optional[StepCensus]
    t0: float
    t1: float
    timing: object
    tokens: int
    live: Optional[LiveWork]
    step: int


class EngineObserver:
    """Hook sink for one engine (``engine.obs``)."""

    def __init__(self, parent: "Observability", pid: int,
                 series_maxlen: int = DEFAULT_SERIES_MAXLEN):
        self.parent = parent
        self.pid = pid
        self.trace: Tracer = parent.trace
        self.census: StepCensusCache = parent.census
        self.roofline = LiveRoofline(parent.hw, maxlen=series_maxlen)
        self.phases: BoundedSeries = BoundedSeries(series_maxlen)
        # per-step pool-byte attribution (opt-in: Observability(
        # audit_memory=True)); fed from end_step
        self.auditor: Optional[MemoryGapAuditor] = \
            MemoryGapAuditor(series_maxlen) if parent.audit_memory else None
        # request-thread timeline anchors (tracer seconds)
        self._t_submit: Dict[int, float] = {}
        self._t_decode: Dict[int, float] = {}
        self._named: set = set()
        # the sync decode hook's payload, consumed by end_step
        self._decode_pending = None
        # prefill hooks whose end mark the device has not passed yet
        self._prefills: List[_PendingPrefill] = []
        self.captures = 0           # bucket first uses (warm-up + capture)

    # ------------------------------------------------------------ naming --
    def _tid(self, req) -> int:
        """Request lifecycle rows: tid = req_id + 1 (tid 0 = step track)."""
        rid = req.req_id
        tid = rid + 1
        if rid not in self._named:
            self._named.add(rid)
            self.trace.name_thread(self.pid, tid, f"req {rid}")
        return tid

    # ------------------------------------------------- lifecycle hooks --
    def on_submit(self, req):
        self._t_submit[req.req_id] = self.trace.now()

    def on_admit(self, req):
        t = self.trace.now()
        t0 = self._t_submit.pop(req.req_id, t)
        self.trace.span("queued", t0, t, pid=self.pid, tid=self._tid(req),
                        cat="lifecycle",
                        args={"req": req.req_id,
                              "arrival_s": req.arrival_s,
                              "prompt_len": req.prompt_len})

    def on_first_token(self, req):
        t = self.trace.now()
        self.trace.instant("first_token", t, pid=self.pid,
                           tid=self._tid(req), cat="lifecycle",
                           args={"req": req.req_id})
        self._t_decode[req.req_id] = t
        w = self.parent.windows
        if w is not None and req.state.t_first_token is not None:
            w.push(STREAM_TTFT, t,
                   req.state.t_first_token - req.arrival_s)

    def on_finish(self, req, reason: str):
        t = self.trace.now()
        tid = self._tid(req)
        t0 = self._t_decode.pop(req.req_id, None)
        if t0 is not None:
            self.trace.span("decode", t0, t, pid=self.pid, tid=tid,
                            cat="lifecycle",
                            args={"req": req.req_id,
                                  "generated": req.state.generated})
        self.trace.instant(f"finish:{reason}", t, pid=self.pid, tid=tid,
                           cat="lifecycle", args={"req": req.req_id})
        self._t_submit.pop(req.req_id, None)
        w = self.parent.windows
        if w is not None:
            if req.state.t_done is not None:
                w.push(STREAM_E2E, t, req.state.t_done - req.arrival_s)
            w.push(STREAM_DEADLINE, t,
                   1.0 if reason == FINISH_DEADLINE else 0.0)

    def on_preempt(self, req):
        # recompute-preemption: the decode span (if any) ends here and the
        # request re-enters the queue — the next admit opens a fresh
        # queued span from this instant
        t = self.trace.now()
        tid = self._tid(req)
        t0 = self._t_decode.pop(req.req_id, None)
        if t0 is not None:
            self.trace.span("decode", t0, t, pid=self.pid, tid=tid,
                            cat="lifecycle", args={"req": req.req_id,
                                                   "preempted": True})
        self.trace.instant("preempt", t, pid=self.pid, tid=tid,
                           cat="lifecycle", args={"req": req.req_id})
        self._t_submit[req.req_id] = t

    def on_shed(self, req, reason: str):
        self.trace.instant("shed", self.trace.now(), pid=self.pid,
                           tid=self._tid(req), cat="lifecycle",
                           args={"req": req.req_id, "reason": reason})
        self._t_submit.pop(req.req_id, None)

    def event(self, name: str, args: Optional[dict] = None, *,
              tid: int = 0, cat: str = "serving"):
        """Generic instant on this engine's step track."""
        self.trace.instant(name, self.trace.now(), pid=self.pid, tid=tid,
                           cat=cat, args=args)

    # --------------------------------------------------- compute hooks --
    def on_prefill(self, req, variant: str, sc: Optional[StepCensus],
                   t0: float, t1: float, timing, tokens: int,
                   live: Optional[LiveWork] = None, step: int = 0):
        """One prefill call (serial, over a prefix, or a chunk): ``t0`` /
        ``t1`` are the host ``perf_counter`` stamps around the call,
        ``timing`` its :class:`~repro_torch.serving.steps.StepTiming`.
        The compute span and the roofline sample are emitted once the
        device has passed its end mark (:meth:`_drain_prefills`)."""
        self._prefills.append(_PendingPrefill(
            req_id=req.req_id, tid=self._tid(req), variant=variant, sc=sc,
            t0=t0, t1=t1, timing=timing, tokens=tokens, live=live,
            step=step))
        self._drain_prefills()

    def _drain_prefills(self):
        """Emit every pending prefill whose end mark has passed, in order
        (a later one waits for an earlier: one stream)."""
        e = self.trace.epoch
        while self._prefills and (self._prefills[0].timing is None
                                  or self._prefills[0].timing.ready()):
            p = self._prefills.pop(0)
            timing = p.timing
            if timing is not None and timing.first_use is not None:
                self._capture(*timing.first_use)
                self.trace.span(p.variant, p.t0 - e, p.t1 - e, pid=self.pid,
                                tid=p.tid, cat="compute",
                                args={"req": p.req_id, "tokens": p.tokens,
                                      "captured": True})
                continue
            device_s = timing.device_s if timing is not None else 0.0
            self.trace.span(p.variant, p.t0 - e, p.t1 - e + device_s,
                            pid=self.pid, tid=p.tid, cat="compute",
                            args={"req": p.req_id, "tokens": p.tokens,
                                  "dispatch_us": (p.t1 - p.t0) * 1e6})
            self.roofline.record(step=p.step, sc=p.sc, device_s=device_s,
                                 batch=p.tokens, variant=p.variant,
                                 live=p.live)

    def _capture(self, t0: float, t1: float):
        """A bucket's first use: the eager warm-up and the capture."""
        self.captures += 1
        e = self.trace.epoch
        self.trace.span("capture", t0 - e, t1 - e, pid=self.pid,
                        cat="phase")

    def on_decode(self, sc: Optional[StepCensus], t0: float, t1: float,
                  t2: float, timing, batch: int, variant: str = "decode",
                  live: Optional[LiveWork] = None):
        """The sync decode, gather or verify step ran and its tokens are
        on the host: ``t0``/``t1`` bound the dispatch call, ``t2`` is
        when the tokens arrived; stash it for this step's ``end_step``."""
        self._decode_pending = (sc, t0, t1, t2, timing, batch, variant,
                                live)

    def on_spec(self, eng, *, drafted: int, accepted: int, committed: int):
        """One speculative verify step committed: counter track for the
        acceptance stream."""
        self.trace.counter("speculation", self.trace.now(),
                           {"drafted": drafted, "accepted": accepted,
                            "committed": committed},
                           pid=self.pid)

    # --------------------------------------------------------- end step --
    def end_step(self, eng, t0: float, t_sched_s: float, n_prefill: int,
                 n_decode: int):
        """Close one synchronous engine step: phase breakdown, step span,
        counters, and the decode roofline sample. ``t0`` is the raw
        ``perf_counter`` stamp the step timer started at; ``t_sched_s`` the
        schedule phase it already measured."""
        t_end = time.perf_counter()
        e = self.trace.epoch
        total_s = t_end - t0
        dispatch_s = device_s = 0.0
        pend = self._decode_pending
        if pend is not None:
            sc, d0, d1, d2, timing, batch, variant, live = pend
            self._decode_pending = None
            if timing.first_use is not None:
                self._capture(*timing.first_use)
            else:
                device_s = timing.device_s
                self.roofline.record(step=eng.step_count, sc=sc,
                                     device_s=device_s, batch=batch,
                                     variant=variant, live=live)
            # the device time that cannot fit between the dispatch's
            # return and the tokens' arrival ran under the dispatch call
            # (all of it on the CPU, where the body runs at dispatch): the
            # dispatch phase is the host's launch time without it
            under = max(device_s - (d2 - d1), 0.0)
            dispatch_s = max(d1 - d0 - under, 0.0)
            self.trace.span("dispatch", d0 - e, d1 - e, pid=self.pid,
                            cat="phase")
            self.trace.span("device", max(d2 - device_s, d1) - e, d2 - e,
                            pid=self.pid, cat="phase")
            self.trace.span("host", d2 - e, t_end - e, pid=self.pid,
                            cat="phase")
        self._drain_prefills()
        host_s = max(total_s - t_sched_s - dispatch_s - device_s, 0.0)
        self.phases.append(StepPhases(
            step=eng.step_count, schedule_s=t_sched_s,
            dispatch_s=dispatch_s, device_s=device_s, host_s=host_s,
            total_s=total_s, n_prefill=n_prefill))
        self.trace.span("schedule", t0 - e, t0 - e + t_sched_s,
                        pid=self.pid, cat="phase")
        self.trace.span(f"step {eng.step_count}", t0 - e, t_end - e,
                        pid=self.pid, cat="step",
                        args={"step": eng.step_count, "decode": n_decode,
                              "prefill_tokens": n_prefill})
        self._step_tracks(eng, t_end - e, total_s, n_prefill, n_decode)

    def _step_tracks(self, eng, t_now: float, total_s: float,
                     n_prefill: int, n_decode: int):
        """The counters, memory-gap audit and windowed feed a step ends
        with (both end_step paths)."""
        self.trace.counter("kv_used_fraction", t_now,
                           {"used": eng.pool.manager.used_fraction},
                           pid=self.pid)
        self.trace.counter("batch", t_now,
                           {"decoding": n_decode,
                            "prefilling": len(eng.prefilling),
                            "waiting": len(eng.waiting)},
                           pid=self.pid)
        # memory-gap audit + windowed feed (both opt-in; see windows.py)
        wb = None
        if self.auditor is not None:
            wb = self.auditor.on_step(eng, n_decode=n_decode)
            self.trace.counter("kv_waste_bytes", t_now,
                               {"used": wb.used_bytes,
                                "block_pad": wb.block_pad_bytes,
                                "prefix_held": wb.prefix_held_bytes,
                                "free": wb.free_bytes,
                                "reserved_unused": wb.reserved_unused_bytes},
                               pid=self.pid)
        w = self.parent.windows
        if w is not None:
            if n_decode:
                w.push(STREAM_ITL, t_now, total_s)
            w.push(STREAM_KV, t_now, eng.pool.manager.used_fraction)
            w.push(STREAM_BATCH, t_now, n_decode)
            w.push(STREAM_TOKENS, t_now, n_decode + n_prefill)
            if wb is not None:
                w.push(STREAM_WASTE_USED, t_now, wb.used_bytes)
                w.push(STREAM_WASTE_RESERVED, t_now,
                       wb.reserved_unused_bytes)

    # ----------------------------------------------- end step (overlap) --
    def end_step_overlap(self, eng, *, step: int, t0: float,
                         t_sched_s: float, n_prefill: int, n_decode: int,
                         sc: Optional[StepCensus], batch: int,
                         t_call: float, t_ret: float, timing, prev_timing,
                         ready_est: float, dispatch_ahead_s: float,
                         total_s: float, host_s: float,
                         variant: str = "decode",
                         live: Optional[LiveWork] = None):
        """Close one *overlapped* engine step, called by the executor at
        its commit (an iteration or two after the dispatch it describes),
        once its tokens are on the host.

        ``t_call``/``t_ret`` bound the dispatch call; ``timing`` holds the
        step's event marks and ``prev_timing`` those of the step
        dispatched before it (``gap_s`` is the device's idle time between
        the two); ``ready_est`` is the host's estimate of when the step
        finished (the reference's, for placing the device span);
        ``total_s`` is the dispatch cadence. A fully invalidated step
        commits nothing and emits no sample."""
        e = self.trace.epoch
        device_s = gap_s = 0.0
        if timing.first_use is not None:
            self._capture(*timing.first_use)
        else:
            device_s = timing.device_s
            gap_s = timing.gap_after(prev_timing)
            self.roofline.record(step=step, sc=sc, device_s=device_s,
                                 batch=batch, variant=variant, live=live)
        self.trace.span("schedule", t0 - e, t0 - e + t_sched_s,
                        pid=self.pid, cat="phase")
        self.trace.span("dispatch", t_call - e, t_ret - e, pid=self.pid,
                        cat="phase")
        if device_s > 0:
            dev1 = max(ready_est, t_ret)
            self.trace.span("device", max(dev1 - device_s, t_call) - e,
                            dev1 - e, pid=self.pid, cat="phase")
        if gap_s > 0:
            # device idle between the previous step's end mark and this
            # step's start mark — the bubble the overlap is meant to close
            self.trace.span("gap", t_call - gap_s - e, t_call - e,
                            pid=self.pid, cat="phase")
        self.phases.append(StepPhases(
            step=step, schedule_s=t_sched_s, dispatch_s=t_ret - t_call,
            device_s=device_s, host_s=host_s, total_s=total_s,
            overlapped=True, dispatch_ahead_s=dispatch_ahead_s,
            gap_s=gap_s, n_prefill=n_prefill))
        self._drain_prefills()
        t_end = time.perf_counter()
        self.trace.span(f"step {step}", t0 - e, t_end - e, pid=self.pid,
                        cat="step",
                        args={"step": step, "decode": n_decode,
                              "prefill_tokens": n_prefill,
                              "overlapped": True,
                              "dispatch_ahead_us": dispatch_ahead_s * 1e6,
                              "gap_us": gap_s * 1e6})
        self._step_tracks(eng, t_end - e, total_s, n_prefill, n_decode)

    # ----------------------------------------------------------- views --
    def phase_summary(self) -> dict:
        """Mean seconds per phase over retained steps + the host-gap
        fraction. For synchronous steps the numerator is host + dispatch
        time; for overlapped steps it is the event-timed device idle
        ``gap_s``."""
        n = len(self.phases)
        if n == 0:
            return {"steps": 0, "schedule_s": 0.0, "dispatch_s": 0.0,
                    "device_s": 0.0, "host_s": 0.0, "total_s": 0.0,
                    "dispatch_ahead_s": 0.0, "gap_s": 0.0,
                    "host_gap_fraction": 0.0}
        tot = sum(p.total_s for p in self.phases)
        mean = lambda f: sum(f(p) for p in self.phases) / n  # noqa: E731
        host = sum(p.gap_s if p.overlapped else p.host_s + p.dispatch_s
                   for p in self.phases)
        return {"steps": self.phases.appended,
                "schedule_s": mean(lambda p: p.schedule_s),
                "dispatch_s": mean(lambda p: p.dispatch_s),
                "device_s": mean(lambda p: p.device_s),
                "host_s": mean(lambda p: p.host_s),
                "total_s": mean(lambda p: p.total_s),
                "dispatch_ahead_s": mean(lambda p: p.dispatch_ahead_s),
                "gap_s": mean(lambda p: p.gap_s),
                "host_gap_fraction": host / max(tot, 1e-12)}

    def summary(self) -> dict:
        self._drain_prefills()
        return {"replica": self.pid,
                "phases": self.phase_summary(),
                "roofline": self.roofline.summary(),
                "decode": self.roofline.summary("decode"),
                "captures": self.captures}


class Observability:
    """Session-scoped observability: tracer + census cache + per-engine
    observers, and the export entry points.

    ::

        obs = Observability()                 # the card's own entry
        obs.attach(engine)
        engine.run(reqs)
        obs.export_chrome_trace("trace.json")
        print(obs.summary())

    ``hw=None`` takes the :mod:`~repro_torch.core.hardware` entry of the
    card the first attached engine runs on (an unknown card raises); an
    engine on the CPU needs ``hw`` given. ``strict_census`` raises a
    census fault instead of recording it in ``census.errors``.
    """

    def __init__(self, hw: Optional[Hardware] = None, *,
                 series_maxlen: int = DEFAULT_SERIES_MAXLEN,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 audit_memory: bool = False,
                 windows: Union[bool, WindowAggregator, None] = None,
                 slos: Optional[Sequence[SLO]] = None,
                 strict_census: bool = False):
        self.hw: Optional[Hardware] = hw
        self.trace = Tracer(max_events=max_events)
        self.census = StepCensusCache(strict=strict_census)
        self.series_maxlen = series_maxlen
        self.observers: Dict[int, EngineObserver] = {}
        self.audit_memory = audit_memory
        # windowed telemetry: pass True for a default aggregator, an
        # aggregator to share one, or SLOs (which require windows)
        if isinstance(windows, WindowAggregator):
            self.windows: Optional[WindowAggregator] = windows
        elif windows or slos:
            self.windows = WindowAggregator()
        else:
            self.windows = None
        self.slo: Optional[SLOMonitor] = SLOMonitor(
            list(slos), self.windows, tracer=self.trace) if slos else None

    def _hardware_for(self, engine) -> Hardware:
        if self.hw is not None:
            return self.hw
        if engine.device.type != "cuda":
            raise ValueError(
                f"an engine on {engine.device} needs Observability(hw=...): "
                f"the peaks of the card it runs on are not known")
        import torch
        self.hw = for_device_name(torch.cuda.get_device_name(engine.device))
        return self.hw

    # ------------------------------------------------------------ attach --
    def attach(self, engine, pid: Optional[int] = None) -> EngineObserver:
        """Attach to one engine (idempotent per replica id): the engine's
        ``obs`` hook slot is pointed at this session's observer."""
        self._hardware_for(engine)
        pid = getattr(engine, "replica_id", 0) if pid is None else pid
        ob = self.observers.get(pid)
        if ob is None:
            ob = EngineObserver(self, pid, self.series_maxlen)
            self.observers[pid] = ob
            self.trace.name_process(pid, f"replica{pid}")
            self.trace.name_thread(pid, 0, "engine steps")
        engine.obs = ob
        return ob

    def attach_cluster(self, cluster) -> "Observability":
        """Attach to every replica of a cluster, each on its own trace
        rows, and install the session as the cluster's event sink."""
        cluster.obs = self
        for rep in cluster.replicas:
            self.attach(rep.engine, rep.idx)
        return self

    def attach_backend(self, backend) -> "Observability":
        """Attach to an engine or a cluster (duck-typed on
        ``replicas``)."""
        if hasattr(backend, "replicas"):
            return self.attach_cluster(backend)
        self.attach(backend)
        return self

    def observer(self, pid: int = 0) -> Optional[EngineObserver]:
        return self.observers.get(pid)

    def replica_event(self, pid: int, name: str,
                      args: Optional[dict] = None):
        """Cluster-level instant on a replica's step track (redrive /
        quarantine / respawn / watchdog / evict) — no-op for a replica
        that was never attached."""
        ob = self.observers.get(pid)
        if ob is not None:
            ob.event(name, args)

    # ----------------------------------------------------------- export --
    def export_chrome_trace(self, path: str) -> str:
        """Write the session trace as Chrome-trace/Perfetto JSON."""
        return self.trace.export_chrome_trace(path)

    def summary(self) -> dict:
        """Per-engine phase + roofline summaries, plus census stats."""
        out = {
            "hardware": self.hw.name if self.hw is not None else "unknown",
            "replicas": {pid: ob.summary()
                         for pid, ob in sorted(self.observers.items())},
            "census": {"compiles": self.census.compiles,
                       "errors": len(self.census.errors)},
            "trace": {"events": self.trace.n_events,
                      "dropped": self.trace.dropped},
        }
        if self.slo is not None:
            out["slo"] = self.slo.summary()
        gap = self.memory_gap_report()
        if gap:
            out["memory_gap"] = gap
        return out

    def memory_gap_report(self) -> Dict[int, dict]:
        """Per-engine end-of-run memory gap reports (empty unless
        ``audit_memory=True`` and steps ran)."""
        return {pid: ob.auditor.report()
                for pid, ob in sorted(self.observers.items())
                if ob.auditor is not None and ob.auditor.audits}

    def roofline_rows(self) -> List[str]:
        """Printable per-engine live-roofline lines."""
        out = []
        for pid, ob in sorted(self.observers.items()):
            s = ob.roofline.summary("decode")
            out.append(
                f"replica {pid}: decode steps={s['steps']} "
                f"bw_util={s['bw_util_mean'] * 100:.1f}% "
                f"mfu={s['mfu_mean'] * 100:.2f}% "
                f"ai={s['ai_mean']:.1f} flop/B bound={s['bound']}")
        return out
