"""Replicated serving: R continuous-batching engines behind one frontend
(the port of ``repro.serving.cluster.cluster``).

The paper's headline payoff (Sec. VI-B) is that the KV memory BCA frees
can host *concurrent model replicas* that lift aggregate throughput. The
paper co-locates replicas on one H100 under NVIDIA MPS; the reference,
on a TPU, slices the device mesh instead. The port runs on the paper's
card, so it co-locates as the paper did, in one process: several engines
on one device, each on its own CUDA stream, behind a router.

Two replica placements:

* :meth:`ReplicatedCluster.colocated` — R replicas on one card sharing
  one :class:`~repro_torch.models.model.Model`, so the weights are held
  once. Each replica owns its KV pool, its allocator, its
  :class:`~repro_torch.serving.steps.StepFunctions` (the CUDA graphs
  capture their own pool's addresses, so they cannot be shared as the
  reference shares its compiled bundle) and its stream, so the kernels of
  two replicas stepped on two host threads run on the card at once.
* :meth:`ReplicatedCluster.sliced` — the counterpart of the reference's
  ``slice_mesh``: a list of devices split R ways, one replica a slice with
  its own copy of the weights. A replica runs on one device (the port has
  no SPMD layer yet), so each slice must hold exactly one; on a one-card
  machine that is R=1.

Two stepping modes:

* ``"thread"`` — one host thread per replica, so one replica's Python
  scheduling overlaps another's device work (the GIL is released while
  the card runs and while a thread waits for it). The main thread feeds
  arrivals by wall clock through the router.
* ``"sync"``  — single-threaded round-robin stepping with fast-forwarded
  idle time; each replica's work is still queued on its own stream. For
  offline (simultaneous-arrival) workloads this is fully deterministic:
  routing order is fixed and a 1-replica sync cluster is token-for-token
  identical to the bare engine. Chunked prefill keeps this property:
  chunk selection is pure FCFS over request state, never the wall clock.
  (With *timed* arrivals, dispatch rounds still follow the wall clock, so
  a load-aware policy's choices can vary with real step durations.)

Per-replica isolation is structural: every engine owns its pool,
allocator, graphs, stream and preemption counter (there is no
module-level serving state; the kernels' launch counters are exact under
threads, :mod:`repro_torch.kernels.launches`), so one replica preempting
under memory pressure cannot perturb another.

Fault tolerance (``recover=True``, the default): replication multiplies
failure domains, so a replica death — injected through
:class:`~repro_torch.serving.faults.FaultInjector` or a host-side
exception — must cost only that replica's in-flight KV, never the run.
The recovery ladder:

* **Poison request** — :class:`~repro_torch.serving.engine.RequestTooLarge`
  (a single request that can never fit the pool) evicts *that request*
  (``finish_reason="failed"``) and keeps the replica serving.
* **Replica death** — any other exception quarantines the replica
  (``healthy=False``). Its stream is drained first (under overlap up to
  two steps are in flight), then its queued and in-flight requests are
  stranded (KV lost), reset via the recompute-preemption path
  (``reset_for_requeue``) and *redriven* through the router onto
  survivors, where counter-based sampling regenerates the same tokens.
  Each request carries a ``max_redrives`` budget; exhausting it finishes
  the request ``"failed"``. With ``respawn=True`` the replica is rebuilt
  over the dead engine's pool tensors, graphs and stream, with a fresh
  allocator and prefix index (no new capture, no second pool), and
  rejoins routing.
* **Wedge** — a replica whose step exceeds ``watchdog_s`` (or that has
  not stepped within it, in threaded mode) is marked ``wedged``; new
  arrivals route around it until a fast step self-heals it.
* **Overload** — admission-time shedding (``route_one`` with a clock)
  consults every eligible replica's ``shed_check``; only when *no*
  replica can take the request is it finished ``"shed"``.

A real device fault (an illegal address, say) poisons the CUDA context of
every replica in the process: the recovery ladder covers host-side
exceptions and injected faults only.

``recover=False`` restores fail-fast semantics, but stops promptly: on a
replica error the threaded feeder stops dispatching, signals every
surviving loop via the stop event, stamps still-pending requests
``finish_reason="failed"``, and re-raises the replica's error.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Union

import torch

from repro_torch.core.replication import slice_devices
from repro_torch.models.model import Model
from repro_torch.serving.cluster.metrics import (ClusterMetrics, ReplicaStats,
                                                 aggregate)
from repro_torch.serving.cluster.router import Router, RouterPolicy
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        EngineConfig, RequestTooLarge)
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.metrics import collect_from_engine
from repro_torch.serving.workload import FINISH_FAILED, FINISH_SHED, Request


@dataclasses.dataclass
class Replica:
    """One engine plus its placement and the requests routed to it."""
    idx: int
    engine: ContinuousBatchingEngine
    # its slice of devices when sliced (one device: the engine's)
    devices: Optional[List[torch.device]] = None
    requests: List[Request] = dataclasses.field(default_factory=list)

    # --- fault-tolerance state (cluster-owned) ---
    healthy: bool = True                   # quarantined replicas are skipped
    wedged: bool = False                   # watchdog tripped; route around
    faults: int = 0                        # failures observed (incl. poison)
    error: Optional[BaseException] = None  # what killed it (kept for report)
    failed_at: Optional[float] = None      # run-clock time of quarantine
    downtime: float = 0.0                  # accumulated out-of-service time
    last_step_at: Optional[float] = None   # time.monotonic() of step start

    # --- load view read by router policies (see cluster.router) ---
    @property
    def queue_depth(self) -> int:
        return len(self.engine.waiting)

    @property
    def in_flight(self) -> int:
        # a half-prefilled (chunked) request holds a batch seat and pool
        # blocks just like a decoding one — load policies must see it
        return len(self.engine.running) + len(self.engine.prefilling)

    @property
    def load(self) -> int:
        return self.queue_depth + self.in_flight

    @property
    def kv_load(self) -> float:
        return self.engine.pool.manager.used_fraction

    def device_ctx(self):
        """The replica's card as the calling thread's current device."""
        dev = self.engine.device
        return torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()


class ReplicatedCluster:
    """R independent engines, a request router, and a cluster scheduler."""

    MODES = ("thread", "sync")

    def __init__(self, engines: Sequence[ContinuousBatchingEngine], *,
                 slices: Optional[Sequence[Sequence]] = None,
                 policy: Union[str, RouterPolicy] = "round-robin",
                 mode: str = "thread",
                 faults: Optional[FaultInjector] = None,
                 recover: bool = True,
                 respawn: bool = False,
                 max_redrives: int = 2,
                 watchdog_s: Optional[float] = None):
        if not engines:
            raise ValueError("a cluster needs at least one engine")
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, "
                             f"got {mode!r}")
        if slices is not None and len(slices) != len(engines):
            raise ValueError(f"{len(slices)} device slices for "
                             f"{len(engines)} engines")
        if max_redrives < 0:
            raise ValueError(f"max_redrives must be >= 0, got {max_redrives}")
        if watchdog_s is not None and watchdog_s <= 0:
            raise ValueError(f"watchdog_s must be > 0, got {watchdog_s}")
        self.replicas = [
            Replica(i, eng, list(slices[i]) if slices is not None else None)
            for i, eng in enumerate(engines)]
        self.router = Router(policy, len(engines))
        self.mode = mode
        self.faults = faults
        self.recover = recover
        self.respawn = respawn
        self.max_redrives = max_redrives
        self.watchdog_s = watchdog_s
        for rep in self.replicas:
            rep.engine.replica_id = rep.idx
            if faults is not None:
                rep.engine.faults = faults
        # observability session (serving.obs.Observability): installed by
        # Observability.attach_cluster — None keeps every hook site free
        self.obs = None
        self.queue_samples: List[List[int]] = []
        self._feeding_done = False
        self._errors: List[BaseException] = []
        # --- fault-tolerance bookkeeping ---
        self.redriven = 0              # stranded requests re-admitted
        self.lost = 0                  # finished "failed" (budget spent /
        #                                no survivors / poison)
        self.shed_count = 0            # cluster-admission rejections
        self.shed_reasons: dict = {}
        self.watchdog_trips = 0
        # requests finished by the cluster itself (shed / failed) without
        # ever being owned by a replica — folded into _collect
        self.unserved: List[Request] = []
        self._redrives: dict = {}      # req_id -> redrives consumed
        self._stop = threading.Event()
        self._failed: deque = deque()  # (Replica, exc) awaiting recovery
        self._flock = threading.Lock()
        self._threads: dict = {}       # replica idx -> current Thread
        self._joinable: List[threading.Thread] = []
        # Event-driven wakeups for the threaded mode: replica loops and
        # the feeder sleep on this condition variable when idle and are
        # woken by submit (route_one), failure enqueue, thread exit,
        # feeding-done, and stop — an idle cluster burns no engine steps
        # (see tests/test_overlap.py::test_idle_cluster_burns_no_steps).
        self._work = threading.Condition()

    # ---------------------------------------------------------- builders --
    @classmethod
    def colocated(cls, model: Model, ecfg: EngineConfig, n_replicas: int,
                  **kw) -> "ReplicatedCluster":
        """R replicas on ``model``'s device sharing its weights; each owns
        its KV pool, allocator, step graphs and CUDA stream."""
        engines = [ContinuousBatchingEngine(model, ecfg, device=model.device)
                   for _ in range(n_replicas)]
        return cls(engines, **kw)

    @classmethod
    def sliced(cls, cfg, params, ecfg: EngineConfig,
               devices: Sequence[Union[str, torch.device]], n_replicas: int,
               **kw) -> "ReplicatedCluster":
        """One replica per disjoint slice of ``devices`` (split R ways in
        order, as ``slice_mesh`` splits the data axis), each with its own
        copy of the weights ``params`` (a tree in the reference's layout;
        None draws each copy from seed 0 on its device)."""
        slices = slice_devices(devices, n_replicas)
        engines = []
        for sub in slices:
            if len(sub) != 1:
                raise NotImplementedError(
                    f"a replica over {len(sub)} devices needs the SPMD "
                    f"layer, which is not ported yet (ROADMAP.md, training "
                    f"and SPMD); give one device a replica")
            model = Model(cfg, params, device=sub[0])
            engines.append(ContinuousBatchingEngine(model, ecfg,
                                                    device=sub[0]))
        return cls(engines, slices=slices, **kw)

    # ------------------------------------------------------------- admin --
    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def reset_stats(self):
        """Clear telemetry and routed-request lists (e.g. after warmup).
        Replica health survives — a quarantined replica stays dead unless
        respawned; only the counters restart."""
        for rep in self.replicas:
            rep.engine.reset_stats()
            rep.requests = []
        self.router.reset()
        self.queue_samples = []
        self.redriven = 0
        self.lost = 0
        self.shed_count = 0
        self.shed_reasons = {}
        self.watchdog_trips = 0
        self.unserved = []
        self._redrives = {}

    def _sample_queues(self):
        self.queue_samples.append([rep.queue_depth for rep in self.replicas])
        # queue-depth samples feed the windows layer too, so the live
        # dashboard shows routing imbalance on the same timeline; the SLO
        # monitor is evaluated here so batch cluster runs (driven without
        # the ServingAPI pump) still fire breach/recovery events
        obs = self.obs
        if obs is not None and obs.windows is not None:
            t = obs.trace.now()
            obs.windows.push("cluster_queue_depth", t,
                             sum(q for q in self.queue_samples[-1]))
            if obs.slo is not None:
                obs.slo.evaluate(t)

    def eligible_replicas(self) -> List[Replica]:
        """Replicas new work may be routed to: healthy and not wedged,
        falling back to healthy-but-wedged when that's all that's left
        (a slow replica beats a shed)."""
        out = [r for r in self.replicas if r.healthy and not r.wedged]
        return out or [r for r in self.replicas if r.healthy]

    def route_one(self, req: Request,
                  now: Optional[float] = None) -> Optional[Replica]:
        """Route a single request through the policy and hand it to its
        replica — the one admission path the batch ``run()`` loop, the
        facade's ``submit()``, and failure redrives all go through.

        With a clock (``now``), admission control runs: if *every*
        eligible replica's :meth:`shed_check` rejects, the request is
        finished ``"shed"`` and None is returned (graceful rejection —
        overload never raises). Without a clock (redrives, legacy
        callers) shedding is skipped to maximize completion. Returns
        None — with the request finished ``"failed"`` — when no healthy
        replica remains.
        """
        eligible = self.eligible_replicas()
        if not eligible:
            self._mark_failed(req, now if now is not None else 0.0)
            return None
        rep = eligible[self.router.route(req, eligible)]
        if now is not None:
            reason = rep.engine.shed_check(req, now)
            if reason is not None:
                # the routed pick is saturated; any other replica with
                # headroom beats shedding (load shedding is a last resort)
                rep = next((r for r in eligible if r is not rep
                            and r.engine.shed_check(req, now) is None), None)
                if rep is None:
                    self._shed(req, now, reason)
                    return None
        # enqueue before recording: add_request rejects over-length
        # prompts loudly, and a rejected request must not linger in the
        # replica's stats as a phantom routed-but-never-served entry
        rep.engine.add_request(req)
        rep.requests.append(req)
        self._notify_work()        # wake the replica's (idle) step loop
        return rep

    def _notify_work(self):
        with self._work:
            self._work.notify_all()

    def _idle_wait_s(self) -> float:
        """Cond-var wait backstop. Kept well under ``watchdog_s`` so the
        feeder's wedge detection and arrival dispatch never stall behind
        a sleeping loop (wakeups themselves are event-driven)."""
        if self.watchdog_s is not None:
            return min(0.05, self.watchdog_s / 4)
        return 0.05

    def _dispatch(self, pending: deque, now: float):
        while pending and pending[0].arrival_s <= now:
            self.route_one(pending.popleft(), now=now)

    # ----------------------------------------------------- fault handling --
    def _shed(self, req: Request, now: float, reason: str):
        req.finish_reason = FINISH_SHED
        req.t_done = max(now, req.arrival_s)
        self.unserved.append(req)
        self.shed_count += 1
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1

    def _mark_failed(self, req: Request, now: float):
        req.finish_reason = FINISH_FAILED
        req.t_done = max(now, req.arrival_s)
        self.unserved.append(req)
        self.lost += 1

    def _handle_replica_failure(self, rep: Replica, exc: Exception,
                                now: float):
        """The recovery ladder (see module docstring): poison requests
        are evicted surgically; anything else quarantines the replica,
        strands its requests (KV lost — recompute on survivors), and
        redrives them through the router within the retry budget."""
        rep.faults += 1
        if isinstance(exc, RequestTooLarge):
            # one hopeless request, healthy replica: evict it, keep serving
            if rep.engine.evict_request(exc.req_id, now,
                                        FINISH_FAILED) is not None:
                self.lost += 1
            if self.obs is not None:
                self.obs.replica_event(rep.idx, "evict_poison",
                                       {"req": exc.req_id})
            return
        rep.healthy = False
        rep.wedged = False
        rep.error = exc
        rep.failed_at = now
        if self.obs is not None:
            self.obs.replica_event(rep.idx, "quarantine",
                                   {"error": f"{type(exc).__name__}: {exc}"})
        eng = rep.engine
        # the steps still queued on its stream (two under overlap) write
        # its pool: they finish before its requests are redriven and before
        # a respawn reuses the pool
        drained = _drain(eng)
        # drop any overlapped in-flight step: a stale commit after requeue
        # would double tokens the redrive regenerates elsewhere
        eng._executor.reset()
        # strand in admission order (running were admitted first) so
        # redrives keep FCFS service order on the survivors
        stranded = (list(eng.running) + list(eng.prefilling)
                    + list(eng.waiting))
        eng.running.clear()
        eng.prefilling.clear()
        eng.waiting.clear()
        eng._prefilled.clear()
        for req in stranded:
            if req in rep.requests:
                rep.requests.remove(req)
            # recompute-preemption path: forget in-flight output so
            # re-admission regenerates it (bit-identical under the
            # counter-based sampler)
            req.state.reset_for_requeue()
        if self.respawn and drained:
            self._respawn(rep, now)
        for req in stranded:
            n = self._redrives.get(req.req_id, 0)
            if n >= self.max_redrives:
                # a request that keeps killing replicas (or keeps landing
                # on dying ones) burns its budget and fails alone
                self._mark_failed(req, now)
                continue
            if not any(r.healthy for r in self.replicas):
                self._mark_failed(req, now)
                continue
            self._redrives[req.req_id] = n + 1
            tgt = self.route_one(req)
            if tgt is not None:
                self.redriven += 1
                if self.obs is not None:
                    self.obs.replica_event(
                        tgt.idx, "redrive",
                        {"req": req.req_id, "from": rep.idx})

    def _respawn(self, rep: Replica, now: float):
        """Rebuild a dead replica over its engine's pool tensors, step
        graphs and stream (drained), with a fresh allocator and prefix
        index — no capture, no second pool — and return it to routing."""
        old = rep.engine
        with rep.device_ctx():
            eng = ContinuousBatchingEngine(old.model, old.ecfg,
                                           device=old.device,
                                           steps=old.steps)
        eng.clock = old.clock
        eng.faults = old.faults
        eng.replica_id = old.replica_id
        if self.obs is not None:
            # the fresh engine rejoins the same observer (same trace rows)
            self.obs.attach(eng, rep.idx)
            self.obs.replica_event(rep.idx, "respawn")
        rep.engine = eng
        rep.healthy = True
        rep.error = None
        if rep.failed_at is not None:
            rep.downtime += max(0.0, now - rep.failed_at)
            rep.failed_at = None

    def _step_replica(self, rep: Replica, now: float) -> bool:
        """One engine step with watchdog accounting: a step exceeding
        ``watchdog_s`` marks the replica wedged (new arrivals route
        around it); a fast step self-heals it. ``last_step_at`` is
        stamped at step *start* so the threaded feeder can detect a
        replica stuck inside a step."""
        rep.last_step_at = time.monotonic()
        busy = rep.engine.step(now)
        if self.watchdog_s is not None:
            if time.monotonic() - rep.last_step_at > self.watchdog_s:
                if not rep.wedged:
                    rep.wedged = True
                    self.watchdog_trips += 1
                    if self.obs is not None:
                        self.obs.replica_event(rep.idx, "watchdog_wedged")
            elif rep.wedged:
                rep.wedged = False
                if self.obs is not None:
                    self.obs.replica_event(rep.idx, "watchdog_healed")
        return busy

    def _check_watchdog(self):
        """Feeder-side wedge detection (threaded mode): a busy replica
        that hasn't *started* a step within ``watchdog_s`` is stuck
        inside one (or its thread is starved) — route around it."""
        if self.watchdog_s is None:
            return
        wall = time.monotonic()
        for rep in self.replicas:
            if rep.healthy and not rep.wedged and rep.engine.busy \
                    and rep.last_step_at is not None \
                    and wall - rep.last_step_at > self.watchdog_s:
                rep.wedged = True
                self.watchdog_trips += 1
                if self.obs is not None:
                    self.obs.replica_event(rep.idx, "watchdog_wedged")

    def _fail_stranded(self, pending: deque, now: float):
        """Fail-fast path (``recover=False``): stamp every request that
        will now never be served with an explicit terminal reason so
        callers holding handles see ``"failed"``, not silence."""
        while pending:
            self._mark_failed(pending.popleft(), now)
        for rep in self.replicas:
            eng = rep.engine
            for req in (list(eng.running) + list(eng.prefilling)
                        + list(eng.waiting)):
                req.finish_reason = FINISH_FAILED
                req.t_done = max(now, req.arrival_s)
                self.lost += 1

    # --------------------------------------------------------------- run --
    def run(self, requests: Sequence[Request]) -> ClusterMetrics:
        """Batch-offline wrapper over the streaming facade
        (:class:`repro_torch.serving.api.ServingAPI`); online callers
        submit, stream and abort through the facade instead."""
        from repro_torch.serving.api import ServingAPI
        return ServingAPI(self).run(requests)

    def _run_impl(self, requests: Sequence[Request]) -> ClusterMetrics:
        """Serve ``requests`` to completion and return aggregate metrics.

        Requests are routed at their arrival time (so queue-aware policies
        see live load, not the t=0 snapshot). Telemetry accumulates across
        runs like the engine's — call :meth:`reset_stats` after a warmup.
        Every replica's wall clock is restored on exit so a later run (or
        facade-driven stepping) never stamps against this run's epoch.
        """
        pending = deque(sorted(requests, key=lambda r: r.arrival_s))
        t0 = time.perf_counter()
        clock = lambda: time.perf_counter() - t0          # noqa: E731
        prev_clocks = [rep.engine.clock for rep in self.replicas]
        for rep in self.replicas:
            rep.engine.clock = clock
        try:
            if self.mode == "sync":
                self._run_sync(pending, clock)
            else:
                self._run_threaded(pending, clock)
            wall = clock()
        finally:
            for rep, prev in zip(self.replicas, prev_clocks):
                rep.engine.clock = prev
        return self._collect(requests, wall)

    def _run_sync(self, pending: deque, clock: Callable[[], float]):
        """Single-threaded interleaving: route, then step each busy
        replica once per round. Idle gaps before the next arrival are
        fast-forwarded instead of slept through. Deterministic whenever
        every request is pending from t=0 (offline workloads); timed
        arrivals are dispatched against the wall clock. Replica failures
        are recovered inline (quarantine + redrive) when ``recover``."""
        now = 0.0
        while pending or any(r.engine.busy for r in self.replicas):
            if not any(r.healthy for r in self.replicas):
                # whole cluster down: everything still queued is lost
                while pending:
                    self._mark_failed(pending.popleft(), now)
                break
            if pending and not any(r.engine.busy for r in self.replicas):
                now = max(now, pending[0].arrival_s)
            self._dispatch(pending, now)
            for rep in self.replicas:
                if rep.healthy and rep.engine.busy:
                    try:
                        self._step_replica(rep, now)
                    except Exception as e:
                        if not self.recover:
                            raise
                        self._handle_replica_failure(rep, e, now)
            self._sample_queues()
            now = max(now, clock())     # monotonic across idle jumps

    def _run_threaded(self, pending: deque, clock: Callable[[], float]):
        """Thread-per-replica stepping; the main thread plays arrivals in
        wall-clock time through the router, services replica failures
        (quarantine + redrive happen on *this* thread — replica loops
        never touch each other's engines), and runs the watchdog.

        On an unrecoverable error the feeder stops dispatching
        immediately, signals every surviving loop through the stop event
        (no drain spin), stamps still-pending requests ``"failed"``, and
        re-raises."""
        self._feeding_done = False
        self._stop.clear()
        self._errors = []
        self._failed.clear()
        self._threads = {}
        self._joinable = []
        # the requests already arrived (an offline workload: all of them)
        # are routed before any replica loop starts, so each replica's
        # first step admits its whole share as in sync mode: its batches,
        # and so its tokens' bits, do not depend on which thread runs first
        self._dispatch(pending, clock())
        for rep in self.replicas:
            if rep.healthy:
                self._start_thread(rep)
        try:
            while True:
                now = clock()
                self._service_failures(now)
                self._check_watchdog()
                if self._errors:
                    break
                if pending:
                    if not any(r.healthy for r in self.replicas):
                        while pending:
                            self._mark_failed(pending.popleft(), now)
                    elif pending[0].arrival_s > now:
                        # cond wait, not sleep: a failure/finish event
                        # wakes the feeder before the arrival timer does
                        with self._work:
                            self._work.wait(timeout=min(
                                pending[0].arrival_s - now,
                                self._idle_wait_s()))
                    else:
                        self._dispatch(pending, now)
                self._sample_queues()
                if not pending:
                    self._feeding_done = True
                    self._notify_work()   # idle loops may now exit
                    if all(not t.is_alive()
                           for t in self._threads.values()):
                        # late failures may still be queued; servicing
                        # them can redrive work and restart threads
                        self._service_failures(clock())
                        if not self._failed and \
                                all(not t.is_alive()
                                    for t in self._threads.values()):
                            break
                    with self._work:
                        if any(t.is_alive()
                               for t in self._threads.values()) \
                                and not self._failed:
                            self._work.wait(timeout=self._idle_wait_s())
        finally:
            self._feeding_done = True
            self._stop.set()
            self._notify_work()
            for t in self._joinable:
                t.join()
        if self._errors:
            self._fail_stranded(pending, clock())
            raise self._errors[0]

    def _start_thread(self, rep: Replica):
        t = threading.Thread(target=self._replica_loop, args=(rep,),
                             name=f"replica-{rep.idx}", daemon=True)
        self._threads[rep.idx] = t
        self._joinable.append(t)
        t.start()

    def _ensure_thread(self, rep: Replica):
        t = self._threads.get(rep.idx)
        if t is None or not t.is_alive():
            self._start_thread(rep)

    def _service_failures(self, now: float):
        """Drain the failure queue (filled by dying replica loops) and
        recover each on the feeder thread; redrives may target replicas
        whose loops already exited idle, and a respawned (or
        poison-evicted) replica needs its loop back — restart those."""
        serviced = False
        while True:
            with self._flock:
                if not self._failed:
                    break
                rep, exc = self._failed.popleft()
            serviced = True
            self._handle_replica_failure(rep, exc, now)
        if serviced and not self._stop.is_set():
            for rep in self.replicas:
                if rep.healthy and rep.engine.busy:
                    self._ensure_thread(rep)

    def _replica_loop(self, rep: Replica):
        """Step while busy; otherwise park on the work condition variable
        until a submit/failure/stop event (or the backstop timeout) —
        an idle replica burns **no** engine steps, so ``step_count``
        measures work, not polling."""
        clock = rep.engine.clock
        try:
            with rep.device_ctx():
                while not self._stop.is_set():
                    if rep.engine.busy:
                        self._step_replica(rep, clock())
                        continue
                    if self._feeding_done:
                        return
                    with self._work:
                        if not rep.engine.busy and not self._feeding_done \
                                and not self._stop.is_set():
                            self._work.wait(timeout=self._idle_wait_s())
        except Exception as e:
            if self.recover:
                # hand off to the feeder thread — recovery must never
                # mutate other replicas from a dying loop
                with self._flock:
                    self._failed.append((rep, e))
            else:
                self._errors.append(e)
        except BaseException as e:          # KeyboardInterrupt etc.
            self._errors.append(e)
        finally:
            # the feeder may be waiting on thread exit or a failure
            # hand-off; wake it regardless of how this loop ended
            self._notify_work()

    # ----------------------------------------------------------- metrics --
    def _availability(self, rep: Replica, wall: float) -> float:
        down = rep.downtime
        if rep.failed_at is not None:
            down += max(0.0, wall - rep.failed_at)
        if wall <= 0:
            return 1.0 if rep.healthy else 0.0
        return max(0.0, 1.0 - down / wall)

    def _collect(self, requests: Sequence[Request],
                 wall: float) -> ClusterMetrics:
        per_replica, itl_all = [], []
        for rep in self.replicas:
            eng = rep.engine
            m = collect_from_engine(eng, rep.requests, wall)
            busy = sum(eng.itl_samples) / max(wall, 1e-9)
            qmax = max((q[rep.idx] for q in self.queue_samples), default=0)
            per_replica.append(ReplicaStats(
                replica=rep.idx, n_requests=len(rep.requests),
                completed=m.n_completed, preemptions=eng.preemptions,
                busy_fraction=busy,
                occupancy=m.avg_batch / eng.ecfg.max_batch,
                max_queue_depth=qmax, metrics=m,
                healthy=rep.healthy, faults=rep.faults,
                availability=self._availability(rep, wall)))
            itl_all.extend(eng.itl_samples)
        # latency percentiles cover *served* requests only: shed/failed
        # requests finish at ~0 E2E and would drag the tails down
        done = [r for r in requests if r.t_done is not None
                and r.finish_reason not in (FINISH_SHED, FINISH_FAILED)]
        metrics = aggregate(
            per_replica, wall_s=wall, policy=self.router.policy.name,
            mode=self.mode,
            ttft_samples=[r.t_first_token - r.arrival_s for r in done
                          if r.t_first_token is not None],
            itl_samples=itl_all,
            e2e_samples=[r.t_done - r.arrival_s for r in done],
            queue_samples=self.queue_samples,
            redriven=self.redriven, lost=self.lost, shed=self.shed_count,
            watchdog_trips=self.watchdog_trips)
        # requests the cluster finished without any replica owning them
        # (shed at admission, failed with no survivors) still count
        ids = {id(r) for r in requests}
        for r in self.unserved:
            if id(r) in ids:
                metrics.completed += 1
                metrics.finish_reasons[r.finish_reason] = \
                    metrics.finish_reasons.get(r.finish_reason, 0) + 1
        return metrics


def _drain(eng: ContinuousBatchingEngine) -> bool:
    """Wait for the work queued on ``eng``'s stream; False when that
    raises (a device fault: the CUDA context is lost, nothing is reused)."""
    if eng.stream is None:
        return True
    try:
        eng.stream.synchronize()
    except RuntimeError:
        return False
    return True
