"""Online serving facade: submit / stream / abort / drain (the port of
``repro.serving.api``).

The engine and cluster are step machines — they expose ``step(now)`` and
mutate request state in place. This module is the *request-level* API on
top: results flow back as incremental :class:`GenerationOutput` events
while the work is still in flight, instead of only after a batch
``run()`` returns. One facade class wraps both backends:

* a single :class:`~repro_torch.serving.engine.ContinuousBatchingEngine`,
  or
* a :class:`~repro_torch.serving.cluster.ReplicatedCluster` —
  ``submit()`` is router-aware (the cluster's policy picks the replica at
  submit time) and ``stream()`` pumps every busy replica, so one
  generator serves requests regardless of which replica they landed on.

Verbs:

* :meth:`ServingAPI.submit` — enqueue a prompt (or a prebuilt
  :class:`~repro_torch.serving.workload.Request`), get a
  :class:`RequestHandle` back immediately.
* :meth:`ServingAPI.stream` — generator yielding one
  :class:`GenerationOutput` per scheduling round that produced tokens
  for the handle (token *deltas* plus the cumulative ids); the final
  event carries ``finished=True`` and a ``finish_reason``.
* :meth:`ServingAPI.abort` — cancel mid-flight in any phase (queued,
  PREFILLING, decoding): KV blocks are reclaimed immediately (shared
  prefix blocks drop back to their cache refcount) and the stream ends
  with ``finish_reason="abort"``.
* :meth:`ServingAPI.drain` — run everything in flight to completion and
  return the final outputs; :meth:`ServingAPI.metrics` summarizes the
  session.

Stepping is cooperative: ``stream()``/``drain()`` drive the backend's
scheduling loop from the calling thread (one mixed
admission+prefill+decode round per pump), so streaming adds no thread
machinery and stays deterministic. ``engine.run()`` and ``cluster.run()``
are thin wrappers over :meth:`ServingAPI.run`, which keeps the
batch-offline loop (arrival fast-forwarding included, never past a
prompt still being prefilled) and restores the backend's wall clock on
exit.

:class:`AsyncServingAPI` runs the same pump on a thread of its own. On
the card each engine queues its work on its own CUDA stream, and a
bucket's first step captures its CUDA graph on whichever thread steps it
(:mod:`repro_torch.serving.steps`), the pump thread included; closing the
facade joins the thread and then waits for every engine's stream, so the
caller may free the engines' graphs as soon as ``close``/``aclose``
returns.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import threading
import time
from typing import (AsyncIterator, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.serving.cluster.cluster import ReplicatedCluster
from repro_torch.serving.cluster.metrics import ClusterMetrics
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.metrics import ServingMetrics, collect_from_engine
from repro_torch.serving.workload import (FINISH_ABORT, Request,
                                          SamplingParams)


@dataclasses.dataclass(frozen=True)
class GenerationOutput:
    """One streaming event for one request.

    ``new_token_ids`` is the delta since the previous event for the same
    handle; ``token_ids`` the cumulative output so far. The last event
    has ``finished=True`` and a non-None ``finish_reason`` (``length`` /
    ``stop`` / ``abort`` / ``deadline`` / ``shed`` / ``failed``); an
    abort — or a deadline expiry, or an admission-control rejection —
    that produced no new tokens still emits a final event with an empty
    delta, so every handle's stream terminates explicitly.
    """
    req_id: int
    new_token_ids: Tuple[int, ...]
    token_ids: Tuple[int, ...]
    finished: bool
    finish_reason: Optional[str] = None


class RequestHandle:
    """Caller-side view of one submitted request (event cursor included).

    A preempted request's output may transiently shrink (recompute-style
    preemption clears it); the handle keeps its own copy of everything
    already emitted, and because decode is deterministic per request
    (greedy or counter-based sampling) the regenerated tokens match that
    history — consumers never see a contradiction, even if the request is
    aborted before the recompute catches back up (the final event then
    reports the emitted history, not the engine's shorter reset state).
    """

    def __init__(self, request: Request):
        self.request = request
        self._seen: List[int] = []     # tokens already emitted, in order
        self._final_sent = False

    @property
    def req_id(self) -> int:
        return self.request.req_id

    @property
    def done(self) -> bool:
        return self.request.state.t_done is not None

    @property
    def finish_reason(self) -> Optional[str]:
        return self.request.state.finish_reason

    def _take_delta(self) -> List[int]:
        """Fold the engine's current output into the emitted history and
        return the new tokens (empty while a preempted request's
        recompute is still behind the history)."""
        toks = self.request.state.output_tokens
        delta = toks[len(self._seen):]
        self._seen.extend(delta)
        return delta

    def _event(self, delta: List[int], fin: bool) -> GenerationOutput:
        if fin:
            self._final_sent = True
        return GenerationOutput(
            req_id=self.req_id, new_token_ids=tuple(delta),
            token_ids=tuple(self._seen), finished=fin,
            finish_reason=self.finish_reason if fin else None)

    def _next_event(self) -> Optional[GenerationOutput]:
        delta = self._take_delta()
        fin = self.done
        if not delta and not (fin and not self._final_sent):
            return None
        return self._event(delta, fin)

    def final_output(self) -> GenerationOutput:
        """Cumulative view (marks everything emitted)."""
        return self._event(self._take_delta(), self.done)


class _EngineBackend:
    """Facade adapter for a single engine."""

    def __init__(self, engine: ContinuousBatchingEngine):
        self.engine = engine

    @property
    def busy(self) -> bool:
        return self.engine.busy

    def enqueue(self, req: Request, now: float):
        # no routing decision to defer: the engine's own admission loop
        # already waits for arrival_s. Admission control may shed — the
        # request then comes back already finished ("shed"), never an
        # exception; with all shedding knobs off this is add_request
        self.engine.try_add_request(req, now)

    def forget(self, req: Request):
        """Nothing request-scoped survives a finish in the engine."""

    def abort(self, req_id: int, now: float) -> bool:
        return self.engine.abort(req_id, now)

    def next_arrival_if_idle(self) -> Optional[float]:
        """Arrival time to fast-forward to when nothing is in flight but
        requests are queued for the (possibly simulated) future — the
        facade folds it into its monotonic timeline so later timestamps
        never land behind the jump."""
        eng = self.engine
        if not eng.running and not eng.prefilling and eng.waiting:
            return eng.waiting[0].arrival_s
        return None

    def pump(self, now: float, clock=None) -> bool:
        """One scheduling round; returns whether work remains. ``clock``
        (the facade session clock) is installed for the step so mid-step
        timestamps (TTFT after a long prefill) have run() fidelity, and
        restored afterwards."""
        eng = self.engine
        if not eng.busy:
            return False
        ff = self.next_arrival_if_idle()
        if ff is not None:
            now = max(now, ff)
        prev = eng.clock
        if clock is not None:
            eng.clock = clock
        try:
            eng.step(now)
        finally:
            eng.clock = prev
        return eng.busy

    def run(self, requests: Sequence[Request]) -> ServingMetrics:
        """The legacy batch-offline loop (engine.run's former body), with
        the wall clock saved and restored around it — a second run, or
        facade-driven stepping after one, stamps against its own epoch
        instead of this run's stale t_start."""
        eng = self.engine
        for r in requests:
            eng.add_request(r)
        prev_clock = eng.clock
        t_start = time.perf_counter()
        eng.clock = lambda: time.perf_counter() - t_start
        try:
            now = 0.0
            while eng.busy:
                if not eng.running and not eng.prefilling and eng.waiting:
                    now = max(now, eng.waiting[0].arrival_s)
                eng.step(now)
                # keep `now` monotonic across fast-forward jumps so t_done
                # never lands behind the arrival time it was admitted at
                now = max(now, time.perf_counter() - t_start)
            wall = time.perf_counter() - t_start
        finally:
            eng.clock = prev_clock
        return self.collect(requests, wall)

    def collect(self, requests: Sequence[Request],
                wall: float) -> ServingMetrics:
        return collect_from_engine(self.engine, requests, wall)


class _ClusterBackend:
    """Facade adapter for a replicated cluster: router-aware submit,
    step-all-busy-replicas pump, abort lookup across replicas.

    A request whose ``arrival_s`` is still in the future is *not* routed
    at submit time — it waits in a facade-side pending queue and goes
    through the policy when its arrival comes, so queue-aware policies
    (jsq / least-kv / prefix-affinity) see live replica load exactly like
    the batch ``run()`` dispatch loop, not a t=0 snapshot.
    """

    def __init__(self, cluster: ReplicatedCluster):
        self.cluster = cluster
        self.pending: List[Request] = []      # sorted by arrival_s
        # aborted before ever being routed: no replica's request list
        # holds them, so session metrics must fold them in explicitly
        self.aborted_unrouted: List[Request] = []

    @property
    def busy(self) -> bool:
        return bool(self.pending) \
            or any(rep.engine.busy for rep in self.cluster.replicas)

    def enqueue(self, req: Request, now: float):
        if req.arrival_s <= now:
            # routed admission: may shed (request comes back finished
            # "shed") or fail (no healthy replica) — never raises
            self.cluster.route_one(req, now=now)
            return
        i = len(self.pending)
        while i > 0 and self.pending[i - 1].arrival_s > req.arrival_s:
            i -= 1
        self.pending.insert(i, req)

    def _dispatch_pending(self, now: float):
        while self.pending and self.pending[0].arrival_s <= now:
            self.cluster.route_one(self.pending.pop(0), now=now)

    def forget(self, req: Request):
        """Drop a released request from its replica's routed list (or the
        unrouted-abort / cluster-unserved lists) so the per-replica stats
        and retained memory match the facade's registry."""
        if req in self.aborted_unrouted:
            self.aborted_unrouted.remove(req)
            return
        if req in self.cluster.unserved:
            self.cluster.unserved.remove(req)
            return
        for rep in self.cluster.replicas:
            if req in rep.requests:
                rep.requests.remove(req)
                return

    def abort(self, req_id: int, now: float) -> bool:
        for i, r in enumerate(self.pending):
            if r.req_id == req_id:
                # not routed yet: nothing allocated anywhere — just stamp
                self.pending.pop(i)
                r.state.finish_reason = FINISH_ABORT
                r.state.t_done = max(now, r.arrival_s)
                self.aborted_unrouted.append(r)
                return True
        return any(rep.engine.abort(req_id, now)
                   for rep in self.cluster.replicas)

    def next_arrival_if_idle(self) -> Optional[float]:
        c = self.cluster
        if any(rep.engine.running or rep.engine.prefilling
               for rep in c.replicas):
            return None
        heads = [rep.engine.waiting[0].arrival_s
                 for rep in c.replicas if rep.engine.waiting]
        if self.pending:
            heads.append(self.pending[0].arrival_s)
        return min(heads) if heads else None

    def pump(self, now: float, clock=None) -> bool:
        c = self.cluster
        if not self.busy:
            return False
        ff = self.next_arrival_if_idle()
        if ff is not None:
            now = max(now, ff)
        self._dispatch_pending(now)
        prev = [rep.engine.clock for rep in c.replicas]
        if clock is not None:
            for rep in c.replicas:
                rep.engine.clock = clock
        try:
            for rep in c.replicas:
                if rep.healthy and rep.engine.busy:
                    try:
                        c._step_replica(rep, now)
                    except Exception as e:
                        if not c.recover:
                            raise
                        # same recovery ladder as the run() loops:
                        # quarantine + redrive onto survivors (handles
                        # streamed through the facade keep their emitted
                        # history; redriven decode regenerates it)
                        c._handle_replica_failure(rep, e, now)
        finally:
            for rep, p in zip(c.replicas, prev):
                rep.engine.clock = p
        c._sample_queues()
        return self.busy

    def run(self, requests: Sequence[Request]) -> ClusterMetrics:
        return self.cluster._run_impl(requests)

    def collect(self, requests: Sequence[Request],
                wall: float) -> ClusterMetrics:
        m = self.cluster._collect(list(requests), wall)
        # per-replica aggregation can't see never-routed aborts; fold
        # them in so the engine- and cluster-backed facades agree
        reqs = set(id(r) for r in requests)
        extra = sum(1 for r in self.aborted_unrouted if id(r) in reqs)
        if extra:
            m.completed += extra
            m.finish_reasons[FINISH_ABORT] = \
                m.finish_reasons.get(FINISH_ABORT, 0) + extra
        return m


class ServingAPI:
    """The online frontend over an engine or a ReplicatedCluster."""

    def __init__(self, backend: Union[ContinuousBatchingEngine,
                                      ReplicatedCluster], *,
                 obs=None, emitter=None, dashboard=None):
        """``obs`` (a :class:`~repro_torch.serving.obs.Observability`) attaches
        runtime observability to the wrapped backend — roofline
        attribution, lifecycle tracing, memory-gap auditing — for this
        session; ``emitter`` (a
        :class:`~repro_torch.serving.obs.MetricsEmitter`) is ticked once per
        scheduling round on the serving timeline, so a streamed session
        emits periodic metrics snapshots without its own timer thread;
        ``dashboard`` (a :class:`~repro_torch.serving.obs.Dashboard`) is ticked
        on the same cadence. When ``obs`` carries an SLO monitor it is
        evaluated every pump, so breach/recovery events land within one
        scheduling round of the window that trips them."""
        if isinstance(backend, ReplicatedCluster):
            self._backend = _ClusterBackend(backend)
        elif isinstance(backend, ContinuousBatchingEngine):
            self._backend = _EngineBackend(backend)
        else:
            raise TypeError(
                f"ServingAPI wraps a ContinuousBatchingEngine or a "
                f"ReplicatedCluster, got {type(backend).__name__}")
        self.backend = backend
        self.obs = obs
        if obs is not None:
            obs.attach_backend(backend)
        self.emitter = emitter
        self.dashboard = dashboard
        self._handles: Dict[int, RequestHandle] = {}
        self._submitted: List[Request] = []
        self._next_id = 0
        self._t0 = time.perf_counter()
        self._now_floor = 0.0      # monotonic serving-timeline watermark
        self._first_submit: Optional[float] = None   # metrics wall anchor

    # ----------------------------------------------------------- clock --
    def _clock(self) -> float:
        """Raw seconds since the facade session started (the wall the
        engine stamps mid-step timestamps against)."""
        return time.perf_counter() - self._t0

    def _now(self) -> float:
        """The session's serving timeline: the wall clock, floored by any
        simulated-arrival fast-forward a pump has taken. Monotonic, so a
        request admitted at a fast-forwarded ``arrival_s`` can never get
        a ``t_done`` (or abort stamp) behind it — the same guard the
        batch run() loop keeps with ``now = max(now, wall)``."""
        self._now_floor = max(self._now_floor, self._clock())
        return self._now_floor

    def _pump_once(self) -> bool:
        ff = self._backend.next_arrival_if_idle()
        if ff is not None:
            self._now_floor = max(self._now_floor, ff)
        busy = self._backend.pump(self._now(), self._clock)
        if self.emitter is not None:
            self.emitter.tick(self._now(), self.metrics)
        if self.obs is not None and self.obs.slo is not None:
            # tracer timeline: the observers' window pushes use it
            self.obs.slo.evaluate(self.obs.trace.now())
        if self.dashboard is not None:
            self.dashboard.tick(self._now())
        return busy

    # ---------------------------------------------------------- submit --
    def submit(self, prompt, sampling: Optional[SamplingParams] = None, *,
               arrival_s: Optional[float] = None) -> RequestHandle:
        """Enqueue one request; returns immediately with its handle.

        ``prompt`` is either a prebuilt :class:`Request` (its
        ``sampling`` wins; passing ``sampling=`` too is an error) or raw
        token ids (list / ndarray), in which case a fresh req_id is
        assigned and ``arrival_s`` defaults to the submit time on the
        facade clock. With a cluster backend the router policy picks the
        replica here, seeing live replica load.
        """
        if isinstance(prompt, Request):
            if sampling is not None:
                raise ValueError("pass sampling on the Request, not both")
            if arrival_s is not None:
                raise ValueError(
                    "arrival_s is frozen on a prebuilt Request; pass it "
                    "at Request construction, not to submit()")
            req = prompt
        else:
            while self._next_id in self._handles:
                self._next_id += 1
            req = Request(
                req_id=self._next_id,
                prompt=np.asarray(prompt, np.int32).reshape(-1),
                arrival_s=self._now() if arrival_s is None else arrival_s,
                sampling=sampling or SamplingParams())
        if req.req_id in self._handles:
            raise ValueError(f"req_id {req.req_id} already submitted")
        if self._first_submit is None:
            self._first_submit = self._now()
        self._backend.enqueue(req, self._now())
        handle = RequestHandle(req)
        self._handles[req.req_id] = handle
        self._submitted.append(req)
        return handle

    # ---------------------------------------------------------- stream --
    def stream(self, handle: RequestHandle) -> Iterator[GenerationOutput]:
        """Yield ``GenerationOutput`` events for ``handle`` as scheduling
        rounds complete, driving the backend from the calling thread.
        Other in-flight requests progress on the same rounds — their
        handles can be streamed afterwards (or drained) without losing
        anything. Terminates after the ``finished=True`` event."""
        while True:
            ev = handle._next_event()
            if ev is not None:
                yield ev
                if ev.finished:
                    return
                continue
            if handle.done:
                return                      # final event already consumed
            if not self._pump_once() and not handle.done \
                    and len(handle.request.state.output_tokens) \
                    <= len(handle._seen):
                raise RuntimeError(
                    f"request {handle.req_id} cannot make progress: the "
                    f"backend is idle but the request never finished")

    def generate(self, prompt, sampling: Optional[SamplingParams] = None
                 ) -> GenerationOutput:
        """Submit + stream to completion; returns the final event."""
        handle = self.submit(prompt, sampling)
        out: Optional[GenerationOutput] = None
        for out in self.stream(handle):
            pass
        assert out is not None and out.finished
        return out

    # ----------------------------------------------------------- abort --
    def abort(self, handle: Union[RequestHandle, int]) -> bool:
        """Cancel a request mid-flight (any phase). KV blocks and
        prefix-cache pins are reclaimed immediately; the handle's stream
        ends with a ``finish_reason="abort"`` event. Returns False when
        the request already finished (or was never submitted)."""
        rid = handle.req_id if isinstance(handle, RequestHandle) \
            else int(handle)
        return self._backend.abort(rid, self._now())

    # ----------------------------------------------------------- drain --
    def drain(self) -> Dict[int, GenerationOutput]:
        """Run everything in flight to completion; returns the final
        cumulative output per req_id (aborted requests included, with
        their partial tokens and ``finish_reason="abort"``)."""
        while self._pump_once():
            pass
        return {rid: h.final_output() for rid, h in self._handles.items()}

    def release(self, handle: Union[RequestHandle, int]) -> bool:
        """Forget a *finished* handle: drop it (and its request) from the
        session registry so a long-lived service doesn't accumulate every
        prompt and output ever served. Released requests leave
        :meth:`metrics` and later :meth:`drain` results. Returns False
        if the handle is unknown or still in flight."""
        rid = handle.req_id if isinstance(handle, RequestHandle) \
            else int(handle)
        h = self._handles.get(rid)
        if h is None or not h.done:
            return False
        del self._handles[rid]
        self._submitted.remove(h.request)
        self._backend.forget(h.request)
        return True

    def metrics(self) -> Union[ServingMetrics, ClusterMetrics]:
        """Session metrics over every request submitted through the
        facade (and not yet released). ``wall_s`` runs on the session
        *serving timeline*, anchored at the first submit — idle time
        before serving never deflates throughput, but simulated-arrival
        fast-forward jumps DO count (unlike ``run()``, whose wall is
        real elapsed time only): online submits arrive "now", so the two
        only diverge for workloads replayed with future ``arrival_s``."""
        wall = max(self._now() - (self._first_submit or 0.0), 0.0)
        return self._backend.collect(self._submitted, wall)

    # ------------------------------------------------------ batch compat --
    def run(self, requests: Sequence[Request]
            ) -> Union[ServingMetrics, ClusterMetrics]:
        """The legacy batch-offline entry point ``engine.run()`` /
        ``cluster.run()`` delegate to: serve ``requests`` to completion
        (arrival fast-forwarding, unchanged scheduling order) and collect
        metrics. Streaming handles are not created — use
        :meth:`submit`/:meth:`drain` for the event-based flow."""
        return self._backend.run(requests)


class AsyncRequestHandle:
    """Caller-side view of one request submitted through
    :class:`AsyncServingAPI`. Events arrive on a private asyncio queue
    fed by the pump thread; :meth:`AsyncServingAPI.stream` reads it."""

    def __init__(self, handle: RequestHandle, queue: "asyncio.Queue",
                 loop: "asyncio.AbstractEventLoop"):
        self.handle = handle
        self._queue = queue
        self._loop = loop

    @property
    def req_id(self) -> int:
        return self.handle.req_id

    @property
    def request(self) -> Request:
        return self.handle.request


class AsyncServingAPI:
    """Genuinely concurrent asyncio front-end over an engine or cluster.

    Unlike :class:`ServingAPI` — whose ``stream()``/``drain()`` pump the
    backend cooperatively from the *calling* thread — this class owns a
    single background **pump thread** that is the only code ever touching
    the backend. Coroutines interact through two thread-safe channels:

    * a **mailbox** of commands (submit / abort / metrics / drain), each
      paired with a ``concurrent.futures.Future`` the caller awaits via
      :func:`asyncio.wrap_future`;
    * per-request **asyncio queues**: after every scheduling round the
      pump thread folds each handle's new tokens into
      :class:`GenerationOutput` events and posts them onto the
      submitting coroutine's loop with ``loop.call_soon_threadsafe`` —
      detokenization/stream fan-out thus never blocks the step loop and
      many ``async for`` consumers stream concurrently.

    The pump thread sleeps on a condition variable while idle (no busy
    work, empty mailbox) and is woken by submit/abort/drain/close, so an
    idle async facade burns no CPU and no engine steps. Scheduling order
    — and therefore output content — is identical to the sync facade:
    the same ``_pump_once`` runs, just on a dedicated thread.

    Works with both sync and overlapped (``EngineConfig.overlap=True``)
    engines. Use as an async context manager, or call :meth:`aclose`
    explicitly; the sync :class:`ServingAPI` is untouched and remains
    the right tool for single-threaded deterministic tests.
    """

    _IDLE_WAIT_S = 0.1          # cond-var backstop; wakeups are event-driven

    def __init__(self, backend: Union[ContinuousBatchingEngine,
                                      ReplicatedCluster], *,
                 obs=None, emitter=None, dashboard=None):
        self._api = ServingAPI(backend, obs=obs, emitter=emitter,
                               dashboard=dashboard)
        self.backend = backend
        self._lock = threading.Condition()
        self._mailbox: List[Tuple[object, concurrent.futures.Future]] = []
        self._drain_waiters: List[concurrent.futures.Future] = []
        self._streams: Dict[int, AsyncRequestHandle] = {}
        self._stop = False
        self._fail: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._pump_loop, name="async-serving-pump", daemon=True)
        self._thread.start()

    # ------------------------------------------------- pump-thread side --
    def _pump_loop(self):
        api = self._api
        while True:
            with self._lock:
                while (not self._mailbox and not self._stop
                       and not self._drain_waiters
                       and not api._backend.busy):
                    self._lock.wait(timeout=self._IDLE_WAIT_S)
                cmds, self._mailbox = self._mailbox, []
                stopping = self._stop
            for fn, fut in cmds:
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(fn())
                except BaseException as e:   # delivered to the awaiter
                    fut.set_exception(e)
            if stopping:
                self._resolve_drains(final=True)
                return
            if api._backend.busy:
                try:
                    api._pump_once()
                except BaseException as e:
                    self._broadcast_failure(e)
                    return
            self._fan_out()
            if not api._backend.busy:
                self._resolve_drains(final=False)

    def _fan_out(self):
        """Post new events for every live stream onto its owner loop."""
        done: List[int] = []
        for rid, ah in self._streams.items():
            h = self._api._handles.get(rid)
            if h is None:
                done.append(rid)
                continue
            while True:
                ev = h._next_event()
                if ev is None:
                    break
                ah._loop.call_soon_threadsafe(ah._queue.put_nowait, ev)
                if ev.finished:
                    done.append(rid)
                    break
        for rid in done:
            self._streams.pop(rid, None)

    def _resolve_drains(self, *, final: bool):
        with self._lock:
            waiters, self._drain_waiters = self._drain_waiters, []
        if not waiters:
            return
        if final:
            for f in waiters:
                f.cancel()
            return
        result = {rid: h.final_output()
                  for rid, h in self._api._handles.items()}
        for f in waiters:
            if f.set_running_or_notify_cancel():
                f.set_result(dict(result))

    def _broadcast_failure(self, err: BaseException):
        """Unrecovered backend error: surface it on every waiter and
        every open stream, then park the facade as failed."""
        with self._lock:
            self._fail = err
            self._stop = True
            cmds, self._mailbox = self._mailbox, []
            waiters, self._drain_waiters = self._drain_waiters, []
        for _, fut in cmds:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(err)
        for f in waiters:
            if f.set_running_or_notify_cancel():
                f.set_exception(err)
        for ah in self._streams.values():
            ah._loop.call_soon_threadsafe(ah._queue.put_nowait, err)
        self._streams.clear()

    # -------------------------------------------------- coroutine side --
    async def _call(self, fn):
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            if self._fail is not None:
                raise RuntimeError(
                    "AsyncServingAPI backend failed") from self._fail
            if self._stop:
                raise RuntimeError("AsyncServingAPI is closed")
            self._mailbox.append((fn, fut))
            self._lock.notify_all()
        return await asyncio.wrap_future(fut)

    async def submit(self, prompt,
                     sampling: Optional[SamplingParams] = None, *,
                     arrival_s: Optional[float] = None) -> AsyncRequestHandle:
        """Enqueue one request; resolves once the pump thread has routed
        it (so cluster policies see live load, exactly like the sync
        facade). Returns an :class:`AsyncRequestHandle` whose event
        queue is bound to the calling coroutine's loop."""
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def do() -> AsyncRequestHandle:
            h = self._api.submit(prompt, sampling, arrival_s=arrival_s)
            ah = AsyncRequestHandle(h, queue, loop)
            self._streams[h.req_id] = ah
            return ah
        return await self._call(do)

    async def stream(self, handle: AsyncRequestHandle
                     ) -> AsyncIterator[GenerationOutput]:
        """Async generator of :class:`GenerationOutput` events; ends
        after the ``finished=True`` event. Multiple handles stream
        concurrently — the pump thread fans out to all of them."""
        while True:
            ev = await handle._queue.get()
            if isinstance(ev, BaseException):
                raise RuntimeError(
                    "AsyncServingAPI backend failed mid-stream") from ev
            yield ev
            if ev.finished:
                return

    async def generate(self, prompt,
                       sampling: Optional[SamplingParams] = None
                       ) -> GenerationOutput:
        """Submit + stream to completion; returns the final event."""
        handle = await self.submit(prompt, sampling)
        out: Optional[GenerationOutput] = None
        async for out in self.stream(handle):
            pass
        assert out is not None and out.finished
        return out

    async def abort(self, handle: Union[AsyncRequestHandle, RequestHandle,
                                        int]) -> bool:
        """Cancel a request mid-flight; the handle's stream terminates
        with a ``finish_reason="abort"`` event on the next fan-out."""
        rid = handle if isinstance(handle, int) else handle.req_id
        return await self._call(lambda: self._api.abort(rid))

    async def drain(self) -> Dict[int, GenerationOutput]:
        """Resolve once everything in flight has completed; returns the
        final cumulative output per req_id (the async analogue of
        :meth:`ServingAPI.drain`, without stealing the pump)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            if self._fail is not None:
                raise RuntimeError(
                    "AsyncServingAPI backend failed") from self._fail
            if self._stop:
                raise RuntimeError("AsyncServingAPI is closed")
            self._drain_waiters.append(fut)
            self._lock.notify_all()
        return await asyncio.wrap_future(fut)

    async def metrics(self) -> Union[ServingMetrics, ClusterMetrics]:
        return await self._call(self._api.metrics)

    async def aclose(self):
        """Stop the pump thread (after it finishes the current round) and
        wait for the device work it queued. In-flight requests are left
        as-is; drain first for a clean end."""
        await asyncio.get_running_loop().run_in_executor(None, self.close)

    def close(self):
        """Sync teardown (for non-async harnesses / atexit paths): stop and
        join the pump thread, then wait for every engine's stream, so the
        caller may free the engines' CUDA graphs once this returns."""
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join()
        backend = self.backend
        engines = ([rep.engine for rep in backend.replicas]
                   if isinstance(backend, ReplicatedCluster) else [backend])
        for eng in engines:
            if eng.stream is not None:
                eng.stream.synchronize()

    async def __aenter__(self) -> "AsyncServingAPI":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()
