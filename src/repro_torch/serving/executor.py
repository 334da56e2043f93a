"""Executor: overlapped step dispatch (counterpart of
``repro.serving.executor``).

Under ``EngineConfig.overlap`` each engine iteration ``i`` runs

    plan i      scheduler decisions on host state only (no token values)
    dispatch i  the decode step for plan i: a graph replay, then a
                non-blocking copy of its ``[B]`` ids into pinned host
                memory and an event after it
    commit      every step past the two retained (``DEPTH``): wait on its
                event, then bookkeeping, the finish protocol, telemetry

so the device computes while the host plans and commits, and a step's
time tends to ``max(host, device)`` rather than their sum.

Tokens equal the synchronous loop's:

* a chained request's input token (its previous token still in flight)
  is gathered on the device from the previous step's output
  (:meth:`~repro_torch.serving.steps.StepFunctions._chain`), queued
  before this step's replay rewrites any graph output;
* plans read only host-knowable state (:mod:`repro_torch.serving.scheduler`);
* a stop token, an abort or a preemption found while later steps of the
  request are in flight invalidates its rows there
  (:meth:`Executor.invalidate`): their tokens never reach
  ``output_tokens``. Their KV writes went to blocks the request owned at
  dispatch, on the one stream every later pool write also takes, so a
  block's next owner writes after them.

A speculative verify step chains none of its rows: how many tokens a row
commits is known only at its commit, so no later plan can read its output
by position. Its requests are left out of planning (``_spec_pending``)
until it commits, through the engine's ``_spec_commit``. Its rows chained
to the previous plain step ride it draft-free, their input gathered on
the device as a plain step's.

A device error from step N surfaces when step N is committed, an
iteration or two later: it is raised again with ``err.engine_step = N``
and a note. On the CPU the steps finish at dispatch, so the executor runs
synchronously, with the same planning, chaining and invalidation.

With an observer attached each dispatch keeps its bucket census, live
work, host stamps and the device-time marks around its replay, and the
commit closes the step through ``end_step_overlap``: ``device_s`` from
the step's marks, ``gap_s`` from the previous dispatch's end mark to this
one's start mark (the device's own idle time), read once the step's
tokens are on the host; the dispatch cadence, the host share and how far
ahead of the previous step's completion the dispatch landed are the
reference's host-clock terms (a step-start probe of each in-flight
step's copy event stamps when the host first saw it done).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.serving.scheduler import StepPlan
from repro_torch.serving.steps import Chain, split_verify


def _is_ready(entry: "InFlightStep") -> bool:
    """Non-blocking completion probe of a step's token copy."""
    return entry.done is None or entry.done.query()


class InFlightStep:
    """One dispatched, uncommitted decode or verify step."""
    __slots__ = ("plan", "device_tokens", "host_tokens", "done", "valid",
                 "obs", "t_seen_ready")

    def __init__(self, plan: StepPlan, device_tokens: torch.Tensor):
        self.plan = plan
        # the step's output on the device: the chain source of the next
        # dispatch (valid until the same bucket's next replay); a verify
        # step's tokens and acceptance mask
        self.device_tokens = device_tokens
        # its copy in (pinned) host memory, complete once ``done`` fires
        self.host_tokens = torch.empty(
            device_tokens.shape, dtype=device_tokens.dtype,
            pin_memory=device_tokens.is_cuda)
        self.host_tokens.copy_(device_tokens, non_blocking=True)
        self.done: Optional[torch.cuda.Event] = None
        if device_tokens.is_cuda:
            self.done = torch.cuda.Event()
            self.done.record()
        # rows are discarded, never committed, when their request
        # finishes, aborts or is preempted while the step is in flight
        self.valid = [True] * len(plan.rids)
        # observed: (variant, census, live work, t_call, t_ret, timing,
        # the previous dispatch's timing); and when a step-start probe
        # first saw its copy done (host clock)
        self.obs = None
        self.t_seen_ready: Optional[float] = None


class Executor:
    """Owns the in-flight window and the deferred commit. The engine's
    ``step()`` routes here under ``EngineConfig.overlap``; in sync mode
    only :meth:`invalidate` is called (a no-op there)."""

    # steps retained in flight between iterations (the reference's): with
    # one, the device idles whenever one host iteration outruns one step
    DEPTH = 2

    def __init__(self, engine):
        self.eng = engine
        self._inflight: List[InFlightStep] = []
        # rid -> (entry, row): where an active request's newest uncommitted
        # token lives; consumed by the next dispatch, cleared at commit or
        # invalidation
        self._chain: Dict[int, Tuple[InFlightStep, int]] = {}
        self._last: Optional[InFlightStep] = None   # newest dispatch
        # rids with a verify step in flight: not planned until it commits
        self._spec_pending: set = set()
        self._t_last_commit: Optional[float] = None
        self._preempt_seen = 0
        # observed steps: the newest dispatch's device-time marks, and the
        # previous commit's completion estimate and dispatch call time
        self._last_timing = None
        self._prev_ready_est: Optional[float] = None
        self._prev_t_call: Optional[float] = None

    def reset(self):
        """Drop every in-flight step without committing."""
        self._inflight.clear()
        self._chain.clear()
        self._spec_pending.clear()
        self._last = None
        self._t_last_commit = None
        self._last_timing = None
        self._prev_ready_est = None
        self._prev_t_call = None

    def _preempted(self) -> int:
        """Preemptions since the last sample (a commit trails its plan)."""
        eng = self.eng
        delta = max(0, eng.preemptions - self._preempt_seen)
        self._preempt_seen = eng.preemptions
        return delta

    def invalidate(self, rid: int):
        """A request left the active set (finish, abort, preemption,
        eviction): discard its uncommitted rows, and drop any step whose
        rows are now all dead (it commits nothing)."""
        self._chain.pop(rid, None)
        self._spec_pending.discard(rid)
        for entry in list(self._inflight):
            hit = False
            for i, r in enumerate(entry.plan.rids):
                if r == rid and entry.valid[i]:
                    entry.valid[i] = False
                    hit = True
            if hit and not any(entry.valid):
                self._inflight.remove(entry)

    # ------------------------------------------------------------- step --
    def step(self, now: float) -> bool:
        """One overlapped iteration: plan i, dispatch i, commit all but
        the newest ``DEPTH`` steps (all of them when nothing was
        dispatched, which drains the window)."""
        eng = self.eng
        if eng.obs is not None:
            # a step whose tokens are already on the host before planning
            # starts finished at the latest now (the reference's probe)
            t_start = time.perf_counter()
            for entry in self._inflight:
                if entry.t_seen_ready is None and _is_ready(entry):
                    entry.t_seen_ready = t_start
        plan = eng.sched.plan(now)
        if plan.has_decode:
            self._dispatch(plan)
        keep = self.DEPTH if plan.has_decode else 0
        while len(self._inflight) > keep:
            self._commit(self._inflight.pop(0))
        if not plan.has_decode and plan.n_prefill:
            eng._record_prefill_only(plan, self._preempted())
        return eng.busy or bool(self._inflight)

    # --------------------------------------------------------- dispatch --
    def _input_tokens(self, rids: List[int]
                      ) -> Tuple[List[int], Optional[Chain]]:
        """The step's host-known input tokens, and the rows chained to
        the newest dispatch (their token still in flight) with the row of
        its output each reads."""
        eng = self.eng
        tokens, rows = [], {}
        for i, rid in enumerate(rids):
            ch = self._chain.get(rid)
            if ch is None:
                tokens.append(eng._tokens[rid])
                continue
            # every dispatch re-chains its whole batch to itself, and a
            # request left out of a later plan is at its budget (never
            # planned again) or invalidated (chain cleared): so a chained
            # row always points at the newest dispatch, whose output no
            # replay has rewritten yet
            if ch[0] is not self._last:
                raise RuntimeError(f"request {rid} is chained to a step "
                                   f"older than the newest dispatch")
            tokens.append(0)
            rows[i] = ch[1]
        return tokens, (self._last.device_tokens, rows) if rows else None

    def _dispatch(self, plan: StepPlan):
        eng = self.eng
        tokens, chain = self._input_tokens(plan.rids)
        if plan.drafts is not None:
            variant = "spec_verify"
            call = lambda: eng._dispatch_verify(  # noqa: E731
                plan, tokens, chain)
        elif eng.decode_mode == "paged":
            variant = "decode"
            call = lambda: eng.steps.paged(  # noqa: E731
                plan.reqs, plan.rids, plan.positions, tokens, chain)
        else:
            variant = "decode_gather"
            call = lambda: eng.steps.gather(  # noqa: E731
                plan.reqs, plan.rids, plan.positions, tokens, chain)
        facts = None
        if eng.obs is not None:
            sc, live = eng._step_facts(variant, plan)
            t_call = time.perf_counter()
            out = call()
            t_ret = time.perf_counter()
            facts = (variant, sc, live, t_call, t_ret, eng.steps.last,
                     self._last_timing)
            self._last_timing = eng.steps.last
        else:
            out = call()
        entry = InFlightStep(plan, out)
        entry.obs = facts
        self._inflight.append(entry)
        self._last = entry
        if plan.drafts is not None:
            # no row is chained to a verify step, and its requests sit
            # planning out until it commits
            self._spec_pending.update(plan.rids)
            return
        eng.decode_steps += 1
        for row, rid in enumerate(plan.rids):
            self._chain[rid] = (entry, row)

    # ----------------------------------------------------------- commit --
    def _commit(self, entry: InFlightStep):
        """Retire one step: wait for its tokens (already on the host in a
        host-bound steady state), then bookkeeping and the finish
        protocol for every still-valid row (a verify step's through the
        engine's ``_spec_commit``), and telemetry."""
        eng = self.eng
        plan = entry.plan
        t_fetch_call = time.perf_counter()
        waited = not _is_ready(entry)
        if waited:
            eng.commit_waits += 1
        try:
            if entry.done is not None:
                entry.done.synchronize()
            host_tokens = entry.host_tokens.numpy()
        except RuntimeError as err:
            # a device error of this step, found a dispatch or two later
            err.engine_step = plan.step
            err.add_note(f"deferred device error from engine step "
                         f"{plan.step} (dispatched under overlap, surfaced "
                         f"at its commit)")
            raise
        t_fetch_ret = time.perf_counter()
        # the host's estimate of when the step finished (the reference's):
        # exact when the fetch waited, else when a probe first saw it done,
        # else the fetch call (it finished some time before)
        if waited:
            ready_est = t_fetch_ret
        elif entry.t_seen_ready is not None:
            ready_est = entry.t_seen_ready
        else:
            ready_est = t_fetch_call
        t_done = plan.now + (time.perf_counter() - plan.t0)
        if plan.drafts is not None:
            self._commit_verify(entry, host_tokens, t_done, ready_est,
                                t_fetch_ret)
            return
        n_valid = 0
        for i, r in enumerate(plan.reqs):
            if not entry.valid[i]:
                continue
            n_valid += 1
            rid = r.req_id
            tok = int(host_tokens[i])
            eng._tokens[rid] = tok
            ch = self._chain.get(rid)
            if ch is not None and ch[0] is entry:
                del self._chain[rid]
            r.state.generated += 1
            r.state.output_tokens.append(tok)
            # may finish -> invalidate(rid): the request's rows in the
            # steps dispatched since die here
            eng._finish_or_run(r, t_done)
        eng.running = [r for r in eng.running
                       if r.state.finish_reason is None]
        self._retire(entry, n_valid, None, ready_est, t_fetch_ret)

    def _commit_verify(self, entry: InFlightStep, out, t_done: float,
                       ready_est: float, t_fetch_ret: float):
        """Retire a verify step: its requests return to planning, and the
        engine commits its still-valid rows token by token."""
        eng = self.eng
        plan = entry.plan
        for rid in plan.rids:
            self._spec_pending.discard(rid)
        n_valid = sum(entry.valid)
        ys, oks = split_verify(out)
        committed = eng._spec_commit(plan, ys, oks, t_done,
                                     valid=entry.valid)
        self._retire(entry, n_valid, committed, ready_est, t_fetch_ret)

    def _retire(self, entry: InFlightStep, n_valid: int,
                committed: Optional[int], ready_est: float,
                t_fetch_ret: float):
        """A committed step's series (ITL under overlap: the cadence of
        commits, which is what a streaming client sees) and, observed,
        its ``end_step_overlap``."""
        eng = self.eng
        plan = entry.plan
        if n_valid:
            t = time.perf_counter()
            t_prev = self._t_last_commit
            self._t_last_commit = t
            eng._record_decode(t - (plan.t0 if t_prev is None else t_prev),
                               plan, n_valid, committed,
                               preempted=self._preempted())
            if entry.obs is not None and eng.obs is not None:
                variant, sc, live, t_call, t_ret, timing, prev = entry.obs
                prev_ready = self._prev_ready_est
                ahead = (max(0.0, prev_ready - t_ret)
                         if prev_ready is not None else 0.0)
                total_s = t_call - (self._prev_t_call
                                    if self._prev_t_call is not None
                                    else plan.t0)
                eng.obs.end_step_overlap(
                    eng, step=plan.step, t0=plan.t0,
                    t_sched_s=plan.t_sched, n_prefill=plan.n_prefill,
                    n_decode=n_valid, sc=sc, batch=len(plan.rids),
                    t_call=t_call, t_ret=t_ret, timing=timing,
                    prev_timing=prev, ready_est=ready_est,
                    dispatch_ahead_s=ahead, total_s=max(total_s, 0.0),
                    host_s=t - t_fetch_ret, variant=variant, live=live)
        if entry.obs is not None:
            self._prev_ready_est = ready_est
            self._prev_t_call = entry.obs[3]
