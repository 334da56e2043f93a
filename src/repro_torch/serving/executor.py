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
    __slots__ = ("plan", "device_tokens", "host_tokens", "done", "valid")

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

    def reset(self):
        """Drop every in-flight step without committing."""
        self._inflight.clear()
        self._chain.clear()
        self._spec_pending.clear()
        self._last = None
        self._t_last_commit = None

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
        plan = eng.sched.plan(now)
        if plan.has_decode:
            self._dispatch(plan)
        keep = self.DEPTH if plan.has_decode else 0
        while len(self._inflight) > keep:
            self._commit(self._inflight.pop(0))
        if not plan.has_decode and plan.n_prefill:
            eng._record_prefill_only(plan)
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
            # no row is chained to a verify step, and its requests sit
            # planning out until it commits
            entry = InFlightStep(plan, eng._dispatch_verify(plan, tokens,
                                                            chain))
            self._inflight.append(entry)
            self._last = entry
            self._spec_pending.update(plan.rids)
            return
        if eng.decode_mode == "paged":
            out = eng.steps.paged(plan.reqs, plan.rids, plan.positions,
                                  tokens, chain)
        else:
            out = eng.steps.gather(plan.reqs, plan.rids, plan.positions,
                                   tokens, chain)
        eng.decode_steps += 1
        entry = InFlightStep(plan, out)
        self._inflight.append(entry)
        self._last = entry
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
        if not _is_ready(entry):
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
        t_done = plan.now + (time.perf_counter() - plan.t0)
        if plan.drafts is not None:
            self._commit_verify(entry, host_tokens, t_done)
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
        if not n_valid:
            return
        # ITL under overlap: the cadence of commits, which is what a
        # streaming client sees
        t = time.perf_counter()
        t_prev = self._t_last_commit
        self._t_last_commit = t
        eng._record_decode(t - (plan.t0 if t_prev is None else t_prev),
                           plan, n_valid)

    def _commit_verify(self, entry: InFlightStep, out, t_done: float):
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
        if not n_valid:
            return
        t = time.perf_counter()
        t_prev = self._t_last_commit
        self._t_last_commit = t
        eng._record_decode(t - (plan.t0 if t_prev is None else t_prev),
                           plan, n_valid, committed)
