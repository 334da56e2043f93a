"""Scheduler: admission, preemption and decode-batch planning (the
synchronous, serial-prefill subset of ``repro.serving.scheduler``).

:class:`Scheduler` owns the request-phase state (arrival queue, running
set, per-request next token and write position) and compresses one
engine iteration's decisions into a :class:`StepPlan`: who is admitted
(each admission runs its whole prompt's prefill at once), who is
preempted for blocks, and which requests take a decode token at which
positions. The engine keeps the compute.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import TYPE_CHECKING, Dict, List

from repro_torch.serving.workload import Request

if TYPE_CHECKING:   # pragma: no cover - typing only
    from repro_torch.serving.engine import ContinuousBatchingEngine


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One iteration's decode work order. ``reqs``/``rids``/``positions``
    are parallel: ``reqs[i]`` takes one token at ``positions[i]``."""
    reqs: List[Request]
    rids: List[int]
    positions: List[int]
    n_prefill: int                # prompt tokens computed this iteration
    t0: float                     # perf_counter at step start

    @property
    def has_decode(self) -> bool:
        return bool(self.rids)


class Scheduler:
    """Owns request-phase state and produces one StepPlan per iteration."""

    def __init__(self, engine: "ContinuousBatchingEngine"):
        self.eng = engine
        self.waiting: deque = deque()
        self.running: List[Request] = []
        self._tokens: Dict[int, int] = {}    # rid -> next input token
        self._pos: Dict[int, int] = {}       # rid -> write position

    def admit(self, now: float):
        """FCFS admission under ``max_batch`` and the pool watermark; each
        admitted request is prefilled at once and emits its first token."""
        eng = self.eng
        mgr = eng.pool.manager
        while (self.waiting
               and len(self.running) < eng.ecfg.max_batch
               and self.waiting[0].arrival_s <= now):
            req = self.waiting[0]
            need = mgr.blocks_needed(req.prompt_len + 1)
            if mgr.free_blocks - need < mgr.watermark_blocks:
                if not self.running:
                    # nothing in flight will ever free a block
                    from repro_torch.serving.engine import RequestTooLarge
                    raise RequestTooLarge(
                        f"KV pool exhausted: request {req.req_id} "
                        f"(prompt_len={req.prompt_len}) needs {need} blocks "
                        f"but the idle pool has {mgr.free_blocks} free "
                        f"({mgr.num_blocks} total, {mgr.watermark_blocks} "
                        f"reserved) — raise kv_pool_tokens or lower "
                        f"max_model_len", req.req_id)
                break
            self.waiting.popleft()
            mgr.allocate(req.req_id, req.prompt_len + 1)
            eng._complete_prefill(req, eng._prefill(req), now)

    def preempt(self, req: Request):
        """Recompute-style preemption: release everything, requeue first;
        greedy decode regenerates identical tokens on re-admission."""
        eng = self.eng
        rid = req.req_id
        eng.pool.release(rid)
        self._tokens.pop(rid, None)
        self._pos.pop(rid, None)
        req.state.reset_for_requeue()
        self.waiting.appendleft(req)
        eng.preemptions += 1

    def ensure_step_capacity(self):
        """Make sure every running request can take its token this step:
        while the requests crossing a block boundary outnumber the free
        blocks, preempt the youngest running request."""
        mgr = self.eng.pool.manager
        while True:
            need = sum(1 for r in self.running
                       if mgr.needs_block(r.req_id, self._pos[r.req_id] + 1))
            if need <= mgr.free_blocks:
                return
            if len(self.running) <= 1:
                from repro_torch.serving.engine import RequestTooLarge
                raise RequestTooLarge(
                    "KV pool exhausted: a single request exceeds pool "
                    "capacity (raise kv_pool_tokens or lower max_model_len)",
                    self.running[0].req_id)
            self.preempt(self.running.pop())

    def plan(self, now: float) -> StepPlan:
        """Admission, capacity preemption and the decode batch, with the
        block for each row's token reserved."""
        eng = self.eng
        t0 = time.perf_counter()
        pf0 = eng.prefill_tokens_computed
        self.admit(now)
        n_prefill = eng.prefill_tokens_computed - pf0
        if not self.running:
            return StepPlan(reqs=[], rids=[], positions=[],
                            n_prefill=n_prefill, t0=t0)
        self.ensure_step_capacity()        # may preempt -> shrink running
        reqs = list(self.running)
        rids = [r.req_id for r in reqs]
        positions = [self._pos[rid] for rid in rids]
        for rid, pos in zip(rids, positions):
            eng.pool.manager.append_token(rid, pos + 1)
        return StepPlan(reqs=reqs, rids=rids, positions=positions,
                        n_prefill=n_prefill, t0=t0)
