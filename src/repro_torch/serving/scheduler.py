"""Scheduler: admission control, deadlines, admission, chunked prefill,
preemption and decode-batch planning, speculative drafts included
(counterpart of ``repro.serving.scheduler``).

:class:`Scheduler` owns the request-phase state (arrival queue, the
PREFILLING and RUNNING sets, per-request chunk progress, next token,
write position and dispatch count) and compresses one engine iteration's
decisions into a :class:`StepPlan`: whose deadline expired (in any
phase), who is admitted (with the prefix cache, a prompt's longest
cached prefix is spliced into its table first), which prompt chunks
stream in, who is preempted for blocks, and which requests take a decode
token at which positions. Admission control (:meth:`Scheduler.shed_check`)
rejects a submit as the reference does: a full queue, a full pool with a
queue behind it, an estimated queue delay past the bound, or a deadline
the estimate already blows. The engine keeps
the compute, and the :class:`~repro_torch.serving.executor.Executor`
dispatches the plans under overlap.

Two prefill modes, as in the reference: serial (each admission prefills
its whole uncached prompt at once) and chunked (admission reserves a
seat and the first chunk's blocks; every step then runs up to
``prefill_chunk_tokens`` prompt tokens, FCFS, beside the decode batch).

Overlap-aware planning (the reference's rules): under
``EngineConfig.overlap`` a request's next step is planned while its
previous step's token is still on the device, so a plan reads only
host-knowable state. A request is planned again only while its
``_dispatched`` count (tokens planned, in flight included) is below its
length budget; ``_pos`` advances when a step is planned (in sync mode,
when it commits), so in both modes ``_pos`` at plan time is where the
next token writes. A stop token is found only at commit: the executor
then discards the request's rows of the steps still in flight.

Speculation (the reference's rules): with a drafter, a plan asks it for a
draft a request, clipped so that the worst case (``1 + k`` tokens) stays
inside the output budget. If any row has a draft the plan is a verify
step: each row's draft span is reserved (shrunk rather than dipping into
the watermark reserve), ``_dispatched`` counts the worst case, corrected
at commit, and ``_pos`` is left alone, since the committed length
depends on acceptance. Under overlap a request whose verify step is in
flight is not planned again until it commits, and a request whose plain
step is in flight rides draft-free; every ``spec_probe_every``-th
iteration with such chained rows plans nothing, so that the pipeline
drains and the drafter sees committed context.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np

from repro_torch.serving.workload import (FINISH_DEADLINE, FINISH_SHED,
                                          Request)

if TYPE_CHECKING:   # pragma: no cover - typing only
    from repro_torch.serving.engine import ContinuousBatchingEngine


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One iteration's decode work order. ``reqs``/``rids``/``positions``
    are parallel: ``reqs[i]`` takes one token at ``positions[i]``.
    ``t_sched`` is the schedule phase (admission and prefill) in seconds,
    ``p0`` the engine's preemption count before the step, ``step`` the
    engine step that planned it and ``now`` its serving-timeline stamp
    (an overlapped plan commits an iteration or two later). ``drafts``,
    parallel to ``reqs``, makes the plan a speculative verify step."""
    reqs: List[Request]
    rids: List[int]
    positions: List[int]
    n_prefill: int                # prompt tokens computed this iteration
    t0: float                     # perf_counter at step start
    t_sched: float = 0.0
    p0: int = 0
    step: int = 0
    now: float = 0.0
    drafts: Optional[List[np.ndarray]] = None

    @property
    def has_decode(self) -> bool:
        return bool(self.rids)


def _too_large(msg: str, req_id: int):
    from repro_torch.serving.engine import RequestTooLarge
    return RequestTooLarge(msg, req_id)


class Scheduler:
    """Owns request-phase state and produces one StepPlan per iteration."""

    def __init__(self, engine: "ContinuousBatchingEngine"):
        self.eng = engine
        self.waiting: deque = deque()
        self.running: List[Request] = []
        # chunked mode: admitted requests whose prompt is still streaming
        # into the pool, FCFS, and how many prompt tokens each has written
        self.prefilling: List[Request] = []
        self._prefilled: Dict[int, int] = {}
        self._tokens: Dict[int, int] = {}    # rid -> next input token
        self._pos: Dict[int, int] = {}       # rid -> write position
        # rid -> output tokens planned, in-flight ones included (equal to
        # state.generated after every sync step; ahead of it under overlap)
        self._dispatched: Dict[int, int] = {}
        # deadlines are scanned for only once a request carries one
        self._has_deadlines = False
        # overlap with speculation: iterations since the last drain
        self._spec_probe = 0

    # ----------------------------------------------- admission control --
    def estimated_queue_delay_s(self) -> float:
        """Wait estimate for a newly queued request: the tokens queued
        ahead of it (prompts plus output budgets) over the recent decode
        token rate (the last 32 steps' decode tokens over their ITL). Zero
        until the engine has decode samples: a cold start never sheds."""
        eng = self.eng
        itl = eng.itl_samples[-32:]
        toks = eng.decode_token_samples[-32:]
        if not itl or not sum(toks):
            return 0.0
        tok_per_s = sum(toks) / max(sum(itl), 1e-9)
        ahead = sum(r.prompt_len + r.sampling.max_new_tokens
                    for r in self.waiting)
        return ahead / tok_per_s

    def shed_check(self, req: Request, now: float) -> Optional[str]:
        """The shed reason admission control gives ``req`` submitted at
        ``now`` (``queue_full``, ``kv_pressure``, ``queue_delay``,
        ``deadline_unmeetable``), or None to accept. Pure: the caller
        sheds. With no shedding knob and no deadline everything is
        accepted."""
        eng = self.eng
        ecfg = eng.ecfg
        if ecfg.max_waiting is not None \
                and len(self.waiting) >= ecfg.max_waiting:
            return "queue_full"
        if ecfg.shed_kv_fraction is not None and self.waiting \
                and eng.pool.manager.used_fraction >= ecfg.shed_kv_fraction:
            return "kv_pressure"
        if ecfg.shed_queue_delay_s is not None or req.sampling.has_deadline:
            est = self.estimated_queue_delay_s()
            if ecfg.shed_queue_delay_s is not None \
                    and est > ecfg.shed_queue_delay_s:
                return "queue_delay"
            # a request whose queue wait alone blows its own deadline
            # would only be admitted to expire: reject it now
            dl = req.sampling.ttft_deadline_s
            if dl is None:
                dl = req.sampling.deadline_s
            if dl is not None and max(now, req.arrival_s) + est \
                    > req.arrival_s + dl:
                return "deadline_unmeetable"
        return None

    def shed_request(self, req: Request, now: float, reason: str):
        """Finish a rejected request (it never entered a queue and holds
        no block) with ``finish_reason="shed"``, counted by reason."""
        eng = self.eng
        req.state.finish_reason = FINISH_SHED
        req.state.t_done = max(now, req.arrival_s)
        eng.shed += 1
        eng.shed_reasons[reason] = eng.shed_reasons.get(reason, 0) + 1
        if eng.obs is not None:
            eng.obs.on_shed(req, reason)

    # -------------------------------------------------------- deadlines --
    def expire_deadlines(self, now: float):
        """Finish every request past its deadline, in any phase: queued
        (it never starts), prefilling (its partial prompt KV released) or
        decoding (its partial output kept, its blocks and prefix pins
        released this step; under overlap its rows of the steps in flight
        are invalidated). Deadline-free serving skips the scan."""
        if not self._has_deadlines:
            return
        eng = self.eng
        for lst in (self.waiting, self.prefilling, self.running):
            expired = [r for r in lst if r.sampling.expired(
                r.arrival_s, now,
                first_token=r.state.t_first_token is not None)]
            for req in expired:
                lst.remove(req)
                self._prefilled.pop(req.req_id, None)
                eng._finish(req, max(now, req.arrival_s),
                            reason=FINISH_DEADLINE)
                eng.deadline_expired += 1

    def admit(self, now: float):
        """FCFS admission under ``max_batch`` and the pool watermark. A
        prefix-cache hit is pinned before any eviction, and only the
        uncached suffix needs free blocks; cache-only blocks are evicted
        (LRU) when that closes the gap. Serial mode prefills each
        admission at once; chunked mode reserves its first chunk. A
        config with per-request state (SSM state, a VLM's image K/V)
        also needs a free dense-state slot: under
        overlap a request at its length budget gives its seat up before
        its last token commits, but keeps its slot until then: the slot is
        released with its blocks, when it finishes."""
        eng = self.eng
        if eng.faults is not None and eng.faults.steals_allocation(
                eng.replica_id, eng.step_count):
            # injected transient allocation failure: admission skips a
            # step (requests wait, shed or expire; nothing crashes)
            return
        mgr = eng.pool.manager
        bs = eng.ecfg.block_size
        pool = eng.pool
        while (self.waiting and self._seats() < eng.ecfg.max_batch
               and (not pool.state_names or pool.free_slots)
               and self.waiting[0].arrival_s <= now):
            req = self.waiting[0]
            hit: List[int] = []
            if eng.prefix is not None:
                hit = eng.prefix.match(req.prompt)
                for b in hit:
                    mgr.incref(b)
            n_cached = len(hit) * bs
            if eng.chunking:
                first = min(eng.ecfg.prefill_chunk_tokens,
                            req.prompt_len + 1 - n_cached)
                need_new = mgr.blocks_needed(n_cached + first) - len(hit)
            else:
                need_new = mgr.blocks_needed(req.prompt_len + 1) - len(hit)
            short = need_new + mgr.watermark_blocks - mgr.free_blocks
            # flush warm entries only when that can close the whole gap
            if eng.prefix is not None \
                    and 0 < short <= eng.prefix.cached_blocks:
                eng.prefix.evict(short)
            if mgr.free_blocks - need_new < mgr.watermark_blocks:
                for b in hit:               # unpin (the cache ref remains)
                    mgr.decref(b)
                if not self.running and not self.prefilling:
                    # nothing in flight will ever free a block
                    evictable = (eng.prefix.cached_blocks
                                 if eng.prefix is not None else 0)
                    if (mgr.free_blocks + evictable - need_new
                            < mgr.watermark_blocks):
                        raise _too_large(
                            f"KV pool exhausted: request {req.req_id} "
                            f"(prompt_len={req.prompt_len}) needs "
                            f"{need_new} blocks but the idle pool has "
                            f"{mgr.free_blocks} free ({mgr.num_blocks} "
                            f"total, {mgr.watermark_blocks} reserved) — "
                            f"raise kv_pool_tokens or lower max_model_len",
                            req.req_id)
                    eng.prefix.evict(need_new + mgr.watermark_blocks
                                     - mgr.free_blocks)
                    continue                # retry the same head request
                break
            self.waiting.popleft()
            if eng.obs is not None:
                eng.obs.on_admit(req)
            if hit:
                mgr.share(req.req_id, hit)
                for b in hit:               # the table's ref replaces the pin
                    mgr.decref(b)
            if eng.prefix is not None:
                eng.prefix.record_admit(req.prompt_len, n_cached)
            if eng.chunking:
                mgr.extend(req.req_id, n_cached + first)
                self._prefilled[req.req_id] = n_cached
                self.prefilling.append(req)
                continue
            mgr.allocate(req.req_id, req.prompt_len + 1 - n_cached)
            eng._complete_prefill(req, eng._prefill(req, n_cached), now)

    def prefill_step(self, now: float) -> int:
        """Run up to ``prefill_chunk_tokens`` prompt tokens of chunked
        prefill, FCFS across PREFILLING requests (leftover budget flows to
        the next in line); a request whose last chunk ran emits its first
        token. Returns the prompt tokens computed."""
        eng = self.eng
        if not eng.chunking or not self.prefilling:
            return 0
        budget = eng.ecfg.prefill_chunk_tokens
        spent = 0
        while budget > 0 and self.prefilling:
            req = self.prefilling[0]
            rid = req.req_id
            done = self._prefilled[rid]
            remaining = req.prompt_len - done
            chunk = min(budget, remaining)
            final = chunk == remaining
            # the final chunk also covers the first decode token's slot
            target = done + chunk + (1 if final else 0)
            if not self._reserve_for_chunk(rid, target):
                break                    # strict FCFS: wait for blocks
            logits = eng._run_chunk(req, done, chunk)
            self._prefilled[rid] = done + chunk
            spent += chunk
            budget -= chunk
            if final:
                self.prefilling.pop(0)
                self._prefilled.pop(rid, None)
                eng._complete_prefill(req, logits, now)
        return spent

    def _reserve_for_chunk(self, rid: int, target_tokens: int) -> bool:
        """Extend ``rid``'s table to cover ``target_tokens`` under the
        watermark. Under pressure: evict cache-only prefix blocks; if
        nothing is decoding (no block will free itself), preempt the
        youngest *other* prefilling request; a lone request that cannot
        fit raises."""
        eng = self.eng
        mgr = eng.pool.manager
        while True:
            short = target_tokens - mgr.covered_tokens(rid)
            if short <= 0:
                return True
            gap = mgr.blocks_needed(short) + mgr.watermark_blocks \
                - mgr.free_blocks
            if eng.prefix is not None \
                    and 0 < gap <= eng.prefix.cached_blocks:
                eng.prefix.evict(gap)
            if mgr.can_allocate(short):
                mgr.extend(rid, target_tokens)
                return True
            if self.running:
                return False             # decode completions free blocks
            victims = [r for r in self.prefilling if r.req_id != rid]
            if not victims:
                raise _too_large(
                    "KV pool exhausted: a single request's prompt exceeds "
                    "pool capacity (raise kv_pool_tokens or lower "
                    "max_model_len)", rid)
            self.preempt(victims[-1])

    def preempt(self, req: Request):
        """Recompute-style preemption of a running or half-prefilled
        request: release everything, requeue first; re-admission redoes
        the prefix match and restreams the prompt, and the counter-based
        sampler replays the same tokens."""
        eng = self.eng
        rid = req.req_id
        if req in self.prefilling:
            self.prefilling.remove(req)
        self._prefilled.pop(rid, None)
        eng.pool.release(rid)
        self._tokens.pop(rid, None)
        self._pos.pop(rid, None)
        self._dispatched.pop(rid, None)
        eng._executor.invalidate(rid)
        if eng.speculator is not None:
            # the drafter's context is the output the requeue resets
            eng.speculator.forget(rid)
        req.state.reset_for_requeue()
        self.waiting.appendleft(req)
        eng.preemptions += 1
        if eng.obs is not None:
            eng.obs.on_preempt(req)

    def _seats(self) -> int:
        """Batch seats taken: the prefilling requests, the running ones
        still to be planned and those with a verify step in flight. Under
        overlap a request whose last token is dispatched gives its seat up
        at once, where the reference's keeps it until that token commits:
        admissions, and with them every step's batch, are then the sync
        loop's (in bf16 a different batch rounds differently). A request
        whose verify step is in flight keeps its seat: how many tokens it
        commits is not known yet."""
        pending = self.eng._executor._spec_pending
        return len(self.prefilling) + sum(
            r.req_id in pending or self._needs_step(r) for r in self.running)

    def _needs_step(self, req: Request) -> bool:
        """Does ``req`` take a decode token this step? In sync mode every
        running request does; under overlap, only while its planned output
        is below its length budget (a request at its budget stays running
        until its last in-flight token commits). A request with a verify
        step in flight is not planned until that step commits: its next
        write position depends on how many drafts are accepted."""
        if req.req_id in self.eng._executor._spec_pending:
            return False
        if not self.eng.ecfg.overlap:
            return True
        return self._dispatched.get(req.req_id, 0) < self.eng._limit(req)

    def ensure_step_capacity(self):
        """Make sure every running request can take its token this step:
        while the requests crossing a block boundary (or needing a
        copy-on-write fork) outnumber the free blocks, evict cache-only
        prefix blocks, then preempt half-prefilled requests youngest
        first, then the youngest running request."""
        eng = self.eng
        mgr = eng.pool.manager
        while True:
            need = 0
            for r in self.running:
                if not self._needs_step(r):
                    continue
                pos = self._pos[r.req_id]
                if mgr.needs_block(r.req_id, pos + 1) \
                        or mgr.needs_cow(r.req_id, pos):
                    need += 1
            if need <= mgr.free_blocks:
                return
            if eng.prefix is not None \
                    and eng.prefix.evict(need - mgr.free_blocks):
                continue
            if self.prefilling:
                self.preempt(self.prefilling[-1])
                continue
            if len(self.running) <= 1:
                raise _too_large(
                    "KV pool exhausted: a single request exceeds pool "
                    "capacity (raise kv_pool_tokens or lower max_model_len)",
                    self.running[0].req_id)
            self.preempt(self.running.pop())

    def plan(self, now: float) -> StepPlan:
        """Deadlines, admission, prefill work (serial admissions or this
        step's chunks), capacity preemption and the decode batch, with
        each row's block reserved and any shared block it writes
        forked."""
        eng = self.eng
        t0 = time.perf_counter()
        pf0 = eng.prefill_tokens_computed
        p0 = eng.preemptions
        self.expire_deadlines(now)
        self.admit(now)
        self.prefill_step(now)
        n_prefill = eng.prefill_tokens_computed - pf0
        t_sched = time.perf_counter() - t0
        empty = StepPlan(reqs=[], rids=[], positions=[], n_prefill=n_prefill,
                         t0=t0, t_sched=t_sched, p0=p0, step=eng.step_count,
                         now=now)
        if not self.running:
            return empty
        if (eng.speculator is not None and eng.ecfg.overlap
                and any(r.req_id in eng._executor._chain
                        for r in self.running)):
            # chained rows hide their newest tokens from the drafter, so
            # under overlap speculation would never engage after a plain
            # dispatch: every spec_probe_every-th such iteration plans
            # nothing, the executor drains, and the next plan sees
            # committed context (verify steps chain no row)
            self._spec_probe += 1
            if self._spec_probe >= eng.ecfg.spec_probe_every:
                self._spec_probe = 0
                return dataclasses.replace(
                    empty, t_sched=time.perf_counter() - t0)
        self.ensure_step_capacity()        # may preempt -> shrink running
        reqs = [r for r in self.running if self._needs_step(r)]
        if not reqs:
            return dataclasses.replace(empty,
                                       t_sched=time.perf_counter() - t0)
        rids = [r.req_id for r in reqs]
        drafts = (self._plan_drafts(reqs)
                  if eng.speculator is not None else None)
        spec = drafts is not None and any(len(d) for d in drafts)
        positions = [self._pos[rid] for rid in rids]
        for i, (rid, pos) in enumerate(zip(rids, positions)):
            eng.pool.manager.append_token(rid, pos + 1)
            eng.pool.ensure_writable(rid, pos)
            if spec:
                # a verify step: reserve the draft span, count the worst
                # case (corrected at commit), leave _pos to the commit
                k = self._reserve_span(rid, pos, len(drafts[i]))
                drafts[i] = drafts[i][:k]
                self._dispatched[rid] = self._dispatched.get(rid, 0) + 1 + k
                continue
            self._dispatched[rid] = self._dispatched.get(rid, 0) + 1
            if eng.ecfg.overlap:
                # the plan pins this token's position; the commit, an
                # iteration or two later, only appends its value
                self._pos[rid] = pos + 1
        return StepPlan(reqs=reqs, rids=rids, positions=positions,
                        n_prefill=n_prefill, t0=t0, t_sched=t_sched, p0=p0,
                        step=eng.step_count, now=now,
                        drafts=drafts if spec else None)

    def _plan_drafts(self, reqs: List[Request]) -> List[np.ndarray]:
        """A draft a planned request, from the drafter: at most ``spec_k``
        and at most the output budget left past the verify step's one
        sure token. Under overlap a request whose plain step is in flight
        gets none (its committed history is not on the host yet) and
        rides the verify step draft-free."""
        eng = self.eng
        chained = eng._executor._chain if eng.ecfg.overlap else {}
        drafts: List[np.ndarray] = []
        for r in reqs:
            rid = r.req_id
            cap = min(eng.ecfg.spec_k,
                      eng._limit(r) - self._dispatched.get(rid, 0) - 1)
            if cap < 1 or rid in chained:
                drafts.append(np.zeros((0,), np.int32))
            else:
                drafts.append(np.asarray(eng.speculator.propose(r, cap),
                                         np.int32))
        return drafts

    def _reserve_span(self, rid: int, pos: int, k: int) -> int:
        """Reserve blocks for a ``k``-token draft span on top of the base
        token's (the verify step writes positions ``pos .. pos + k``). The
        span shrinks rather than dipping into the watermark reserve,
        which a running request's serial token may need. Forks any shared
        block the span writes into. Returns the reserved draft length."""
        if k <= 0:
            return 0
        eng = self.eng
        mgr = eng.pool.manager
        while k > 0 and not mgr.can_extend(rid, pos + 1 + k):
            k -= 1
        if k == 0:
            return 0
        mgr.extend(rid, pos + 1 + k)
        bs = eng.ecfg.block_size
        for b in range(pos // bs + 1, (pos + k) // bs + 1):
            eng.pool.ensure_writable(rid, b * bs)
        return k
