"""Continuous-batching serving engine (Orca/vLLM-style) on the paged KV
pool: the synchronous, serial-prefill, greedy slice of
``repro.serving.engine``.

Each engine iteration admits waiting requests FCFS under ``max_batch``
and the pool's free-block watermark (each admitted prompt is prefilled
at batch 1 in a padded length bucket and emits its first token), then
runs one decode step for every running request at its own position, in
one of the reference's two decode modes:

* ``paged`` (the default) — zero-copy: attention reads the physical KV
  blocks through the block tables, and each layer's new K/V row is
  written into its physical (block, slot) in place. Batch size and table
  width are padded to power-of-two buckets, as in the reference, so the
  kernels see the same padding rows (length 0, trash-block tables).
* ``gather`` — the reference's dense-copy fallback: the running
  requests' blocks are gathered into a ``[L, B, S_pad, K, hd]`` copy
  (``S_pad`` bucketed to multiples of four blocks, no batch padding),
  the model decodes against it with the contiguous decode kernel and
  ``lengths = pos + 1``, and each request's new row is scattered back
  into the pool.

If the pool runs out of blocks mid-decode the youngest running requests
are preempted and recomputed later; greedy decode regenerates identical
tokens.

Features of the reference engine outside this slice (prefix cache,
chunked prefill, overlapped stepping, speculative decoding, load
shedding, deadlines and sampled decoding) raise ``NotImplementedError``
when asked for; ROADMAP.md lists them as the next slices.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.models.model import Model
from repro_torch.models.sampler import (positions_array, sample_tokens,
                                        stack_sampling)
from repro_torch.serving.metrics import ServingMetrics, collect
from repro_torch.serving.scheduler import Scheduler, StepPlan
from repro_torch.serving.workload import FINISH_LENGTH, FINISH_STOP, Request


class RequestTooLarge(RuntimeError):
    """A single request can never fit the KV pool (its prompt or decode
    footprint exceeds capacity with everything else evicted)."""

    def __init__(self, msg: str, req_id: int):
        super().__init__(msg)
        self.req_id = req_id


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, next slices: {item})")


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 16
    block_size: int = 16
    kv_pool_tokens: int = 8192          # total KV token capacity
    max_model_len: int = 1024
    prefill_bucket: int = 64            # pad prompts to multiples of this
    decode_mode: str = "paged"          # or "gather" (the dense-copy fallback)
    # the reference's other features; any value but the default raises
    # NotImplementedError (see the module docstring)
    prefix_cache: bool = False
    overlap: bool = False
    prefill_chunk_tokens: Optional[int] = None
    max_waiting: Optional[int] = None
    shed_kv_fraction: Optional[float] = None
    shed_queue_delay_s: Optional[float] = None
    speculate: bool = False

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}")
        if self.kv_pool_tokens % self.block_size:
            raise ValueError(
                f"kv_pool_tokens ({self.kv_pool_tokens}) must be divisible "
                f"by block_size ({self.block_size}); the pool is allocated "
                f"in whole blocks")
        if self.kv_pool_tokens < self.block_size:
            raise ValueError(
                f"kv_pool_tokens ({self.kv_pool_tokens}) must hold at least "
                f"one block of {self.block_size} tokens")
        if self.max_model_len > self.kv_pool_tokens:
            raise ValueError(
                f"max_model_len ({self.max_model_len}) exceeds the KV pool "
                f"capacity ({self.kv_pool_tokens} tokens): a single "
                f"max-length request could never be admitted — raise "
                f"kv_pool_tokens or lower max_model_len")
        if self.prefill_bucket < 1:
            raise ValueError(
                f"prefill_bucket must be >= 1, got {self.prefill_bucket}")
        if self.decode_mode not in ("paged", "gather"):
            raise ValueError(
                f"decode_mode must be 'paged' or 'gather', "
                f"got {self.decode_mode!r}")
        if self.prefix_cache:
            raise _not_ported("prefix_cache", "prefix-aware prefill")
        if self.prefill_chunk_tokens is not None:
            raise _not_ported("prefill_chunk_tokens",
                              "prefix-aware prefill (chunked prefill)")
        if self.overlap:
            raise _not_ported("overlap", "scheduler/executor overlap")
        if self.speculate:
            raise _not_ported("speculate", "speculative verify")
        if (self.max_waiting, self.shed_kv_fraction,
                self.shed_queue_delay_s) != (None, None, None):
            raise _not_ported("load shedding", "observability")


def _bucket(n: int, b: int) -> int:
    return max(b, ((n + b - 1) // b) * b)


def _pow2_bucket(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class ContinuousBatchingEngine:
    """Serves requests through ``model`` on its device; ``device=None``
    means the card and must match the model's."""

    def __init__(self, model: Model, ecfg: EngineConfig, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine asked "
                             f"for {self.device}")
        self.model = model
        self.cfg: ArchConfig = model.cfg
        self.ecfg = ecfg
        self.decode_mode = ecfg.decode_mode
        self.pool = PagedKVCache(
            self.cfg, num_blocks=ecfg.kv_pool_tokens // ecfg.block_size,
            block_size=ecfg.block_size, device=self.device)
        self.sched = Scheduler(self)
        # serving-timeline clock (seconds since start); run() installs one
        self.clock: Optional[Callable[[], float]] = None
        self.decode_steps = 0        # decode steps run
        self.prefills = 0            # admission prefills run
        self.itl_samples: List[float] = []
        self.batch_samples: List[int] = []
        self.kv_fraction_samples: List[float] = []
        self.max_kv_fraction = 0.0
        self.preemptions = 0
        self.prefill_tokens_computed = 0

    # scheduler state, re-exported under the reference engine's names
    @property
    def waiting(self) -> deque:
        return self.sched.waiting

    @property
    def running(self) -> List[Request]:
        return self.sched.running

    @running.setter
    def running(self, v):
        self.sched.running = v

    @property
    def _tokens(self):
        return self.sched._tokens

    @property
    def _pos(self):
        return self.sched._pos

    @property
    def busy(self) -> bool:
        """Any request still queued or decoding?"""
        return bool(self.waiting or self.running)

    def add_request(self, req: Request):
        if req.prompt_len + 1 > self.ecfg.max_model_len:
            raise ValueError(
                f"request {req.req_id}: prompt_len ({req.prompt_len}) + 1 "
                f"first output token exceeds max_model_len "
                f"({self.ecfg.max_model_len}); reject or truncate the "
                f"prompt upstream")
        if not req.sampling.greedy:
            raise _not_ported(f"request {req.req_id}: temperature > 0",
                              "bit-exact sampled decoding")
        if req.sampling.has_deadline:
            raise _not_ported(f"request {req.req_id}: deadlines",
                              "observability")
        self.waiting.append(req)

    def _now(self, fallback: float) -> float:
        return self.clock() if self.clock is not None else fallback

    def _limit(self, req: Request) -> int:
        """Output-token budget: the request's own cap, clipped by model
        length. At least 1 — prefill always emits the first token."""
        return max(1, min(req.max_new_tokens,
                          self.ecfg.max_model_len - req.prompt_len - 1))

    def _finish(self, req: Request, t_done: float, reason: str):
        self.max_kv_fraction = max(self.max_kv_fraction,
                                   self.pool.manager.used_fraction)
        req.state.finish_reason = reason
        req.state.t_done = t_done
        self.pool.release(req.req_id)
        self._tokens.pop(req.req_id, None)
        self._pos.pop(req.req_id, None)

    def _finish_or_run(self, req: Request, t_done: float) -> bool:
        """Finish protocol for the just-produced last token: a stop token
        ends the request the same step, else the length budget decides.
        Returns True when the request finished."""
        tok = req.state.output_tokens[-1]
        if req.sampling.stops_on(tok):
            self._finish(req, t_done, reason=FINISH_STOP)
        elif req.state.generated >= self._limit(req):
            self._finish(req, t_done, reason=FINISH_LENGTH)
        else:
            return False
        return True

    def _post_prefill(self, req: Request, now: float):
        """Stamp TTFT, then finish the request outright (a budget of one
        token, or a stop token first) or move it to the decode batch.
        ``now`` may be ahead of the clock after an arrival fast-forward."""
        req.state.t_first_token = max(now, self._now(now))
        if not self._finish_or_run(req, req.state.t_first_token):
            self.running.append(req)

    def _complete_prefill(self, req: Request, logits: torch.Tensor,
                          now: float):
        """The first output token from the prompt's last logits, then the
        decode bookkeeping and the finish-or-run decision."""
        rid = req.req_id
        tok = int(sample_tokens(logits, *stack_sampling([req.sampling]),
                                positions_array([req.prompt_len]))[0])
        self._tokens[rid] = tok
        self._pos[rid] = req.prompt_len
        req.generated = 1
        req.output_tokens.append(tok)
        self._post_prefill(req, now)

    def _prefill(self, req: Request) -> torch.Tensor:
        """Serial whole-prompt prefill at batch 1, padded to a multiple of
        ``prefill_bucket``; writes the K/V into the request's blocks and
        returns the last-position logits."""
        S = _bucket(req.prompt_len, self.ecfg.prefill_bucket)
        toks = np.zeros((1, S), np.int64)
        toks[0, :req.prompt_len] = req.prompt
        logits, cache = self.model.prefill(
            torch.from_numpy(toks).to(self.device),
            torch.tensor([req.prompt_len], device=self.device), cache_len=S)
        self.pool.write_prefill(req.req_id, cache)
        self.prefills += 1
        self.prefill_tokens_computed += req.prompt_len
        return logits

    def step(self, now: float) -> bool:
        """One engine iteration. Returns False when fully idle. The step
        timer starts before admission, so prefill stalls show in ITL."""
        plan = self.sched.plan(now)
        if not plan.has_decode:
            if plan.n_prefill:     # KV streamed in with no decode step
                self.kv_fraction_samples.append(
                    self.pool.manager.used_fraction)
                self.max_kv_fraction = max(self.max_kv_fraction,
                                           self.pool.manager.used_fraction)
            return self.busy
        reqs = plan.reqs
        if self.decode_mode == "paged":
            next_tokens = self._decode_paged(plan)
        else:
            next_tokens = self._decode_gather(plan)
        dt = time.perf_counter() - plan.t0
        self.itl_samples.append(dt)
        self.batch_samples.append(len(reqs))
        self.kv_fraction_samples.append(self.pool.manager.used_fraction)
        self.max_kv_fraction = max(self.max_kv_fraction,
                                   self.pool.manager.used_fraction)
        still = []
        for i, r in enumerate(reqs):
            self._pos[r.req_id] += 1
            tok = int(next_tokens[i])
            self._tokens[r.req_id] = tok
            r.state.generated += 1
            r.state.output_tokens.append(tok)
            if not self._finish_or_run(r, now + dt):
                still.append(r)
        self.running = still
        return True

    def _decode_paged(self, plan: StepPlan) -> np.ndarray:
        """One zero-copy decode step over the bucketed batch; returns the
        next token of each live row (padding rows are greedy and cut)."""
        rids, B = plan.rids, len(plan.rids)
        max_blocks = max(len(self.pool.manager.tables[rid]) for rid in rids)
        nb_pad = _pow2_bucket(max_blocks, lo=4)
        batch_pad = _pow2_bucket(B)
        view = self.pool.view(rids, plan.positions, nb_pad, batch_pad)
        tokens = np.zeros((batch_pad,), np.int64)
        tokens[:B] = [self._tokens[rid] for rid in rids]
        logits = self.model.decode_step(
            torch.from_numpy(tokens).to(self.device), view)
        temp, top_k, top_p, seed = stack_sampling(
            [r.sampling for r in plan.reqs], pad_to=batch_pad)
        next_tokens = sample_tokens(
            logits, temp, top_k, top_p, seed,
            positions_array([p + 1 for p in plan.positions], batch_pad))
        self.decode_steps += 1
        return next_tokens[:B].cpu().numpy()

    def _decode_gather(self, plan: StepPlan) -> np.ndarray:
        """One dense-copy decode step (the reference's ``_decode_gather``):
        gather, decode at ``lengths = pos + 1``, scatter the new rows
        back, then sample; returns the next token of each row."""
        rids = plan.rids
        pad_blocks = self.pool.manager.blocks_needed(
            _bucket(max(plan.positions) + 1, self.ecfg.block_size * 4))
        cache = self.pool.gather(rids, pad_blocks)
        host = np.array([[self._tokens[rid] for rid in rids],
                         plan.positions], np.int64)
        tokens, pos = torch.from_numpy(host).to(self.device)
        logits = self.model.decode_step(tokens, cache, pos, lengths=pos + 1)
        self.pool.scatter_new_token(rids, plan.positions, cache)
        next_tokens = sample_tokens(
            logits, *stack_sampling([r.sampling for r in plan.reqs]),
            positions_array([p + 1 for p in plan.positions]))
        self.decode_steps += 1
        return next_tokens.cpu().numpy()

    def run(self, requests: List[Request]) -> ServingMetrics:
        """Batch-offline loop: submit everything, step to completion with
        arrival fast-forwarding and a monotonic ``now``, collect metrics
        (the semantics of the reference's ``_EngineBackend.run``)."""
        for r in requests:
            self.add_request(r)
        prev_clock = self.clock
        t_start = time.perf_counter()
        self.clock = lambda: time.perf_counter() - t_start
        try:
            now = 0.0
            while self.busy:
                if not self.running and self.waiting:
                    now = max(now, self.waiting[0].arrival_s)
                self.step(now)
                now = max(now, time.perf_counter() - t_start)
            wall = time.perf_counter() - t_start
        finally:
            self.clock = prev_clock
        return collect(list(requests), wall, self.itl_samples,
                       self.max_kv_fraction, self.batch_samples,
                       kv_samples=self.kv_fraction_samples,
                       preemptions=self.preemptions)
