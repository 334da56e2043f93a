"""Continuous-batching serving engine (Orca/vLLM-style) on the paged KV
pool: the synchronous slice of ``repro.serving.engine``.

Each engine iteration admits waiting requests FCFS under ``max_batch``
and the pool's free-block watermark, runs prefill work, then one decode
step for every running request at its own position. Prefill is serial by
default (each admitted prompt is prefilled at batch 1 in a padded length
bucket and emits its first token) or chunked (``prefill_chunk_tokens``:
admission reserves a seat, and every step runs up to that many prompt
tokens, FCFS, each chunk attending over the request's already-written
pool KV and writing its rows token by token, so a long prompt streams in
between decode steps). With ``prefix_cache`` a radix index over full
blocks splices a prompt's longest cached prefix into its block table and
only the rest is prefilled. A prefill over a prefix (a cache hit, a
chunk after the prompt's first) goes through the flash kernel's
prefix-masked entry, every other through its plain entry with the
request's length. Decode runs in one of the reference's two modes:

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
are preempted and recomputed later. Tokens are greedy or sampled
(temperature, top-k, top-p) with the reference's counter-based RNG, keyed
on each request's seed and position, so preemption, batch composition
and chunked against serial prefill all leave a request's tokens as they
are; sampling runs on the device and only the ``[B]`` ids come back.

With ``speculate`` (the reference's speculative decoding, paged mode
only) a prompt-lookup drafter proposes up to ``spec_k`` tokens a request
from its own prompt and output, and a step with any draft is a verify
step: ``K + 1`` serial decode iterations with the acceptance on the
device (:mod:`repro_torch.serving.spec`). Each row commits its accepted
drafts plus one sampled token, token by token through the finish
protocol, and the table tail reserved for the rest is rolled back; the
tokens are serial decode's.

Every step (the paged and the gather decode step, a verify step, each
prefill and chunk) runs on static buffers and, on a CUDA device, replays
one CUDA graph a shape bucket, captured at the bucket's first use
(:mod:`repro_torch.serving.steps`, the reference's ``StepFunctions``);
``cuda_graphs=False`` keeps them eager, for comparison. With ``overlap``
the :class:`~repro_torch.serving.executor.Executor` keeps two decode
steps in flight and commits each an iteration or two later, with the
same tokens as the synchronous loop; prefills replay on the same stream,
so the pool's writes stay in order. :meth:`ContinuousBatchingEngine.abort` and
:meth:`~ContinuousBatchingEngine.evict_request` finish a request in any
phase and reclaim its blocks.

Requests may carry deadlines (``deadline_s``, ``ttft_deadline_s``): each
step first finishes every request past its deadline, in any phase, its
partial output kept. :meth:`ContinuousBatchingEngine.try_add_request`
applies admission control (``max_waiting``, ``shed_kv_fraction``,
``shed_queue_delay_s``, and a deadline the estimated queue delay already
blows), finishing a rejected request as ``shed`` instead of queueing it.

A VLM's requests each hold a dense-state slot of image K/V, written
by their prefill from the reference's zero image stub (the vision
frontend is not modelled) and read by every decode step. The encoder
and sliding-window configs, which no decode step of the reference's
engine runs, are refused at construction (:func:`refuse_undecodable`).

On a CUDA device each engine queues all its device work on a CUDA
stream of its own (:attr:`ContinuousBatchingEngine.stream`), so engines
co-located on one card and stepped on their own threads
(:mod:`repro_torch.serving.cluster`) run their kernels at the same time.
A cluster's fault injector (``engine.faults``,
:mod:`repro_torch.serving.faults`) is consulted at the top of each step,
before anything is dispatched, and at admission.

Over a mesh (a ``Model`` that is one rank of a tensor-parallel model,
:mod:`repro_torch.distributed`) every rank builds the same engine over
its shard and its KV heads' pool. Rank 0 runs the scheduler and sends
each step it runs (its key and staged words) and each pool copy to the
other ranks before running it; they :meth:`~ContinuousBatchingEngine.
follow`, so every rank issues the same collectives in the same order
whatever rank 0's clock decided (:meth:`ContinuousBatchingEngine.
serve_mesh` does both). Every mode runs over a mesh: the overlapped
executor, chunked prefill, the prefix cache, speculation and the gather
mode decide on rank 0's host (its scheduler, prefix index, drafter,
chain map and verify keys), and what they decide reaches the other
ranks only as staged words and pool copies. Preemption, rollback and
aborts stay on rank 0's host. Every mode also runs over a KV sequence
sharded on the model axis (``shard_kv_seq``: each rank's pool holds its
share of every block's rows): a dense copy or a prefix holds the rank's
rows, a prefill over a prefix all-gathers them, and every decode
combines every rank's partials, so the ranks' outputs stay bit-identical
and a chained row may read its own rank's previous output.

Over a data axis (a ``D x M`` mesh) one engine serves ``max_batch`` rows
split over D data ranks: rank 0's scheduler gives each request a seat
on one data rank (:mod:`repro_torch.serving.scheduler`), whose share of
the pool holds its blocks, and each step runs every rank's block of the
rows at one common bucket, its outputs gathered over the data axis
(:mod:`repro_torch.serving.steps`). Serial admissions prefill one
request a data rank a step (:meth:`ContinuousBatchingEngine.
_prefill_waves`); a chunk runs alone. The synchronous and the overlapped
loops and chunked prefill run there; the prefix cache, speculation, the
gather mode and ``max_batch`` not divisible by D are refused at
construction (:func:`refuse_data`).

An attached observer (``engine.obs``, :mod:`repro_torch.serving.obs`)
receives every lifecycle event, every prefill and decode step's bucket
census, live attention work and device time (CUDA events around the
step's replay, read once its output is on the host), and each step's
end. Detached, each hook site costs one attribute check and no event is
recorded. Every per-step series is bounded
(:class:`~repro_torch.serving.obs.series.BoundedSeries`,
``series_maxlen``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.census import LiveWork
from repro_torch.device import on_stream, resolve_device
from repro_torch.distributed import StepChannel
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.kvcache.prefix import (PrefixIndex, PrefixStats,
                                        prefix_cache_supported)
from repro_torch.models.model import Model
from repro_torch.models.sampler import (positions_array, sample_tokens,
                                        stack_sampling)
from repro_torch.serving.executor import Executor
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.obs.series import (DEFAULT_SERIES_MAXLEN,
                                            BoundedSeries)
from repro_torch.serving.scheduler import Scheduler, StepPlan
from repro_torch.serving.spec import Drafter, PromptLookupDrafter
from repro_torch.serving.spec.verify import accepted_prefix
from repro_torch.serving.steps import (StepFunctions, bucket, pow2_bucket,
                                       split_verify)
from repro_torch.serving.workload import (FINISH_ABORT, FINISH_FAILED,
                                          FINISH_LENGTH, FINISH_STOP, Request)


def refuse_undecodable(cfg: ArchConfig):
    """Refuse, at construction, a config no decode step of the
    reference's engine runs, with the reference's own reason: an encoder
    (prompts are embeddings, so its first prefill fails there on a
    ``KeyError: 'embeds'``), and a sliding window (the reference falls
    back to its gather mode, whose ragged decode asserts ``ragged decode
    does not support windows`` at the first step; its paged pool holds no
    ring). The static-batch loop (``Model.prefill`` and
    ``Model.decode_step`` at one position) runs both families' paths."""
    if cfg.embedding_inputs:
        raise NotImplementedError(
            f"{cfg.name}: an encoder has no decode step: its inputs are "
            f"embeddings, not token ids (the reference engine fails at its "
            f"first prefill, KeyError: 'embeds'); use Model.forward")
    if cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: sliding window {cfg.sliding_window}: ragged "
            f"decode does not support windows and the paged pool holds no "
            f"ring (the reference engine falls back to gather mode and "
            f"fails at its first decode); use the static-batch loop")


def refuse_data(ecfg: "EngineConfig", data: int):
    """Refuse, at construction, what one engine does not run over a data
    axis of ``data`` ranks: the prefix cache, speculation and the gather
    mode (naming the ROADMAP entry), and a batch or pool that does not
    split into equal shares, or a share a max-length request cannot
    fit."""
    if data == 1:
        return
    from repro_torch.launch.mesh import multi_card_item
    for on, what in ((ecfg.prefix_cache, "the prefix cache"),
                     (ecfg.speculate, "speculation"),
                     (ecfg.decode_mode == "gather", "the gather mode")):
        if on:
            raise NotImplementedError(
                f"{what} over a data axis of {data} "
                f"({multi_card_item('data')})")
    if ecfg.max_batch % data:
        raise ValueError(
            f"max_batch ({ecfg.max_batch}) does not divide over {data} "
            f"data ranks: each rank holds max_batch / {data} seats")
    blocks = ecfg.kv_pool_tokens // ecfg.block_size
    if blocks % data or blocks // data * ecfg.block_size \
            < ecfg.max_model_len:
        raise ValueError(
            f"a pool of {blocks} blocks of {ecfg.block_size} does not "
            f"split over {data} data ranks into shares that each hold a "
            f"max_model_len ({ecfg.max_model_len}) request")


class RequestTooLarge(RuntimeError):
    """A single request can never fit the KV pool (its prompt or decode
    footprint exceeds capacity with everything else evicted)."""

    def __init__(self, msg: str, req_id: int):
        super().__init__(msg)
        self.req_id = req_id


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 16
    block_size: int = 16
    kv_pool_tokens: int = 8192          # total KV token capacity
    max_model_len: int = 1024
    prefill_bucket: int = 64            # pad prompts to multiples of this
    decode_mode: str = "paged"          # or "gather" (the dense-copy fallback)
    # radix prefix cache over full blocks (opt-in), and a cap on the
    # blocks it holds (None: bounded only by LRU eviction)
    prefix_cache: bool = False
    prefix_cache_blocks: Optional[int] = None
    # chunked prefill: a step's prompt-token budget (None: serial)
    prefill_chunk_tokens: Optional[int] = None
    # two decode steps in flight, committed an iteration or two later
    overlap: bool = False
    # on a CUDA device, replay every step (paged or gather decode, verify,
    # each prefill) from one CUDA graph a bucket (False: every step eager,
    # the same kernels, for comparison)
    cuda_graphs: bool = True
    # speculative decoding (prompt-lookup drafts, off by default): verify
    # up to spec_k drafted tokens a request a step; the tokens stay
    # serial decode's. Needs the paged decode path and per-token KV;
    # other configs fall back, the reason in spec_disabled_reason
    speculate: bool = False
    spec_k: int = 8                     # most draft tokens a step
    spec_ngram: int = 3                 # longest prompt-lookup n-gram
    # overlap only: every spec_probe_every-th iteration with rows chained
    # to an in-flight plain step plans nothing, so the drafter sees
    # committed context
    spec_probe_every: int = 8
    # --- admission control / load shedding (all off by default) ---
    # bound on the arrival queue: a submit past it is shed ("queue_full")
    max_waiting: Optional[int] = None
    # refuse submits while the pool is fuller than this fraction and
    # requests already queue behind it ("kv_pressure")
    shed_kv_fraction: Optional[float] = None
    # refuse submits once the estimated queue delay exceeds this bound
    # ("queue_delay"); a submit whose own deadline the estimate blows is
    # shed as "deadline_unmeetable" even without it
    shed_queue_delay_s: Optional[float] = None
    # bound on every per-step series (ITL, KV occupancy, stall, token
    # splits, preemptions, the observer's samples): a series reaching it
    # decimates itself (uniform 1-in-N over the whole run)
    series_maxlen: int = DEFAULT_SERIES_MAXLEN

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
        if self.prefix_cache_blocks is not None \
                and self.prefix_cache_blocks < 1:
            raise ValueError(
                f"prefix_cache_blocks must be >= 1 (or None for "
                f"unbounded), got {self.prefix_cache_blocks}")
        if self.prefill_chunk_tokens is not None \
                and self.prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1 (or None for serial "
                f"admission-time prefill), got {self.prefill_chunk_tokens}")
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.spec_ngram < 1:
            raise ValueError(
                f"spec_ngram must be >= 1, got {self.spec_ngram}")
        if self.spec_probe_every < 1:
            raise ValueError(
                f"spec_probe_every must be >= 1, got "
                f"{self.spec_probe_every}")
        if self.max_waiting is not None and self.max_waiting < 1:
            raise ValueError(
                f"max_waiting must be >= 1 (or None for an unbounded "
                f"queue), got {self.max_waiting}")
        if self.shed_kv_fraction is not None \
                and not 0.0 < self.shed_kv_fraction <= 1.0:
            raise ValueError(
                f"shed_kv_fraction must be in (0, 1] (or None to "
                f"disable), got {self.shed_kv_fraction}")
        if self.shed_queue_delay_s is not None \
                and self.shed_queue_delay_s <= 0:
            raise ValueError(
                f"shed_queue_delay_s must be > 0 (or None to disable), "
                f"got {self.shed_queue_delay_s}")
        if self.series_maxlen < 2:
            raise ValueError(
                f"series_maxlen must be >= 2, got {self.series_maxlen}")


_bucket = bucket
_pow2_bucket = pow2_bucket


class ContinuousBatchingEngine:
    """Serves requests through ``model`` on its device; ``device=None``
    means the card and must match the model's. ``steps``, a dead
    engine's :class:`StepFunctions` built for the same model and
    configuration, rebuilds the engine over its pool tensors, graphs and
    stream with a fresh allocator (a cluster's respawn)."""

    def __init__(self, model: Model, ecfg: EngineConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 steps: Optional[StepFunctions] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine asked "
                             f"for {self.device}")
        refuse_undecodable(model.cfg)
        refuse_data(ecfg, model.data)
        self.model = model
        self.cfg: ArchConfig = model.cfg
        self.ecfg = ecfg
        self.decode_mode = ecfg.decode_mode
        # chunked prefill, the prefix cache and speculation need
        # per-token-addressable KV; an unsupported config falls back, the
        # reason recorded
        ok, why = prefix_cache_supported(self.cfg)
        # speculation also needs the paged pool's tables to roll back
        self.speculator: Optional[Drafter] = None
        self.spec_disabled_reason: Optional[str] = None
        if ecfg.speculate:
            if not ok:
                self.spec_disabled_reason = why
            elif self.decode_mode != "paged":
                self.spec_disabled_reason = (
                    "decode_mode 'gather' (dense-copy fallback has no "
                    "paged block tables to roll back)")
            else:
                self.speculator = PromptLookupDrafter(
                    max_ngram=ecfg.spec_ngram, max_k=ecfg.spec_k)
        spec_k = ecfg.spec_k if self.speculator is not None else None
        if steps is None:
            # the engine's own stream: every device operation of the
            # engine is queued on it, so engines stepped on several host
            # threads run on the card at the same time
            stream = None
            if self.device.type == "cuda":
                stream = torch.cuda.Stream(self.device)
                # the weights were written on the caller's stream
                stream.wait_stream(torch.cuda.current_stream(self.device))
            with on_stream(stream):
                self.pool = PagedKVCache(
                    self.cfg,
                    num_blocks=ecfg.kv_pool_tokens // ecfg.block_size,
                    block_size=ecfg.block_size, device=self.device,
                    max_batch=ecfg.max_batch, kv_heads=model.n_kv_heads,
                    seq_shard=model.seq_shard, data=model.data)
                steps = StepFunctions(
                    model, self.pool, max_batch=ecfg.max_batch,
                    max_model_len=ecfg.max_model_len,
                    prefill_bucket=ecfg.prefill_bucket,
                    cuda_graphs=ecfg.cuda_graphs, spec_k=spec_k,
                    stream=stream)
            if stream is not None:
                # and the caller's later work sees the zeroed pool
                torch.cuda.current_stream(self.device).wait_stream(stream)
        else:
            # a dead engine's steps (a respawn): its pool tensors, graphs
            # and stream, with a fresh allocator; the caller drained the
            # stream first
            steps.check_reuse(model, ecfg, spec_k)
            steps.pool.reset()
            steps.timing, steps.last = False, None
            self.pool = steps.pool
        self.steps = steps
        if model.group is not None:
            steps.channel = StepChannel(model.group)
            if steps.channel.leads:
                self.pool.mirror = steps.channel.send
        self.sched = Scheduler(self)
        self._executor = Executor(self)
        self.step_count = 0          # step() calls, counted from 1
        # fault injection (serving.faults): a cluster installs one
        # injector and this engine's replica id; None consults no hook
        self.faults: Optional[FaultInjector] = None
        self.replica_id = 0
        # observability hook sink (serving.obs): None = detached; an
        # attached observer also turns the steps' device-time marks on
        self._obs = None
        self.chunking = ecfg.prefill_chunk_tokens is not None and ok
        self.chunking_disabled_reason = (
            why if ecfg.prefill_chunk_tokens is not None else None)
        self.prefix: Optional[PrefixIndex] = None
        self.prefix_disabled_reason = why if ecfg.prefix_cache else None
        if ecfg.prefix_cache and ok:
            self.prefix = PrefixIndex(self.pool.manager,
                                      max_blocks=ecfg.prefix_cache_blocks)
        # serving-timeline clock (seconds since start); run() installs one
        self.clock: Optional[Callable[[], float]] = None
        self.reset_stats()

    def follow(self):
        """A rank other than 0 over a mesh: run the steps and pool copies
        rank 0's engine sends, on this engine's stream, until it stops."""
        with on_stream(self.stream):
            self.steps.follow()

    def serve_mesh(self, requests: List[Request]
                   ) -> Optional[ServingMetrics]:
        """Every rank of a mesh calls this with the same engine
        configuration: rank 0 serves ``requests`` (:meth:`run`) and then
        releases the others, which follow it meanwhile. Returns rank 0's
        metrics, None on the other ranks."""
        if self.model.group is None:
            raise ValueError("serve_mesh needs a model over a mesh")
        if not self.steps.channel.leads:
            self.follow()
            return None
        try:
            return self.run(requests)
        finally:
            with on_stream(self.stream):
                self.steps.channel.stop()

    @property
    def stream(self) -> Optional[torch.cuda.Stream]:
        """The CUDA stream the engine queues its device work on (None on
        the CPU)."""
        return self.steps.stream

    def reset_stats(self):
        """Clear the telemetry (e.g. after a warm-up run); the prefix
        index keeps its contents, only its counters reset."""
        self.decode_steps = 0        # plain decode steps run
        self.prefills = 0            # whole or suffix prefills run
        # prefill steps run (a serial prefill or a chunk each; over a
        # data axis a step prefills up to one request a data rank)
        self.prefill_steps = 0
        self.chunks = 0              # chunk prefills run
        # prefills and chunks that attend over a prefix in the pool (a
        # prefix-cache hit, or a chunk after the prompt's first)
        self.suffix_prefills = 0
        ml = self.ecfg.series_maxlen
        self.itl_samples: List[float] = BoundedSeries(ml)
        self.batch_samples: List[int] = BoundedSeries(ml)
        self.kv_fraction_samples: List[float] = BoundedSeries(ml)
        self.max_kv_fraction = 0.0
        self.preemptions = 0
        self.prefill_tokens_computed = 0
        # per step: seconds of admission and prefill before the decode
        # launch (the head-of-line share of ITL), prompt and decode tokens,
        # and the preemptions it made
        self.stall_samples: List[float] = BoundedSeries(ml)
        self.prefill_token_samples: List[int] = BoundedSeries(ml)
        self.decode_token_samples: List[int] = BoundedSeries(ml)
        self.preemption_samples: List[int] = BoundedSeries(ml)
        self.queued_aborts = 0       # aborts caught in the arrival queue
        # robustness counters (also broken down in finish_reasons)
        self.deadline_expired = 0
        self.shed = 0
        self.shed_reasons: Dict[str, int] = {}
        # the newest decode step's bucket facts, kept only while observed:
        # (rows_pad, table width, live table entries), the memory-gap
        # auditor's bucket-pad overlay
        self._last_buckets = None
        # overlapped commits that found their step still running (the
        # device set the pace), of decode_steps
        self.commit_waits = 0
        # speculation: verify steps committed, draft tokens proposed,
        # accepted and rejected, each verify step's acceptance rate; and
        # the decode iterations of the verify steps run (K_pad + 1 each)
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.spec_acceptance_samples: List[float] = BoundedSeries(ml)
        self.verify_iterations = 0
        if self.prefix is not None:
            self.prefix.stats = PrefixStats()

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
    def prefilling(self) -> List[Request]:
        return self.sched.prefilling

    @property
    def _prefilled(self):
        return self.sched._prefilled

    @property
    def _tokens(self):
        return self.sched._tokens

    @property
    def _pos(self):
        return self.sched._pos

    @property
    def obs(self):
        """The attached observer (None: detached)."""
        return self._obs

    @obs.setter
    def obs(self, observer):
        self._obs = observer
        self.steps.timing = observer is not None

    @property
    def busy(self) -> bool:
        """Any request still queued, prefilling or decoding?"""
        return bool(self.waiting or self.prefilling or self.running)

    def add_request(self, req: Request):
        if req.prompt_len + 1 > self.ecfg.max_model_len:
            raise ValueError(
                f"request {req.req_id}: prompt_len ({req.prompt_len}) + 1 "
                f"first output token exceeds max_model_len "
                f"({self.ecfg.max_model_len}); reject or truncate the "
                f"prompt upstream")
        if req.sampling.has_deadline:
            self.sched._has_deadlines = True
        self.waiting.append(req)
        if self.obs is not None:
            self.obs.on_submit(req)

    # ----------------------------------------------- admission control --
    def estimated_queue_delay_s(self) -> float:
        """See :meth:`Scheduler.estimated_queue_delay_s`."""
        return self.sched.estimated_queue_delay_s()

    def shed_check(self, req: Request, now: float) -> Optional[str]:
        """Would admission control reject ``req`` submitted at ``now``?
        See :meth:`Scheduler.shed_check`."""
        return self.sched.shed_check(req, now)

    def shed_request(self, req: Request, now: float, reason: str):
        """See :meth:`Scheduler.shed_request`."""
        self.sched.shed_request(req, now, reason)

    def try_add_request(self, req: Request, now: float) -> Optional[str]:
        """Admission-controlled enqueue: shed ``req`` (returning the
        reason) or accept it (returning None). An overloaded engine
        degrades by rejecting work; it never raises on it."""
        reason = self.shed_check(req, now)
        if reason is not None:
            self.shed_request(req, now, reason)
            return reason
        self.add_request(req)
        return None

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
        self.pool.manager.disown(req.req_id)
        self._tokens.pop(req.req_id, None)
        self._pos.pop(req.req_id, None)
        self.sched._dispatched.pop(req.req_id, None)
        # its rows of any step still in flight never commit
        self._executor.invalidate(req.req_id)
        if self.speculator is not None:
            self.speculator.forget(req.req_id)
        if self.obs is not None:
            self.obs.on_finish(req, reason)

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
        if self.obs is not None:
            self.obs.on_first_token(req)
        if not self._finish_or_run(req, req.state.t_first_token):
            self.running.append(req)

    def abort(self, req_id: int, now: float = 0.0) -> bool:
        """Cancel a request in any phase: queued (nothing allocated; counted
        in ``queued_aborts``), prefilling (chunk progress dropped) or
        decoding (its in-flight rows discarded). Every block is released
        (shared prefix blocks back to their cache-only count) and the
        request finishes with ``finish_reason="abort"``. Returns False for
        an unknown or finished request."""
        with on_stream(self.stream):
            return self._abort(req_id, now)

    def _abort(self, req_id: int, now: float) -> bool:
        req = next((r for r in self.waiting if r.req_id == req_id), None)
        if req is not None:
            self.waiting.remove(req)
            self.queued_aborts += 1
        else:
            for lst in (self.prefilling, self.running):
                req = next((r for r in lst if r.req_id == req_id), None)
                if req is not None:
                    lst.remove(req)
                    break
        if req is None:
            return False
        self._prefilled.pop(req_id, None)
        self._finish(req, max(self._now(now), req.arrival_s),
                     reason=FINISH_ABORT)
        return True

    def evict_request(self, req_id: int, now: float = 0.0,
                      reason: str = FINISH_FAILED) -> Optional[Request]:
        """Force-finish one request with the caller's reason, releasing its
        blocks (as :meth:`abort`, but a queued eviction is not a client
        abort). Returns the request, or None if unknown or finished."""
        with on_stream(self.stream):
            return self._evict(req_id, now, reason)

    def _evict(self, req_id: int, now: float, reason: str
               ) -> Optional[Request]:
        for lst in (self.waiting, self.prefilling, self.running):
            req = next((r for r in lst if r.req_id == req_id), None)
            if req is not None:
                lst.remove(req)
                self._prefilled.pop(req_id, None)
                self._finish(req, max(self._now(now), req.arrival_s),
                             reason=reason)
                return req
        return None

    def _complete_prefill(self, req: Request, logits: torch.Tensor,
                          now: float):
        """The one completion protocol of every prefill mode: the first
        output token sampled from the prompt's last logits (RNG counter
        ``prompt_len``, the same for serial, suffix-only and chunked
        prefill), the decode bookkeeping, the prompt's full blocks
        registered in the prefix index, and the finish-or-run decision."""
        rid = req.req_id
        tok = int(sample_tokens(logits, *stack_sampling([req.sampling]),
                                positions_array([req.prompt_len]))[0])
        self._tokens[rid] = tok
        self._pos[rid] = req.prompt_len
        # the first token is dispatched and committed: the overlap
        # planner's length gate starts here
        self.sched._dispatched[rid] = 1
        req.generated = 1
        req.output_tokens.append(tok)
        if self.prefix is not None:
            self.prefix.insert(req.prompt, self.pool.manager.tables[rid])
        self._post_prefill(req, now)

    def _suffix_prefill(self, req: Request, start: int, n: int,
                        prefix_blocks: int, variant: str) -> torch.Tensor:
        """Prefill prompt positions ``[start, start + n)`` at batch 1 over
        the prefix in the request's first ``prefix_blocks`` blocks
        (gathered in a power-of-two number of blocks, as in the reference;
        none when ``start`` is 0), writing the rows token by token (the
        engine's step, a graph replay on a CUDA device). Returns the last
        position's ``[1, vocab]`` logits. An observer gets the call as
        ``variant`` (the reference's name for it)."""
        if start:
            self.suffix_prefills += 1
        self.prefill_steps += 1
        self.prefill_tokens_computed += n
        nb_pad = _pow2_bucket(prefix_blocks)
        call = lambda: self.steps.prefill(  # noqa: E731
            req.req_id, req.prompt[start:start + n], start, prefix_blocks,
            nb_pad)
        obs = self.obs
        if obs is None:
            return call()
        S = self.steps.prefill_key(n, start, nb_pad)[1]
        sc = obs.census.get(variant, (S, nb_pad) if start else (S,),
                            cfg=self.cfg, block_size=self.ecfg.block_size)
        self.steps.census_for = sc
        t0 = time.perf_counter()
        logits = call()
        t1 = time.perf_counter()
        obs.on_prefill(req, variant, sc, t0, t1, self.steps.last, tokens=n,
                       live=LiveWork(rows=n, context=start,
                                     entries=prefix_blocks),
                       step=self.step_count)
        return logits

    def _prefill(self, req: Request, n_cached: int = 0) -> torch.Tensor:
        """Serial prefill of the uncached part of the prompt (all of it
        without a prefix-cache hit), attending over the cached prefix's
        ``n_cached`` tokens (whole blocks); writes its K/V into the
        request's own blocks and returns the last-position logits."""
        if n_cached % self.ecfg.block_size:
            raise ValueError(
                f"a cached prefix of {n_cached} tokens is not block-aligned "
                f"(block_size={self.ecfg.block_size})")
        self.prefills += 1
        return self._suffix_prefill(req, n_cached, req.prompt_len - n_cached,
                                    n_cached // self.ecfg.block_size,
                                    "prefix_prefill" if n_cached
                                    else "prefill")

    def _prefill_waves(self, reqs: List[Request], now: float):
        """Prefill serial admissions over a data axis (their blocks
        allocated, prompts uncached): each step carries the first pending
        request of every data rank, in admission order, and completes
        them (:meth:`_complete_prefill`) before the next."""
        mgr = self.pool.manager
        pending = list(reqs)
        while pending:
            wave: Dict[int, Request] = {}
            for r in pending:
                wave.setdefault(mgr.rank_of(r.req_id), r)
            pending = [r for r in pending if r not in wave.values()]
            jobs = [(r.req_id, r.prompt, 0, 0) for r in wave.values()]
            n = max(r.prompt_len for r in wave.values())
            self.prefills += len(jobs)
            self.prefill_steps += 1
            self.prefill_tokens_computed += sum(r.prompt_len
                                                for r in wave.values())
            obs = self.obs
            if obs is not None:
                sc = obs.census.get("prefill", (self.steps.prefill_key(
                    n, 0, 1)[1],), cfg=self.cfg,
                    block_size=self.ecfg.block_size)
                self.steps.census_for = sc
                t0 = time.perf_counter()
            logits = self.steps.prefill_wave(jobs, 1)
            if obs is not None:
                first = next(iter(wave.values()))
                obs.on_prefill(first, "prefill", sc, t0,
                               time.perf_counter(), self.steps.last,
                               tokens=n, live=LiveWork(rows=n, context=0,
                                                       entries=0),
                               step=self.step_count)
            for d, r in wave.items():
                self._complete_prefill(r, logits[d:d + 1], now)

    def _run_chunk(self, req: Request, done: int, chunk: int
                   ) -> torch.Tensor:
        """Prefill prompt positions ``[done, done + chunk)`` over the KV
        already in the pool (``done`` need not be block-aligned) and write
        the chunk's rows token by token; returns its last logits (only the
        final chunk's are used)."""
        self.chunks += 1
        return self._suffix_prefill(req, done, chunk,
                                    -(-done // self.ecfg.block_size),
                                    "chunk_prefill" if done else "prefill")

    def step(self, now: float) -> bool:
        """One engine iteration, its device work queued on the engine's
        stream. Returns False when fully idle. In sync mode the decode
        step runs and commits here; under overlap the executor dispatches
        it and commits earlier ones. The step timer starts before
        admission, so prefill stalls show in ITL."""
        self.step_count += 1
        if self.faults is not None:
            # may sleep (delay, the watchdog's trigger) or raise
            # InjectedFault (kill, the cluster's quarantine trigger): on
            # the host, before any mutation and before any dispatch, so
            # injected faults stay ordered under overlap too
            self.faults.on_step(self.replica_id, self.step_count)
        with on_stream(self.stream):
            return self._step(now)

    def _step(self, now: float) -> bool:
        if self.ecfg.overlap:
            return self._executor.step(now)
        plan = self.sched.plan(now)
        if not plan.has_decode:
            if plan.n_prefill:     # KV streamed in with no decode step
                self._record_prefill_only(plan,
                                          self.preemptions - plan.p0)
            return self.busy
        reqs = plan.reqs
        if plan.drafts is not None:
            # a verify step: a variable number of tokens a row
            self._spec_step_sync(plan, now)
            return True
        if self.decode_mode == "paged":
            next_tokens = self._decode_paged(plan)
        else:
            next_tokens = self._decode_gather(plan)
        dt = time.perf_counter() - plan.t0
        self._record_decode(dt, plan, len(reqs),
                            preempted=self.preemptions - plan.p0)
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
        if self.obs is not None:
            # last statement of the step: the host phase runs to here
            self.obs.end_step(self, t0=plan.t0, t_sched_s=plan.t_sched,
                              n_prefill=plan.n_prefill, n_decode=len(reqs))
        return True

    def _record_kv(self):
        self.kv_fraction_samples.append(self.pool.manager.used_fraction)
        self.max_kv_fraction = max(self.max_kv_fraction,
                                   self.pool.manager.used_fraction)

    def _record_prefill_only(self, plan: StepPlan, preempted: int):
        """The series of an iteration that streamed KV in with no decode
        step (``preempted``: the preemptions since the last sample), and
        the observer's step end."""
        self.stall_samples.append(plan.t_sched)
        self.prefill_token_samples.append(plan.n_prefill)
        self.decode_token_samples.append(0)
        self.preemption_samples.append(preempted)
        self._record_kv()
        if self.obs is not None:
            self.obs.end_step(self, t0=plan.t0, t_sched_s=plan.t_sched,
                              n_prefill=plan.n_prefill, n_decode=0)

    def _record_decode(self, itl: float, plan: StepPlan, n_decode: int,
                       tokens: Optional[int] = None, preempted: int = 0):
        """The series of a committed decode step of ``n_decode`` rows that
        committed ``tokens`` tokens (one a row unless a verify step's)."""
        self.itl_samples.append(itl)
        self.stall_samples.append(plan.t_sched)
        self.prefill_token_samples.append(plan.n_prefill)
        self.decode_token_samples.append(
            n_decode if tokens is None else tokens)
        self.preemption_samples.append(preempted)
        self.batch_samples.append(n_decode)
        self._record_kv()

    def _step_facts(self, variant: str, plan: StepPlan):
        """An observed decode, gather or verify step's bucket census and
        live attention work (:class:`~repro_torch.core.census.LiveWork`:
        its rows, their summed lengths, their live table entries), read
        on the host at staging; stashes the bucket facts for the
        memory-gap auditor and hands the census to the step
        (:attr:`~repro_torch.serving.steps.StepFunctions.census_for`).
        Returns ``(census, live)``."""
        rids, positions = plan.rids, plan.positions
        if variant == "decode_gather":
            width = self.steps.gather_bucket(positions)
            bucket: Tuple = (len(rids), width)
        elif variant == "spec_verify":
            bucket = self.steps.verify_bucket(rids, plan.drafts)
            width = bucket[1]
        else:
            bucket = self.steps.paged_bucket(rids)
            width = bucket[1]
        tables = self.pool.manager.tables
        entries = sum(min(len(tables[r]), width) for r in rids)
        self._last_buckets = (bucket[0], width, entries)
        live = LiveWork(rows=len(rids), context=sum(positions) + len(rids),
                        entries=entries)
        sc = self.obs.census.get(variant, bucket, cfg=self.cfg,
                                 block_size=self.ecfg.block_size)
        # the step's eager body (a first use), if it runs one, fills the
        # bucket's dispatched census
        self.steps.census_for = sc
        return sc, live

    def _observed_sync(self, variant: str, plan: StepPlan, dispatch,
                       fetch) -> np.ndarray:
        """Run one sync decode, gather or verify step: ``dispatch()``
        queues it, ``fetch(out)`` brings its tokens to the host; an
        attached observer gets its census, live work, host stamps and
        device-time marks."""
        obs = self.obs
        if obs is None:
            return fetch(dispatch())
        sc, live = self._step_facts(variant, plan)
        t0 = time.perf_counter()
        out = dispatch()
        t1 = time.perf_counter()
        timing = self.steps.last
        host = fetch(out)
        obs.on_decode(sc, t0, t1, time.perf_counter(), timing,
                      batch=len(plan.rids), variant=variant, live=live)
        return host

    def _decode_paged(self, plan: StepPlan) -> np.ndarray:
        """One zero-copy decode step over the bucketed batch (a graph
        replay on a CUDA device); returns the next token of each live
        row (padding rows are greedy and cut)."""
        self.decode_steps += 1
        return self._observed_sync(
            "decode", plan,
            lambda: self.steps.paged(plan.reqs, plan.rids, plan.positions,
                                     [self._tokens[r] for r in plan.rids]),
            lambda out: out[:len(plan.rids)].cpu().numpy())

    def _decode_gather(self, plan: StepPlan) -> np.ndarray:
        """One dense-copy decode step (the reference's ``_decode_gather``):
        gather, decode at ``lengths = pos + 1``, scatter the new rows
        back, then sample; returns the next token of each row."""
        self.decode_steps += 1
        return self._observed_sync(
            "decode_gather", plan,
            lambda: self.steps.gather(plan.reqs, plan.rids, plan.positions,
                                      [self._tokens[r] for r in plan.rids]),
            lambda out: out.cpu().numpy())

    # ------------------------------------------------ speculative decode --
    def rollback_kv(self, rid: int, n_tokens: int) -> List[int]:
        """Token-granular KV rollback (:meth:`PagedKVCache.rollback`),
        refused for a request mid-prefill: its chunk progress tracks the
        table's tail (preempt or abort it instead)."""
        if rid in self._prefilled:
            raise RuntimeError(
                f"KV rollback of request {rid} during PREFILLING "
                f"({self._prefilled[rid]} prompt tokens streamed): chunked "
                f"prefill progress tracks the table tail — preempt or "
                f"abort instead of rolling back mid-prefill")
        return self.pool.rollback(rid, n_tokens)

    def _dispatch_verify(self, plan: StepPlan, tokens, chain=None
                         ) -> torch.Tensor:
        """Queue one verify step (a graph replay on a CUDA device) and
        count its ``K_pad + 1`` decode iterations; returns its
        ``[batch_pad, 2 (K_pad + 1)]`` device output
        (:meth:`StepFunctions.verify`)."""
        out = self.steps.verify(plan.reqs, plan.rids, plan.positions,
                                tokens, plan.drafts, chain)
        self.verify_iterations += out.shape[1] // 2
        return out

    def _verify_paged(self, plan: StepPlan):
        """One verify step in sync mode; returns host ``(ys, oks)`` of the
        live rows."""
        return split_verify(self._observed_sync(
            "spec_verify", plan,
            lambda: self._dispatch_verify(
                plan, [self._tokens[r] for r in plan.rids]),
            lambda out: out[:len(plan.rids)].cpu().numpy()))

    def _spec_commit(self, plan: StepPlan, ys: np.ndarray, oks: np.ndarray,
                     t_done: float, valid: Optional[List[bool]] = None
                     ) -> int:
        """Commit one verify step: a row's accepted drafts plus its
        correction or bonus token, token by token through the serial
        finish protocol (a stop token ends the request mid-span and the
        rest is discarded), then the table tail reserved for drafts that
        did not commit is rolled back. Shared by the sync step and the
        executor (``valid`` masks rows invalidated in flight). Returns
        the tokens committed."""
        drafted = accepted = committed = 0
        for i, r in enumerate(plan.reqs):
            if valid is not None and not valid[i]:
                continue
            rid = r.req_id
            dl = len(plan.drafts[i])
            n_ok = accepted_prefix(oks[i], dl)
            drafted += dl
            accepted += n_ok
            if self.speculator is not None:
                self.speculator.observe(rid, n_ok, dl)
            finished = False
            for j in range(n_ok + 1):
                tok = int(ys[i][j])
                self._pos[rid] += 1
                self._tokens[rid] = tok
                r.state.generated += 1
                r.state.output_tokens.append(tok)
                committed += 1
                if self._finish_or_run(r, t_done):
                    finished = True
                    break
            if not finished:
                # every committed position's K/V is written; the next
                # input token's slot is reserved again by the next plan
                self.rollback_kv(rid, self._pos[rid])
                # the plan counted the worst case (1 + k): what committed
                self.sched._dispatched[rid] = r.state.generated
        self.running = [r for r in self.running
                        if r.state.finish_reason is None]
        self.spec_steps += 1
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_rejected += drafted - accepted
        if drafted:
            self.spec_acceptance_samples.append(accepted / drafted)
        if self.obs is not None:
            self.obs.on_spec(self, drafted=drafted, accepted=accepted,
                             committed=committed)
        return committed

    def _spec_step_sync(self, plan: StepPlan, now: float):
        """A verify step in sync mode: verify, commit, and the plain
        step's series (the decode-token sample counts committed tokens:
        more than the batch is speculation's gain)."""
        ys, oks = self._verify_paged(plan)
        dt = time.perf_counter() - plan.t0
        committed = self._spec_commit(plan, ys, oks, now + dt)
        self._record_decode(dt, plan, len(plan.reqs), committed,
                            preempted=self.preemptions - plan.p0)
        if self.obs is not None:
            self.obs.end_step(self, t0=plan.t0, t_sched_s=plan.t_sched,
                              n_prefill=plan.n_prefill,
                              n_decode=len(plan.reqs))

    def run(self, requests: List[Request]) -> ServingMetrics:
        """Batch-offline wrapper over the streaming facade
        (:class:`repro_torch.serving.api.ServingAPI`): submit everything,
        step to completion with arrival fast-forwarding (never past a
        prompt still being prefilled) and a monotonic ``now``, collect
        metrics. The wall clock installed for timestamping is restored on
        exit, so back-to-back runs, or facade or step use after a run,
        never stamp against a stale epoch."""
        from repro_torch.serving.api import ServingAPI
        return ServingAPI(self).run(requests)
