"""The engine's steps on static buffers, each replayed from one CUDA graph
per bucket (counterpart of ``StepFunctions`` in ``repro.serving.engine``
and of its ``_prefill_fn``, ``_prefix_prefill_fn``, ``_chunk_prefill_fn``,
``_decode_fn``, ``_paged_decode_fn`` and ``spec_verify``).

The reference compiles each step once per shape bucket, so a step costs
one dispatch. Eager PyTorch issues some 1100-1200 launches for a decode
step and 46-49 a layer for a prefill, and the host, not the device, then
sets the pace. Here every step is one ``torch.cuda.CUDAGraph`` a bucket:

* ``(batch_pad, nb_pad, sampled)``, the paged decode step
  (``Model.decode_step`` on a :class:`PagedCacheView`, then
  :func:`~repro_torch.models.sampler.sample_tokens_device`): batch and
  table padded to powers of two;
* ``("gather", B, pad_blocks, sampled)``, the gather fallback's step: a
  dense copy of ``pad_blocks`` blocks a request through the staged
  tables, ``Model.decode_step`` on it (the contiguous decode kernel), the
  new rows scattered back at addresses computed on the device, sampling.
  The reference's shapes, with no batch padding: padding rows would copy
  trash blocks and inflate the very copy the gather path is measured by;
* ``("prefill", S)``, a prefill without a prefix (serial, or a chunked
  prompt's first chunk): the flash kernel's plain entry with the
  request's length, then the rows written token by token;
* ``("suffix", S, nb_pad)``, a prefill over a prefix in the pool (a
  prefix-cache hit, every later chunk): the prefix gathered through the
  staged table, the flash kernel's prefix-masked entry with the prefix
  length read from the device, then the write. One program for the
  reference's ``_prefix_prefill_fn`` and ``_chunk_prefill_fn``;
* ``("verify", batch_pad, nb_pad, K_pad, sampled)``, a speculative verify
  step (:func:`~repro_torch.serving.spec.verify.spec_verify_body`):
  ``K_pad + 1`` paged decode iterations with the acceptance gating on the
  device, the paged step's buckets plus the longest draft padded to a
  power of two; it returns ``[batch_pad, 2 (K_pad + 1)]`` int32, the
  sampled tokens then the acceptance mask.

``S`` is the prompt rows' bucket (a multiple of ``prefill_bucket``),
``nb_pad`` the prefix's blocks padded to a power of two. A prefill graph
returns its ``[1, vocab]`` logits, which the engine samples at once (the
first token's sample stays outside the graph, as the reference's separate
``sample`` call does).

* A step's inputs (block tables, lengths, positions, input tokens, the
  chain map of an overlapped step, the sampling vectors and the host
  folded RNG keys; a verify step's drafts and the keys of every counter a
  row may reach; a prefill's tokens, length, prefix length, prefix
  table and write addresses) are packed on the host into a pinned
  staging buffer (:func:`~repro_torch.kvcache.view.step_fields`,
  :func:`~repro_torch.kvcache.view.prefill_fields`) and go up in one
  non-blocking copy into one static device buffer that every bucket
  reads at its own offsets. The staging buffers are a ring with an event
  an upload, so none is rewritten while its copy is pending.
* An overlapped step's chained input tokens are gathered on the device
  from the previous step's output, before the replay (:meth:`_chain`).
* The step that first meets a bucket runs eagerly on a side stream (the
  warm-up: it loads the kernel libraries and cuBLAS, so nothing is built
  inside a capture), then the bucket's graph is captured; every later
  step of the bucket replays it. The decode graphs share one memory
  pool and the prefill graphs another: a graph may reuse, for its
  intermediates, memory that a graph captured later holds as its output,
  and a prefill replayed between two overlapped decode steps must not
  overwrite the earlier step's output before the later one reads it. A
  capture or replay that fails raises: nothing falls back to the eager
  step. ``EngineConfig(cuda_graphs=False)`` runs every step eagerly on
  the same buffers, for comparison.
* A graph's kernels run with no Python, so the launches a capture
  records are tallied on the capturing thread, apart from the kernels'
  ``launches`` counters (a capture launches nothing, and replicas on
  other threads go on counting theirs), and added at each replay.
* Every step is queued on the caller's current stream; an engine makes
  that its own :attr:`StepFunctions.stream`. Captures take one lock a
  process and capture in ``thread_local`` mode, so an engine may capture
  while others, on other threads and streams, replay and synchronise.
* Every step folds the finiteness of its logits into :attr:`finite`, on
  the device, with no sync.
* With :attr:`StepFunctions.timing` on (an observer is attached), each
  replay (or eager body) is bracketed by two timing CUDA events on the
  engine's stream, kept as :attr:`StepFunctions.last`
  (:class:`StepTiming`); nothing is recorded inside a capture, and a
  bucket's first use is marked as such. Off, no event is created.

The graphs capture the pool's addresses, so the pool is written in
place (as it always is in the port) and every write to it goes on the
stream of the replays: a discarded overlapped step's KV writes are then
ordered before any later owner's, the counterpart of the reference's
donated-pool chaining. On the CPU the same bodies run eagerly on the same
buffers.
"""
from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.launches import add_counts, tally_launches
from repro_torch.kernels.ops import launch_counters
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.kvcache.view import (PagedCacheView, prefill_fields,
                                      prefill_size, step_fields, step_size,
                                      verify_fields, verify_size)
from repro_torch.models.model import Model
from repro_torch.models.params import cache_layers
from repro_torch.models.sampler import fold_keys, sample_tokens_device
from repro_torch.serving.spec.verify import (spec_verify_body, stack_drafts,
                                             verify_keys)

# staging buffers in the ring: the executor's two retained steps, the one
# being dispatched and one to spare
STAGING_SLOTS = 4

# one graph capture at a time in the process: torch.cuda.graph
# synchronises the device and empties the allocator's cache as it begins,
# which another thread's capture would not survive, and the collector is
# switched off process-wide for the capture
_CAPTURE_LOCK = threading.Lock()

# an overlapped step's chained rows: the previous step's [n] device
# output, and {row: the row of that output holding its input token}
Chain = Tuple[torch.Tensor, Dict[int, int]]

# a body's outputs: the [batch] next tokens (None for a prefill) and the
# float32 logits
Outputs = Tuple[Optional[torch.Tensor], torch.Tensor]


def pow2_bucket(n: int, lo: int = 1) -> int:
    """The smallest ``lo * 2**k`` at least ``n`` (the reference's
    ``_pow2_bucket``)."""
    p = lo
    while p < n:
        p *= 2
    return p


def bucket(n: int, b: int) -> int:
    """``n`` rounded up to a multiple of ``b``, at least ``b`` (the
    reference's ``_bucket``)."""
    return max(b, ((n + b - 1) // b) * b)


def split_verify(out: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A verify step's output on the host (``[B, 2 (K_pad + 1)]``, see
    :meth:`StepFunctions.verify`) as ``(ys, oks)``: the sampled tokens and
    the boolean acceptance mask, each ``[B, K_pad + 1]``."""
    n = out.shape[1] // 2
    return out[:, :n], out[:, n:].astype(bool)


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch count, by kernel name."""
    return {name: fn.launches for name, fn in launch_counters().items()}


def take_launches(before: Dict[str, int]) -> Dict[str, int]:
    """The launches counted since ``before`` (a :func:`launch_counts`),
    and the counters put back to ``before`` (one thread's view; a capture
    counts on its own thread's tally instead, which other threads'
    launches do not reach)."""
    delta = {}
    for name, fn in launch_counters().items():
        delta[name] = fn.launches - before[name]
        fn.launches = before[name]
    return delta


def add_launches(delta: Dict[str, int]):
    """Count a replay's launches (by kernel name), under the counters'
    lock: replicas replay on several threads."""
    counters = launch_counters()
    add_counts({counters[name]: n for name, n in delta.items()})


def _mark(device: torch.device):
    """A device-time mark on the current stream: a timing CUDA event on a
    CUDA device, the host clock on the CPU (where a step's body runs at
    dispatch)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


class StepTiming:
    """One step's device-time marks (:meth:`StepFunctions._run`): CUDA
    events recorded on the engine's stream right before and right after
    its replay or eager body, or host stamps on the CPU. A bucket's first
    use (the eager warm-up on the side stream, then the capture) has no
    marks: ``first_use`` holds its host ``(start, end)`` instead."""
    __slots__ = ("start", "end", "first_use")

    def __init__(self, start, end,
                 first_use: Optional[Tuple[float, float]] = None):
        self.start = start
        self.end = end
        self.first_use = first_use

    def ready(self) -> bool:
        """Has the device passed the end mark? (Non-blocking.)"""
        return self.first_use is not None or isinstance(self.end, float) \
            or self.end.query()

    @property
    def device_s(self) -> float:
        """Seconds between the marks (0 for a first use); read only once
        :meth:`ready`."""
        if self.first_use is not None:
            return 0.0
        return _between(self.start, self.end)

    def gap_after(self, prev: Optional["StepTiming"]) -> float:
        """The device's idle seconds between ``prev``'s end mark and this
        step's start mark (0 without both)."""
        if prev is None or prev.first_use is not None \
                or self.first_use is not None:
            return 0.0
        return max(_between(prev.end, self.start), 0.0)


def _between(a, b) -> float:
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


class CapturedStep:
    """One bucket's graph, its static outputs, and the kernel launches
    that one replay makes."""
    __slots__ = ("graph", "tokens", "logits", "launches")

    def __init__(self, graph, tokens: Optional[torch.Tensor],
                 logits: torch.Tensor, launches: Dict[str, int]):
        self.graph = graph
        # [batch] int32 (None: a prefill; a verify step's tokens and
        # acceptance mask, [batch, 2 (K_pad + 1)])
        self.tokens = tokens
        self.logits = logits        # [batch, vocab] float32
        self.launches = launches

    def replay(self) -> Optional[torch.Tensor]:
        """Run the graph; its outputs are rewritten in place."""
        self.graph.replay()
        add_launches(self.launches)
        return self.tokens


class _Staging:
    """A ring of host staging buffers for one static device buffer;
    pinned on a CUDA device, where each upload records an event that the
    slot's next writer waits on."""

    def __init__(self, n: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.bufs = [torch.zeros((n,), dtype=torch.int32,
                                 pin_memory=self.cuda)
                     for _ in range(STAGING_SLOTS)]
        self.uploaded: List[Optional[torch.cuda.Event]] = \
            [None] * STAGING_SLOTS
        self.slot = 0
        self.device_buf = torch.zeros((n,), dtype=torch.int32, device=device)

    def host(self) -> np.ndarray:
        """The next slot, once its last upload has been read."""
        self.slot = (self.slot + 1) % STAGING_SLOTS
        ev = self.uploaded[self.slot]
        if ev is not None:
            ev.synchronize()
        return self.bufs[self.slot].numpy()

    def upload(self, n: int) -> torch.Tensor:
        """Copy the current slot's first ``n`` words up; returns the
        device buffer's first ``n``."""
        dst = self.device_buf[:n]
        dst.copy_(self.bufs[self.slot][:n], non_blocking=True)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.uploaded[self.slot] = ev
        return dst


class StepFunctions:
    """An engine's steps over its pool (one :class:`StepFunctions` a
    pool: the graphs capture its addresses). ``max_batch``,
    ``max_model_len``, ``prefill_bucket`` and, with speculation,
    ``spec_k`` (the longest draft) size the static buffers;
    ``cuda_graphs=False`` keeps every step eager on a CUDA device."""

    def __init__(self, model: Model, pool: PagedKVCache, *, max_batch: int,
                 max_model_len: int, prefill_bucket: int = 64,
                 cuda_graphs: bool = True, spec_k: Optional[int] = None,
                 stream: Optional[torch.cuda.Stream] = None):
        self.model = model
        self.pool = pool
        self.device = pool.device
        # the stream its engine queues every step on (None: the caller's
        # current stream, and on the CPU)
        self.stream = stream
        self.sizing = (max_batch, max_model_len, prefill_bucket,
                       cuda_graphs, spec_k)
        self.prefill_bucket = prefill_bucket
        self.graphs_on = cuda_graphs and self.device.type == "cuda"
        nb_max = pow2_bucket(pool.manager.blocks_needed(max_model_len), lo=4)
        words = step_size(pow2_bucket(max_batch), nb_max)
        if spec_k is not None:      # the largest verify layout too
            words = verify_size(pow2_bucket(max_batch), nb_max,
                                pow2_bucket(spec_k))
        self._staging = _Staging(words, self.device)
        self._prefill_staging = _Staging(
            prefill_size(bucket(max_model_len, prefill_bucket), nb_max),
            self.device)
        # every step's logits finite so far
        self.finite = torch.ones((), dtype=torch.bool, device=self.device)
        # a VLM prefill's image embeddings: the reference engine's stub of
        # the vision frontend, zeros (its cross K/V then zero too)
        self._img_stub = None
        if model is not None and cache_layers(model.cfg)["cross"]:
            cfg = model.cfg
            self._img_stub = torch.zeros(
                (1, cfg.n_img_tokens, cfg.d_model),
                dtype=cfg.activation_dtype, device=self.device)
        self.graphs: Dict[Tuple, CapturedStep] = {}
        self.capture_s = 0.0         # seconds spent capturing graphs
        self.replays = 0
        # device-time marks around each step (an observer is attached):
        # the newest step's StepTiming; off, no event is created
        self.timing = False
        self.last: Optional[StepTiming] = None
        if self.graphs_on:
            self._decode_pool = torch.cuda.graph_pool_handle()
            self._prefill_pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)

    def check_reuse(self, model: Model, ecfg, spec_k: Optional[int]):
        """Refuse an engine these steps were not built for: they hold one
        model, one pool's geometry and buffers sized for one
        configuration."""
        if model is not self.model:
            raise ValueError("the StepFunctions were built for a different "
                             "Model instance")
        if self.pool.block_size != ecfg.block_size \
                or self.pool.num_blocks * self.pool.block_size \
                != ecfg.kv_pool_tokens:
            raise ValueError(
                f"the StepFunctions' pool has {self.pool.num_blocks} blocks "
                f"of block_size={self.pool.block_size}; the engine asks for "
                f"{ecfg.kv_pool_tokens} tokens in blocks of "
                f"{ecfg.block_size}")
        want = (ecfg.max_batch, ecfg.max_model_len, ecfg.prefill_bucket,
                ecfg.cuda_graphs, spec_k)
        if want != self.sizing:
            raise ValueError(
                f"the StepFunctions were sized for (max_batch, "
                f"max_model_len, prefill_bucket, cuda_graphs, spec_k) = "
                f"{self.sizing}, the engine asks for {want}")

    # ----------------------------------------------------------- inputs --
    def _stage(self, reqs: Sequence, positions: Sequence[int],
               tokens: Sequence[int], chain: Optional[Chain],
               batch_pad: int, nb_pad: int, rids: Sequence[int],
               drafts: Optional[Sequence[np.ndarray]] = None,
               K_pad: int = 0) -> Tuple[Dict[str, torch.Tensor], bool]:
        """Pack one decode step's inputs (with ``drafts``, a verify step's,
        ``K_pad`` wide) on the host, copy them up, and gather chained
        tokens on the device. Returns the device fields and whether any
        row samples. Padding rows are greedy with seed 0."""
        B = len(reqs)
        if drafts is None:
            layout, shape = step_fields, (batch_pad, nb_pad)
            n = step_size(*shape)
        else:
            layout, shape = verify_fields, (batch_pad, nb_pad, K_pad)
            n = verify_size(*shape)
        f = layout(self._staging.host()[:n], *shape)
        self.pool.fill_view(f, rids, positions)
        if drafts is not None:
            f["drafts"][:], f["draft_len"][:] = stack_drafts(
                drafts, batch_pad, K_pad)
        f["tokens"][:] = 0
        f["tokens"][:B] = tokens
        f["use_prev"][:] = 0
        f["prev_rows"][:] = 0
        if chain is not None:
            for i, row in chain[1].items():
                f["use_prev"][i] = 1
                f["prev_rows"][i] = row
        sp = [r.sampling for r in reqs]
        sampled = any(s.temperature > 0 for s in sp)
        if sampled:
            for name in ("temperature", "top_k", "top_p"):
                f[name][:] = 1 if name == "top_p" else 0
                f[name][:B] = [getattr(s, name) for s in sp]
            seed = np.zeros((batch_pad,), np.int64)
            seed[:B] = [np.uint32(s.seed) for s in sp]
            pos = np.zeros((batch_pad,), np.int64)
            pos[:B] = positions
            if drafts is None:
                f["keys"].view(np.uint32)[:] = fold_keys(seed, pos + 1)
            else:
                f["key_block"].view(np.uint32)[:] = verify_keys(seed, pos,
                                                                K_pad)
        dev = layout(self._staging.upload(n), *shape)
        if chain is not None:
            self._chain(dev, chain[0])
        return dev, sampled

    @staticmethod
    def _chain(dev: Dict[str, torch.Tensor], prev: torch.Tensor):
        """Chained rows take their input token from the previous step's
        device output, the value the sync loop would have copied through
        the host (the reference's ``_chain_tokens_fn``). Queued before
        this step's replay, which may rewrite ``prev``."""
        dev["tokens"].copy_(torch.where(
            dev["use_prev"] != 0, prev.index_select(0, dev["prev_rows"]),
            dev["tokens"]))

    # ------------------------------------------------------------ paged --
    def _paged_body(self, dev: Dict[str, torch.Tensor],
                    sampled: bool) -> Outputs:
        """The captured step: decode on the static view, fold finiteness,
        sample. Reads and writes device tensors only."""
        view = PagedCacheView(self.pool.pool, dev["tables"], dev["lengths"],
                              dev["positions"], self.pool.block_size,
                              dev["slots"])
        logits = self.model.decode_step(dev["tokens"], view)
        return self._sample(logits, dev, sampled), logits

    def _sample(self, logits: torch.Tensor, dev: Dict[str, torch.Tensor],
                sampled: bool) -> torch.Tensor:
        """Fold the logits' finiteness, then pick each row's token."""
        self.finite.logical_and_(torch.isfinite(logits).all())
        return sample_tokens_device(logits, dev["temperature"], dev["top_k"],
                                    dev["top_p"], dev["keys"], sampled)

    def paged_bucket(self, rids: Sequence[int]) -> Tuple[int, int]:
        """``(batch_pad, nb_pad)``: the batch and the widest table padded
        to powers of two (at least 4 blocks), as in the reference."""
        max_blocks = max(len(self.pool.manager.tables[r]) for r in rids)
        return pow2_bucket(len(rids)), pow2_bucket(max_blocks, lo=4)

    def paged(self, reqs: Sequence, rids: Sequence[int],
              positions: Sequence[int], tokens: Sequence[int],
              chain: Optional[Chain] = None) -> torch.Tensor:
        """One zero-copy decode step: request ``rids[i]`` writes at
        ``positions[i]`` and takes ``tokens[i]`` as input (or, for a row
        in ``chain``, the previous step's output). Returns the
        ``[batch_pad]`` int32 next tokens on the device (padding rows
        greedy), which a later replay of the same bucket rewrites."""
        batch_pad, nb_pad = self.paged_bucket(rids)
        dev, sampled = self._stage(reqs, positions, tokens, chain,
                                   batch_pad, nb_pad, rids)
        return self._run((batch_pad, nb_pad, sampled),
                         lambda: self._paged_body(dev, sampled),
                         "decode")[0]

    # ----------------------------------------------------------- verify --
    def _verify_body(self, dev: Dict[str, torch.Tensor], K_pad: int,
                     sampled: bool) -> Outputs:
        """The captured verify step: ``K_pad + 1`` decode iterations on
        the static fields, every iteration's finiteness folded; returns
        the sampled tokens and the acceptance mask in one int32 tensor,
        and iteration 0's logits. Reads and writes device tensors only."""
        ys, oks, logits, finite = spec_verify_body(self.model, self.pool,
                                                   dev, K_pad, sampled)
        self.finite.logical_and_(finite)
        return torch.cat([ys, oks.to(torch.int32)], 1), logits

    def verify_bucket(self, rids: Sequence[int],
                      drafts: Sequence[np.ndarray]) -> Tuple[int, int, int]:
        """``(batch_pad, nb_pad, K_pad)``: the paged step's buckets and the
        longest draft padded to a power of two, as in the reference."""
        K_pad = pow2_bucket(max((len(d) for d in drafts), default=1), lo=1)
        return self.paged_bucket(rids) + (K_pad,)

    def verify(self, reqs: Sequence, rids: Sequence[int],
               positions: Sequence[int], tokens: Sequence[int],
               drafts: Sequence[np.ndarray],
               chain: Optional[Chain] = None) -> torch.Tensor:
        """One speculative verify step: request ``rids[i]`` takes
        ``tokens[i]`` (or, in ``chain``, the previous step's output) at
        ``positions[i]`` and has the draft ``drafts[i]`` checked, its
        span's blocks already reserved. Returns ``[batch_pad, 2 (K_pad +
        1)]`` int32 on the device: each row's ``K_pad + 1`` sampled tokens,
        then its acceptance mask; a later replay of the same bucket
        rewrites it."""
        batch_pad, nb_pad, K_pad = self.verify_bucket(rids, drafts)
        dev, sampled = self._stage(reqs, positions, tokens, chain,
                                   batch_pad, nb_pad, rids, drafts, K_pad)
        return self._run(("verify", batch_pad, nb_pad, K_pad, sampled),
                         lambda: self._verify_body(dev, K_pad, sampled),
                         "decode")[0]

    # ----------------------------------------------------------- gather --
    def _gather_body(self, dev: Dict[str, torch.Tensor],
                     sampled: bool) -> Outputs:
        """The gather step: the dense copy through the staged tables,
        decode at ``lengths = pos + 1``, the new rows scattered back,
        finiteness folded, sampling. Reads and writes device tensors
        only."""
        cache = self.pool.gather_tables(dev["tables"], dev["slots"])
        logits = self.model.decode_step(dev["tokens"], cache,
                                        dev["positions"],
                                        lengths=dev["lengths"])
        self.pool.scatter_rows(dev["tables"], dev["positions"], cache,
                               dev["slots"])
        return self._sample(logits, dev, sampled), logits

    def gather_bucket(self, positions: Sequence[int]) -> int:
        """The gather step's blocks a request: the longest context padded
        to a multiple of four blocks, as in the reference."""
        return self.pool.manager.blocks_needed(
            bucket(max(positions) + 1, self.pool.block_size * 4))

    def gather(self, reqs: Sequence, rids: Sequence[int],
               positions: Sequence[int], tokens: Sequence[int],
               chain: Optional[Chain] = None) -> torch.Tensor:
        """One dense-copy decode step (the reference's gather fallback):
        gather :meth:`gather_bucket` blocks a request, decode at
        ``lengths = pos + 1``, scatter the new rows back, sample; the
        bucket is ``("gather", B, pad_blocks, sampled)``. Returns the
        ``[B]`` int32 next tokens on the device, which a later replay of
        the same bucket rewrites."""
        pad_blocks = self.gather_bucket(positions)
        dev, sampled = self._stage(reqs, positions, tokens, chain,
                                   len(rids), pad_blocks, rids)
        return self._run(("gather", len(rids), pad_blocks, sampled),
                         lambda: self._gather_body(dev, sampled),
                         "decode")[0]

    # ---------------------------------------------------------- prefill --
    def _prefill_body(self, dev: Dict[str, torch.Tensor],
                      over_prefix: bool) -> Outputs:
        """A prefill at batch 1: over a prefix (gathered through the
        staged table, attended with the prefix length read from the
        device) or without one; the rows written at the staged addresses
        (a VLM's image K/V, from the zero stub, at the request's slot);
        finiteness folded. Reads and writes device tensors only."""
        prefix, prefix_len = None, 0
        if over_prefix:
            prefix = self.pool.gather_tables(dev["table"][None])
            prefix_len = dev["prefix_len"]
        logits, cache = self.model.prefill(dev["tokens"], dev["n"],
                                           prefix=prefix,
                                           prefix_len=prefix_len,
                                           img_embeds=self._img_stub)
        self.pool.write_rows(cache, dev["blocks"], dev["slots"],
                             dev["state_slot"])
        self.finite.logical_and_(torch.isfinite(logits).all())
        return None, logits

    def prefill_key(self, n: int, start: int, nb_pad: int) -> Tuple:
        """The bucket of a prefill of ``n`` prompt tokens from position
        ``start``: ``("prefill", S)`` without a prefix, ``("suffix", S,
        nb_pad)`` over one."""
        S = bucket(n, self.prefill_bucket)
        return ("suffix", S, nb_pad) if start else ("prefill", S)

    def prefill(self, rid: int, tokens: Sequence[int], start: int,
                prefix_blocks: int, nb_pad: int) -> torch.Tensor:
        """Prefill prompt positions ``[start, start + len(tokens))`` of
        request ``rid`` at batch 1 over the prefix already in its first
        ``prefix_blocks`` blocks (gathered ``nb_pad`` blocks wide; none
        when ``start`` is 0), writing the rows' K/V into its blocks.
        Returns the ``[1, vocab]`` float32 logits of the last prompt
        token, which a later replay of the same bucket rewrites."""
        key = self.prefill_key(len(tokens), start, nb_pad)
        S, nb = key[1], nb_pad if start else 0
        n = prefill_size(S, nb)
        f = prefill_fields(self._prefill_staging.host()[:n], S, nb)
        self.pool.fill_prefill(f, rid, tokens, start, prefix_blocks)
        dev = prefill_fields(self._prefill_staging.upload(n), S, nb)
        return self._run(key, lambda: self._prefill_body(dev, bool(start)),
                         "prefill")[1]

    # ----------------------------------------------------------- graphs --
    def _run(self, key: Tuple, body: Callable[[], Outputs],
             pool: str) -> Outputs:
        """Replay ``key``'s graph; or, with none yet, run ``body``
        eagerly (without graphs) or as the bucket's first use. With
        :attr:`timing` on, the replay (or eager body) is bracketed by
        device-time marks, kept in :attr:`last`; a first use is marked as
        such instead (nothing is recorded inside a capture)."""
        step = self.graphs.get(key)
        if step is not None:
            self.replays += 1
            start = _mark(self.device) if self.timing else None
            step.replay()
            if self.timing:
                self.last = StepTiming(start, _mark(self.device))
            return step.tokens, step.logits
        if not self.graphs_on:
            start = _mark(self.device) if self.timing else None
            out = body()
            if self.timing:
                self.last = StepTiming(start, _mark(self.device))
            return out
        t0 = time.perf_counter()
        out = self._first_use(key, body, pool)
        if self.timing:
            self.last = StepTiming(None, None, first_use=(
                t0, time.perf_counter()))
        return out

    def _first_use(self, key: Tuple, body: Callable[[], Outputs],
                   pool: str) -> Outputs:
        """Run a new bucket's step eagerly on the side stream (the
        warm-up), then capture its graph into the ``pool`` graphs'
        memory pool (``"decode"`` or ``"prefill"``)."""
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = body()
        cur.wait_stream(self._side)
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            # no collection during the capture: an engine left in a
            # reference cycle (engine, scheduler, executor) would take its
            # graphs down with it, and a capture refuses the calls that
            # free them
            collecting = gc.isenabled()
            gc.disable()
            try:
                # thread_local: other threads' engines go on synchronising
                # (staging events, token copies) while this one captures;
                # the launches the capture records are this thread's tally
                with tally_launches() as tally, torch.cuda.graph(
                        graph, stream=self._side, pool=(
                            self._decode_pool if pool == "decode"
                            else self._prefill_pool),
                        capture_error_mode="thread_local"):
                    static = body()
            finally:
                if collecting:
                    gc.enable()
            self.capture_s += time.perf_counter() - t0
        self.graphs[key] = CapturedStep(graph, *static, {
            name: tally.get(fn, 0)
            for name, fn in launch_counters().items()})
        return out
