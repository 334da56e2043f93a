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
* A step given a bucket census without a dispatched one
  (:attr:`StepFunctions.census_for`, which the engine sets while an
  observer is attached) runs its eager body under a
  :class:`~repro_torch.core.analysis.DispatchCensus` (a first use's
  warm-up; without graphs, the eager step itself) and fills the
  census's ``dispatched``: the operations the graph then replays. A
  replay takes none. :meth:`StepFunctions.meta_twin` runs the same
  bodies on meta tensors (:meth:`StepFunctions.body`).

On a rank of a tensor-parallel model the step bodies hold the layers'
collectives (:mod:`repro_torch.distributed`), captured into the graphs
with the rest. Rank 0's steps send each step's key and staged words to
the other ranks over :attr:`StepFunctions.channel` before running it;
the other ranks :meth:`StepFunctions.follow` the channel, staging the
same words (a step's chain map among them: an overlapped step's chained
rows gather their input from the rank's own previous output) and
running the same key, so every rank warms up, captures and replays the
same buckets in the same order.

Over a data axis of D ranks (an engine of a ``D x M`` mesh) a step's
rows are split by data rank, and every rank runs the same bucket over
its own block of ``rows / D`` (the largest rank's count padded to a
power of two; a rank's unused rows are padding that writes to its trash
block). A decode step's words hold the engine's row order (``order``,
each row's place in the data ranks' blocks), then each data rank's part
in :func:`~repro_torch.kvcache.view.step_fields`' layout, its tables in
the ids of its share of the pool; each rank stages and runs its own
part. The body samples the rank's rows, gathers every rank's tokens
(and the finiteness of its logits) over the data axis
(:meth:`~repro_torch.distributed.MeshGroup.gather_rows`) and puts them
back in the engine's order, so rank 0 reads the whole batch from one
buffer and a chained row may read any row of it. A prefill step's words
hold one :func:`~repro_torch.kvcache.view.prefill_fields` part a data
rank (a rank without a request prefills one padding row into its trash
block, :meth:`~repro_torch.kvcache.paged.PagedKVCache.fill_padding`),
and its logits come back gathered, ``[D, vocab]``
(:meth:`StepFunctions.prefill_wave`). Every rank issues the same
collectives in the same order.

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

from repro_torch.core.analysis import DispatchCensus
from repro_torch.distributed import STOP
from repro_torch.kernels.launches import add_counts, tally_launches
from repro_torch.kernels.ops import launch_counters
# re-exported: callers of the steps read the launch counts from here
from repro_torch.kernels.ops import launch_counts  # noqa: F401
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.kvcache.view import (PagedCacheView, prefill_fields,
                                      prefill_size, step_fields, step_size,
                                      verify_fields, verify_size)
from repro_torch.models.model import Model
from repro_torch.models.params import cache_layers, map_tree
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
        # the data ranks a step's rows are split over, and this rank's
        self.data = 1 if model is None else model.data
        self.data_rank = model.layout.data_rank if self.data > 1 else 0
        nb_max = pow2_bucket(pool.manager.blocks_needed(max_model_len), lo=4)
        rows = pow2_bucket(max_batch // self.data)
        # each data rank's part, after the rows' order over more than one
        words = self.data * step_size(rows, nb_max) + \
            (self.data * rows if self.data > 1 else 0)
        if spec_k is not None:      # the largest verify layout too
            words = verify_size(pow2_bucket(max_batch), nb_max,
                                pow2_bucket(spec_k))
        self._staging = _Staging(words, self.device)
        self._prefill_staging = _Staging(
            self.data * prefill_size(bucket(max_model_len, prefill_bucket),
                                     nb_max), self.device)
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
        # the bucket census (a serving.obs StepCensus) whose dispatched
        # census the next step's eager body fills, if it has none yet
        self.census_for = None
        # a tensor-parallel rank's step commands (rank 0 sends, the
        # others follow); None on one device
        self.channel = None
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
        tokens on the device. Returns this rank's device fields and
        whether any row samples. Padding rows are greedy with seed 0.
        Over a data axis each data rank's part holds its requests' rows,
        in the engine's order, and ``order`` each row's place."""
        key = (batch_pad, nb_pad, False) if drafts is None else \
            ("verify", batch_pad, nb_pad, K_pad, False)
        staging, n = self._staged(key)
        host = staging.host()[:n]
        sampled = any(r.sampling.temperature > 0 for r in reqs)
        rows = dict(chain[1]) if chain is not None else {}
        parts = [list(range(len(reqs)))]
        if self.data > 1:
            mgr = self.pool.manager
            parts = [[] for _ in range(self.data)]
            for i, rid in enumerate(rids):
                parts[mgr.rank_of(rid)].append(i)
            order = self._fields(key, host, 0)["order"]
            order[:] = 0
            b = batch_pad // self.data
            for d, idx in enumerate(parts):
                order[idx] = d * b + np.arange(len(idx))
        for d, idx in enumerate(parts):
            self._fill_rows(self._fields(key, host, d),
                            [reqs[i] for i in idx], [rids[i] for i in idx],
                            [positions[i] for i in idx],
                            [tokens[i] for i in idx],
                            {k: rows[i] for k, i in enumerate(idx)
                             if i in rows},
                            None if drafts is None else
                            [drafts[i] for i in idx], K_pad, sampled)
        dev = self._fields(key, staging.upload(n))
        if chain is not None:
            self._chain(dev, chain[0])
        return dev, sampled

    def _fill_rows(self, f: Dict[str, np.ndarray], reqs: Sequence,
                   rids: Sequence[int], positions: Sequence[int],
                   tokens: Sequence[int], chained: Dict[int, int],
                   drafts: Optional[Sequence[np.ndarray]], K_pad: int,
                   sampled: bool):
        """One part's host fields: its rows' tables, positions, input
        tokens, chain rows and (``sampled``) sampling vectors and keys;
        the rows past ``len(reqs)`` padding."""
        B = len(reqs)
        batch_pad = f["tokens"].shape[0]
        self.pool.fill_view(f, rids, positions)
        if drafts is not None:
            f["drafts"][:], f["draft_len"][:] = stack_drafts(
                drafts, batch_pad, K_pad)
        f["tokens"][:] = 0
        f["tokens"][:B] = tokens
        f["use_prev"][:] = 0
        f["prev_rows"][:] = 0
        for i, row in chained.items():
            f["use_prev"][i] = 1
            f["prev_rows"][i] = row
        if sampled:
            sp = [r.sampling for r in reqs]
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

    @staticmethod
    def _chain(dev: Dict[str, torch.Tensor], prev: torch.Tensor):
        """Chained rows take their input token from the previous step's
        device output, the value the sync loop would have copied through
        the host (the reference's ``_chain_tokens_fn``). Queued before
        this step's replay, which may rewrite ``prev``."""
        dev["tokens"].copy_(torch.where(
            dev["use_prev"] != 0, prev.index_select(0, dev["prev_rows"]),
            dev["tokens"]))

    # ------------------------------------------------------------ bodies --
    def body(self, key: Tuple) -> Callable[[], Outputs]:
        """Bucket ``key``'s body over the static buffers' current fields:
        what its graph replays (the steps build the same body from their
        staged fields)."""
        staging, n = self._staged(key)
        dev = self._fields(key, staging.device_buf[:n])
        if key[0] == "gather":
            return lambda: self._gather_body(dev, key[3])
        if key[0] == "verify":
            return lambda: self._verify_body(dev, key[3], key[4])
        if key[0] in ("prefill", "suffix"):
            return lambda: self._prefill_body(dev, key[0] == "suffix")
        return lambda: self._paged_body(dev, key[2])

    def meta_twin(self) -> "StepFunctions":
        """These steps on the meta device: the model's weights, the pool
        and the static buffers as meta tensors of the same shapes and
        dtypes, no graphs. Its :meth:`body` dispatches a bucket's
        operations at no cost, so a census of it equals the card's."""
        cfg, pool = self.model.cfg, self.pool
        meta = lambda t: torch.empty(t.shape, dtype=t.dtype,  # noqa: E731
                                     device="meta")
        model = Model(cfg, map_tree(meta, self.model.params), device="meta")
        twin_pool = PagedKVCache(cfg, num_blocks=pool.num_blocks,
                                 block_size=pool.block_size, device="meta",
                                 max_batch=pool.max_batch or None,
                                 kv_heads=self.model.n_kv_heads)
        max_batch, max_model_len, prefill_bucket, _, spec_k = self.sizing
        return StepFunctions(model, twin_pool, max_batch=max_batch,
                             max_model_len=max_model_len,
                             prefill_bucket=prefill_bucket,
                             cuda_graphs=False, spec_k=spec_k)

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
        """Fold the logits' finiteness, then pick each row's token. Over a
        data axis every rank's tokens and finiteness are gathered, and the
        tokens put in the engine's row order (``order``)."""
        finite = torch.isfinite(logits).all()
        tokens = sample_tokens_device(logits, dev["temperature"],
                                      dev["top_k"], dev["top_p"],
                                      dev["keys"], sampled)
        if self.data == 1:
            self.finite.logical_and_(finite)
            return tokens
        both = self.model.group.gather_rows(
            torch.cat([tokens, finite.to(tokens.dtype)[None]]))
        both = both.reshape(self.data, -1)
        self.finite.logical_and_(both[:, -1].bool().all())
        return both[:, :-1].reshape(-1).index_select(0, dev["order"])

    def paged_bucket(self, rids: Sequence[int]) -> Tuple[int, int]:
        """``(batch_pad, nb_pad)``: the batch and the widest table padded
        to powers of two (at least 4 blocks), as in the reference; over a
        data axis ``batch_pad`` is D times the largest data rank's rows
        padded so."""
        mgr = self.pool.manager
        max_blocks = max(len(mgr.tables[r]) for r in rids)
        rows = len(rids)
        if self.data > 1:
            counts = np.bincount([mgr.rank_of(r) for r in rids],
                                 minlength=self.data)
            rows = int(counts.max())
        return self.data * pow2_bucket(rows), pow2_bucket(max_blocks, lo=4)

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
                                        lengths=dev["lengths"],
                                        block_size=self.pool.block_size)
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
                                           img_embeds=self._img_stub,
                                           own_rows=False,
                                           block_size=self.pool.block_size)
        self.pool.write_rows(cache, dev["blocks"], dev["slots"],
                             dev["state_slot"])
        if self.data > 1:
            logits = self.model.group.gather_rows(logits)
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
        token, which a later replay of the same bucket rewrites. Over a
        data axis the other data ranks prefill padding beside it."""
        out = self.prefill_wave([(rid, tokens, start, prefix_blocks)],
                                nb_pad)
        if self.data == 1:
            return out
        d = self.pool.manager.rank_of(rid)
        return out[d:d + 1]

    def prefill_wave(self, jobs: Sequence[Tuple], nb_pad: int
                     ) -> torch.Tensor:
        """One prefill step of ``jobs``, each ``(rid, tokens, start,
        prefix_blocks)`` as :meth:`prefill` takes them, at most one a data
        rank and all with a prefix or none (one bucket: the longest
        prompt's rows); each data rank without one prefills padding.
        Returns the logits ``[D, vocab]`` float32, data rank ``d``'s
        request's in row ``d``."""
        mgr = self.pool.manager
        by_rank = {mgr.rank_of(job[0]): job for job in jobs}
        if len(by_rank) != len(jobs) or \
                len({bool(job[2]) for job in jobs}) != 1:
            raise ValueError("a prefill step takes one request a data rank, "
                             "all over a prefix or none")
        start = jobs[0][2]
        key = self.prefill_key(max(len(job[1]) for job in jobs), start,
                               nb_pad)
        staging, n = self._staged(key)
        host = staging.host()[:n]
        for d in range(self.data):
            f = self._fields(key, host, d)
            if d in by_rank:
                self.pool.fill_prefill(f, *by_rank[d])
            else:
                self.pool.fill_padding(f)
        dev = self._fields(key, staging.upload(n))
        return self._run(key, lambda: self._prefill_body(dev, bool(start)),
                         "prefill")[1]

    # ------------------------------------------------------------ mesh --
    def _part(self, key: Tuple) -> Tuple[_Staging, int, int, Callable]:
        """Bucket ``key``'s staging ring, the words before the data ranks'
        parts (a decode step's ``order`` over a data axis), the words of
        one part and the fields of a part's words."""
        if key[0] in ("prefill", "suffix"):
            S, nb = key[1], key[2] if key[0] == "suffix" else 0
            return self._prefill_staging, 0, prefill_size(S, nb), \
                lambda buf: prefill_fields(buf, S, nb)
        if key[0] == "gather":
            return self._staging, 0, step_size(key[1], key[2]), \
                lambda buf: step_fields(buf, key[1], key[2])
        if key[0] == "verify":
            return self._staging, 0, verify_size(*key[1:4]), \
                lambda buf: verify_fields(buf, *key[1:4])
        rows = key[0] // self.data
        head = key[0] if self.data > 1 else 0
        return self._staging, head, step_size(rows, key[1]), \
            lambda buf: step_fields(buf, rows, key[1])

    def _staged(self, key: Tuple) -> Tuple[_Staging, int]:
        """The staging ring a bucket reads and its words."""
        staging, head, part, _ = self._part(key)
        return staging, head + self.data * part

    def _fields(self, key: Tuple, buf, rank: Optional[int] = None) -> Dict:
        """Data rank ``rank``'s (this rank's by default) fields of bucket
        ``key`` in its packed words ``buf`` (on the host or the device),
        with the step's ``order`` where it has one."""
        _, head, part, fields = self._part(key)
        at = head + (self.data_rank if rank is None else rank) * part
        f = fields(buf[at:at + part])
        if head:
            f["order"] = buf[:head]
        return f

    def follow(self):
        """A rank other than 0: run the steps rank 0 sends over
        :attr:`channel` (each staged as rank 0 staged it, then run as its
        key) and the pool copies, until rank 0 stops. A decode step's
        chained rows (``use_prev`` in its words: rank 0 dispatched it
        with the previous step in flight) take their input from this
        rank's own output of the previous decode step, which equals rank
        0's: the logits are gathered whole on every rank and sampled
        alike."""
        def into(key: Tuple, n: int) -> torch.Tensor:
            staging, _ = self._staged(key)
            staging.host()
            return staging.bufs[staging.slot][:n]

        prev = None
        while True:
            key, words = self.channel.recv(into)
            if key[0] == STOP:
                return
            if key[0] == "copy":
                self.pool.copy_block(key[1], key[2])
                continue
            staging, n = self._staged(key)
            dev = self._fields(key, staging.upload(n))
            prefill = key[0] in ("prefill", "suffix")
            if not prefill and self._fields(key, words.numpy())[
                    "use_prev"].any():
                self._chain(dev, prev)
            out = self._run(key, self.body(key),
                            "prefill" if prefill else "decode")
            if not prefill:
                prev = out[0]

    # ----------------------------------------------------------- graphs --
    def _run(self, key: Tuple, body: Callable[[], Outputs],
             pool: str) -> Outputs:
        """Replay ``key``'s graph; or, with none yet, run ``body``
        eagerly (without graphs) or as the bucket's first use, under a
        dispatch census where :attr:`census_for` asks for one. With :attr:`timing` on, the replay (or eager body) is
        bracketed by device-time marks, kept in :attr:`last`; a first use
        is marked as such instead (nothing is recorded inside a
        capture)."""
        if self.channel is not None and self.channel.leads:
            staging, n = self._staged(key)
            self.channel.send(key, staging.bufs[staging.slot][:n])
        census, self.census_for = self.census_for, None
        if census is not None and census.dispatched is not None:
            census = None
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
            out = _censused(body, census)
            if self.timing:
                self.last = StepTiming(start, _mark(self.device))
            return out
        t0 = time.perf_counter()
        out = self._first_use(key, body, pool, census)
        if self.timing:
            self.last = StepTiming(None, None, first_use=(
                t0, time.perf_counter()))
        return out

    def _first_use(self, key: Tuple, body: Callable[[], Outputs],
                   pool: str, census=None) -> Outputs:
        """Run a new bucket's step eagerly on the side stream (the
        warm-up; under a dispatch census for ``census``, if given), then
        capture its graph into the ``pool`` graphs' memory pool
        (``"decode"`` or ``"prefill"``)."""
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = _censused(body, census)
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


def _censused(body: Callable[[], Outputs], census) -> Outputs:
    """Run ``body``; with a bucket ``census``, under a dispatch census
    that becomes its ``dispatched``."""
    if census is None:
        return body()
    with DispatchCensus() as cen:
        out = body()
    census.dispatched = cen.result()
    return out
