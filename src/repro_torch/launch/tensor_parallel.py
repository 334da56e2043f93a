"""One model over a ``D x M`` mesh, one process a device: what each rank
runs under :func:`repro_torch.distributed.spawn`.

Each function takes the rank's :class:`~repro_torch.distributed.MeshGroup`
first and is called on every rank with the same arguments; what it
returns from rank 0 is the model's output (the logits and the collectives
are replicated over the model axis, and each step's outputs gathered
over the data axis, so every rank computes the same), the others return
their own accounting. E.g., on two cards::

    from repro_torch.distributed import devices_mesh, spawn
    out = spawn(serve_rank, devices_mesh(2), cfg, ecfg, requests)

serves ``requests`` over ``cuda:0`` and ``cuda:1`` (``devices_mesh(2,
"cpu")``: two gloo ranks on the CPU) tensor-parallel, in any engine mode
``ecfg`` asks for, under the ``act_replicated`` rules unless ``rules``
(the reference's flags, :func:`mesh_rules`; ``fsdp`` among them) asks
for others; ``devices_mesh(4, data=2)`` serves one engine's batch rows
over two data ranks of two cards each, in the modes a data axis runs
(:func:`~repro_torch.serving.engine.refuse_data`). A
:class:`ParallelReplica` is a replica of several devices this
process leads as its rank 0 while its other ranks run
:func:`follow_rank` in processes it starts (what
:meth:`~repro_torch.serving.cluster.ReplicatedCluster.sliced` builds of
a slice of several devices), and :func:`cluster_rank` a whole cluster of
such replicas, run in a process of its own
(:func:`~repro_torch.distributed.run_child`)::

    out = run_child(cluster_rank, cfg, ecfg,
                    make_mesh((2, 2), ("data", "model"), devices), 2,
                    requests)
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed import MeshGroup, RankProcesses, rendezvous
from repro_torch.kernels.ops import launch_counts
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.models.model import Model
from repro_torch.models.params import init_shard, params_from_numpy
from repro_torch.sharding import rules_for


# the rules a rank runs under unless it is given others: the reference's
# act_replicated (Megatron) layout
DEFAULT_RULES = {"act_replicated": True}


def mesh_rules(mesh, rules: Optional[Dict[str, bool]] = None):
    """The :func:`~repro_torch.sharding.rules_for` rules over ``mesh``
    with the reference's flags ``rules`` (``act_replicated``,
    ``shard_kv_seq``; :data:`DEFAULT_RULES` if None): a plain dict, so it
    crosses to the ranks' processes."""
    return rules_for(mesh, **(DEFAULT_RULES if rules is None else rules))


def rank_model(group, cfg, params=None, *, seed: int = 0,
               slice_bytes: Optional[int] = None,
               rules: Optional[Dict[str, bool]] = None) -> Model:
    """The rank's model under the flags ``rules`` (:func:`mesh_rules`):
    its blocks of ``params`` (a whole tree of numpy leaves, in the
    reference's layout) or, without them, of the weights the one-device
    model draws from ``seed`` (in slices of ``slice_bytes`` if given)."""
    rules = mesh_rules(group.mesh, rules)
    if params is None:
        gen = torch.Generator(group.device).manual_seed(seed)
        params = init_shard(cfg, gen, rules, group.rank,
                            device=group.device, slice_bytes=slice_bytes)
    else:
        params = params_from_numpy(cfg, params, device=group.device,
                                   rules=rules, rank=group.rank)
    return Model(cfg, params, mesh=group.mesh, rules=rules, group=group)


def run_jobs(group, jobs: Sequence) -> List[object]:
    """Several of this module's functions on one spawn: ``jobs`` is a
    list of ``(fn, args, kwargs)``, each run as ``fn(group, *args,
    **kwargs)`` in order; returns their results."""
    return [fn(group, *args, **kwargs) for fn, args, kwargs in jobs]


def logits_rank(group, cfg, params, tokens: np.ndarray,
                lengths: np.ndarray, feed: np.ndarray,
                block_size: int = 8, nb_pad: int = 4,
                rules: Optional[Dict[str, bool]] = None,
                record: bool = False,
                dense_len: Optional[int] = None) -> Dict[str, object]:
    """``prefill`` of the padded batch ``tokens [B, S]`` (valid
    ``lengths``), its K/V written into a paged pool of ``block_size``
    blocks, then one paged ``decode_step`` a row of ``feed [steps, B]``
    (the input tokens, at the next positions; tables ``nb_pad`` wide);
    with ``dense_len``, :func:`dense_logits` instead (``lengths`` None).
    Returns the float32 logits of each call as numpy (``prefill`` ``[B,
    vocab]``, ``decode`` ``[steps, B, vocab]``) and the rank's heads,
    under the flags ``rules`` (:func:`mesh_rules`); with ``record``, its
    collectives in order (``(op, shape, dtype)``). Over a data axis each
    data rank runs its block of the ``B`` rows (its own pool) and the
    logits are gathered over the data axis."""
    model = rank_model(group, cfg, params, rules=rules)
    group.record = [] if record else None
    if model.data > 1:
        a, b = model.layout.rows(tokens.shape[0])
        tokens, feed = tokens[a:b], feed[:, a:b]
        lengths = None if lengths is None else lengths[a:b]
    logits = (paged_logits(model, tokens, lengths, feed, block_size, nb_pad)
              if dense_len is None
              else dense_logits(model, tokens, feed, dense_len))
    if model.data > 1:
        whole = lambda x: group.gather_rows(  # noqa: E731
            torch.from_numpy(x).to(model.device)).cpu().numpy()
        logits = {"prefill": whole(logits["prefill"]),
                  "decode": whole(logits["decode"].transpose(1, 0, 2)
                                  .copy()).transpose(1, 0, 2)}
    out = dict(logits, kv_heads=model.n_kv_heads, heads=model.n_heads,
               record=group.record)
    group.record = None
    return out


def paged_logits(model: Model, tokens: np.ndarray, lengths: np.ndarray,
                 feed: np.ndarray, block_size: int = 8,
                 nb_pad: int = 4) -> Dict[str, np.ndarray]:
    """:func:`logits_rank`'s calls on ``model`` (a rank's, or a model of
    one device)."""
    dev = model.device
    B, S = tokens.shape
    lt, cache = model.prefill(torch.as_tensor(tokens, device=dev),
                              torch.as_tensor(lengths, device=dev),
                              cache_len=S, own_rows=False)
    need = -(-(int(lengths.max()) + len(feed)) // block_size)
    pool = PagedKVCache(model.cfg, num_blocks=B * need,
                        block_size=block_size, device=dev,
                        kv_heads=model.n_kv_heads, seq_shard=model.seq_shard)
    for b, n in enumerate(lengths):
        pool.manager.allocate(b, int(n) + 1)
        pool.write_prefill(b, {k: v[:, b:b + 1] for k, v in cache.items()})
    positions = lengths.astype(np.int64).copy()
    decode = []
    for row in feed:
        for b in range(B):
            pool.manager.append_token(b, int(positions[b]) + 1)
        view = pool.view(list(range(B)), positions.tolist(),
                         nb_pad=nb_pad, batch_pad=B)
        decode.append(model.decode_step(torch.as_tensor(row, device=dev),
                                        view).cpu().numpy())
        positions += 1
    return {"prefill": lt.cpu().numpy(), "decode": np.stack(decode)}


def dense_logits(model: Model, tokens: np.ndarray, feed: np.ndarray,
                 cache_len: int) -> Dict[str, np.ndarray]:
    """The static loop's calls on ``model``: ``prefill`` of the aligned
    batch ``tokens [B, S]`` into a dense cache of ``cache_len`` slots (a
    ring under a sliding window; over a sharded KV sequence the rank's
    share of them), then one dense ``decode_step`` a row of ``feed
    [steps, B]`` at positions ``S, S + 1, ...``. Returns what
    :func:`paged_logits` does."""
    dev = model.device
    S = tokens.shape[1]
    lt, cache = model.prefill(torch.as_tensor(tokens, device=dev),
                              cache_len=cache_len)
    decode = [model.decode_step(torch.as_tensor(row, device=dev), cache,
                                pos=S + i).cpu().numpy()
              for i, row in enumerate(feed)]
    return {"prefill": lt.cpu().numpy(), "decode": np.stack(decode)}


def _served(group, engine, serve, record: bool) -> Dict[str, object]:
    """Run ``serve()`` on this rank's ``engine``; its kernel launches,
    graphs and, with ``record``, its collectives."""
    if record:
        group.record = []
    before = launch_counts()
    serve()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    out: Dict[str, object] = {
        "rank": group.rank,
        "launches": {k: v - before[k] for k, v in launch_counts().items()},
        "record": group.record, "graphs": list(engine.steps.graphs)}
    group.record = None
    return out


def serve_rank(group, cfg, ecfg, requests: Sequence, params=None, *,
               seed: int = 0, slice_bytes: Optional[int] = None,
               record: bool = False,
               rules: Optional[Dict[str, bool]] = None) -> Dict[str, object]:
    """Serve ``requests`` over the mesh (:meth:`~repro_torch.serving.
    engine.ContinuousBatchingEngine.serve_mesh`) in the mode ``ecfg``
    asks for. Every rank returns its kernel launches and, with
    ``record``, its collectives in order (``(op, shape, dtype)``); rank 0
    also each request's output tokens and finish reason, and the engine's
    counters (:func:`engine_counters`). ``rules``: the flags of
    :func:`mesh_rules`."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    model = rank_model(group, cfg, params, seed=seed,
                       slice_bytes=slice_bytes, rules=rules)
    engine = ContinuousBatchingEngine(model, ecfg, device=group.device)
    requests = list(requests)
    out = _served(group, engine, lambda: engine.serve_mesh(requests),
                  record)
    if group.rank == 0:
        out.update(tokens=[list(r.state.output_tokens) for r in requests],
                   finish=[r.state.finish_reason for r in requests],
                   **engine_counters(engine))
    return out


def engine_counters(engine) -> Dict[str, int]:
    """An engine's step, prefill, speculation and prefix-cache counters."""
    out = {name: getattr(engine, name) for name in (
        "decode_steps", "prefills", "prefill_steps", "chunks",
        "suffix_prefills",
        "spec_steps", "spec_drafted", "spec_accepted", "verify_iterations",
        "preemptions")}
    if engine.prefix is not None:
        out["prefix_hit_tokens"] = engine.prefix.stats.hit_tokens
    return out


def follow_rank(group, cfg, ecfg, params=None, seed: int = 0,
                slice_bytes: Optional[int] = None,
                record: bool = False,
                rules: Optional[Dict[str, bool]] = None) -> Dict[str, object]:
    """A cluster replica's rank other than 0: its shard (as
    :func:`rank_model` draws or cuts it, under the flags ``rules``) in an
    engine of ``ecfg`` that follows rank 0's, until the cluster stops it.
    Returns what :func:`serve_rank` returns of a rank other than 0."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    model = rank_model(group, cfg, params, seed=seed,
                       slice_bytes=slice_bytes, rules=rules)
    engine = ContinuousBatchingEngine(model, ecfg, device=group.device)
    return _served(group, engine, engine.follow, record)


class ParallelReplica:
    """A replica of ``cfg`` over the ``D x M`` ``mesh``
    (weights ``params``, a whole numpy tree, or drawn from ``seed`` in
    slices of ``slice_bytes``) that this process leads as rank 0, on
    process groups of the replica's own (so one process may lead several
    replicas without their collectives meeting).

    Built, it has started its ranks other than 0, each a process of its
    own that joins the mesh and follows rank 0's steps
    (:func:`follow_rank`); :meth:`lead` joins as rank 0 and returns its
    engine (start several replicas before leading any, so their
    followers load at once); :meth:`check` raises once a follower has
    exited (its next collective would wait on it forever); :meth:`close`
    stops the followers and leaves the groups. ``record`` keeps every
    rank's collectives (the lock-step check); ``rules`` are the flags of
    :func:`mesh_rules`."""

    def __init__(self, cfg, ecfg, mesh, params=None, *, seed: int = 0,
                 slice_bytes: Optional[int] = None, record: bool = False,
                 rules: Optional[Dict[str, bool]] = None):
        MeshGroup.check_mesh(mesh)
        self.cfg, self.ecfg, self.mesh, self.params = cfg, ecfg, mesh, params
        self.seed, self.slice_bytes, self.record = seed, slice_bytes, record
        self.rules = rules
        # rank 0's rendezvous, served here (port 0 picks a free one)
        self.store = rendezvous("tcp://127.0.0.1:0", 0, mesh.size)
        self.address = f"tcp://127.0.0.1:{self.store.port}"
        self.followers = RankProcesses(
            follow_rank, mesh, self.address,
            (cfg, ecfg, params, seed, slice_bytes, record, rules),
            range(1, mesh.size)) if mesh.size > 1 else None
        self.engine = None

    def lead(self):
        """Join the mesh as rank 0: its shard (:func:`rank_model`) in an
        engine of ``ecfg`` whose steps the followers run."""
        from repro_torch.serving.engine import ContinuousBatchingEngine
        dev = torch.device(self.mesh.devices.flat[0])
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            group = MeshGroup.init(self.mesh, 0, self.address,
                                   store=self.store)
            group.record = [] if self.record else None
            model = rank_model(group, self.cfg, self.params, seed=self.seed,
                               slice_bytes=self.slice_bytes,
                               rules=self.rules)
            self.engine = ContinuousBatchingEngine(model, self.ecfg,
                                                   device=dev)
        return self.engine

    def check(self):
        """Raise if a rank other than 0 has exited."""
        if self.followers is not None and self.followers.exited() is not None:
            raise RuntimeError("a rank other than 0 exited while the "
                               "replica serves")

    def close(self) -> Dict[int, Dict[str, object]]:
        """Send the followers rank 0's stop, drop the engine's CUDA graphs,
        leave the groups (an NCCL group aborts: its shutdown would wait
        for the followers'), and return each follower's
        :func:`follow_rank` result by rank; every follower process has
        ended when this returns. Once closed, or never led, it only stops
        the followers."""
        group = self.engine.model.group if self.engine is not None else None
        results: Dict[int, Dict[str, object]] = {}
        try:
            if group is not None and group.host is not None:
                if self.followers is None or self.followers.exited() is None:
                    self.engine.steps.channel.stop()
                if group.device.type == "cuda":
                    torch.cuda.synchronize(group.device)
                # a graph that captured the group's collectives holds its
                # NCCL communicator: aborting it first hangs, on this rank
                # and on its peers (seen on four H100s)
                self.engine.steps.graphs.clear()
                group.close()
                if self.followers is not None:
                    results = self.followers.collect(600.0)
        finally:
            if self.followers is not None:
                self.followers.stop()
                self.followers = None
            if group is not None and group.host is not None:
                group.close()
            self.store = None
        return results


def cluster_rank(cfg, ecfg, mesh, n_replicas: int, requests: Sequence,
                 params=None, *, seed: int = 0,
                 slice_bytes: Optional[int] = None, record: bool = False,
                 faults: Optional[str] = None,
                 **kw) -> Dict[str, object]:
    """A cluster of ``n_replicas`` replicas, one a slice of ``mesh``
    (:meth:`~repro_torch.serving.cluster.ReplicatedCluster.sliced`, with
    ``kw``; ``faults`` a :meth:`~repro_torch.serving.faults.FaultInjector.
    parse` spec), serving ``requests``: what a process of its own runs
    (:func:`~repro_torch.distributed.run_child`), leading every replica
    as its rank 0 while the replicas' other ranks follow in processes it
    starts. Returns each request's tokens and finish reason, the cluster
    metrics' counters, each replica's engine counters, the process's
    launches (every replica's rank 0 together) and, with ``record``, each
    replica's collectives; ``followers`` holds each replica's other
    ranks' :func:`follow_rank` results."""
    from repro_torch.serving.cluster import ReplicatedCluster
    from repro_torch.serving.faults import FaultInjector
    if torch.device(mesh.devices.flat[0]).type == "cpu":
        torch.set_num_threads(1)
    cluster = ReplicatedCluster.sliced(
        cfg, params, ecfg, mesh, n_replicas, seed=seed,
        slice_bytes=slice_bytes, record=record,
        faults=FaultInjector.parse(faults) if faults else None, **kw)
    requests = list(requests)
    before = launch_counts()
    metrics = cluster.run(requests)
    return {
        "tokens": [list(r.state.output_tokens) for r in requests],
        "finish": [r.state.finish_reason for r in requests],
        "redriven": metrics.redriven, "lost": metrics.lost,
        "healthy": [rep.healthy for rep in cluster.replicas],
        "replica_faults": [rep.faults for rep in cluster.replicas],
        "routed": [[r.req_id for r in rep.requests]
                   for rep in cluster.replicas],
        "engines": [engine_counters(rep.engine) for rep in cluster.replicas],
        "launches": {k: v - before[k] for k, v in launch_counts().items()},
        "records": [rep.engine.model.group.record
                    if rep.engine.model.group is not None else None
                    for rep in cluster.replicas],
        "followers": cluster.follower_results,
        "metrics": {"output_throughput": metrics.output_throughput,
                    "wall_s": metrics.wall_s,
                    "ttft": (metrics.ttft.p50, metrics.ttft.p95),
                    "itl": (metrics.itl.p50, metrics.itl.p95),
                    "output_tokens": metrics.output_tokens}}


def case_rank(group, case_args: Dict, seed: int = 0,
              steps: int = 1) -> List[np.ndarray]:
    """A dry-run decode case (``case_for(**case_args)`` over the group's
    mesh, under the ``act_replicated`` rules unless ``case_args`` names
    ``act_replicated``) materialized from ``seed`` as the rank's blocks,
    then ``steps`` greedy decode steps from its random tokens; returns
    each step's logits."""
    from repro_torch.launch.input_specs import case_for, materialize
    case = case_for(mesh=group.mesh, group=group,
                    **{"act_replicated": True, **case_args})
    gen = torch.Generator(group.device).manual_seed(seed)
    params, cache, tokens, pos = materialize(case, group.mesh, gen,
                                             rank=group.rank)
    out = []
    for _ in range(steps):
        logits, cache = case.fn(params, cache, tokens, pos)
        out.append(logits.cpu().numpy())
        tokens = logits.argmax(-1).to(torch.int32)
        pos = pos + 1
    return out
