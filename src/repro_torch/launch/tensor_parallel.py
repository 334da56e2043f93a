"""One tensor-parallel model, one process a device: what each rank runs
under :func:`repro_torch.distributed.spawn`.

Each function takes the rank's :class:`~repro_torch.distributed.MeshGroup`
first and is called on every rank with the same arguments; what it
returns from rank 0 is the model's output (the logits and the collectives
are replicated, so every rank computes the same), the others return
their own accounting. E.g., on two cards::

    from repro_torch.distributed import devices_mesh, spawn
    out = spawn(serve_rank, devices_mesh(2), cfg, ecfg, requests)

serves ``requests`` over ``cuda:0`` and ``cuda:1`` (``devices_mesh(2,
"cpu")``: two gloo ranks on the CPU).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.models.model import Model
from repro_torch.models.params import init_shard, params_from_numpy
from repro_torch.serving.steps import launch_counts
from repro_torch.sharding import rules_for


def rank_model(group, cfg, params=None, *, seed: int = 0,
               slice_bytes: Optional[int] = None) -> Model:
    """The rank's model: its blocks of ``params`` (a whole tree of numpy
    leaves, in the reference's layout) or, without them, of the weights
    the one-device model draws from ``seed`` (in slices of
    ``slice_bytes`` if given)."""
    rules = rules_for(group.mesh, act_replicated=True)
    if params is None:
        gen = torch.Generator(group.device).manual_seed(seed)
        params = init_shard(cfg, gen, rules, group.rank,
                            device=group.device, slice_bytes=slice_bytes)
    else:
        params = params_from_numpy(cfg, params, device=group.device,
                                   rules=rules, rank=group.rank)
    return Model(cfg, params, mesh=group.mesh, rules=rules)


def run_jobs(group, jobs: Sequence) -> List[object]:
    """Several of this module's functions on one spawn: ``jobs`` is a
    list of ``(fn, args, kwargs)``, each run as ``fn(group, *args,
    **kwargs)`` in order; returns their results."""
    return [fn(group, *args, **kwargs) for fn, args, kwargs in jobs]


def logits_rank(group, cfg, params, tokens: np.ndarray,
                lengths: np.ndarray, feed: np.ndarray,
                block_size: int = 8, nb_pad: int = 4) -> Dict[str, object]:
    """``prefill`` of the padded batch ``tokens [B, S]`` (valid
    ``lengths``), its K/V written into a paged pool of ``block_size``
    blocks, then one paged ``decode_step`` a row of ``feed [steps, B]``
    (the input tokens, at the next positions; tables ``nb_pad`` wide).
    Returns the float32 logits of each call as numpy (``prefill`` ``[B,
    vocab]``, ``decode`` ``[steps, B, vocab]``) and the rank's heads."""
    model = rank_model(group, cfg, params)
    return dict(paged_logits(model, tokens, lengths, feed, block_size,
                             nb_pad), kv_heads=model.n_kv_heads,
                heads=model.n_heads)


def paged_logits(model: Model, tokens: np.ndarray, lengths: np.ndarray,
                 feed: np.ndarray, block_size: int = 8,
                 nb_pad: int = 4) -> Dict[str, np.ndarray]:
    """:func:`logits_rank`'s calls on ``model`` (a rank's, or a model of
    one device)."""
    dev = model.device
    B, S = tokens.shape
    lt, cache = model.prefill(torch.as_tensor(tokens, device=dev),
                              torch.as_tensor(lengths, device=dev),
                              cache_len=S)
    need = -(-(int(lengths.max()) + len(feed)) // block_size)
    pool = PagedKVCache(model.cfg, num_blocks=B * need,
                        block_size=block_size, device=dev,
                        kv_heads=model.n_kv_heads)
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


def serve_rank(group, cfg, ecfg, requests: Sequence, params=None, *,
               seed: int = 0, slice_bytes: Optional[int] = None,
               record: bool = False) -> Dict[str, object]:
    """Serve ``requests`` over the mesh (:meth:`~repro_torch.serving.
    engine.ContinuousBatchingEngine.serve_mesh`). Every rank returns its
    kernel launches and, with ``record``, its collectives in order
    (``(op, shape, dtype)``); rank 0 also each request's output tokens
    and finish reason, and the engine's decode steps and prefills."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    model = rank_model(group, cfg, params, seed=seed,
                       slice_bytes=slice_bytes)
    engine = ContinuousBatchingEngine(model, ecfg, device=group.device)
    if record:
        group.record = []
    before = launch_counts()
    engine.serve_mesh(list(requests))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    out: Dict[str, object] = {
        "rank": group.rank,
        "launches": {k: v - before[k] for k, v in launch_counts().items()},
        "record": group.record, "graphs": list(engine.steps.graphs)}
    group.record = None
    if group.rank == 0:
        out.update(tokens=[list(r.state.output_tokens) for r in requests],
                   finish=[r.state.finish_reason for r in requests],
                   decode_steps=engine.decode_steps,
                   prefills=engine.prefills)
    return out


def case_rank(group, case_args: Dict, seed: int = 0,
              steps: int = 1) -> List[np.ndarray]:
    """A dry-run decode case (``case_for(**case_args)`` over the group's
    mesh under the ``act_replicated`` rules) materialized from ``seed``
    as the rank's blocks, then ``steps`` greedy decode steps from its
    random tokens; returns each step's logits."""
    from repro_torch.launch.input_specs import case_for, materialize
    case = case_for(mesh=group.mesh, act_replicated=True, **case_args)
    gen = torch.Generator(group.device).manual_seed(seed)
    params, cache, tokens, pos = materialize(case, group.mesh, gen)
    out = []
    for _ in range(steps):
        logits, cache = case.fn(params, cache, tokens, pos)
        out.append(logits.cpu().numpy())
        tokens = logits.argmax(-1).to(torch.int32)
        pos = pos + 1
    return out
