"""Autoscaler: close the loop from measured engine curves to a running
cluster (the port of ``repro.serving.cluster.autoscale``).

The paper's pipeline (Secs. IV-VI) is profile -> advise -> replicate:

1. sweep the engine's ``max_batch`` knob on a fixed workload to get
   *measured* T(B)/ITL(B)/KV(B) curves (:func:`measure_curves`),
2. solve BCA (Eq. 2) on those curves for ``B_opt``,
3. ask :class:`~repro_torch.core.replication.ReplicationPlanner` how many
   ``B_opt``-sized replicas the freed memory hosts, capped to what the
   devices can be sliced into (:func:`decide`),
4. launch a :class:`~repro_torch.serving.cluster.ReplicatedCluster` with
   the decision (the caller picks placement: sliced or co-located).

Steps 2-3 are pure and cheap (tested on synthetic curves); step 1 runs
real engines and is what the replication benchmark spends its time on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.bca import (BatchingConfigurationAdvisor, BCAResult,
                                  slo_from_reference)
from repro_torch.core.hardware import Hardware
from repro_torch.core.perfmodel import ServingCurves
from repro_torch.core.replication import ReplicationPlan, ReplicationPlanner
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.workload import Request


@dataclasses.dataclass
class AutoscaleDecision:
    """Everything the sweep learned plus what to launch."""
    curves: ServingCurves
    bca: BCAResult
    plan: ReplicationPlan
    n_replicas: int              # what will actually launch (mesh-capped)
    per_replica_batch: int
    slo_s: float

    def summary(self) -> str:
        return (f"BCA {self.bca.summary()}\n"
                f"plan {self.plan.summary()} -> launch {self.n_replicas} "
                f"replica(s) x max_batch={self.per_replica_batch}")


def measure_curves(make_engine: Callable[[int], ContinuousBatchingEngine],
                   make_workload: Callable[[], List[Request]],
                   batches: Sequence[int], *,
                   warmup: bool = True) -> ServingCurves:
    """Sweep ``max_batch`` over real engines: the measured-data path into
    BCA, mirroring the paper's online-mode evaluation.

    ``make_engine(B)`` must return a fresh engine with ``max_batch=B``;
    ``make_workload()`` a fresh request list (same seed each call, so every
    point sees the identical workload). With ``warmup`` each engine first
    serves one workload uncounted, so its graph captures stay out of the
    curves.
    """
    rows = []
    for b in batches:
        engine = make_engine(int(b))
        if warmup:
            engine.run(make_workload())
            engine.reset_stats()
        m = engine.run(make_workload())
        rows.append((m.output_throughput, m.itl_s, m.max_kv_fraction))
    # curves are keyed by the max_batch knob (what BCA's B_opt must be),
    # not the measured average occupancy
    return ServingCurves(
        batches=np.asarray(batches, float),
        throughput=np.asarray([r[0] for r in rows]),
        itl_s=np.asarray([r[1] for r in rows]),
        kv_fraction=np.asarray([r[2] for r in rows]))


def _largest_divisor_at_most(size: int, cap: int) -> int:
    for d in range(min(size, cap), 0, -1):
        if size % d == 0:
            return d
    return 1


def decide(curves: ServingCurves, *, hw: Hardware, cfg: ArchConfig,
           ctx: int, slo_factor: float = 2.0, eps: float = 0.1,
           ref_batch: Optional[int] = None,
           max_replicas: Optional[int] = None,
           mesh_slices: Optional[int] = None) -> AutoscaleDecision:
    """BCA on ``curves`` -> ``B_opt`` -> replication plan -> launch size.

    ``mesh_slices`` is the number of devices replicas are carved from
    (the reference's mesh axis; None for co-location on one card); the
    launch count is clamped to its largest divisor not exceeding the
    memory-feasible replica count (slicing needs even splits).
    """
    ref = ref_batch if ref_batch is not None else int(curves.batches.min())
    slo_s = slo_from_reference(curves, ref, slo_factor)
    bca = BatchingConfigurationAdvisor(curves, slo_s=slo_s, eps=eps).solve()
    plan = ReplicationPlanner(hw, cfg, ctx=ctx).plan(
        bca.b_opt, max_replicas=max_replicas)
    n = plan.n_replicas
    if mesh_slices is not None:
        n = _largest_divisor_at_most(mesh_slices, n)
    return AutoscaleDecision(curves=curves, bca=bca, plan=plan,
                             n_replicas=n, per_replica_batch=bca.b_opt,
                             slo_s=slo_s)


def autoscale(make_engine: Callable[[int], ContinuousBatchingEngine],
              make_workload: Callable[[], List[Request]],
              batches: Sequence[int], *, hw: Hardware, cfg: ArchConfig,
              ctx: int, **decide_kw) -> AutoscaleDecision:
    """measure_curves + decide in one call — the autoscaler entry point."""
    curves = measure_curves(make_engine, make_workload, batches)
    return decide(curves, hw=hw, cfg=cfg, ctx=ctx, **decide_kw)
