"""Aggregated cluster metrics: goodput, per-replica utilization, queue
depths, and TTFT/ITL/E2E tail percentiles across all replicas (a copy of
``repro.serving.cluster.metrics``, field for field, over the port's
``ServingMetrics``).

``ClusterMetrics`` is the cluster-level analogue of
:class:`~repro_torch.serving.metrics.ServingMetrics`: per-replica metrics are
kept verbatim (``per_replica``) so a router-policy comparison can look at
imbalance, while the aggregate view answers the paper's Table IV question
— does BCA x R replicas beat the single MAX-batch replica?
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.serving.metrics import Percentiles, ServingMetrics
from repro_torch.serving.workload import FINISH_REASONS


@dataclasses.dataclass
class ReplicaStats:
    """One replica's contribution to a cluster run."""
    replica: int
    n_requests: int              # requests routed to this replica
    completed: int
    preemptions: int
    busy_fraction: float         # time in decode steps / cluster wall time
    occupancy: float             # avg running batch / max_batch
    max_queue_depth: int
    metrics: ServingMetrics
    # --- fault tolerance ---
    healthy: bool = True         # still serving at collection time
    faults: int = 0              # failures observed on this replica
    # fraction of the run this replica was in service (1.0 = never
    # failed; a replica quarantined at t and never respawned scores
    # t / wall; a respawned one loses only its downtime)
    availability: float = 1.0

    def row(self) -> str:
        health = "" if self.healthy else \
            f" DOWN(avail={self.availability*100:.0f}%)"
        return (f"replica {self.replica}:{health} reqs={self.n_requests} "
                f"busy={self.busy_fraction*100:.0f}% "
                f"occ={self.occupancy*100:.0f}% "
                f"preempt={self.preemptions} "
                f"qmax={self.max_queue_depth}  {self.metrics.row()}")


@dataclasses.dataclass
class ClusterMetrics:
    wall_s: float
    n_replicas: int
    policy: str
    mode: str
    completed: int               # requests finished across all replicas
    total_tokens: int            # input + output (paper's throughput unit)
    output_tokens: int
    ttft_s: float                # mean time-to-first-token
    ttft: Percentiles
    itl: Percentiles             # pooled decode-step latencies
    e2e: Percentiles
    mean_queue_depth: float
    max_queue_depth: int
    per_replica: List[ReplicaStats]
    # KV pool occupancy across replicas (peak of peaks / mean of means)
    peak_kv_fraction: float = 0.0
    mean_kv_fraction: float = 0.0
    # prefix-cache reuse pooled across replicas (0 / zeros when off)
    prefix_hit_rate: float = 0.0
    prefill_tokens_skipped: int = 0
    prefix_blocks_shared: int = 0
    # finish-reason breakdown summed across replicas ({"length": n,
    # "stop": n, "abort": n, "deadline": n, "shed": n, "failed": n})
    finish_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    # --- fault tolerance / robustness ---
    faults: int = 0              # replica failures observed (injected or real)
    redriven: int = 0            # stranded requests re-admitted on survivors
    lost: int = 0                # requests finished "failed" (redrives spent)
    shed: int = 0                # rejected by admission control
    deadline_expired: int = 0    # finished "deadline" across replicas
    queued_aborts: int = 0       # aborts caught in arrival queues
    watchdog_trips: int = 0      # wedged-replica detections
    # mean per-replica availability (1.0 = no replica ever failed)
    availability: float = 1.0
    # --- speculative decoding (summed across replicas; all zero when
    # no replica ran with EngineConfig.speculate) ---
    spec_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_rejected: int = 0

    @property
    def throughput(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)

    @property
    def output_throughput(self) -> float:
        """Aggregate output tok/s — the replication payoff metric."""
        return self.output_tokens / max(self.wall_s, 1e-9)

    @property
    def goodput_rps(self) -> float:
        """Completed requests per second across the cluster."""
        return self.completed / max(self.wall_s, 1e-9)

    @property
    def preemptions(self) -> int:
        return sum(r.preemptions for r in self.per_replica)

    @property
    def spec_acceptance_rate(self) -> float:
        """Pooled accepted fraction of all drafted tokens cluster-wide."""
        return self.spec_accepted / max(self.spec_drafted, 1)

    def row(self) -> str:
        return (f"R={self.n_replicas} [{self.policy}/{self.mode}] "
                f"T={self.throughput:.1f} tok/s "
                f"out={self.output_throughput:.1f} tok/s "
                f"goodput={self.goodput_rps:.2f} req/s "
                f"TTFT_p95={self.ttft.p95*1e3:.0f} ms "
                f"ITL_p95={self.itl.p95*1e3:.0f} ms")

    def summary(self) -> str:
        lines = [self.row(),
                 f"  TTFT {self.ttft.row()}",
                 f"  ITL  {self.itl.row()}",
                 f"  E2E  {self.e2e.row(scale=1.0, unit='s')}",
                 f"  queue depth: mean={self.mean_queue_depth:.1f} "
                 f"max={self.max_queue_depth}",
                 f"  KV pool: peak={self.peak_kv_fraction*100:.1f}% "
                 f"mean={self.mean_kv_fraction*100:.1f}%"]
        if self.prefill_tokens_skipped or self.prefix_hit_rate:
            lines.append(
                f"  prefix cache: hit_rate={self.prefix_hit_rate*100:.1f}% "
                f"skipped={self.prefill_tokens_skipped} tok "
                f"shared={self.prefix_blocks_shared} blk")
        if self.finish_reasons:
            lines.append("  finish: " + " ".join(
                f"{k}={self.finish_reasons.get(k, 0)}"
                for k in FINISH_REASONS))
        if self.spec_steps:
            lines.append(
                f"  spec: steps={self.spec_steps} "
                f"drafted={self.spec_drafted} "
                f"accepted={self.spec_accepted} "
                f"({self.spec_acceptance_rate*100:.0f}%)")
        if self.faults or self.shed or self.deadline_expired \
                or self.watchdog_trips:
            lines.append(
                f"  faults: {self.faults} redriven={self.redriven} "
                f"lost={self.lost} shed={self.shed} "
                f"deadline={self.deadline_expired} "
                f"watchdog={self.watchdog_trips} "
                f"avail={self.availability*100:.1f}%")
        lines += [f"  {r.row()}" for r in self.per_replica]
        return "\n".join(lines)


def aggregate(per_replica: List[ReplicaStats], *, wall_s: float, policy: str,
              mode: str, ttft_samples: Sequence[float],
              itl_samples: Sequence[float], e2e_samples: Sequence[float],
              queue_samples: Sequence[Sequence[int]],
              redriven: int = 0, lost: int = 0, shed: int = 0,
              watchdog_trips: int = 0) -> ClusterMetrics:
    """Fold per-replica stats + pooled latency samples into one view."""
    depth = np.asarray([sum(q) for q in queue_samples], float) \
        if queue_samples else np.zeros(0)
    pfx = [r.metrics.prefix for r in per_replica
           if r.metrics.prefix is not None]
    prompt_toks = sum(p.prompt_tokens for p in pfx)
    hit_toks = sum(p.hit_tokens for p in pfx)
    kv_means = [r.metrics.kv_used_mean for r in per_replica
                if r.metrics.kv_used_series]
    finish: Dict[str, int] = {}
    for r in per_replica:
        for k, v in r.metrics.finish_reasons.items():
            finish[k] = finish.get(k, 0) + v
    return ClusterMetrics(
        wall_s=wall_s,
        n_replicas=len(per_replica),
        policy=policy,
        mode=mode,
        completed=sum(r.completed for r in per_replica),
        total_tokens=sum(r.metrics.total_tokens for r in per_replica),
        output_tokens=sum(r.metrics.output_tokens for r in per_replica),
        ttft_s=float(np.mean(ttft_samples)) if len(ttft_samples) else 0.0,
        ttft=Percentiles.from_samples(ttft_samples),
        itl=Percentiles.from_samples(itl_samples),
        e2e=Percentiles.from_samples(e2e_samples),
        mean_queue_depth=float(depth.mean()) if depth.size else 0.0,
        max_queue_depth=int(depth.max()) if depth.size else 0,
        per_replica=per_replica,
        peak_kv_fraction=max((r.metrics.max_kv_fraction
                              for r in per_replica), default=0.0),
        mean_kv_fraction=float(np.mean(kv_means)) if kv_means else 0.0,
        prefix_hit_rate=hit_toks / prompt_toks if prompt_toks else 0.0,
        prefill_tokens_skipped=hit_toks,
        prefix_blocks_shared=sum(p.blocks_shared for p in pfx),
        finish_reasons=finish,
        faults=sum(r.faults for r in per_replica),
        redriven=redriven,
        lost=lost,
        # cluster-level sheds (routed admission) + any engine-level ones
        shed=shed + sum(r.metrics.shed for r in per_replica),
        deadline_expired=sum(r.metrics.deadline_expired
                             for r in per_replica),
        queued_aborts=sum(r.metrics.queued_aborts for r in per_replica),
        watchdog_trips=watchdog_trips,
        availability=(float(np.mean([r.availability for r in per_replica]))
                      if per_replica else 1.0),
        spec_steps=sum(r.metrics.spec_steps for r in per_replica),
        spec_drafted=sum(r.metrics.spec_drafted for r in per_replica),
        spec_accepted=sum(r.metrics.spec_accepted for r in per_replica),
        spec_rejected=sum(r.metrics.spec_rejected for r in per_replica))
