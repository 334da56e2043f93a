"""Model replication planner — the paper's Section VI-B (a copy of
``repro.core.replication``'s planner).

The paper co-locates replicas on one H100 with NVIDIA MPS, one process a
replica, so each process holds its own copy of the weights: the planner
counts ``model_bytes`` once a replica, as the reference does. The port's
co-located replicas (``ReplicatedCluster.colocated``) run in one process
and share one set of weights, so on the card they hold the weights once
and the plan overstates their memory by ``(R - 1) x model_bytes``. The
reference's ``slice_mesh`` has its counterpart in :func:`slice_devices`,
which splits a list of devices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.hardware import Hardware


@dataclasses.dataclass
class ReplicationPlan:
    n_replicas: int
    per_replica_batch: int
    model_bytes: float
    kv_bytes_per_replica: float
    total_bytes: float
    capacity_bytes: float

    def summary(self) -> str:
        return (f"{self.n_replicas} replicas x B={self.per_replica_batch}: "
                f"{self.total_bytes/1e9:.1f} / {self.capacity_bytes/1e9:.1f} GB")


class ReplicationPlanner:
    """How many replicas fit once BCA trims the KV allocation?"""

    def __init__(self, hw: Hardware, cfg: ArchConfig, *, ctx: int,
                 dtype_bytes: int = 2, reserve_fraction: float = 0.1):
        self.hw = hw
        self.cfg = cfg
        self.ctx = ctx
        self.dtype_bytes = dtype_bytes
        self.reserve = reserve_fraction

    def plan(self, b_opt: int, max_replicas: Optional[int] = None
             ) -> ReplicationPlan:
        model_b = self.cfg.num_params() * self.dtype_bytes
        kv_b = self.cfg.kv_bytes_per_token(self.dtype_bytes) * self.ctx * b_opt
        cap = self.hw.hbm_bytes * (1 - self.reserve)
        per_replica = model_b + kv_b
        n = max(1, int(cap // per_replica))
        if max_replicas:
            n = min(n, max_replicas)
        return ReplicationPlan(
            n_replicas=n, per_replica_batch=b_opt, model_bytes=model_b,
            kv_bytes_per_replica=kv_b, total_bytes=n * per_replica,
            capacity_bytes=cap)


def slice_devices(devices: Sequence[Union[str, torch.device]],
                  n_replicas: int) -> List[List[torch.device]]:
    """Split ``devices`` into ``n_replicas`` disjoint slices in order (the
    reference's ``slice_mesh`` over a list of devices); raises if the count
    does not divide."""
    devs = [torch.device(d) for d in devices]
    if n_replicas < 1:
        raise ValueError(f"need >= 1 replica, got {n_replicas}")
    if not devs or len(devs) % n_replicas:
        raise ValueError(f"{len(devs)} devices not divisible by "
                         f"{n_replicas}")
    per = len(devs) // n_replicas
    return [devs[i * per:(i + 1) * per] for i in range(n_replicas)]
