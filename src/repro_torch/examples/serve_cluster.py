"""Serve a bursty workload through the replicated cluster: R engine
replicas (one per mesh slice when >= 2 devices are visible, else
co-located), a pluggable router, and aggregated cluster metrics.

With --autoscale the cluster is sized by the paper's loop instead of
--replicas: sweep measured curves on one replica, solve BCA for B_opt,
cap the ReplicationPlanner's count by the available mesh slices.

The counterpart of ``examples/serve_cluster.py``. The devices are the
machine's cards (``torch.cuda.device_count()``), or two ``"cpu"``
devices under ``--device cpu``, so a CPU run takes the same sliced
branch as the reference's two virtual host devices. A sliced replica
runs on one card (a slice of several would need the sharding rules run
across cards), so the mesh is made over the first R cards. The
autoscaler plans for the card's own ``Hardware`` (on the CPU the H100
SXM5 entry, from the data sheet), where the reference plans for a TPU
v5e. After the reference's summary it prints each replica's device and
the tokens it served.

    PYTHONPATH=src python -m repro_torch.examples.serve_cluster
    PYTHONPATH=src python -m repro_torch.examples.serve_cluster --autoscale --policy jsq
    PYTHONPATH=src python -m repro_torch.examples.serve_cluster --full --replicas 4 --requests 32
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.core import Hardware
from repro_torch.device import resolve_device
from repro_torch.examples import (Lines, add_port_options, card_hardware,
                                  parser)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import Model
from repro_torch.models.params import Tree, init_params
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                 ReplicatedCluster, Request, sharegpt_like)
from repro_torch.serving.cluster import autoscale as autoscale_cluster

ARCH = "opt-1.3b"


def engine_config(max_batch: int) -> EngineConfig:
    return EngineConfig(max_batch=max_batch, block_size=16,
                        kv_pool_tokens=4096, max_model_len=128,
                        prefill_bucket=32)


def workload(n: int, vocab: int, seed: int, mean_in: int, mean_out: int,
             pattern: str, rate: Optional[float] = None) -> List[Request]:
    # offline workloads (no rate — e.g. the autoscale curve sweep) can't
    # carry a non-poisson pattern
    return sharegpt_like(n, vocab, seed=seed, mean_in=mean_in,
                         mean_out=mean_out, max_len=64, sigma=0.3,
                         arrival_rate=rate,
                         arrival_pattern=pattern if rate else "poisson",
                         burst_size=4)


def run(cfg: ArchConfig, params: Tree, devices: Sequence[torch.device],
        hw: Hardware, *, requests: int = 8, replicas: int = 2,
        max_batch: int = 2, mean_in: int = 12, mean_out: int = 8,
        policy: str = "round-robin", mode: str = "thread",
        arrival_rate: float = 4.0, pattern: str = "burst",
        autoscale: bool = False, echo: bool = True) -> Dict:
    """Serve ``requests`` through R replicas of ``cfg`` with the weights
    ``params`` (a tree in the reference's layout) over ``devices``.
    Returns ``lines``, ``branch`` (``"sliced"`` or ``"colocated"``),
    ``cluster``, ``requests`` (served) and ``metrics``."""
    out = Lines(echo)
    n_dev = len(devices)

    def wl(seed, rate=None):
        return workload(requests, cfg.vocab_size, seed, mean_in, mean_out,
                        pattern, rate)

    n_rep = replicas
    if autoscale:
        model = Model(cfg, params, device=devices[0])
        decision = autoscale_cluster(
            lambda b: ContinuousBatchingEngine(model, engine_config(b),
                                               device=model.device),
            lambda: wl(1), batches=(1, 2), hw=hw, cfg=cfg,
            ctx=mean_in + mean_out, eps=0.05, mesh_slices=n_dev)
        out(decision.summary())
        n_rep, max_batch = decision.n_replicas, decision.per_replica_batch

    if n_dev >= n_rep > 1 and n_dev % n_rep == 0:
        out(f"[cluster] {n_rep} replicas on disjoint mesh slices")
        mesh = make_mesh((n_rep, 1), ("data", "model"),
                         devices=devices[:n_rep])
        cluster = ReplicatedCluster.sliced(cfg, params,
                                           engine_config(max_batch), mesh,
                                           n_rep, policy=policy, mode=mode)
        branch = "sliced"
    else:
        out(f"[cluster] {n_rep} co-located replicas (shared mesh)")
        model = Model(cfg, params, device=devices[0])
        cluster = ReplicatedCluster.colocated(model, engine_config(max_batch),
                                              n_rep, policy=policy,
                                              mode=mode)
        branch = "colocated"
    reqs = wl(0, rate=arrival_rate)
    metrics = cluster.run(reqs)
    out(metrics.summary())
    assert metrics.completed == requests, "cluster dropped requests"
    for rep in cluster.replicas:
        out(f"[cluster] replica {rep.idx} on {rep.engine.device}: "
            f"{len(rep.requests)} requests, "
            f"{sum(len(r.output_tokens) for r in rep.requests)} output "
            f"tokens")
    return {"lines": out, "branch": branch, "cluster": cluster,
            "requests": reqs, "metrics": metrics}


def devices_for(device: torch.device) -> List[torch.device]:
    """Every card of the machine, or two CPU devices (the stand-in for
    several cards, as the reference's CI forces two virtual host
    devices)."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device] * 2


def build_parser():
    ap = parser("serve_cluster", __doc__)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--mean-in", type=int, default=12)
    ap.add_argument("--mean-out", type=int, default=8)
    ap.add_argument("--policy", default="round-robin",
                    choices=("round-robin", "jsq", "least-kv"))
    ap.add_argument("--mode", default="thread", choices=("thread", "sync"))
    ap.add_argument("--arrival-rate", type=float, default=4.0)
    ap.add_argument("--pattern", default="burst",
                    choices=("poisson", "burst", "ramp"))
    ap.add_argument("--autoscale", action="store_true")
    return add_port_options(ap)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    full = get_config(ARCH)
    cfg = full if args.full else reduced(full)
    devices = devices_for(device)
    params = init_params(cfg, torch.Generator(devices[0]).manual_seed(0),
                         device=devices[0])
    hw, _ = card_hardware(device)
    return run(cfg, params, devices, hw, requests=args.requests,
               replicas=args.replicas, max_batch=args.max_batch,
               mean_in=args.mean_in, mean_out=args.mean_out,
               policy=args.policy, mode=args.mode,
               arrival_rate=args.arrival_rate, pattern=args.pattern,
               autoscale=args.autoscale)


if __name__ == "__main__":
    main()
