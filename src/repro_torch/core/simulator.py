"""Event-driven multi-replica serving simulator (paper Table IV / Fig. 13;
a copy of ``repro.core.simulator``, over the port's own perf model, so
its results equal the reference's to the last bit).

Each replica alternates host phases (scheduler/dispatch — the paper's "CPU
time", no device resource) and device phases. A device phase carries two
work quantities: memory bytes and compute FLOPs. Concurrent device phases
share HBM bandwidth processor-sharing style (the MPS analogue), while
compute runs at full rate per replica up to the chip total — this is
exactly the overlap mechanism the paper exploits: while one replica sits
in its host gap or is compute-finishing, another streams the DRAM.

The simulator advances in events (phase completions under current rates)
and reports throughput / ITL / utilization per configuration, reproducing
the paper's qualitative result: replication raises DRAM utilization and
total throughput until bandwidth saturates (+34% OPT-1.3B, +13% OPT-2.7B).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.hardware import Hardware
from repro_torch.core.perfmodel import HostOverhead, decode_step_terms


@dataclasses.dataclass
class SimResult:
    n_replicas: int
    batch_per_replica: int
    steps: int
    wall_s: float
    throughput_tok_s: float
    itl_s: float
    dram_utilization: float
    compute_utilization: float
    host_gap_fraction: float

    def summary(self) -> str:
        return (f"R={self.n_replicas} B={self.batch_per_replica}: "
                f"T={self.throughput_tok_s:.0f} tok/s  "
                f"ITL={self.itl_s*1e3:.2f} ms  "
                f"DRAM={self.dram_utilization*100:.0f}%  "
                f"compute={self.compute_utilization*100:.0f}%  "
                f"host-gap={self.host_gap_fraction*100:.0f}%")


@dataclasses.dataclass
class _Replica:
    idx: int
    phase: str                 # 'host' | 'gpu'
    mem_left: float = 0.0      # bytes
    comp_left: float = 0.0     # flops
    host_left: float = 0.0     # seconds
    steps_done: int = 0


@dataclasses.dataclass(frozen=True)
class BandwidthEfficiency:
    """Achievable fraction of peak HBM bandwidth vs concurrency.

    The paper's central GPU observation (Table IV "DRAM Read" column):
    a single replica's dependency stalls and poor cache hit rates
    (Table III) cap achieved DRAM bandwidth well below peak (~47% at MAX
    batch); co-scheduled replicas interleave independent request streams
    and push it up (66% at R=2, 77% at R=4). eta(n) below is calibrated
    to those three points.
    """
    eta1: float = 0.61
    eta_inf: float = 0.82

    def eta(self, n: int) -> float:
        if n <= 0:
            return self.eta1
        return self.eta1 + (self.eta_inf - self.eta1) * (1.0 - 1.0 / n)


def simulate_decode(cfg: ArchConfig, hw: Hardware, *, batch: int,
                    n_replicas: int, ctx: int, steps: int = 64,
                    host: Optional[HostOverhead] = None,
                    dtype_bytes: int = 2,
                    bw_eff: Optional[BandwidthEfficiency] = None
                    ) -> SimResult:
    """Simulate ``steps`` decode steps on each of ``n_replicas`` replicas
    co-located on one accelerator."""
    host = host or HostOverhead()
    bw_eff = bw_eff or BandwidthEfficiency()
    terms = decode_step_terms(cfg, batch, ctx, hw, dtype_bytes=dtype_bytes,
                              host=host)
    mem_work = terms.mem_bytes
    comp_work = terms.flops
    host_s = terms.host_s

    reps = [_Replica(i, "host", host_left=host_s * (0.3 + 0.7 * i / max(
        n_replicas, 1))) for i in range(n_replicas)]
    t = 0.0
    dram_busy_bytes = 0.0
    comp_busy_flops = 0.0
    host_busy = [0.0] * n_replicas
    total_steps_target = steps * n_replicas
    done_steps = 0
    eps = 1e-12

    while done_steps < total_steps_target:
        gpu_active = [r for r in reps if r.phase == "gpu"]
        n_act = len(gpu_active)
        # aggregate achieved bandwidth grows with concurrency (see
        # BandwidthEfficiency), then is processor-shared among phases
        agg_bw = hw.hbm_bw * bw_eff.eta(n_act)
        mem_rate = agg_bw / max(n_act, 1)
        comp_rate = hw.peak_flops / max(n_act, 1)
        # time to next completion
        dt = float("inf")
        for r in reps:
            if r.phase == "host":
                dt = min(dt, r.host_left)
            else:
                need = max(r.mem_left / mem_rate, r.comp_left / comp_rate)
                dt = min(dt, need)
        if dt == float("inf"):
            break
        dt = max(dt, eps)
        # advance
        for r in reps:
            if r.phase == "host":
                r.host_left -= dt
                host_busy[r.idx] += dt
            else:
                # both resources progress toward the max() completion time
                need = max(r.mem_left / mem_rate, r.comp_left / comp_rate)
                frac = min(1.0, dt / max(need, eps))
                dm = r.mem_left * frac
                dc = r.comp_left * frac
                r.mem_left -= dm
                r.comp_left -= dc
                dram_busy_bytes += dm
                comp_busy_flops += dc
        t += dt
        # phase transitions
        for r in reps:
            if r.phase == "host" and r.host_left <= eps:
                r.phase = "gpu"
                r.mem_left = mem_work
                r.comp_left = comp_work
            elif r.phase == "gpu" and r.mem_left <= eps and r.comp_left <= eps:
                r.phase = "host"
                r.host_left = host_s
                r.steps_done += 1
                done_steps += 1

    wall = max(t, eps)
    tput = done_steps * batch / wall
    return SimResult(
        n_replicas=n_replicas, batch_per_replica=batch, steps=done_steps,
        wall_s=wall, throughput_tok_s=tput,
        itl_s=wall / max(min(r.steps_done for r in reps), 1),
        dram_utilization=dram_busy_bytes / (hw.hbm_bw * wall),
        compute_utilization=comp_busy_flops / (hw.peak_flops * wall),
        host_gap_fraction=sum(host_busy) / (n_replicas * wall))


def replication_sweep(cfg: ArchConfig, hw: Hardware, *, batch: int,
                      ctx: int, max_replicas: int = 4,
                      host: Optional[HostOverhead] = None
                      ) -> List[SimResult]:
    return [simulate_decode(cfg, hw, batch=batch, n_replicas=r, ctx=ctx,
                            host=host)
            for r in range(1, max_replicas + 1)]
