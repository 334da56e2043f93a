"""Three-term roofline from a step's cost census (a copy of
``repro.core.roofline``'s ``RooflineReport``, ``roofline_report`` and
``model_flops_for``).

    compute term    = census FLOPs / peak FLOP/s      (per chip)
    memory term     = census bytes / HBM bandwidth    (per chip)
    collective term = coll_bytes   / link bandwidth   (per chip)

The reference reads its census from the compiled XLA program; the port's
comes from :mod:`repro_torch.core.census` (one card, no collectives).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.census import OpCensus, param_count
from repro_torch.core.hardware import Hardware


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float              # 6*N*D (global, analytic)
    hlo_flops_global: float         # census flops * chips
    useful_ratio: float             # model_flops / hlo_flops_global
    per_class_ai: Dict[str, float]
    per_class_terms: Dict[str, Dict[str, float]]
    memory_gb_per_chip: float = 0.0
    # a live report's bucket census as dispatched
    # (repro_torch.core.analysis.Dispatched; None where not measured),
    # beside the terms and not one of them
    dispatched: Optional[object] = dataclasses.field(default=None,
                                                     compare=False)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        # optimistic full-overlap model: the roofline bound is the max term
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """model-FLOPs utilization at the roofline-bound step time."""
        if self.step_time_s <= 0:
            return 0.0
        return (self.compute_s / self.step_time_s) * self.useful_ratio

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} "
                f"| {self.compute_s*1e3:.2f} | {self.memory_s*1e3:.2f} "
                f"| {self.collective_s*1e3:.2f} | **{self.dominant}** "
                f"| {self.useful_ratio:.2f} | {self.memory_gb_per_chip:.2f} |")


def roofline_report(census: OpCensus, hw: Hardware, *, arch: str = "",
                    shape: str = "", mesh: str = "", chips: int = 1,
                    model_flops: float = 0.0,
                    memory_bytes_per_chip: float = 0.0) -> RooflineReport:
    per_class_ai = {k: v.flops / max(v.bytes, 1.0)
                    for k, v in census.per_class.items()}
    per_class_terms = {
        k: {"compute_s": v.flops / hw.peak_flops,
            "memory_s": v.bytes / hw.hbm_bw,
            "collective_s": v.coll_bytes / hw.link_bw}
        for k, v in census.per_class.items()}
    hlo_global = census.flops * chips
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh,
        compute_s=census.flops / hw.peak_flops,
        memory_s=census.bytes / hw.hbm_bw,
        collective_s=census.coll_bytes / hw.link_bw,
        model_flops=model_flops,
        hlo_flops_global=hlo_global,
        useful_ratio=model_flops / hlo_global if hlo_global else 0.0,
        per_class_ai=per_class_ai,
        per_class_terms=per_class_terms,
        memory_gb_per_chip=memory_bytes_per_chip / 1e9,
    )


def model_flops_for(cfg, shape_kind: str, batch: int, seq: int,
                    train: bool, n_params: int = 0) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE: the top-k experts of each MoE
    layer, as the reference counts them); decode processes batch
    tokens. ``N`` is ``n_params`` where given (the dry-run passes the
    config's analytic ``active_params``, as the reference's dry-run
    does), else the parameter tree's active count."""
    n = n_params or param_count(cfg, active=True)
    tokens = batch * seq if shape_kind != "decode" else batch
    mult = 6.0 if train else 2.0
    return mult * n * tokens
