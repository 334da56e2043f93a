"""Arithmetic-intensity analysis (the paper's Fig. 1; a copy of
``repro.core.intensity``).

Produces per-kernel-class (attention / matmul / ssm) arithmetic intensity
as a function of batch size from the analytical perf model. The paper's
headline result is that attention AI is ~constant in batch (0.5-1
FLOP/B) while matmul AI is ~linear until weight traffic amortizes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import ArchConfig
from repro_torch.core.hardware import Hardware
from repro_torch.core.perfmodel import decode_step_terms


@dataclasses.dataclass
class IntensityPoint:
    batch: int
    ai: Dict[str, float]                 # class -> FLOP/byte
    perf: Dict[str, float]               # class -> achieved FLOP/s (roofline-capped)
    mem_rate: Dict[str, float]           # class -> achieved bytes/s


def intensity_sweep(cfg: ArchConfig, hw: Hardware, *, ctx: int,
                    batches: List[int],
                    dtype_bytes: int = 2) -> List[IntensityPoint]:
    out = []
    for b in batches:
        terms = decode_step_terms(cfg, b, ctx, hw, dtype_bytes=dtype_bytes)
        ai, perf, mrate = {}, {}, {}
        for name, c in terms.classes.items():
            ai[name] = c["flops"] / max(c["bytes"], 1.0)
            t = max(c["compute_s"], c["memory_s"])
            perf[name] = c["flops"] / max(t, 1e-12)
            mrate[name] = c["bytes"] / max(t, 1e-12)
        out.append(IntensityPoint(batch=b, ai=ai, perf=perf, mem_rate=mrate))
    return out


def roofline_position(ai: float, hw: Hardware) -> float:
    """Attainable FLOP/s at a given arithmetic intensity (roofline curve)."""
    return min(hw.peak_flops, ai * hw.hbm_bw)
