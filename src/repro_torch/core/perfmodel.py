"""Analytical decode/prefill step-time model (a copy of
``repro.core.perfmodel``: the same formulas, so its curves equal the
reference's to the last bit).

This is the algebra behind the paper's central observation: per decode step
each request streams its *own* KV bytes, so attention FLOP/byte is O(1) in
batch while matmul FLOP/byte grows linearly until weight traffic amortizes.
The model produces T(B), ITL(B), and per-kernel-class arithmetic intensity
for any ``ArchConfig`` on any ``Hardware`` — it is used to (a) reproduce
the paper's Figs. 1-3 + Table II on the paper's own models with the H100
constants, and (b) drive BCA when no measured curves are available.

Calibration: a ``HostOverhead`` linear-in-batch host gap reproduces the
paper's "CPU time" column (Table IV); defaults are fit to OPT-1.3B.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.hardware import Hardware


@dataclasses.dataclass(frozen=True)
class HostOverhead:
    """Per-step host (scheduler/launch) gap: t = base_s + per_req_s * B.

    Defaults are calibrated to the paper's OPT-1.3B "CPU time" column
    (Table IV: ~23% of the step at B=96, ~37% at MAX) — vLLM's Python
    scheduler cost grows with the number of in-flight requests.
    """
    base_s: float = 5.0e-4
    per_req_s: float = 1.6e-5

    def gap_s(self, batch: int) -> float:
        return self.base_s + self.per_req_s * batch


@dataclasses.dataclass
class StepTerms:
    """Per-class compute/memory seconds + raw flops/bytes of one step."""
    classes: Dict[str, Dict[str, float]]
    host_s: float = 0.0

    def cls_time(self, name: str) -> float:
        c = self.classes[name]
        return max(c["compute_s"], c["memory_s"])

    @property
    def gpu_s(self) -> float:
        return sum(self.cls_time(k) for k in self.classes)

    @property
    def step_s(self) -> float:
        return self.gpu_s + self.host_s

    @property
    def mem_bytes(self) -> float:
        return sum(c["bytes"] for c in self.classes.values())

    @property
    def flops(self) -> float:
        return sum(c["flops"] for c in self.classes.values())

    def ai(self, name: str) -> float:
        c = self.classes[name]
        return c["flops"] / max(c["bytes"], 1.0)


def decode_step_terms(cfg: ArchConfig, batch: int, ctx: int, hw: Hardware,
                      *, dtype_bytes: int = 2,
                      host: Optional[HostOverhead] = None) -> StepTerms:
    """One decode step: B requests, each with ctx tokens of context."""
    d, hd = cfg.d_model, cfg.hd
    H, K = cfg.n_heads, cfg.n_kv_heads
    plan = cfg.block_plan()
    n_attn = sum(1 for k in plan if k in ("attn", "shared_attn", "cross"))
    n_ssm = sum(1 for k in plan if k == "ssm")

    # ---- attention class: streams the KV cache (the paper's bottleneck) --
    kv_bytes = n_attn * 2 * K * hd * ctx * batch * dtype_bytes
    attn_flops = n_attn * 2 * 2 * H * hd * ctx * batch   # qk^T + pV
    # ---- ssm class: streams recurrent state (batch-linear, ctx-constant) -
    ssm_bytes = ssm_flops = 0.0
    if cfg.ssm is not None and n_ssm:
        d_in = cfg.ssm.expand * d
        nh = d_in // cfg.ssm.head_dim
        state = nh * cfg.ssm.head_dim * cfg.ssm.d_state
        ssm_bytes = n_ssm * batch * state * 2 * 4        # read+write f32
        ssm_flops = n_ssm * batch * state * 6
    # ---- matmul class: weights stream once, activations per request ------
    w_bytes = cfg.active_params() * dtype_bytes
    act_bytes = batch * d * (4 * len(plan)) * dtype_bytes
    mm_flops = 2 * cfg.active_params() * batch
    classes = {
        "attention": {"flops": attn_flops, "bytes": kv_bytes},
        "matmul": {"flops": mm_flops, "bytes": w_bytes + act_bytes},
    }
    if ssm_bytes:
        classes["ssm"] = {"flops": ssm_flops, "bytes": ssm_bytes}
    for c in classes.values():
        c["compute_s"] = c["flops"] / hw.peak_flops
        c["memory_s"] = c["bytes"] / hw.hbm_bw
    host_s = (host or HostOverhead()).gap_s(batch)
    return StepTerms(classes=classes, host_s=host_s)


def prefill_step_terms(cfg: ArchConfig, batch: int, seq: int, hw: Hardware,
                       *, dtype_bytes: int = 2) -> StepTerms:
    plan = cfg.block_plan()
    n_attn = sum(1 for k in plan if k in ("attn", "shared_attn", "cross"))
    H, hd = cfg.n_heads, cfg.hd
    attn_flops = n_attn * 2 * 2 * H * hd * seq * seq / 2 * batch
    attn_bytes = n_attn * batch * seq * (2 * cfg.n_kv_heads + H) * hd * dtype_bytes
    mm_flops = 2 * cfg.active_params() * batch * seq
    w_bytes = cfg.active_params() * dtype_bytes
    act_bytes = batch * seq * cfg.d_model * 4 * len(plan) * dtype_bytes
    classes = {
        "attention": {"flops": attn_flops, "bytes": attn_bytes},
        "matmul": {"flops": mm_flops, "bytes": w_bytes + act_bytes},
    }
    for c in classes.values():
        c["compute_s"] = c["flops"] / hw.peak_flops
        c["memory_s"] = c["bytes"] / hw.hbm_bw
    return StepTerms(classes=classes, host_s=0.0)


@dataclasses.dataclass
class ServingCurves:
    """T(B), L(B), KV usage — the inputs of BCA (Eq. 2)."""
    batches: np.ndarray
    throughput: np.ndarray       # output tokens/s at batch B
    itl_s: np.ndarray            # inter-token latency (= step time)
    kv_fraction: np.ndarray      # fraction of max KV cache used
    e2e_s: Optional[np.ndarray] = None


def decode_curves(cfg: ArchConfig, hw: Hardware, *, ctx: int,
                  max_batch: int, host: Optional[HostOverhead] = None,
                  dtype_bytes: int = 2, kv_capacity_bytes: Optional[float]
                  = None, out_len: int = 338,
                  prefix_hit_rate: float = 0.0) -> ServingCurves:
    """Model-driven throughput/latency curves (the paper's Figs. 2-3).

    ``prefix_hit_rate`` (fraction of prompt tokens served from a shared
    prefix cache, measured by the serving engine) shrinks each request's
    *footprint* in the KV pool — shared blocks are stored once — so the
    KV-fraction curve scales by ``(1 - hit_rate)``. Step-time terms are
    deliberately NOT scaled: per decode step every request still *streams*
    its full context KV (shared blocks are read once per request that
    attends over them), so the DRAM-bandwidth bottleneck is unchanged;
    prefix reuse buys capacity (larger feasible B, more replicas), not
    faster steps.
    """
    if not 0.0 <= prefix_hit_rate < 1.0:
        raise ValueError(
            f"prefix_hit_rate must be in [0, 1), got {prefix_hit_rate}")
    Bs, T, L, KV = [], [], [], []
    kv_per_req = cfg.kv_bytes_per_token(dtype_bytes) * ctx \
        * (1.0 - prefix_hit_rate)
    if kv_capacity_bytes is None:
        kv_capacity_bytes = hw.hbm_bytes * 0.9 - cfg.num_params() * dtype_bytes
    b = 1
    grid = []
    while b < max_batch:
        grid.append(b)
        b = b + max(1, b // 4)
    grid.append(max_batch)
    for b in grid:
        t = decode_step_terms(cfg, b, ctx, hw, dtype_bytes=dtype_bytes,
                              host=host)
        Bs.append(b)
        T.append(b / t.step_s)
        L.append(t.step_s)
        KV.append(b * kv_per_req / kv_capacity_bytes)
    return ServingCurves(np.array(Bs), np.array(T), np.array(L),
                         np.array(KV),
                         e2e_s=np.array(L) * out_len)


def max_batch_for(cfg: ArchConfig, hw: Hardware, ctx: int,
                  dtype_bytes: int = 2,
                  prefix_hit_rate: float = 0.0) -> int:
    """MAX batch: fills 90% of HBM with model + KV (vLLM-style).

    ``prefix_hit_rate`` scales each request's *effective* KV footprint by
    ``(1 - hit_rate)`` — prefix-cached blocks are stored once no matter
    how many requests share them, so the same HBM admits more requests.
    """
    if not 0.0 <= prefix_hit_rate < 1.0:
        raise ValueError(
            f"prefix_hit_rate must be in [0, 1), got {prefix_hit_rate}")
    kv_per_req = cfg.kv_bytes_per_token(dtype_bytes) * ctx \
        * (1.0 - prefix_hit_rate)
    free = hw.hbm_bytes * 0.9 - cfg.num_params() * dtype_bytes
    if cfg.ssm is not None:
        d_in = cfg.ssm.expand * cfg.d_model
        nh = d_in // cfg.ssm.head_dim
        state_bytes = nh * cfg.ssm.head_dim * cfg.ssm.d_state * 4
        n_ssm = sum(1 for k in cfg.block_plan() if k == "ssm")
        kv_per_req += n_ssm * state_bytes
    return max(1, int(free // max(kv_per_req, 1)))
