"""Batching Configuration Advisor — the paper's Eq. (2) (a copy of
``repro.core.bca``).

    B_opt = argmax_B T(B)
    s.t.  L(B) <= SLO
          T(B) / (B * T(1)) > eps

Works on *measured* curves (from the serving engine benchmark loop) or on
*modeled* curves (core.perfmodel). Also quantifies the memory the choice
frees versus MAX allocation — the input to the replication planner.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.perfmodel import ServingCurves


@dataclasses.dataclass
class BCAResult:
    b_opt: int
    throughput: float
    itl_s: float
    kv_fraction: float                 # KV used at B_opt / full KV capacity
    throughput_at_max: float
    kv_fraction_at_max: float
    slo_s: float
    eps: float
    # per-step chunked-prefill token budget keeping mixed-step ITL under
    # the SLO at B_opt (None when the advisor was not given a per-token
    # prefill cost — serial admission prefill is then assumed)
    chunk_tokens: Optional[int] = None

    @property
    def throughput_retained(self) -> float:
        return self.throughput / max(self.throughput_at_max, 1e-12)

    @property
    def kv_freed_fraction(self) -> float:
        return max(0.0, self.kv_fraction_at_max - self.kv_fraction)

    def summary(self) -> str:
        s = (f"B_opt={self.b_opt}  T={self.throughput:.1f} tok/s "
             f"({self.throughput_retained*100:.1f}% of MAX)  "
             f"ITL={self.itl_s*1e3:.2f} ms  KV={self.kv_fraction*100:.1f}% "
             f"(MAX uses {self.kv_fraction_at_max*100:.1f}%)")
        if self.chunk_tokens is not None:
            s += f"  chunk={self.chunk_tokens} tok/step"
        return s


def chunk_budget_for(curves: ServingCurves, batch: int, slo_s: float,
                     prefill_token_s: float, *, quantum: int = 16,
                     max_tokens: int = 4096) -> int:
    """Largest per-step chunked-prefill token budget (a multiple of
    ``quantum``) that keeps the *mixed* step under the ITL SLO at
    ``batch``:

        L_mixed(B, C) ≈ L_decode(B) + C * t_prefill_token <= SLO

    The knob BCA sweeps alongside ``max_batch``: a bigger budget finishes
    prefills (TTFT) faster, a smaller one keeps decode ITL tighter — the
    SLO headroom above the pure-decode step time is exactly the prefill
    time the scheduler may spend per step. Floors at ``quantum`` (a zero
    budget would starve prefill and stall admission forever).
    """
    if prefill_token_s <= 0:
        raise ValueError(
            f"prefill_token_s must be > 0, got {prefill_token_s}")
    if quantum < 1:
        raise ValueError(f"quantum must be >= 1, got {quantum}")
    idx = int(np.argmin(np.abs(curves.batches - batch)))
    headroom = slo_s - float(curves.itl_s[idx])
    c = int(headroom / prefill_token_s) // quantum * quantum
    return int(np.clip(c, quantum, max_tokens))


def with_prefix_reuse(curves: ServingCurves,
                      hit_rate: float) -> ServingCurves:
    """Rescale measured/modeled curves for a prefix-cache hit rate.

    A hit rate of h (fraction of prompt tokens served from shared cached
    blocks, as measured by ``ServingMetrics.prefix.hit_rate``) means each
    request *stores* only ``(1-h)`` of its KV — shared blocks count once.
    Only the KV-fraction curve changes: decode still streams the full
    context per request per step, so T(B) and ITL(B) are untouched. This
    is the hook that lets BCA size B_opt from effective footprint: the
    same pool now admits ``1/(1-h)`` x the requests, and the memory BCA
    frees (the replication planner's input) grows accordingly.
    """
    if not 0.0 <= hit_rate < 1.0:
        raise ValueError(f"hit_rate must be in [0, 1), got {hit_rate}")
    return dataclasses.replace(
        curves, kv_fraction=curves.kv_fraction * (1.0 - hit_rate))


class BatchingConfigurationAdvisor:
    def __init__(self, curves: ServingCurves, *, slo_s: float,
                 eps: float = 0.1, prefix_hit_rate: float = 0.0,
                 prefill_token_s: Optional[float] = None,
                 chunk_quantum: int = 16):
        if prefix_hit_rate:
            curves = with_prefix_reuse(curves, prefix_hit_rate)
        self.curves = curves
        self.slo_s = slo_s
        self.eps = eps
        self.prefix_hit_rate = prefix_hit_rate
        # per-prompt-token prefill cost (measured or modeled via
        # core.perfmodel.prefill_step_terms): when given, solve() also
        # sizes the chunked-prefill budget at B_opt
        self.prefill_token_s = prefill_token_s
        self.chunk_quantum = chunk_quantum

    def solve(self) -> BCAResult:
        c = self.curves
        t1 = float(c.throughput[np.argmin(c.batches)])
        feasible = np.ones(len(c.batches), bool)
        feasible &= c.itl_s <= self.slo_s
        # marginal scaling efficiency vs ideal linear scaling T(1)*B
        eff = c.throughput / np.maximum(c.batches * t1, 1e-12)
        feasible &= eff > self.eps
        if not feasible.any():
            idx = int(np.argmin(c.itl_s))
        else:
            masked = np.where(feasible, c.throughput, -np.inf)
            idx = int(np.argmax(masked))
        imax = int(np.argmax(c.batches))
        chunk = None
        if self.prefill_token_s is not None:
            chunk = chunk_budget_for(c, int(c.batches[idx]), self.slo_s,
                                     self.prefill_token_s,
                                     quantum=self.chunk_quantum)
        return BCAResult(
            b_opt=int(c.batches[idx]),
            throughput=float(c.throughput[idx]),
            itl_s=float(c.itl_s[idx]),
            kv_fraction=float(c.kv_fraction[idx]),
            throughput_at_max=float(c.throughput[imax]),
            kv_fraction_at_max=float(c.kv_fraction[imax]),
            slo_s=self.slo_s, eps=self.eps, chunk_tokens=chunk)


def slo_from_reference(curves: ServingCurves, ref_batch: int = 32,
                       factor: float = 2.0) -> float:
    """The paper's SLO convention: factor x the ITL observed at batch 32
    (strict=2x, relaxed=4x)."""
    idx = int(np.argmin(np.abs(curves.batches - ref_batch)))
    return float(curves.itl_s[idx]) * factor


def knee_point(curves: ServingCurves, eps: float = 0.1) -> int:
    """Largest batch whose marginal efficiency still exceeds eps."""
    t1 = float(curves.throughput[np.argmin(curves.batches)])
    eff = curves.throughput / np.maximum(curves.batches * t1, 1e-12)
    ok = curves.batches[eff > eps]
    return int(ok.max()) if len(ok) else int(curves.batches.min())


# --------------------------------------------- speculative decoding math --

@dataclasses.dataclass(frozen=True)
class SpecPlan:
    """One batch size's speculative-decoding recommendation.

    ``k == 0`` means "don't speculate at this batch" — the expected
    acceptance doesn't buy back the extra verify compute. ``speedup_x``
    is modeled tokens/s at ``k`` over plain decode at the same batch.
    """
    batch: int
    k: int                       # recommended draft length (0 = off)
    alpha: float                 # assumed per-token acceptance prob
    expected_tokens: float       # E[tokens committed / request / step]
    speedup_x: float             # vs k=0 at the same batch
    break_even_batch: float      # (K+1)*B ceiling of the free-verify zone

    @property
    def enabled(self) -> bool:
        return self.k > 0

    def summary(self) -> str:
        if not self.enabled:
            return (f"B={self.batch}: speculation off "
                    f"(past break-even B*={self.break_even_batch:.0f}, "
                    f"alpha={self.alpha:.2f} doesn't pay)")
        return (f"B={self.batch}: speculate K={self.k} "
                f"(E[tok/step]={self.expected_tokens:.2f}, "
                f"modeled {self.speedup_x:.2f}x, "
                f"B*={self.break_even_batch:.0f}, "
                f"alpha={self.alpha:.2f})")


def speculation_advisor(cfg, hw, *, batch: int, alpha: float = 0.6,
                        max_k: int = 8,
                        dtype_bytes: int = 2) -> SpecPlan:
    """Pick the draft length K for one batch size from break-even math.

    The memory-gap argument (SNIPPETS Snippet 3): a decode step's memory
    latency is the weight stream ``2 * P * n_bytes / bw`` — independent
    of how many tokens it scores — while its compute latency is
    ``tokens * 2 * P / flops``. They cross at ``tokens = n_bytes *
    flops / bw`` (~161 * n_bytes on an A100, ~1200 on the paper's H100
    at bf16): below that product the step is memory-bound and verifying
    K extra tokens per request is *compute the step was wasting anyway*.
    An idealized fused verify of K+1 positions is therefore free while
    ``(K+1) * B`` stays under the break-even product, and commits

        E[tokens/step] = (1 - alpha^(K+1)) / (1 - alpha)

    per request for per-token acceptance probability ``alpha``. The
    advisor maximizes modeled tokens/s = ``B * E / max(t_mem, t_comp)``
    over K in [0, max_k]; at small B every K <= max_k is free and the
    answer rides ``alpha`` alone, past break-even extra K costs linearly
    and the argmax drops to 0.

    Honest model note: this prices an ideal *fused* verify (one weight
    pass scores all K+1 positions). The engine's verify step chains
    K+1 exact serial iterations inside one CUDA graph to preserve
    bit-identity, so on the card its win is smaller than modeled; what
    the one-replay structure always buys is (K+1)-fold amortization of
    per-step host overhead.
    """
    if not 0.0 <= alpha < 1.0:
        raise ValueError(f"alpha must be in [0, 1), got {alpha}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if max_k < 0:
        raise ValueError(f"max_k must be >= 0, got {max_k}")
    p = cfg.active_params()
    t_mem = 2.0 * p * dtype_bytes / hw.hbm_bw

    def expected(k: int) -> float:
        if alpha <= 0.0:
            return 1.0
        return (1.0 - alpha ** (k + 1)) / (1.0 - alpha)

    def speed(k: int) -> float:
        t_comp = (k + 1) * batch * 2.0 * p / hw.peak_flops
        return batch * expected(k) / max(t_mem, t_comp)

    base = speed(0)
    best_k = 0
    best = base
    for k in range(1, max_k + 1):
        s = speed(k)
        if s > best:
            best, best_k = s, k
    return SpecPlan(
        batch=batch, k=best_k, alpha=alpha,
        expected_tokens=expected(best_k),
        speedup_x=best / max(base, 1e-12),
        break_even_batch=dtype_bytes * hw.peak_flops / hw.hbm_bw)


# ------------------------------------------- offline-vs-observed sizing --

@dataclasses.dataclass(frozen=True)
class SizingAudit:
    """Offline ``max_batch_for`` sizing held against observed true use.

    Both sides are expressed in *tokens per request* so the comparison is
    dtype- and layout-free: the offline sizer assumed every request holds
    ``assumed_ctx_tokens`` of KV; the memory-gap auditor measured the peak
    true use at ``observed_tokens_per_req``. ``achievable_batch`` is what
    the same HBM budget supports at the observed footprint — the batch
    headroom worst-case sizing left on the table.
    """
    sized_batch: int                 # max_batch_for's worst-case answer
    assumed_ctx_tokens: int
    observed_tokens_per_req: float   # auditor peak_used_tokens_per_req
    achievable_batch: int
    gap_fraction: float              # 1 - observed/assumed footprint
    headroom_x: float                # achievable / sized

    def summary(self) -> str:
        return (f"sized B={self.sized_batch} @ {self.assumed_ctx_tokens} "
                f"tok/req worst-case; observed peak "
                f"{self.observed_tokens_per_req:.1f} tok/req -> "
                f"achievable B={self.achievable_batch} "
                f"({self.headroom_x:.1f}x headroom, "
                f"gap {self.gap_fraction * 100:.1f}%)")


def audit_sizing(cfg, hw, ctx: int, *, observed_tokens_per_req: float,
                 dtype_bytes: int = 2,
                 prefix_hit_rate: float = 0.0) -> SizingAudit:
    """Cross-check BCA's offline HBM sizing against an observed run.

    :func:`repro_torch.core.perfmodel.max_batch_for` sizes the batch assuming
    every request pins ``ctx`` KV tokens (vLLM-style 90%-of-HBM fill).
    The memory-gap auditor reports what requests *actually* held at the
    pool's true-use peak; at that footprint the same free HBM supports
    ``ctx / observed`` times the batch. A large ``gap_fraction`` is the
    paper's memory gap, localized: capacity reserved for worst-case
    context that the workload never used.
    """
    from repro_torch.core.perfmodel import max_batch_for
    if observed_tokens_per_req <= 0:
        raise ValueError("observed_tokens_per_req must be > 0 "
                         "(did the auditor see any steps?)")
    sized = max_batch_for(cfg, hw, ctx, dtype_bytes=dtype_bytes,
                          prefix_hit_rate=prefix_hit_rate)
    # the sizer's own free-HBM budget, re-divided at the observed
    # per-request footprint (same formula, observed ctx)
    achievable = max_batch_for(
        cfg, hw, max(1, int(round(observed_tokens_per_req))),
        dtype_bytes=dtype_bytes, prefix_hit_rate=prefix_hit_rate)
    return SizingAudit(
        sized_batch=sized,
        assumed_ctx_tokens=int(ctx),
        observed_tokens_per_req=float(observed_tokens_per_req),
        achievable_batch=achievable,
        gap_fraction=max(0.0, 1.0 - observed_tokens_per_req / ctx),
        headroom_x=achievable / max(sized, 1))
