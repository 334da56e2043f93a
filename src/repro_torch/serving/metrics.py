"""Serving metrics: throughput, ITL, TTFT, E2E, KV usage (paper Tables
I/IV) with tail-latency percentiles, the scheduler stall, preemptions,
shedding and deadline expiries, aborts caught in the queue, prefix-cache
reuse, the speculation counters and the observability riders (memory
gap, SLO events): a copy of ``repro.serving.metrics``, field for field,
so one JSON schema and one Prometheus registry serve both packages."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.kvcache.prefix import PrefixStats
from repro_torch.serving.obs.auditor import MemoryGapStats
from repro_torch.serving.workload import FINISH_REASONS, Request


@dataclasses.dataclass(frozen=True)
class Percentiles:
    """p50/p95/p99 of a latency sample set (seconds)."""
    p50: float = 0.0
    p95: float = 0.0
    p99: float = 0.0

    @classmethod
    def from_samples(cls, samples: Sequence[float]) -> "Percentiles":
        if len(samples) == 0:
            return cls()
        p50, p95, p99 = np.percentile(np.asarray(samples, float),
                                      [50.0, 95.0, 99.0])
        return cls(float(p50), float(p95), float(p99))

    def row(self, scale: float = 1e3, unit: str = "ms") -> str:
        return (f"p50={self.p50 * scale:.2f}{unit} "
                f"p95={self.p95 * scale:.2f}{unit} "
                f"p99={self.p99 * scale:.2f}{unit}")


@dataclasses.dataclass
class ServingMetrics:
    wall_s: float
    total_tokens: int            # input + output (paper's throughput unit)
    output_tokens: int
    itl_s: float                 # mean inter-token latency
    e2e_s: float                 # mean request end-to-end latency
    max_kv_fraction: float
    avg_batch: float
    # tail-latency view (all seconds); defaults keep older call sites valid
    n_completed: int = 0
    ttft_s: float = 0.0          # mean time-to-first-token
    ttft: Percentiles = dataclasses.field(default_factory=Percentiles)
    itl: Percentiles = dataclasses.field(default_factory=Percentiles)
    e2e: Percentiles = dataclasses.field(default_factory=Percentiles)
    # KV pool occupancy over the run (per decode step) + its mean; the
    # peak is max_kv_fraction above
    kv_used_mean: float = 0.0
    kv_used_series: List[float] = dataclasses.field(default_factory=list)
    # prefix-cache reuse counters (None when the cache was off)
    prefix: Optional[PrefixStats] = None
    # scheduler-stall view: per-step seconds spent on admission + prefill
    # before the decode launch (the head-of-line component of ITL — a
    # serial long-prompt prefill shows up here as one huge sample, the
    # chunked scheduler as many bounded ones), plus the per-step
    # prefill/decode token split of the mixed batch
    stall_s_mean: float = 0.0
    stall: Percentiles = dataclasses.field(default_factory=Percentiles)
    stall_series: List[float] = dataclasses.field(default_factory=list)
    prefill_tokens_per_step: float = 0.0     # mean computed prompt tokens
    decode_tokens_per_step: float = 0.0      # mean decoded tokens
    # how the completed requests ended: {"length": n, "stop": n,
    # "abort": n, "deadline": n, "shed": n, "failed": n} (stop-token
    # finishes release blocks the same step and are accounted identically
    # to length finishes; this breakdown is the only place they differ)
    finish_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    # --- robustness series ---
    # recompute re-admissions: total, plus the per-step delta series
    # (recovery redrives and pool thrash both ride this path)
    preemptions: int = 0
    preemption_series: List[int] = dataclasses.field(default_factory=list)
    # requests rejected by admission control, with the per-policy
    # breakdown ({"queue_full": n, "kv_pressure": n, ...})
    shed: int = 0
    shed_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    # requests finished by deadline expiry (any phase)
    deadline_expired: int = 0
    # aborts that caught the request still in the arrival queue
    queued_aborts: int = 0
    # --- speculative decoding (all zero unless EngineConfig.speculate) ---
    # verify steps run, draft tokens proposed / accepted / rejected, and
    # the per-verify-step acceptance-rate series (accepted/drafted)
    spec_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_rejected: int = 0
    spec_acceptance_series: List[float] = \
        dataclasses.field(default_factory=list)
    # --- observability riders (None/0 unless the run opted in) ---
    # memory-gap audit summary (Observability(audit_memory=True))
    memgap: Optional[MemoryGapStats] = None
    # SLO breach/recovery event counts; session-level — a cluster run
    # reports the same monitor's counts on every replica's metrics
    slo_breaches: int = 0
    slo_recoveries: int = 0

    @property
    def throughput(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)

    @property
    def output_throughput(self) -> float:
        return self.output_tokens / max(self.wall_s, 1e-9)

    def row(self) -> str:
        s = (f"T={self.throughput:.1f} tok/s  ITL={self.itl_s*1e3:.2f} ms  "
             f"E2E={self.e2e_s:.2f} s  KV_max={self.max_kv_fraction*100:.1f}%  "
             f"avgB={self.avg_batch:.1f}")
        if self.prefix is not None:
            s += f"  pfx_hit={self.prefix.hit_rate*100:.0f}%"
        return s

    def latency_row(self) -> str:
        return (f"TTFT {self.ttft.row()}  ITL {self.itl.row()}  "
                f"E2E {self.e2e.row(scale=1.0, unit='s')}")

    def stall_row(self) -> str:
        return (f"stall {self.stall.row()}  "
                f"pf/step={self.prefill_tokens_per_step:.1f} tok  "
                f"dec/step={self.decode_tokens_per_step:.1f} tok")

    def finish_row(self) -> str:
        parts = [f"{k}={self.finish_reasons.get(k, 0)}"
                 for k in FINISH_REASONS]
        return "finish: " + " ".join(parts)

    @property
    def spec_acceptance_rate(self) -> float:
        """Accepted fraction of all drafted tokens (0 when never drafted)."""
        return self.spec_accepted / max(self.spec_drafted, 1)

    def robustness_row(self) -> str:
        return (f"preempt={self.preemptions} shed={self.shed} "
                f"deadline={self.deadline_expired} "
                f"q_abort={self.queued_aborts}")

    def spec_row(self) -> str:
        return (f"spec: steps={self.spec_steps} "
                f"drafted={self.spec_drafted} "
                f"accepted={self.spec_accepted} "
                f"({self.spec_acceptance_rate * 100:.0f}%)")


def collect(requests: List[Request], wall_s: float, itl_samples: List[float],
            max_kv_fraction: float, batch_samples: List[int],
            kv_samples: Optional[Sequence[float]] = None,
            prefix: Optional[PrefixStats] = None,
            stall_samples: Optional[Sequence[float]] = None,
            prefill_token_samples: Optional[Sequence[int]] = None,
            decode_token_samples: Optional[Sequence[int]] = None,
            preemptions: int = 0,
            preemption_samples: Optional[Sequence[int]] = None,
            shed: int = 0,
            shed_reasons: Optional[Dict[str, int]] = None,
            deadline_expired: int = 0,
            queued_aborts: int = 0,
            spec_steps: int = 0,
            spec_drafted: int = 0,
            spec_accepted: int = 0,
            spec_rejected: int = 0,
            spec_acceptance_samples: Optional[Sequence[float]] = None,
            memgap: Optional[MemoryGapStats] = None,
            slo_breaches: int = 0,
            slo_recoveries: int = 0) -> ServingMetrics:
    done = [r for r in requests if r.t_done is not None]
    total_in = sum(r.prompt_len for r in done)
    total_out = sum(r.generated for r in done)
    e2e = [r.t_done - r.arrival_s for r in done]
    ttft = [r.t_first_token - r.arrival_s for r in done
            if r.t_first_token is not None]
    finish: Dict[str, int] = {}
    for r in done:
        # legacy fabricated requests may carry t_done with no reason
        reason = getattr(r, "finish_reason", None)
        if reason is not None:
            finish[reason] = finish.get(reason, 0) + 1
    return ServingMetrics(
        wall_s=wall_s,
        total_tokens=total_in + total_out,
        output_tokens=total_out,
        itl_s=float(np.mean(itl_samples)) if itl_samples else 0.0,
        e2e_s=float(np.mean(e2e)) if e2e else 0.0,
        max_kv_fraction=max_kv_fraction,
        avg_batch=float(np.mean(batch_samples)) if batch_samples else 0.0,
        n_completed=len(done),
        ttft_s=float(np.mean(ttft)) if ttft else 0.0,
        ttft=Percentiles.from_samples(ttft),
        itl=Percentiles.from_samples(itl_samples),
        e2e=Percentiles.from_samples(e2e),
        kv_used_mean=float(np.mean(kv_samples)) if kv_samples else 0.0,
        kv_used_series=list(kv_samples) if kv_samples else [],
        prefix=prefix,
        stall_s_mean=(float(np.mean(stall_samples))
                      if stall_samples else 0.0),
        stall=Percentiles.from_samples(stall_samples or []),
        stall_series=list(stall_samples) if stall_samples else [],
        prefill_tokens_per_step=(float(np.mean(prefill_token_samples))
                                 if prefill_token_samples else 0.0),
        decode_tokens_per_step=(float(np.mean(decode_token_samples))
                                if decode_token_samples else 0.0),
        finish_reasons=finish,
        preemptions=preemptions,
        preemption_series=list(preemption_samples or []),
        shed=shed,
        shed_reasons=dict(shed_reasons or {}),
        deadline_expired=deadline_expired,
        queued_aborts=queued_aborts,
        spec_steps=spec_steps,
        spec_drafted=spec_drafted,
        spec_accepted=spec_accepted,
        spec_rejected=spec_rejected,
        spec_acceptance_series=list(spec_acceptance_samples or []),
        memgap=memgap,
        slo_breaches=slo_breaches,
        slo_recoveries=slo_recoveries)


def collect_from_engine(eng, requests: List[Request],
                        wall_s: float) -> ServingMetrics:
    """:func:`collect` with every series pulled off a
    :class:`~repro_torch.serving.engine.ContinuousBatchingEngine`
    (duck-typed to keep this module import-light) — the one place the
    engine's telemetry attribute list is spelled out."""
    memgap = None
    slo_breaches = slo_recoveries = 0
    obs = getattr(eng, "obs", None)
    if obs is not None:
        aud = getattr(obs, "auditor", None)
        if aud is not None and aud.audits:
            memgap = aud.stats()
        mon = getattr(getattr(obs, "parent", None), "slo", None)
        if mon is not None:
            slo_breaches, slo_recoveries = mon.breaches, mon.recoveries
    return collect(list(requests), wall_s, eng.itl_samples,
                   eng.max_kv_fraction, eng.batch_samples,
                   kv_samples=eng.kv_fraction_samples,
                   prefix=eng.prefix.stats if eng.prefix else None,
                   stall_samples=eng.stall_samples,
                   prefill_token_samples=eng.prefill_token_samples,
                   decode_token_samples=eng.decode_token_samples,
                   preemptions=eng.preemptions,
                   preemption_samples=eng.preemption_samples,
                   shed=eng.shed, shed_reasons=eng.shed_reasons,
                   deadline_expired=eng.deadline_expired,
                   queued_aborts=eng.queued_aborts,
                   spec_steps=eng.spec_steps,
                   spec_drafted=eng.spec_drafted,
                   spec_accepted=eng.spec_accepted,
                   spec_rejected=eng.spec_rejected,
                   spec_acceptance_samples=eng.spec_acceptance_samples,
                   memgap=memgap,
                   slo_breaches=slo_breaches,
                   slo_recoveries=slo_recoveries)
