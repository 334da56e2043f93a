"""Serving metrics: throughput, TTFT/ITL/E2E percentiles, KV usage,
preemptions, finish reasons, aborts caught in the queue, prefix-cache
reuse, the per-step scheduler stall and the speculation counters (the
subset of ``repro.serving.metrics`` that the port's engine fills)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.kvcache.prefix import PrefixStats
from repro_torch.serving.workload import Request


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
    n_completed: int = 0
    ttft_s: float = 0.0          # mean time-to-first-token
    ttft: Percentiles = dataclasses.field(default_factory=Percentiles)
    itl: Percentiles = dataclasses.field(default_factory=Percentiles)
    e2e: Percentiles = dataclasses.field(default_factory=Percentiles)
    kv_used_mean: float = 0.0
    preemptions: int = 0
    finish_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    # prefix-cache reuse counters (None when the cache was off)
    prefix: Optional[PrefixStats] = None
    # per-step seconds of admission and prefill before the decode launch
    # (a serial long prefill is one large sample, chunked prefill many
    # bounded ones), and the mean prompt / decode tokens a step
    stall_s_mean: float = 0.0
    stall: Percentiles = dataclasses.field(default_factory=Percentiles)
    prefill_tokens_per_step: float = 0.0
    decode_tokens_per_step: float = 0.0
    # aborts that caught the request still in the arrival queue
    queued_aborts: int = 0
    # speculative decoding (all zero unless EngineConfig.speculate): verify
    # steps run, draft tokens proposed / accepted / rejected, and each
    # verify step's acceptance rate (accepted / drafted)
    spec_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_rejected: int = 0
    spec_acceptance_series: List[float] = \
        dataclasses.field(default_factory=list)

    @property
    def throughput(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)

    @property
    def output_throughput(self) -> float:
        return self.output_tokens / max(self.wall_s, 1e-9)

    @property
    def spec_acceptance_rate(self) -> float:
        """Accepted fraction of all drafted tokens (0 when never drafted)."""
        return self.spec_accepted / max(self.spec_drafted, 1)

    def spec_row(self) -> str:
        return (f"spec: steps={self.spec_steps} "
                f"drafted={self.spec_drafted} "
                f"accepted={self.spec_accepted} "
                f"({self.spec_acceptance_rate * 100:.0f}%)")


def _mean(xs: Sequence[float]) -> float:
    return float(np.mean(xs)) if len(xs) else 0.0


def collect(requests: List[Request], wall_s: float,
            itl_samples: Sequence[float], max_kv_fraction: float,
            batch_samples: Sequence[int],
            kv_samples: Sequence[float] = (),
            preemptions: int = 0,
            prefix: Optional[PrefixStats] = None,
            stall_samples: Sequence[float] = (),
            prefill_token_samples: Sequence[int] = (),
            decode_token_samples: Sequence[int] = (),
            queued_aborts: int = 0,
            spec_steps: int = 0,
            spec_drafted: int = 0,
            spec_accepted: int = 0,
            spec_rejected: int = 0,
            spec_acceptance_samples: Sequence[float] = ()
            ) -> ServingMetrics:
    done = [r for r in requests if r.t_done is not None]
    e2e = [r.t_done - r.arrival_s for r in done]
    ttft = [r.t_first_token - r.arrival_s for r in done
            if r.t_first_token is not None]
    finish: Dict[str, int] = {}
    for r in done:
        if r.finish_reason is not None:
            finish[r.finish_reason] = finish.get(r.finish_reason, 0) + 1
    total_out = sum(r.generated for r in done)
    return ServingMetrics(
        wall_s=wall_s,
        total_tokens=sum(r.prompt_len for r in done) + total_out,
        output_tokens=total_out,
        itl_s=float(np.mean(itl_samples)) if len(itl_samples) else 0.0,
        e2e_s=float(np.mean(e2e)) if e2e else 0.0,
        max_kv_fraction=max_kv_fraction,
        avg_batch=float(np.mean(batch_samples)) if len(batch_samples) else 0.0,
        n_completed=len(done),
        ttft_s=float(np.mean(ttft)) if ttft else 0.0,
        ttft=Percentiles.from_samples(ttft),
        itl=Percentiles.from_samples(itl_samples),
        e2e=Percentiles.from_samples(e2e),
        kv_used_mean=float(np.mean(kv_samples)) if len(kv_samples) else 0.0,
        preemptions=preemptions,
        finish_reasons=finish,
        prefix=prefix,
        stall_s_mean=_mean(stall_samples),
        stall=Percentiles.from_samples(stall_samples),
        prefill_tokens_per_step=_mean(prefill_token_samples),
        decode_tokens_per_step=_mean(decode_token_samples),
        queued_aborts=queued_aborts,
        spec_steps=spec_steps,
        spec_drafted=spec_drafted,
        spec_accepted=spec_accepted,
        spec_rejected=spec_rejected,
        spec_acceptance_series=list(spec_acceptance_samples))
