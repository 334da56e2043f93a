"""Request/response data model + the ShareGPT-statistics workload
generator (the port's own copy of ``repro.serving.workload``).

:class:`Request` is the frozen input (prompt token ids, arrival time and
a :class:`SamplingParams`); :class:`RequestState` is the engine-owned
output. :func:`sharegpt_like` makes the same numpy draws as the
reference for the same arguments, so both packages serve identical
requests: the paper samples ShareGPT requests with mean 161 input / 338
output tokens, and lengths here are lognormal around those means.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

SHAREGPT_MEAN_IN = 161
SHAREGPT_MEAN_OUT = 338

ARRIVAL_PATTERNS = ("poisson", "burst", "ramp")

# the complete finish_reason vocabulary (GenerationOutput contract)
FINISH_LENGTH = "length"     # hit max_new_tokens / model-length budget
FINISH_STOP = "stop"         # sampled a stop/EOS token
FINISH_ABORT = "abort"       # cancelled via the API (blocks reclaimed)
FINISH_DEADLINE = "deadline"  # missed its deadline_s/ttft_deadline_s SLO
FINISH_SHED = "shed"         # rejected by admission control (backpressure)
FINISH_FAILED = "failed"     # lost to a replica failure (redrives exhausted)
FINISH_REASONS = (FINISH_LENGTH, FINISH_STOP, FINISH_ABORT,
                  FINISH_DEADLINE, FINISH_SHED, FINISH_FAILED)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode contract (frozen; travels with the Request).

    ``temperature == 0`` (the default) is greedy argmax — bit-identical
    to the pre-sampler engine. With ``temperature > 0`` the engine
    samples from the (optionally top-k / top-p truncated) softmax using
    counter-based per-request RNG: the key for the token at sequence
    position ``p`` is ``fold_in(PRNGKey(seed), p)``, so a fixed
    ``seed`` reproduces the same tokens bit-for-bit regardless of batch
    composition, bucketing, preemption, chunked-vs-serial prefill, or
    which replica served the request.

    ``stop_token_ids`` double as the EOS set (there is no tokenizer in
    this repo): sampling one of them finishes the request the same step
    with ``finish_reason="stop"`` — unless ``ignore_eos`` is set, which
    decodes through stop tokens to the length budget (benchmark mode).

    The deadline fields are QoS riders (they never touch token
    selection): ``deadline_s`` bounds the whole request — the engine
    finishes it with ``finish_reason="deadline"`` (partial output kept,
    KV released the same step) once the serving clock passes
    ``arrival_s + deadline_s``, whether it is still queued, mid-prefill,
    or mid-decode. ``ttft_deadline_s`` bounds only the time to the first
    token: a request that has not completed prefill by
    ``arrival_s + ttft_deadline_s`` expires the same way (it is moot
    once the first token exists). Both default to None (no deadline).
    """
    temperature: float = 0.0
    top_k: int = 0               # 0 = disabled (full vocabulary)
    top_p: float = 1.0           # 1.0 = disabled (no nucleus truncation)
    seed: int = 0                # per-request RNG stream id
    max_new_tokens: int = 16
    stop_token_ids: Tuple[int, ...] = ()
    ignore_eos: bool = False
    deadline_s: Optional[float] = None       # E2E SLO, relative to arrival
    ttft_deadline_s: Optional[float] = None  # first-token SLO

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), "
                f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = disabled), "
                             f"got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")
        for name in ("deadline_s", "ttft_deadline_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0 (or None for no "
                                 f"deadline), got {v}")
        # normalize the seed into the PRNG key domain: any Python int is
        # accepted (CLI flags pass negatives freely) and wraps mod 2**32
        # deterministically — NumPy 2 would otherwise raise OverflowError
        # mid-decode-step when the sampler stacks it into a uint32 vector
        object.__setattr__(self, "seed", int(self.seed) % (1 << 32))
        # normalize to a hashable tuple of ints (callers pass lists/arrays)
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def has_deadline(self) -> bool:
        return self.deadline_s is not None or self.ttft_deadline_s is not None

    def expired(self, arrival_s: float, now: float, *,
                first_token: bool) -> bool:
        """Is the request past its SLO at serving time ``now``?

        ``first_token`` = has prefill already produced the first output
        token (which retires the TTFT deadline; the E2E one keeps
        running). Deadlines are half-open: ``now`` strictly past the
        bound expires, landing exactly on it does not.
        """
        if self.deadline_s is not None \
                and now > arrival_s + self.deadline_s:
            return True
        return (not first_token
                and self.ttft_deadline_s is not None
                and now > arrival_s + self.ttft_deadline_s)

    def stops_on(self, token: int) -> bool:
        """Does sampling ``token`` finish the request with reason "stop"?"""
        return (not self.ignore_eos) and token in self.stop_token_ids


@dataclasses.dataclass
class RequestState:
    """The engine-owned mutable half of a request.

    Only the engine (and the API facade's abort path) writes these;
    everything else observes them through the ``Request`` proxies or as
    :class:`~repro.serving.api.GenerationOutput` stream events.
    """
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    generated: int = 0
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None

    def reset_for_requeue(self):
        """Preemption (recompute-style): forget the in-flight output so
        re-admission regenerates it from scratch. The terminal fields
        (``t_done``/``finish_reason``) are by construction still unset —
        finished requests are never preempted."""
        self.t_first_token = None
        self.generated = 0
        self.output_tokens = []


class Request:
    """Frozen input half of a request + its attached engine state.

    Input fields (``req_id``, ``prompt``, ``sampling``, ``arrival_s``)
    cannot be reassigned after construction. The legacy engine-mutated
    attributes (``t_first_token``, ``t_done``, ``generated``,
    ``output_tokens``, plus the new ``finish_reason``) are read/write
    proxies into ``self.state`` so existing call sites — and tests that
    fabricate completed requests — keep working unchanged.

    ``max_new_tokens`` may still be passed directly (legacy call shape);
    it is folded into a default ``SamplingParams``. Passing both it and
    ``sampling`` is an error unless they agree.
    """

    _INPUT_FIELDS = ("req_id", "prompt", "sampling", "arrival_s")

    def __init__(self, req_id: int, prompt: np.ndarray,
                 max_new_tokens: Optional[int] = None,
                 arrival_s: float = 0.0, *,
                 sampling: Optional[SamplingParams] = None):
        if sampling is None:
            if max_new_tokens is None:
                raise TypeError(
                    "Request needs either sampling=SamplingParams(...) or "
                    "the legacy max_new_tokens=")
            sampling = SamplingParams(max_new_tokens=max_new_tokens)
        elif max_new_tokens is not None \
                and max_new_tokens != sampling.max_new_tokens:
            raise ValueError(
                f"conflicting output budgets: max_new_tokens="
                f"{max_new_tokens} vs sampling.max_new_tokens="
                f"{sampling.max_new_tokens}; set it on SamplingParams only")
        object.__setattr__(self, "req_id", int(req_id))
        object.__setattr__(self, "prompt", prompt)
        object.__setattr__(self, "sampling", sampling)
        object.__setattr__(self, "arrival_s", float(arrival_s))
        object.__setattr__(self, "state", RequestState())

    def __setattr__(self, name, value):
        if name in self._INPUT_FIELDS:
            raise AttributeError(
                f"Request.{name} is frozen input; engine-mutated fields "
                f"live on Request.state")
        object.__setattr__(self, name, value)

    def __repr__(self):
        return (f"Request(req_id={self.req_id}, "
                f"prompt_len={self.prompt_len}, "
                f"sampling={self.sampling}, arrival_s={self.arrival_s}, "
                f"generated={self.state.generated}, "
                f"finish_reason={self.state.finish_reason!r})")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def max_new_tokens(self) -> int:
        return self.sampling.max_new_tokens

    # --- legacy mutable-field proxies (engine-owned state) ---
    @property
    def t_first_token(self) -> Optional[float]:
        return self.state.t_first_token

    @t_first_token.setter
    def t_first_token(self, v):
        self.state.t_first_token = v

    @property
    def t_done(self) -> Optional[float]:
        return self.state.t_done

    @t_done.setter
    def t_done(self, v):
        self.state.t_done = v

    @property
    def generated(self) -> int:
        return self.state.generated

    @generated.setter
    def generated(self, v):
        self.state.generated = v

    @property
    def output_tokens(self) -> List[int]:
        return self.state.output_tokens

    @output_tokens.setter
    def output_tokens(self, v):
        self.state.output_tokens = v

    @property
    def finish_reason(self) -> Optional[str]:
        return self.state.finish_reason

    @finish_reason.setter
    def finish_reason(self, v):
        self.state.finish_reason = v


def _request_sampling(template: Optional[SamplingParams], i: int,
                      max_new_tokens: int) -> SamplingParams:
    """Per-request SamplingParams from a workload-level template: request
    ``i`` gets RNG stream ``template.seed + i`` (distinct streams so
    sampled requests aren't token-for-token clones of each other) and its
    own output budget."""
    if template is None:
        return SamplingParams(max_new_tokens=max_new_tokens)
    return dataclasses.replace(template, seed=template.seed + i,
                               max_new_tokens=max_new_tokens)


def arrival_times(n: int, rate: float, *, pattern: str = "poisson",
                  rng: Optional[np.random.Generator] = None, seed: int = 0,
                  burst_size: int = 8) -> np.ndarray:
    """Arrival timestamps (seconds, nondecreasing) for ``n`` requests at a
    long-run average of ``rate`` requests/s under the given pattern."""
    if pattern not in ARRIVAL_PATTERNS:
        raise ValueError(f"arrival pattern must be one of "
                         f"{ARRIVAL_PATTERNS}, got {pattern!r}")
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    rng = rng if rng is not None else np.random.default_rng(seed)
    if pattern == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, size=n))
    if pattern == "burst":
        if burst_size < 1:
            raise ValueError(f"burst_size must be >= 1, got {burst_size}")
        n_bursts = -(-n // burst_size)
        # exponential gaps between bursts at rate/burst_size keeps the
        # long-run request rate equal to `rate`
        starts = np.cumsum(rng.exponential(burst_size / rate, size=n_bursts))
        return np.repeat(starts, burst_size)[:n]
    # ramp: instantaneous rate grows linearly 3x start-to-end; the gap
    # scale is normalized by the harmonic mean so the expected long-run
    # rate is exactly `rate` (a plain 0.5x..1.5x ramp would land ~9% low)
    ramp = np.linspace(0.5, 1.5, n)
    scale = (1.0 / rate) / float(np.mean(1.0 / ramp))
    return np.cumsum(rng.exponential(scale, size=n) / ramp)


def sharegpt_like(n: int, vocab: int, *, seed: int = 0,
                  mean_in: int = SHAREGPT_MEAN_IN,
                  mean_out: int = SHAREGPT_MEAN_OUT,
                  fixed: bool = False, sigma: float = 0.7,
                  arrival_rate: Optional[float] = None,
                  arrival_pattern: str = "poisson", burst_size: int = 8,
                  max_len: int = 2048,
                  sampling: Optional[SamplingParams] = None
                  ) -> List[Request]:
    """``fixed=True`` = the paper's offline mode (exact 161/338 lengths)."""
    if arrival_pattern not in ARRIVAL_PATTERNS:
        raise ValueError(f"arrival pattern must be one of "
                         f"{ARRIVAL_PATTERNS}, got {arrival_pattern!r}")
    if arrival_pattern != "poisson" and not arrival_rate:
        raise ValueError(f"arrival_pattern={arrival_pattern!r} requires "
                         f"arrival_rate (otherwise it is silently a t=0 "
                         f"batch workload)")
    rng = np.random.default_rng(seed)
    arrivals = None
    if arrival_rate and arrival_pattern != "poisson":
        # non-default patterns draw from their own stream so the length
        # draws below stay bitwise-identical for a given seed
        arrivals = arrival_times(n, arrival_rate, pattern=arrival_pattern,
                                 rng=np.random.default_rng((seed, 1)),
                                 burst_size=burst_size)
    reqs = []
    t = 0.0
    for i in range(n):
        if fixed:
            # clamp to the same bound as the lognormal draws below — an
            # unclamped fixed length silently overran engine model-length
            # limits the stochastic path already respects
            lin = int(np.clip(mean_in, 1, max_len // 2))
            lout = int(np.clip(mean_out, 1, max_len // 2))
        else:
            lin = int(np.clip(rng.lognormal(np.log(mean_in), sigma), 1,
                              max_len // 2))
            lout = int(np.clip(rng.lognormal(np.log(mean_out), sigma), 1,
                               max_len // 2))
        if arrivals is not None:
            t = float(arrivals[i])
        elif arrival_rate:
            t += rng.exponential(1.0 / arrival_rate)
        prompt = rng.integers(0, vocab, size=lin).astype(np.int32)
        reqs.append(Request(req_id=i, prompt=prompt, arrival_s=t,
                            sampling=_request_sampling(sampling, i, lout)))
    return reqs
