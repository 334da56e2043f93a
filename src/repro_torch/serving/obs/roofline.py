"""Per-step roofline attribution on the card (counterpart of
``repro.serving.obs.roofline``).

* **Per bucket** (:class:`StepCensusCache`): the first time a step
  variant runs in a shape bucket (decode, verify, gather, serial prefill,
  prefix prefill, chunk), its cost census is computed from the model
  config and the bucket (:func:`repro_torch.core.census.step_census`;
  the reference compiles the step ahead of time and reads its XLA
  program, which a CUDA graph does not have). The cache is keyed by
  ``(variant, bucket)``, so a steady step pays one dict lookup. The
  bucket's eager first use (the warm-up before its capture; without
  graphs, its first step) then runs under a dispatch census
  (:mod:`repro_torch.core.analysis`), kept as the census's
  ``dispatched``: FLOPs, bytes and launches by class of the operations
  the graph replays. Samples keep reading the analytic census.
* **Per step** (:class:`LiveRoofline`): every executed step is tagged
  with its bucket's census, its live attention work (the engine's
  :class:`~repro_torch.core.census.LiveWork`: the same bucket at a
  longer context reads more K/V) and its device time, measured with CUDA
  events around its replay. This yields a live series of achieved
  bandwidth and compute shares of the card's peaks, arithmetic intensity
  and a memory- or compute-bound verdict. :meth:`LiveRoofline.report`
  folds a variant's newest census back through
  :func:`repro_torch.core.roofline.roofline_report`, the offline formula.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.analysis import Dispatched
from repro_torch.core.census import (ClassCost, LiveWork, OpCensus,
                                     attention_cost, step_census,
                                     with_attention)
from repro_torch.core.hardware import Hardware
from repro_torch.core.roofline import RooflineReport, roofline_report
from repro_torch.serving.obs.series import (DEFAULT_SERIES_MAXLEN,
                                            BoundedSeries)


@dataclasses.dataclass
class StepCensus:
    """One step variant's census in one bucket: the part the bucket
    fixes (weights, padded-row FLOPs, activations, the bucket's dense
    copies). A sample adds its live attention terms (:meth:`live`).
    ``dispatched`` is the dispatch census of the bucket's eager body,
    once a step has run it (None before)."""
    variant: str                 # "decode" / "chunk_prefill" / ...
    key: Tuple                   # the shape bucket
    census: OpCensus             # per-kernel-class FLOPs / bytes
    cfg: object = dataclasses.field(compare=False, repr=False, default=None)
    block_size: int = 0
    dispatched: Optional[Dispatched] = dataclasses.field(
        compare=False, default=None)

    @property
    def flops(self) -> float:
        return self.census.flops

    @property
    def bytes(self) -> float:
        return self.census.bytes

    @property
    def ai(self) -> float:
        """Arithmetic intensity of the bucket's fixed part (FLOP / byte)."""
        return self.census.flops / max(self.census.bytes, 1.0)

    def live(self, work: Optional[LiveWork]) -> ClassCost:
        """One step's live attention terms (none without ``work``)."""
        if work is None:
            return ClassCost()
        return attention_cost(self.cfg, self.variant, self.key, work,
                              self.block_size)


class StepCensusCache:
    """Lazy per-``(variant, bucket)`` census for one model config and
    block size (the first engine attached fixes them; another raises).

    ``compiles`` counts the censuses computed. A census that fails is
    cached as ``None`` and kept in ``errors`` (the sample is then
    timing-only), as the reference does, so telemetry never breaks
    serving; with ``strict`` it raises instead (the tests' setting)."""

    def __init__(self, *, strict: bool = False):
        self._cache: Dict[Tuple, Optional[StepCensus]] = {}
        self.errors: Dict[Tuple, str] = {}
        self.compiles = 0           # censuses computed
        self.strict = strict
        self._model: Optional[Tuple] = None

    def get(self, variant: str, bucket: Tuple, *, cfg,
            block_size: int) -> Optional[StepCensus]:
        key = (variant, tuple(bucket))
        hit = self._cache.get(key, _MISS)
        if hit is not _MISS:
            if hit is not None and (hit.cfg is not cfg
                                    or hit.block_size != block_size):
                self._bind(cfg, block_size)      # raises on a mismatch
            return hit
        sc: Optional[StepCensus] = None
        try:
            self._bind(cfg, block_size)
            sc = StepCensus(variant=variant, key=key[1],
                            census=step_census(cfg, variant, key[1],
                                               block_size),
                            cfg=cfg, block_size=block_size)
            self.compiles += 1
        except Exception as e:          # never break serving for telemetry
            if self.strict:
                raise
            self.errors[key] = f"{type(e).__name__}: {e}"
        self._cache[key] = sc
        return sc

    def _bind(self, cfg, block_size: int):
        model = (cfg, block_size)
        if self._model is None:
            self._model = model
        elif self._model[0] != cfg or self._model[1] != block_size:
            raise ValueError(
                "one StepCensusCache serves one model config and block "
                f"size; got {cfg.name}/{block_size} after "
                f"{self._model[0].name}/{self._model[1]}")


_MISS = object()


@dataclasses.dataclass(frozen=True)
class RooflineSample:
    """One executed step, attributed: what it moved, what it achieved."""
    step: int
    variant: str
    batch: int                   # decoded requests (or prefill tokens)
    device_s: float
    flops: float
    bytes: float

    def bw_util(self, hw: Hardware) -> float:
        """Achieved HBM bandwidth / peak (the paper's DRAM saturation)."""
        if self.device_s <= 0:
            return 0.0
        return (self.bytes / self.device_s) / hw.hbm_bw

    def compute_util(self, hw: Hardware) -> float:
        """Achieved FLOP/s over peak — MFU of this step's census FLOPs."""
        if self.device_s <= 0:
            return 0.0
        return (self.flops / self.device_s) / hw.peak_flops

    @property
    def ai(self) -> float:
        return self.flops / max(self.bytes, 1.0)

    def bound(self, hw: Hardware) -> str:
        """Roofline verdict: which term bounds this step's census."""
        return ("memory" if self.bytes / hw.hbm_bw
                >= self.flops / hw.peak_flops else "compute")


class LiveRoofline:
    """Per-step attribution series + aggregate view for one engine."""

    def __init__(self, hw: Hardware,
                 maxlen: int = DEFAULT_SERIES_MAXLEN):
        self.hw = hw
        self.samples: BoundedSeries = BoundedSeries(maxlen)
        # census of the most recent step per variant, its live terms
        # included (offline cross-check anchor) + verdict tally over ALL
        # steps (not just retained ones)
        self.latest: Dict[str, StepCensus] = {}
        self.bound_counts: Dict[str, int] = {}

    def record(self, step: int, sc: Optional[StepCensus], device_s: float,
               batch: int, variant: str, live: Optional[LiveWork] = None):
        if sc is None:                   # census unavailable: timing-only
            self.samples.append(RooflineSample(
                step=step, variant=variant, batch=batch,
                device_s=device_s, flops=0.0, bytes=0.0))
            return
        attn = sc.live(live)
        sample = RooflineSample(step=step, variant=sc.variant, batch=batch,
                                device_s=device_s,
                                flops=sc.flops + attn.flops,
                                bytes=sc.bytes + attn.bytes)
        self.latest[sc.variant] = dataclasses.replace(
            sc, census=with_attention(sc.census, attn))
        verdict = sample.bound(self.hw)
        self.bound_counts[verdict] = self.bound_counts.get(verdict, 0) + 1
        self.samples.append(sample)

    # -------------------------------------------------------- aggregate --
    def variant_samples(self, variant: str) -> List[RooflineSample]:
        return [s for s in self.samples if s.variant == variant]

    def summary(self, variant: Optional[str] = None) -> dict:
        """Mean achieved bandwidth / MFU / AI and the verdict histogram —
        the live analogue of one roofline table row."""
        samples = (self.variant_samples(variant) if variant
                   else list(self.samples))
        attributed = [s for s in samples if s.bytes > 0]
        n = len(attributed)
        mean = lambda f: sum(f(s) for s in attributed) / n if n else 0.0  # noqa: E731
        return {
            "hardware": self.hw.name,
            "steps": len(samples),
            "attributed_steps": n,
            "bw_util_mean": mean(lambda s: s.bw_util(self.hw)),
            "mfu_mean": mean(lambda s: s.compute_util(self.hw)),
            "ai_mean": mean(lambda s: s.ai),
            "device_s_mean": (sum(s.device_s for s in samples) / len(samples)
                              if samples else 0.0),
            "bound_counts": dict(self.bound_counts),
            "bound": (max(self.bound_counts, key=self.bound_counts.get)
                      if self.bound_counts else "unknown"),
        }

    def report(self, variant: str = "decode", *,
               arch: str = "", mesh: str = "live") -> Optional[RooflineReport]:
        """The newest census of ``variant`` (its live terms included)
        folded through the offline roofline formula
        (:func:`repro_torch.core.roofline.roofline_report`), its bucket's
        dispatched census beside it (``dispatched``)."""
        sc = self.latest.get(variant)
        if sc is None:
            return None
        rep = roofline_report(sc.census, self.hw, arch=arch,
                              shape=variant, mesh=mesh)
        rep.dispatched = sc.dispatched
        return rep
