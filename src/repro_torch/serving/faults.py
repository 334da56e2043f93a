"""Deterministic fault injection for the serving stack (a copy of
``repro.serving.faults``: the same specs, parsing and seeded draws).

The paper's replication strategy multiplies failure domains: R replicas
means R chances for a crash, a wedged step, or pool exhaustion to strand
every queued and in-flight request. The recovery machinery in
:mod:`repro_torch.serving.cluster` (quarantine + redrive + respawn) is only
trustworthy if every path through it is *testable*, so faults here are
injected deterministically — a :class:`FaultSpec` pins the fault to an
exact ``(replica, step)`` coordinate, and the seeded
:meth:`FaultInjector.random_kill` constructor derives that coordinate
from a PRNG stream so randomized soak tests replay bit-identically.

Three fault kinds, wired through engine/cluster hooks:

* ``"kill"``  — raise :class:`InjectedFault` at the top of the victim
  replica's ``step()`` (before any state mutation and before anything is
  dispatched to the card), emulating a replica crash. The cluster
  quarantines the replica and redrives its requests.
* ``"delay"`` — sleep ``seconds`` inside the step, emulating a wedged
  host thread (GC pause, driver stall). The cluster watchdog detects the
  missing step progress and routes new arrivals around the replica until
  it steps again.
* ``"alloc-fail"`` — make the engine's admission loop behave as if the
  pool had no free blocks for that step, emulating transient allocation
  failure; queued requests simply wait (or shed / expire their
  deadlines), never crash.

Every spec fires exactly once; ``fired`` records the order for
assertions. Injectors are shared across replicas (the cluster installs
one injector on every engine with the engine's ``replica_id``), so a
single schedule describes the whole cluster's fault plan.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("kill", "delay", "alloc-fail")


class InjectedFault(RuntimeError):
    """Raised inside a replica's step loop by a ``kill`` fault spec."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` at step ``step`` of ``replica``.

    ``step`` counts the victim engine's ``step()`` calls from 1 (the
    engine increments before consulting the injector), so ``step=1``
    fires before any work happens and ``step=50`` fires mid-run.
    """
    kind: str
    replica: int
    step: int
    seconds: float = 0.05       # delay duration (delay kind only)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if self.replica < 0:
            raise ValueError(f"replica must be >= 0, got {self.replica}")
        if self.step < 1:
            raise ValueError(f"step must be >= 1 (steps count from 1), "
                             f"got {self.step}")
        if self.seconds < 0:
            raise ValueError(f"seconds must be >= 0, got {self.seconds}")


def parse_fault(text: str) -> FaultSpec:
    """Parse the CLI shape ``replica=1,step=50[,kind=kill][,seconds=.1]``.

    ``kind`` defaults to ``kill`` (the headline recovery scenario).
    """
    fields = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad fault spec field {part!r} in {text!r}; expected "
                f"key=value pairs like 'replica=1,step=50'")
        k, v = (s.strip() for s in part.split("=", 1))
        fields[k] = v
    unknown = set(fields) - {"replica", "step", "kind", "seconds"}
    if unknown:
        raise ValueError(f"unknown fault spec fields {sorted(unknown)} in "
                         f"{text!r}")
    if "replica" not in fields or "step" not in fields:
        raise ValueError(f"fault spec {text!r} needs at least "
                         f"replica= and step=")
    return FaultSpec(kind=fields.get("kind", "kill"),
                     replica=int(fields["replica"]),
                     step=int(fields["step"]),
                     seconds=float(fields.get("seconds", 0.05)))


class FaultInjector:
    """A deterministic schedule of :class:`FaultSpec` plus firing state.

    One injector serves a whole cluster: the cluster assigns every engine
    its ``replica_id`` and installs the injector; each engine consults
    :meth:`on_step` at the top of ``step()`` and
    :meth:`steals_allocation` at the top of its admission loop. The
    injector is host-side bookkeeping only — it never touches device
    state, so a fault-free schedule (no matching specs) has zero effect
    on scheduling or outputs.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), *, seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        # (spec, wall time.monotonic()) in firing order
        self.fired: List[Tuple[FaultSpec, float]] = []
        self._pending: List[FaultSpec] = list(self.specs)

    # ------------------------------------------------------ constructors --
    @classmethod
    def parse(cls, *texts: str, seed: int = 0) -> "FaultInjector":
        """Build from CLI spec strings (``--inject-fault`` values)."""
        return cls([parse_fault(t) for t in texts], seed=seed)

    @classmethod
    def random_kill(cls, n_replicas: int, max_step: int, *,
                    seed: int = 0) -> "FaultInjector":
        """One kill at a seeded-random (replica, step) coordinate — the
        soak-test shape: which replica dies and when varies with the
        seed, but a fixed seed replays the exact same schedule."""
        if n_replicas < 1 or max_step < 1:
            raise ValueError(f"need >= 1 replica and >= 1 step, got "
                             f"{n_replicas}/{max_step}")
        rng = np.random.default_rng(seed)
        spec = FaultSpec(kind="kill",
                         replica=int(rng.integers(0, n_replicas)),
                         step=int(rng.integers(1, max_step + 1)))
        return cls([spec], seed=seed)

    # ------------------------------------------------------------- state --
    @property
    def pending(self) -> Tuple[FaultSpec, ...]:
        """Specs that have not fired yet."""
        return tuple(self._pending)

    def reset(self):
        """Re-arm every spec (e.g. to replay a schedule after a warmup)."""
        self.fired = []
        self._pending = list(self.specs)

    def _take(self, kind: str, replica: int, step: int
              ) -> Optional[FaultSpec]:
        """Pop-and-record the first pending spec matching the coordinate.

        ``step`` matches at-or-after the scheduled step, not exactly:
        a quarantined-then-respawned replica restarts its step counter,
        and an idle replica may never reach the exact step — firing on
        the first step >= the scheduled one keeps schedules robust
        without losing determinism (the firing step is recorded)."""
        for spec in self._pending:
            if spec.kind == kind and spec.replica == replica \
                    and step >= spec.step:
                self._pending.remove(spec)
                self.fired.append((spec, time.monotonic()))
                return spec
        return None

    # ------------------------------------------------------ engine hooks --
    def on_step(self, replica: int, step: int):
        """Engine hook at the top of ``step()`` — may sleep (delay) or
        raise :class:`InjectedFault` (kill). Called before any state
        mutation, so a killed engine's host bookkeeping is consistent
        (the cluster discards it wholesale anyway: its KV is lost)."""
        delay = self._take("delay", replica, step)
        if delay is not None and delay.seconds > 0:
            time.sleep(delay.seconds)
        kill = self._take("kill", replica, step)
        if kill is not None:
            raise InjectedFault(
                f"injected kill: replica {replica} at step {step} "
                f"(scheduled for step {kill.step})")

    def steals_allocation(self, replica: int, step: int) -> bool:
        """Engine hook at the top of the admission loop: True = pretend
        the pool has no free blocks this step (admission skipped)."""
        return self._take("alloc-fail", replica, step) is not None
