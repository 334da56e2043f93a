"""Kernel launch counting that stays exact when several threads launch.

Each kernel wrapper keeps a ``launches`` count of the launches it made
where its kernel runs. Co-located replicas step on their own host
threads, so one thread may capture a CUDA graph (whose launches are not
launches: they are added at each replay) while another launches or
replays. :func:`count_launch` therefore counts a launch made inside
:func:`tally_launches` on that thread's tally, not on the shared count,
and every change to a shared count holds one lock (``+=`` on an attribute
is not atomic across threads).

:func:`counted_kernel` makes a wrapper report each call to the dispatch
census active on its thread (:mod:`repro_torch.core.analysis`) as one
launch of its kernel, whatever the device: the card's launch, the plain
version on a CPU tensor, or a meta tensor's output with no work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Callable, Dict, Iterator, Mapping

_lock = threading.Lock()
_local = threading.local()


def count_launch(fn: Callable) -> None:
    """One launch of ``fn``'s kernel: on this thread's tally while it is
    inside :func:`tally_launches`, else on ``fn.launches``."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[fn] = tally.get(fn, 0) + 1
        return
    with _lock:
        fn.launches += 1


def add_counts(counts: Mapping[Callable, int]) -> None:
    """Add ``counts[fn]`` launches to each ``fn.launches`` (a replay)."""
    with _lock:
        for fn, n in counts.items():
            fn.launches += n


@contextlib.contextmanager
def tally_launches() -> Iterator[Dict[Callable, int]]:
    """Count this thread's launches on a fresh tally (yielded, by
    wrapper) instead of the shared counts, as a graph capture must: the
    other threads' launches meanwhile still count."""
    if getattr(_local, "tally", None) is not None:
        raise RuntimeError("launches are already being tallied on this "
                           "thread")
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        _local.tally = None


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """What one launch of a hand-written kernel moves and computes at its
    static shapes, and the scratch it allocates while it runs."""
    flops: float
    bytes: float
    scratch: float = 0.0


def active_census():
    """The dispatch census active on this thread, if any."""
    return getattr(_local, "census", None)


def set_census(census):
    """Make ``census`` (or None) this thread's active census; returns the
    one it replaces."""
    outer = getattr(_local, "census", None)
    _local.census = census
    return outer


def counted_kernel(name: str, cost: Callable[..., KernelCost]):
    """Decorate a hand-written kernel's wrapper: under an active census
    the wrapper runs with the census suspended (the operations of its
    plain version or of its launch uncounted) and counts as one launch of
    ``name`` costing ``cost(*args, **kwargs)`` (the census's ``kernel``);
    otherwise it runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            census = active_census()
            if census is None:
                return fn(*args, **kwargs)
            from torch.utils._python_dispatch import _disable_current_modes
            spent = cost(*args, **kwargs)
            with _disable_current_modes():
                set_census(None)
                try:
                    out = fn(*args, **kwargs)
                finally:
                    set_census(census)
            census.kernel(name, spent, out)
            return out
        return call
    return wrap
