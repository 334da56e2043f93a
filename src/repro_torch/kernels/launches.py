"""Kernel launch counting that stays exact when several threads launch.

Each kernel wrapper keeps a ``launches`` count of the launches it made
where its kernel runs. Co-located replicas step on their own host
threads, so one thread may capture a CUDA graph (whose launches are not
launches: they are added at each replay) while another launches or
replays. :func:`count_launch` therefore counts a launch made inside
:func:`tally_launches` on that thread's tally, not on the shared count,
and every change to a shared count holds one lock (``+=`` on an attribute
is not atomic across threads).
"""
from __future__ import annotations

import contextlib
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
