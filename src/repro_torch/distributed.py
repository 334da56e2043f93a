"""Tensor parallelism across devices: the counterpart of what ``jit`` over
a mesh does in the reference.

A :class:`MeshGroup` is this process's place on a ``1 x M`` mesh
(:func:`~repro_torch.launch.mesh.make_model_mesh`): rank ``r`` runs on
``mesh.devices.flat[r]`` (``cuda:r``, or the CPU when the caller asks)
and holds that device's block of every weight under the reference's
``act_replicated`` rules (:func:`~repro_torch.sharding.check_executable`).
Its process groups:

* the ``model`` axis: NCCL for CUDA devices, gloo for CPU ones, chosen
  by the device and never as a fallback (a CUDA mesh whose NCCL group
  cannot be made raises). The layers' collectives run on it;
* a gloo group on the host, for control messages (the engine's step
  commands, :class:`StepChannel`).

The layers call :func:`reduce_partial` (an all-reduce of a row-parallel
product's partial sums: ``wo``, ``w2``, the vocab-parallel embedding)
and :func:`gather_last` (an all-gather of the vocab-sharded logits);
each is a no-op unless a model's entry point has made its group
:func:`active` on the calling thread, and each runs under
``scope("collective")``, counted by an active dispatch census as
collective bytes (an all-reduce twice its bytes, an all-gather its
output's, the dry-run census's convention).

:func:`spawn` runs ``fn(group, *args)`` in one process a device (spawn
start method) over a free port found at run time, and returns each
rank's result. A mesh with ``data`` > 1 raises.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import socket
import threading
import traceback
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.launches import active_census
from repro_torch.launch.mesh import Mesh, multi_card_item

_local = threading.local()
_CURRENT: Optional["MeshGroup"] = None

# how long a rank waits on another in a collective or a control message
TIMEOUT = datetime.timedelta(minutes=10)


class MeshGroup:
    """This process's rank on ``mesh`` and its process groups; see the
    module docstring. :meth:`init` makes one; :func:`current` returns it.
    With ``record`` set to a list, every collective appends ``(op, shape,
    dtype)`` to it (the lock-step check)."""

    def __init__(self, mesh: Mesh, rank: int, group, host):
        self.mesh = mesh
        self.rank = rank
        self.size = mesh.shape["model"]
        self.device = torch.device(mesh.devices.flat[rank])
        self.group = group
        self.host = host
        self.record: Optional[List[Tuple[str, Tuple[int, ...], str]]] = None

    @staticmethod
    def check_mesh(mesh: Mesh):
        """Refuse a mesh this module does not run: no devices, no
        ``model`` axis, or more than one device on another axis."""
        if mesh.devices is None:
            raise ValueError("a process group needs a mesh over real "
                             "devices")
        if "model" not in mesh.shape:
            raise ValueError(f"mesh must have a 'model' axis, got "
                             f"{mesh.axis_names}")
        data = mesh.size // mesh.shape["model"]
        if data > 1:
            raise NotImplementedError(
                f"a mesh of {data} devices along its data axes "
                f"({multi_card_item('data')})")

    @classmethod
    def init(cls, mesh: Mesh, rank: int, address: str) -> "MeshGroup":
        """Join the mesh's process groups as ``rank`` at ``address``
        (``tcp://127.0.0.1:<port>``) and make the group :func:`current`."""
        global _CURRENT
        cls.check_mesh(mesh)
        if _CURRENT is not None:
            raise RuntimeError("this process already belongs to a mesh")
        device = torch.device(mesh.devices.flat[rank])
        kinds = {torch.device(d).type for d in mesh.devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh mixes device types {sorted(kinds)}")
        world = mesh.size
        if device.type == "cuda":
            if not torch.cuda.is_available() or \
                    torch.cuda.device_count() <= (device.index or 0):
                raise RuntimeError(f"no CUDA device {device} for rank "
                                   f"{rank}")
            if not dist.is_nccl_available():
                raise RuntimeError("this PyTorch has no NCCL: a mesh of "
                                   "CUDA devices cannot be made")
            torch.cuda.set_device(device)
            kw = {}
            if "device_id" in dist.init_process_group.__code__.co_varnames:
                kw["device_id"] = device
            dist.init_process_group("nccl", init_method=address,
                                    world_size=world, rank=rank,
                                    timeout=TIMEOUT, **kw)
        elif device.type == "cpu":
            dist.init_process_group("gloo", init_method=address,
                                    world_size=world, rank=rank,
                                    timeout=TIMEOUT)
        else:
            raise ValueError(f"no process group for device {device}")
        host = dist.new_group(backend="gloo", timeout=TIMEOUT)
        _CURRENT = cls(mesh, rank, dist.group.WORLD, host)
        return _CURRENT

    def close(self):
        """Leave the process groups (the process may join another mesh
        afterwards)."""
        global _CURRENT
        if _CURRENT is self:
            _CURRENT = None
        if dist.is_initialized():
            dist.destroy_process_group()

    @contextlib.contextmanager
    def active(self):
        """Make this group the one the layers' collectives run on, on the
        calling thread, for the ``with`` block."""
        outer = getattr(_local, "group", None)
        _local.group = self
        try:
            yield self
        finally:
            _local.group = outer

    def _note(self, op: str, t: torch.Tensor):
        if self.record is not None:
            self.record.append((op, tuple(t.shape), str(t.dtype)))

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the model axis, in place."""
        self._note("all_reduce", x)
        _collective("all-reduce", 2 * _nbytes(x),
                    lambda: dist.all_reduce(x, group=self.group))
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along a new leading dim ``[M,
        *x.shape]``, in rank order."""
        self._note("all_gather", x)
        x = x.contiguous()
        out = torch.empty((self.size * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        _collective("all-gather", _nbytes(out),
                    lambda: gather(out, x, group=self.group))
        return out.reshape(self.size, *x.shape)

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective(kind: str, nbytes: int, run: Callable[[], Any]):
    """Run a collective under ``scope("collective")``; under an active
    dispatch census it runs outside the census's mode and counts as
    ``nbytes`` of ``kind``."""
    # (imported here: the census imports the models, which import this)
    from repro_torch.core.analysis import scope
    with scope("collective"):
        census = active_census()
        if census is None:
            run()
            return
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            run()
        census.collective(kind, nbytes)


def current() -> Optional[MeshGroup]:
    """This process's mesh group, if it joined one."""
    return _CURRENT


def active() -> Optional[MeshGroup]:
    """The group the calling thread's layers run their collectives on."""
    return getattr(_local, "group", None)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums, all-reduced over the active
    group (``x`` itself without one)."""
    g = active()
    return x if g is None else g.all_reduce(x)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """``x [..., n]``, each rank's block of the last dim, gathered to
    ``[..., M * n]`` over the active group (``x`` itself without one)."""
    g = active()
    if g is None:
        return x
    parts = g.all_gather(x.reshape(-1, x.shape[-1]))       # [M, rows, n]
    return parts.permute(1, 0, 2).reshape(*x.shape[:-1], -1)


def vocab_block(rows: int) -> Optional[Tuple[int, int]]:
    """``(first, count)`` of the vocab rows the active group's rank holds,
    ``rows`` of them; None without a group."""
    g = active()
    return None if g is None else (g.rank * rows, rows)


# ------------------------------------------------------------ control --
STOP = "stop"
_KEY_KINDS = ("paged", "prefill", "suffix", "gather", "verify", "copy", STOP)
_HEADER = 8


class StepChannel:
    """Rank 0's step commands to the other ranks, over the host group: a
    header (the step's key) and the words of its packed staging buffer
    (:class:`~repro_torch.serving.steps.StepFunctions`). Every rank then
    runs the same step bodies, so every rank issues the same collectives
    in the same order, whatever rank 0's host decided from its clock."""

    def __init__(self, group: MeshGroup):
        self.group = group
        self.leads = group.rank == 0

    def _header(self, key: Tuple, n: int) -> torch.Tensor:
        kind = key[0] if isinstance(key[0], str) else "paged"
        ints = key[1:] if isinstance(key[0], str) else key
        h = torch.zeros((_HEADER,), dtype=torch.int64)
        h[0] = _KEY_KINDS.index(kind)
        h[1] = n
        h[2:2 + len(ints)] = torch.tensor([int(i) for i in ints])
        h[-1] = len(ints)
        return h

    def send(self, key: Tuple, words: Optional[torch.Tensor] = None):
        """Rank 0: broadcast step ``key`` and its ``words`` (an int32 CPU
        tensor)."""
        n = 0 if words is None else words.numel()
        h = self._header(key, n)
        dist.broadcast(h, 0, group=self.group.host)
        if n:
            dist.broadcast(words, 0, group=self.group.host)

    def stop(self):
        """Rank 0: release the other ranks from following."""
        self.send((STOP,))

    def recv(self, into: Callable[[Tuple, int], torch.Tensor]
             ) -> Tuple[Tuple, Optional[torch.Tensor]]:
        """Another rank: the next key and its words, received into the
        int32 CPU tensor ``into(key, n)`` returns."""
        h = torch.zeros((_HEADER,), dtype=torch.int64)
        dist.broadcast(h, 0, group=self.group.host)
        kind = _KEY_KINDS[int(h[0])]
        ints = tuple(int(i) for i in h[2:2 + int(h[-1])])
        if kind == "paged":             # (batch_pad, nb_pad, sampled)
            key = (ints[0], ints[1], bool(ints[2]))
        elif kind in ("gather", "verify"):        # a trailing sampled flag
            key = (kind, *ints[:-1], bool(ints[-1]))
        else:
            key = (kind, *ints)
        n = int(h[1])
        if not n:
            return key, None
        buf = into(key, n)
        dist.broadcast(buf, 0, group=self.group.host)
        return key, buf


# -------------------------------------------------------------- spawn --
def free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, mesh: Mesh, rank: int, address: str, args, out):
    if torch.device(mesh.devices.flat[rank]).type == "cpu":
        torch.set_num_threads(1)
    group = None
    try:
        group = MeshGroup.init(mesh, rank, address)
        result = fn(group, *args)
        out.put((rank, True, result))
    except BaseException:                          # noqa: BLE001
        out.put((rank, False, traceback.format_exc()))
    finally:
        if group is not None:
            group.close()


def spawn(fn: Callable[..., Any], mesh: Mesh, *args,
          timeout_s: float = 1800.0) -> List[Any]:
    """Run ``fn(group, *args)`` in one process a device of ``mesh``
    (spawn start method: ``fn`` and ``args`` must pickle), over a free
    port, and return each rank's result in rank order. A rank that
    raises, dies or outlasts ``timeout_s`` raises here, and every process
    is stopped before this returns."""
    import multiprocessing as mp
    import time
    MeshGroup.check_mesh(mesh)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    address = f"tcp://127.0.0.1:{free_port()}"
    env = os.environ.get("OMP_NUM_THREADS")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, mesh, r, address, args, out),
                         daemon=True)
             for r in range(mesh.size)]
    results: dict = {}
    try:
        if mesh.devices.flat[0] is not None and \
                torch.device(mesh.devices.flat[0]).type == "cpu":
            os.environ["OMP_NUM_THREADS"] = "1"
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(results) < len(procs):
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank process {procs.index(dead[0])} died with "
                        f"exit code {dead[0].exitcode}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(len(procs))]


def devices_mesh(n: int, device: str = "cuda") -> Mesh:
    """A ``1 x n`` mesh over ``cuda:0..n-1``, or ``n`` CPU ranks."""
    from repro_torch.launch.mesh import make_model_mesh
    devs = [f"cuda:{i}" if device == "cuda" else "cpu" for i in range(n)]
    return make_model_mesh(devs)
