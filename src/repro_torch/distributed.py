"""Tensor and data parallelism across devices: the counterpart of what
``jit`` over a mesh does in the reference.

A :class:`MeshGroup` is a process's place on a ``D x M`` mesh
(:func:`~repro_torch.launch.mesh.make_data_mesh`; ``1 x M``,
:func:`~repro_torch.launch.mesh.make_model_mesh`, for tensor
parallelism alone): rank ``r = d * M + m`` runs on
``mesh.devices.flat[r]`` (``cuda:r``, or the CPU when the caller asks),
is data rank ``d``'s model rank ``m``, and holds that device's block of
every weight under the rules its model was given
(:func:`~repro_torch.sharding.layout_for`).
Its process groups are its own, built on a rendezvous store that rank 0
hosts (never the process's default group), so one process may lead
several meshes, as a cluster's process leads its replicas:

* the ``model`` axis of its data row (M ranks): NCCL for CUDA devices,
  gloo for CPU ones, chosen by the device and never as a fallback (a
  CUDA mesh whose NCCL group cannot be made raises). The layers'
  collectives run on it;
* the ``data`` axis of its model column (D ranks, where D > 1), chosen
  the same way: each step's outputs gathered over the batch rows
  (:meth:`MeshGroup.gather_rows`) and, under FSDP, each weight's
  ``W_IN`` block gathered a layer (:meth:`MeshGroup.gather_weight`);
* a gloo group of every rank on the host, for control messages (the
  engine's step commands, :class:`StepChannel`).

Every communicator connects when the group is made, never inside a
graph capture.

The layers call :func:`reduce_partial` (an all-reduce of a row-parallel
product's partial sums: ``wo``, ``w2``, the vocab-parallel embedding),
:func:`scatter_last` (its reduce-scatter to the rank's block of the last
dim, where the residual is d_model-sharded), :func:`gather_last` (an
all-gather of a last dim: the vocab-sharded logits, a sharded residual,
a head-dim-sharded ``q/k/v``), :func:`reduce_stats` (an all-reduce of a
norm's float32 row sums over the d_model shards), :func:`gather_parts`
(an all-gather of each rank's attention partials over a sharded KV
sequence) and :func:`gather_weight` (FSDP's all-gather of a weight's
block over the data axis); each is a no-op unless a model's entry point
has made its group :func:`active` on the calling thread, with its
:class:`~repro_torch.sharding.Layout` (:func:`layout`), and each runs
under ``scope("collective")``, counted by an active dispatch census as
collective bytes (an all-reduce twice its bytes, an all-gather its
output's, a reduce-scatter its input's, the dry-run census's
convention).

:func:`spawn` runs ``fn(group, *args)`` in one process a device (spawn
start method) over a free port found at run time, and returns each
rank's result; :class:`RankProcesses` starts some ranks of a mesh (a
cluster replica's followers, whose rank 0 is the calling process), and
:func:`run_child` runs a function in a process of its own.
"""
from __future__ import annotations

import contextlib
import datetime
import gc
import os
import queue
import socket
import threading
import traceback
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import (AllgatherOptions, AllreduceOptions,
                                        BroadcastOptions, ReduceOp,
                                        ReduceScatterOptions)

from repro_torch.kernels.launches import active_census
from repro_torch.launch.mesh import Mesh

_local = threading.local()

# how long a rank waits on another in a collective or a control message
TIMEOUT = datetime.timedelta(minutes=10)


class MeshGroup:
    """A process's rank on ``mesh`` and its process groups; see the
    module docstring. :meth:`init` makes one, which the caller hands to
    its model (``Model(..., group=)``). ``rank`` is the device's place
    in the mesh, ``size`` the model axis's devices and ``model_rank`` its
    place there, ``data_size`` the data axes' devices and ``data_rank``
    its place there. With ``record`` set to a list, every collective
    appends ``(op, shape, dtype)`` to it (the lock-step check)."""

    def __init__(self, mesh: Mesh, rank: int, group, host, store=None,
                 data=None):
        self.mesh = mesh
        self.rank = rank
        self.size = mesh.shape["model"]
        self.model_rank = rank % self.size
        self.data_size = mesh.size // self.size
        self.data_rank = rank // self.size
        self.device = torch.device(mesh.devices.flat[rank])
        self.group = group
        # the data axis's group of the rank's model column (None: one
        # data rank)
        self.data = data
        self.host = host
        # the rendezvous (rank 0 serves it while the group lives)
        self.store = store
        self.record: Optional[List[Tuple[str, Tuple[int, ...], str]]] = None

    @staticmethod
    def check_mesh(mesh: Mesh):
        """Refuse a mesh this module does not run: no devices, or no
        ``model`` axis as its last (the data axes lead, so device ``d * M
        + m`` is data rank ``d``'s model rank ``m``)."""
        if mesh.devices is None:
            raise ValueError("a process group needs a mesh over real "
                             "devices")
        if mesh.axis_names[-1:] != ("model",):
            raise ValueError(f"mesh must have a 'model' axis last, got "
                             f"{mesh.axis_names}")

    @classmethod
    def init(cls, mesh: Mesh, rank: int, address: str, *,
             store=None) -> "MeshGroup":
        """Join the mesh's process groups as ``rank``, meeting the other
        ranks at ``address`` (``tcp://127.0.0.1:<port>``, served by rank
        0, or the store rank 0 already serves there, ``store``). The
        process's current device is left as it is: one process may lead
        several meshes."""
        cls.check_mesh(mesh)
        device = torch.device(mesh.devices.flat[rank])
        kinds = {torch.device(d).type for d in mesh.devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh mixes device types {sorted(kinds)}")
        size = mesh.size
        if device.type == "cuda":
            if not torch.cuda.is_available() or \
                    torch.cuda.device_count() <= (device.index or 0):
                raise RuntimeError(f"no CUDA device {device} for rank "
                                   f"{rank}")
            if not dist.is_nccl_available():
                raise RuntimeError("this PyTorch has no NCCL: a mesh of "
                                   "CUDA devices cannot be made")
        elif device.type != "cpu":
            raise ValueError(f"no process group for device {device}")
        if store is None:
            store = rendezvous(address, rank, size)
        m = mesh.shape["model"]
        d, mr = divmod(rank, m)
        model = _device_group(device, store, f"model/{d}", mr, m)
        data = _device_group(device, store, f"data/{mr}", d, size // m) \
            if size > m else None
        host = dist.ProcessGroupGloo(dist.PrefixStore("host", store), rank,
                                     size, TIMEOUT)
        return cls(mesh, rank, model, host, store, data)

    def close(self):
        """Leave the process groups (the process may join another mesh
        afterwards)."""
        if self.device.type == "cuda":
            # abort, not shutdown: NCCL's shutdown waits for every rank's,
            # and a cluster's rank 0 closes before it collects its followers
            for g in (self.group, self.data):
                stop = getattr(g, "abort", None) or \
                    getattr(g, "shutdown", None)
                if stop is not None:
                    stop()
        self.group = self.data = self.host = self.store = None

    @contextlib.contextmanager
    def active(self, layout=None):
        """Make this group the one the layers' collectives run on, and
        ``layout`` (a :class:`~repro_torch.sharding.Layout`) the plan they
        read, on the calling thread, for the ``with`` block."""
        outer = getattr(_local, "group", None), getattr(_local, "layout",
                                                        None)
        _local.group, _local.layout = self, layout
        try:
            yield self
        finally:
            _local.group, _local.layout = outer

    def _note(self, op: str, t: torch.Tensor):
        if self.record is not None:
            self.record.append((op, tuple(t.shape), str(t.dtype)))

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the model axis, in place."""
        self._note("all_reduce", x)
        opts = AllreduceOptions()
        opts.asyncOp = False
        _collective("all-reduce", 2 * _nbytes(x),
                    lambda: _wait(self.group.allreduce([x], opts)))
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along a new leading dim ``[M,
        *x.shape]``, in rank order."""
        self._note("all_gather", x)
        x = x.contiguous()
        out = torch.empty((self.size * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        opts = AllgatherOptions()
        opts.asyncOp = False
        _collective("all-gather", _nbytes(out),
                    lambda: _wait(self.group._allgather_base(out, x, opts)))
        return out.reshape(self.size, *x.shape)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model axis of ``x [M * n, ...]``, each rank
        keeping its ``[n, ...]`` block of the leading dim."""
        self._note("reduce_scatter", x)
        x = x.contiguous()
        out = torch.empty((x.shape[0] // self.size, *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        opts = ReduceScatterOptions()
        opts.reduceOp = ReduceOp.SUM
        opts.asyncOp = False
        _collective("reduce-scatter", _nbytes(x),
                    lambda: _wait(self.group._reduce_scatter_base(out, x,
                                                                  opts)))
        return out

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's block of rows ``x [n, ...]`` stacked in data
        rank order, ``[D * n, ...]``, over the data group (``x`` itself
        with one data rank): a step's outputs made whole on every rank."""
        if self.data is None:
            return x
        self._note("gather_rows", x)
        return self._gather_data(x.contiguous())

    def gather_weight(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """FSDP: a weight's block ``w`` of dim ``dim`` (its ``W_IN``
        block, :attr:`~repro_torch.sharding.Layout.w_in`) gathered whole
        over the data group, in data rank order. A gathered dim other than
        the first comes back as a strided view (the matmuls take it as
        it is)."""
        self._note("gather_weight", w)
        return self._gather_data(w.movedim(dim, 0).contiguous()).movedim(
            0, dim)

    def _gather_data(self, x: torch.Tensor) -> torch.Tensor:
        """The data group's all-gather of a contiguous ``x [n, ...]``:
        ``[D * n, ...]``, in data rank order."""
        out = torch.empty((self.data_size * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        opts = AllgatherOptions()
        opts.asyncOp = False
        _collective("all-gather", _nbytes(out),
                    lambda: _wait(self.data._allgather_base(out, x, opts)))
        return out

    def broadcast_host(self, t: torch.Tensor):
        """Rank 0's CPU tensor ``t`` into every rank's ``t``, over the
        host group."""
        opts = BroadcastOptions()
        opts.rootRank = 0
        _wait(self.host.broadcast([t], opts))


def _device_group(device: torch.device, store, prefix: str, rank: int,
                  size: int):
    """A process group of ``size`` ranks on ``store`` under ``prefix``:
    NCCL on a CUDA device (its communicator connected now, on every rank
    at once: never inside a graph capture), gloo on the CPU."""
    if device.type == "cuda":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = TIMEOUT
        with torch.cuda.device(device):
            group = dist.ProcessGroupNCCL(dist.PrefixStore(prefix, store),
                                          rank, size, opts)
            group.eager_connect_single_device(device)
        return group
    return dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank,
                                 size, TIMEOUT)


def _wait(work):
    """Wait for a collective's work, as ``torch.distributed``'s own calls
    do: a synchronous NCCL collective on the current stream returns
    none."""
    if work is not None:
        work.wait()


def rendezvous(address: str, rank: int, size: int):
    """The store ``size`` ranks meet at ``address`` (``tcp://host:port``):
    rank 0 serves it (port 0 picks a free one, ``store.port``), the others
    connect, retrying until rank 0 is up."""
    host, port = address.removeprefix("tcp://").rsplit(":", 1)
    return dist.TCPStore(host, int(port), size, rank == 0, TIMEOUT,
                         wait_for_workers=False)


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


def active() -> Optional[MeshGroup]:
    """The group the calling thread's layers run their collectives on."""
    return getattr(_local, "group", None)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums, all-reduced over the active
    group (``x`` itself without one)."""
    g = active()
    return x if g is None else g.all_reduce(x)


def layout():
    """The plan (:class:`~repro_torch.sharding.Layout`) the calling
    thread's layers run under; None on one device."""
    return getattr(_local, "layout", None)


def scatter_last(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums ``x [..., M * n]``, summed
    over the active group, each rank keeping its block ``[..., n]`` of the
    last dim (a reduce-scatter)."""
    g = active()
    if g is None:
        return x
    n = x.shape[-1] // g.size
    parts = x.reshape(-1, g.size, n).transpose(0, 1)     # [M, rows, n]
    return g.reduce_scatter(parts.reshape(-1, n)).reshape(
        *x.shape[:-1], n)


def reduce_stats(x: torch.Tensor) -> torch.Tensor:
    """Float32 row statistics (a norm's partial sums over the rank's
    d_model block), summed over the active group in place."""
    if x.dtype != torch.float32:
        raise TypeError(f"row statistics are float32, got {x.dtype}")
    return reduce_partial(x)


def gather_parts(x: torch.Tensor) -> torch.Tensor:
    """Each rank's ``x`` stacked along a new leading dim ``[M,
    *x.shape]`` in rank order (an all-gather); ``x[None]`` without a
    group."""
    g = active()
    return x[None] if g is None else g.all_gather(x)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """``x [..., n]``, each rank's block of the last dim, gathered to
    ``[..., M * n]`` over the active group (``x`` itself without one)."""
    g = active()
    if g is None:
        return x
    parts = g.all_gather(x.reshape(-1, x.shape[-1]))       # [M, rows, n]
    return parts.permute(1, 0, 2).reshape(*x.shape[:-1], -1)


def gather_weight(w: torch.Tensor, dim: int) -> torch.Tensor:
    """FSDP: the active group's rank's block ``w`` of dim ``dim``
    gathered whole over its data axis (:meth:`MeshGroup.gather_weight`;
    ``w`` itself without a group or with one data rank)."""
    g = active()
    return w if g is None or g.data is None else g.gather_weight(w, dim)


def vocab_block(rows: int) -> Optional[Tuple[int, int]]:
    """``(first, count)`` of the vocab rows the active group's rank holds,
    ``rows`` of them; None without a group."""
    g = active()
    return None if g is None else (g.model_rank * rows, rows)


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
        self.group.broadcast_host(h)
        if n:
            self.group.broadcast_host(words)

    def stop(self):
        """Rank 0: release the other ranks from following."""
        self.send((STOP,))

    def recv(self, into: Callable[[Tuple, int], torch.Tensor]
             ) -> Tuple[Tuple, Optional[torch.Tensor]]:
        """Another rank: the next key and its words, received into the
        int32 CPU tensor ``into(key, n)`` returns."""
        h = torch.zeros((_HEADER,), dtype=torch.int64)
        self.group.broadcast_host(h)
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
        self.group.broadcast_host(buf)
        return key, buf


# -------------------------------------------------------------- spawn --
def free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, mesh: Mesh, rank: int, address: str, args, out):
    device = torch.device(mesh.devices.flat[rank])
    if device.type == "cpu":
        torch.set_num_threads(1)
    group = None
    try:
        if device.type == "cuda":
            # the rank's card is the process's own
            torch.cuda.set_device(device)
        group = MeshGroup.init(mesh, rank, address)
        result = fn(group, *args)
        out.put((rank, True, result))
    except BaseException:                          # noqa: BLE001
        # on stderr too: a rank whose peers wait on it in a collective
        # is read back only once they give up
        traceback.print_exc()
        out.put((rank, False, traceback.format_exc()))
    finally:
        if group is not None:
            # the rank's engine sits in a reference cycle: collect it, so
            # that no CUDA graph holding the NCCL communicator outlives
            # it (aborting a communicator a graph holds hangs)
            gc.collect()
            group.close()


def _child_main(fn, args, kwargs, out):
    try:
        out.put((0, True, fn(*args, **kwargs)))
    except BaseException:                          # noqa: BLE001
        out.put((0, False, traceback.format_exc()))


class Processes:
    """Child processes (spawn start method), each putting ``(key, ok,
    value)`` on one queue: :meth:`collect` returns each key's value, and
    raises for one that failed, died or outlasted its time; :meth:`stop`
    ends whatever still runs. A CPU mesh's processes run one thread."""

    def __init__(self, targets: List[Tuple[Callable, tuple]], *,
                 one_thread: bool = False, daemon: bool = True):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.out = ctx.Queue()
        self.procs = [ctx.Process(target=t, args=(*a, self.out),
                                  daemon=daemon) for t, a in targets]
        env = os.environ.get("OMP_NUM_THREADS")
        try:
            if one_thread:
                os.environ["OMP_NUM_THREADS"] = "1"
            for p in self.procs:
                p.start()
        except BaseException:
            self.stop()
            raise
        finally:
            if env is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = env

    def collect(self, timeout_s: float = 1800.0) -> dict:
        """Every process's value by key, once each has put one."""
        import time
        results: dict = {}
        deadline = time.monotonic() + timeout_s
        while len(results) < len(self.procs):
            try:
                key, ok, value = self.out.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in self.procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"process {self.procs.index(dead[0])} died with "
                        f"exit code {dead[0].exitcode}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"processes still running after "
                                       f"{timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {key} failed:\n{value}")
            results[key] = value
        for p in self.procs:
            p.join(timeout=60)
        return results

    def exited(self) -> Optional[int]:
        """The index of a process that has already exited (its value, or
        its error, is on the queue), if any: a follower that ends before
        it is stopped has failed."""
        return next((i for i, p in enumerate(self.procs)
                     if p.exitcode is not None), None)

    def stop(self):
        """End every process still running."""
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()


class RankProcesses(Processes):
    """Ranks ``ranks`` of ``mesh``, one process each, running ``fn(group,
    *args)`` once they joined the mesh at ``address`` (rank 0's, which
    may be the calling process's)."""

    def __init__(self, fn: Callable[..., Any], mesh: Mesh, address: str,
                 args: tuple, ranks):
        cpu = torch.device(mesh.devices.flat[0]).type == "cpu"
        super().__init__([(_rank_main, (fn, mesh, r, address, args))
                          for r in ranks], one_thread=cpu)


def spawn(fn: Callable[..., Any], mesh: Mesh, *args,
          timeout_s: float = 1800.0) -> List[Any]:
    """Run ``fn(group, *args)`` in one process a device of ``mesh``
    (spawn start method: ``fn`` and ``args`` must pickle), over a free
    port, and return each rank's result in rank order. A rank that
    raises, dies or outlasts ``timeout_s`` raises here, and every process
    is stopped before this returns."""
    MeshGroup.check_mesh(mesh)
    ranks = RankProcesses(fn, mesh, f"tcp://127.0.0.1:{free_port()}", args,
                          range(mesh.size))
    try:
        results = ranks.collect(timeout_s)
    finally:
        ranks.stop()
    return [results[r] for r in range(mesh.size)]


def run_child(fn: Callable[..., Any], *args, timeout_s: float = 1800.0,
              **kwargs) -> Any:
    """``fn(*args, **kwargs)`` in a process of its own (spawn start method, not
    daemonic, so it may start rank processes of its own: a cluster whose
    replicas span several devices), its result returned; it raises as
    :func:`spawn` does."""
    child = Processes([(_child_main, (fn, args, kwargs))], daemon=False)
    try:
        return child.collect(timeout_s)[0]
    finally:
        child.stop()


def devices_mesh(n: int, device: str = "cuda", data: int = 1) -> Mesh:
    """A ``data x n/data`` mesh over ``cuda:0..n-1``, or ``n`` CPU ranks
    (``1 x n`` by default)."""
    from repro_torch.launch.mesh import make_data_mesh
    devs = [f"cuda:{i}" if device == "cuda" else "cpu" for i in range(n)]
    return make_data_mesh(devs, data)
