"""Dispatch census: the port's counterpart of ``repro.core.analysis``.

The reference parses the optimized per-device XLA program of a step and
totals its FLOPs, HBM bytes and collective bytes per kernel class
(``HloCensus``), and reads the program's argument, output and temporary
bytes (``memory_from_compiled``). A CUDA graph has no such program. What
the port has instead is the eager run of the same step, which dispatches
exactly the operations a captured graph replays. :class:`DispatchCensus`
is a ``TorchDispatchMode`` that sees each of them and builds the same
:class:`OpCensus` (one definition of it and of :class:`ClassCost`, as the
reference keeps them here), plus what a program census cannot count on
the card: **launches** a class and the **peak of live temporary bytes**.
It runs the same on CPU, meta and CUDA tensors, so a step's census on
meta tensors equals the card's op for op, and costs no device work there.

**Classes.** :func:`scope` is the counterpart of ``jax.named_scope``: a
thread-local name stack the models push at the reference's scope sites
(``qkv_proj``, ``attn_core``, ``mlp``, ``embed``, ``logits``, ...), read
by :func:`classify` (a copy of the reference's rules) when an operation
dispatches. The same names label ``torch.profiler`` ranges while a
profiler runs, so a census and a trace group the work alike. A scope is
host-only: it adds nothing to a replayed CUDA graph.

**Bytes** (after ``HloCensus._instr_bytes``): an operation counts the
bytes of its tensor inputs and outputs once each (an in-place operation
its operand once). A view (``view``, ``t``, ``expand``, slicing, ...)
and an allocation count no bytes and no launch. A gather
(``index``, ``index_select``, ``gather``, ``embedding``) counts twice its
output, the rows it reads and writes; a scatter into a buffer
(``index_copy_``, ``index_put_``, ``scatter_``, ``index_add_``) twice
the update, never the buffer: without this every decode step would count
the whole KV pool.

**FLOPs:** ``2·M·N·K`` for products, from ``torch.utils.flop_counter``'s
registry, plus the adds of a bias folded into ``addmm``/``baddbmm``. An
elementwise operation (PyTorch's pointwise tag, a dtype conversion, a
masked fill) counts its output's elements, as ``HloCensus`` counts its
``_EW_FLOP_OPS``, and an activation PyTorch runs as one kernel (silu,
softplus, gelu) the operations of its formula; a gather counts its
output's elements too, as the reference counts the bounds
select of each element its ``jnp.take`` adds. Reductions and copies count
none (``HloCensus`` counts no applier).

**Hand-written kernels**
(:func:`~repro_torch.kernels.launches.counted_kernel`): each wrapper
reports one launch to an active census, under ``attention``, with the
FLOPs and bytes of its static shapes, and its plain version's own operations are
not counted: on a CPU tensor the plain version stands in for one launch,
and on a meta tensor the wrapper returns an output of the right shape
with no work. The census reads no length from the device: the live terms
stay :mod:`repro_torch.core.census`'s.

**Temporary bytes** (:func:`census_of`): the peak of the storages the
call allocated that were alive at once, the counterpart of
``memory_analysis().temp_size_in_bytes`` (the call's outputs included
while alive, as an allocator's peak counts them). The reference's
``cpu_upcast_artifact_bytes`` measures float32 twins XLA's CPU backend
makes of bfloat16 operands; PyTorch makes none, so it has no counterpart.

**Collectives:** on one device nothing is collective and ``coll_bytes``
is 0. A rank of a tensor-parallel model (:mod:`repro_torch.distributed`)
counts each all-reduce and all-gather it issues under class
``collective``: its bytes in ``coll_bytes`` (an all-reduce twice the
tensor's, an all-gather its output's) and one launch.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import defaultdict
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.launches import (KernelCost,  # noqa: F401
                                          counted_kernel, set_census)


@dataclasses.dataclass
class ClassCost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0

    def add(self, other: "ClassCost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_bytes += other.coll_bytes * mult


@dataclasses.dataclass
class OpCensus:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    per_class: Dict[str, ClassCost] = dataclasses.field(
        default_factory=lambda: defaultdict(ClassCost))
    per_collective: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))

    def arithmetic_intensity(self, cls: Optional[str] = None) -> float:
        c = self.per_class[cls] if cls else self
        return c.flops / max(c.bytes, 1.0)


# op_name substring -> kernel class (mirrors the paper's Fig. 6 kernel split)
_CLASS_RULES = (
    ("attn_core", "attention"),
    ("kv_update", "attention"),
    ("cross_attn", "attention"),
    ("qkv_proj", "matmul"),
    ("attn_out", "matmul"),
    ("mlp", "matmul"),
    ("expert_ffn", "matmul"),
    ("router", "moe_dispatch"),
    ("moe_", "moe_dispatch"),
    ("ssd_", "ssm"),
    ("ssm_", "ssm"),
    ("embed", "head"),
    ("logits", "head"),
    ("loss", "head"),
)


def classify(op_name: str) -> str:
    for pat, cls in _CLASS_RULES:
        if pat in op_name:
            return cls
    return "other"


# ----------------------------------------------------------------- scopes --
_local = threading.local()


def scope_path() -> str:
    """This thread's open scopes, outermost first, joined by ``/`` (the
    reference's ``op_name`` form)."""
    return getattr(_local, "path", "")


class scope:
    """``with scope("mlp"): ...``: the counterpart of
    ``jax.named_scope``. Extends this thread's scope path for the census,
    and opens a ``torch.profiler`` range of the same name while a
    profiler runs (none otherwise: outside a profile it costs two
    attribute writes)."""

    __slots__ = ("name", "_outer", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        self._outer = outer = getattr(_local, "path", "")
        _local.path = f"{outer}/{self.name}" if outer else self.name
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _local.path = self._outer
        return False


# ------------------------------------------------------------- the census --
aten = torch.ops.aten

# operations that launch nothing: allocations, aliases, metadata
_NO_LAUNCH = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten._unsafe_view.default,
    aten.resize_.default, aten.set_.source_Storage_storage_offset,
    aten.set_.source_Tensor, aten.lift_fresh.default,
    aten.detach.default, aten.alias.default,
}
# gathers: twice the output (the rows read and written)
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
# scatters into a buffer: twice the update, at this argument
_SCATTERS = {aten.index_copy_.default: 3, aten.index_put_.default: 2,
             aten._index_put_impl_.default: 2, aten.scatter_.src: 3,
             aten.scatter_add_.default: 3, aten.index_add_.default: 3}
# elementwise besides the pointwise tag: conversions and masked fills
_ELEMENTWISE = {aten._to_copy.default, aten.masked_fill.Scalar,
                aten.masked_fill.Tensor, aten.masked_fill_.Scalar,
                aten.masked_fill_.Tensor}
_BIASED = {aten.addmm.default, aten.baddbmm.default}
# activations PyTorch computes in one kernel: the elementwise operations
# of their formula an element (silu x / (1 + exp(-x)): negate, exp, add,
# divide; softplus log(1 + exp(x)); gelu's tanh form), as XLA expands
# them into that many ops for the reference's census
_FORMULA_OPS = {aten.silu.default: 4, aten.softplus.default: 3,
                aten.gelu.default: 8}


def _tensors(tree) -> list:
    """The tensors in nested tuples, lists and dicts (an operation's
    arguments or outputs)."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):  # a tensor with no storage
        return None


class _Rule(NamedTuple):
    """How the census counts one operation: ``kind`` ``view`` (no bytes,
    no launch), ``alloc`` (no launch), ``scatter`` (``arg`` the update's
    position), ``gather``, ``product`` (``arg``: a bias folded in) or
    ``elementwise`` (``arg`` operations an element; 0 for a copy or a
    reduction)."""
    kind: str
    arg: object
    name: str
    in_place: bool              # it writes an argument (in place, out=)


def _rule_of(func) -> _Rule:
    if func.is_view:
        kind, arg = "view", None
    elif func in _NO_LAUNCH:
        kind, arg = "alloc", None
    elif func in _SCATTERS:
        kind, arg = "scatter", _SCATTERS[func]
    elif func in _GATHERS:
        kind, arg = "gather", None
    elif func.overloadpacket in flop_registry:
        kind, arg = "product", func in _BIASED
    elif func in _FORMULA_OPS:
        kind, arg = "elementwise", _FORMULA_OPS[func]
    elif torch.Tag.pointwise in func.tags or func in _ELEMENTWISE:
        kind, arg = "elementwise", 1
    else:
        kind, arg = "elementwise", 0
    writes = any(getattr(a.alias_info, "is_write", False)
                 for a in func._schema.arguments)
    return _Rule(kind, arg, str(func.overloadpacket), writes)


# memos: an operation's rule and a scope path's class, each a pure
# function of its key
_RULES: Dict[object, _Rule] = {}
_CLASSES: Dict[str, str] = {}


def _rule(func) -> _Rule:
    rule = _RULES.get(func)
    if rule is None:
        rule = _RULES[func] = _rule_of(func)
    return rule


def op_cost(func, args, kwargs, out) -> Tuple[float, float]:
    """One dispatched operation's ``(flops, bytes)`` under the module
    docstring's rules."""
    rule = _rule(func)
    outs = _tensors(out)
    if rule.kind == "scatter":
        upd = args[rule.arg] if len(args) > rule.arg else None
        return 0.0, 2.0 * (_nbytes(upd) if isinstance(upd, torch.Tensor)
                           else sum(_nbytes(t) for t in outs))
    out_n = sum(t.numel() for t in outs)
    if rule.kind == "gather":
        return float(out_n), 2.0 * sum(_nbytes(t) for t in outs)
    seen = {}
    for t in _tensors((args, kwargs)) + outs:
        seen[id(t)] = _nbytes(t)
    nbytes = float(sum(seen.values()))
    if rule.kind == "product":
        flops = float(flop_registry[func.overloadpacket](
            *args, **(kwargs or {}), out_val=out))
        return flops + (out_n if rule.arg else 0), nbytes
    return float(rule.arg * out_n), nbytes


@dataclasses.dataclass
class Launches:
    """A census's launches: ``per_class`` every launch by kernel class,
    the hand-written kernels' among them also by kernel name
    (``kernels``)."""
    per_class: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    kernels: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))

    @property
    def total(self) -> int:
        return sum(self.per_class.values())


class Dispatched(NamedTuple):
    """A call's dispatch census (:func:`census_of`)."""
    census: OpCensus
    launches: Launches
    temp_bytes: int


class DispatchCensus(TorchDispatchMode):
    """Census every operation dispatched on this thread while active
    (module docstring): ``census`` (:class:`OpCensus`), ``launches``
    (:class:`Launches`), ``ops`` (launches by ``(class, operation)``),
    and ``peak`` (the most bytes of storages allocated inside, and alive,
    at once)."""

    def __init__(self):
        super().__init__()
        self.census = OpCensus()
        self.launches = Launches()
        self.ops: Dict[Tuple[str, str], int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self._outer = None

    def __enter__(self):
        self._outer = set_census(self)
        return super().__enter__()

    def __exit__(self, *exc):
        set_census(self._outer)
        return super().__exit__(*exc)

    # ----------------------------------------------------------- counts --
    def _count(self, cls: str, name: str, flops: float, nbytes: float):
        cc = self.census.per_class[cls]
        cc.flops += flops
        cc.bytes += nbytes
        self.census.flops += flops
        self.census.bytes += nbytes
        self.launches.per_class[cls] += 1
        self.ops[(cls, name)] += 1

    def _hold(self, t: torch.Tensor, nbytes: int, known=()):
        """Count ``t``'s storage as allocated here until it dies (once;
        never a storage the operation was given)."""
        s = _storage(t)
        if s is None:
            return
        key = s._cdata
        if key in self._held or key in known:
            return
        self._held[key] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int):
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = _rule(func)
        if rule.kind != "view" and not rule.in_place:
            # (a view or an in-place operation returns storage it was
            # given)
            outs = _tensors(out)
            if outs:
                known = set()
                for t in _tensors((args, kwargs)):
                    s = _storage(t)
                    if s is not None:
                        known.add(s._cdata)
                for t in outs:
                    s = _storage(t)
                    if s is not None:
                        self._hold(t, s.nbytes(), known)
        if rule.kind in ("view", "alloc"):
            return out
        flops, nbytes = op_cost(func, args, kwargs, out)
        path = scope_path()
        cls = _CLASSES.get(path)
        if cls is None:
            cls = _CLASSES[path] = classify(path)
        self._count(cls, rule.name, flops, nbytes)
        return out

    def collective(self, kind: str, nbytes: float):
        """One collective (``"all-reduce"``, ``"all-gather"``) moving
        ``nbytes`` (:mod:`repro_torch.distributed`'s count), class
        ``collective``."""
        c = self.census
        c.coll_bytes += nbytes
        c.per_collective[kind] += nbytes
        c.per_class["collective"].coll_bytes += nbytes
        self.launches.per_class["collective"] += 1
        self.ops[("collective", kind)] += 1

    def kernel(self, name: str, cost: KernelCost, out):
        """One launch of hand-written kernel ``name`` (class
        ``attention``) that returned ``out``: its cost counted, its
        output held as allocated here, its scratch at the peak while it
        ran."""
        self._count("attention", name, cost.flops, cost.bytes)
        self.launches.kernels[name] += 1
        self.peak = max(self.peak, self.live + int(cost.scratch))
        for t in _tensors(out):
            self._hold(t, _nbytes(t))

    def result(self) -> Dispatched:
        """The census so far, with plain dicts (the reference's
        ``census()``), the launches and the peak."""
        c = self.census
        return Dispatched(
            OpCensus(flops=c.flops, bytes=c.bytes, coll_bytes=c.coll_bytes,
                     per_class={k: dataclasses.replace(v)
                                for k, v in c.per_class.items()},
                     per_collective=dict(c.per_collective)),
            Launches(dict(self.launches.per_class),
                     dict(self.launches.kernels)),
            self.peak)


def census_of(fn: Callable, *args, **kwargs) -> Dispatched:
    """``fn(*args, **kwargs)`` under a :class:`DispatchCensus`:
    ``(census, launches, temp_bytes)``, ``temp_bytes`` the peak of the
    storages the call allocated alive at once (the counterpart of
    ``memory_from_compiled``'s ``temp_bytes``). ``fn``'s result is
    dropped."""
    with DispatchCensus() as cen:
        fn(*args, **kwargs)
    return cen.result()
