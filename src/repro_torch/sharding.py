"""Logical-axis sharding rules with a divisibility fallback (a copy of
``repro.sharding``'s rules, over the port's
:class:`~repro_torch.launch.mesh.Mesh`).

Every parameter, cache and batch leaf declares a *logical* axis name a
dimension. ``ShardingRules`` maps each name to candidate mesh-axis
assignments; the first whose mesh size divides the dimension wins, else
the dimension is replicated, and a mesh axis is used at most once a
tensor. E.g. ``qwen2.5-3b``'s 2 KV heads fail ``kv_heads -> model`` on a
16-wide model axis, and the KV *sequence* dim takes the model axis
instead (``shard_kv_seq``).

:meth:`ShardingRules.spec` returns the port's ``PartitionSpec``: a plain
tuple with one entry a dimension, ``None`` (replicated), a mesh axis
name, or a tuple of names. :func:`shard_shape` is one device's block of a
tensor under a spec, :func:`shard_leaf` and :func:`shard_tree` a rank's
block of the tensors themselves (JAX's ``NamedSharding`` convention:
device ``i`` along an axis holds block ``i``).

What runs across cards (:mod:`repro_torch.distributed`) is the
reference's ``act_replicated=True`` layout, the Megatron one: norms,
learned positions and the residual stream replicated, ``wq/wk/wv``,
``w1/w3`` and the vocab of ``tok``/``unemb`` column-sharded, ``wo`` and
``w2`` row-sharded; :func:`check_executable` refuses the rest. The
reference's ``constrain`` has no counterpart: the collectives that keep
the residual stream replicated are written into the layers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, multi_card_item

AxisAssignment = Union[str, Tuple[str, ...], None]
PartitionSpec = Tuple[AxisAssignment, ...]

# the logical axis vocabulary
BATCH = "batch"
SEQ = "seq"              # query/sequence dim of activations (unsharded)
KV_SEQ = "kv_seq"        # KV-cache sequence dim (model axis if heads miss it)
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"    # fallback shard target when heads % model != 0
D_MODEL = "d_model"
D_FF = "d_ff"
W_IN = "w_in"            # weight input dim: data-axes sharded under fsdp
VOCAB = "vocab"
EXPERTS = "experts"
SSM_HEADS = "ssm_heads"
CONV_CH = "conv_ch"
LAYERS = "layers"        # stacked-layer leading dim (never sharded)
STATE = "state"


def axes_of(assignment: AxisAssignment) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if assignment is None:
        return ()
    return (assignment,) if isinstance(assignment, str) else \
        tuple(assignment)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axes, with per-tensor fallback."""
    mesh: Mesh
    # data-parallel axes, e.g. ("data",) or ("pod", "data")
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    # shard the KV cache's sequence dim on the model axis (when kv_heads
    # does not divide it)
    shard_kv_seq: bool = False
    # weights also shard their input dim over the batch axes (ZeRO-3)
    fsdp: bool = False
    # activations feature-replicated between blocks (classic Megatron)
    act_replicated: bool = False

    def axis_size(self, assignment: AxisAssignment) -> int:
        return math.prod(self.mesh.shape[a] for a in axes_of(assignment))

    def candidates(self, logical: Optional[str]
                   ) -> Sequence[AxisAssignment]:
        m, b = self.model_axis, self.batch_axes
        table: Dict[str, Sequence[AxisAssignment]] = {
            BATCH: (b, None),
            SEQ: (None,),
            KV_SEQ: ((m,) if self.shard_kv_seq else (None,)),
            HEADS: (m, None),
            KV_HEADS: ((None,) if self.shard_kv_seq else (m, None)),
            HEAD_DIM: (m, None),
            D_MODEL: ((None,) if self.act_replicated else (m, None)),
            D_FF: (m, None),
            W_IN: ((b, None) if self.fsdp else (None,)),
            VOCAB: (m, None),
            EXPERTS: (b, None),
            SSM_HEADS: (m, None),
            CONV_CH: (m, None),
            STATE: (None,),
            LAYERS: (None,),
        }
        if logical is None:
            return (None,)
        return table[logical]

    def assign(self, logical: Optional[str], dim: int) -> AxisAssignment:
        for cand in self.candidates(logical):
            if cand is None:
                return None
            if dim % self.axis_size(cand) == 0:
                return cand
        return None

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> PartitionSpec:
        """The spec of a tensor with these logical axes and shape."""
        if len(logical_axes) != len(shape):
            raise ValueError(f"logical axes {tuple(logical_axes)} do not "
                             f"match shape {tuple(shape)}")
        used: set = set()
        out = []
        for name, dim in zip(logical_axes, shape):
            a = self.assign(name, dim)
            # a mesh axis may appear at most once in a spec
            flat = axes_of(a)
            if a is not None and any(x in used for x in flat):
                a = None
            else:
                used.update(flat)
            # one axis as its name, as a PartitionSpec holds it
            out.append(a[0] if isinstance(a, tuple) and len(a) == 1 else a)
        return tuple(out)


def shard_shape(spec: PartitionSpec, shape: Sequence[int],
                mesh: Mesh) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` under ``spec`` (the
    reference's ``NamedSharding.shard_shape``); a dimension its mesh axes
    do not divide raises."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape "
                         f"{tuple(shape)}")
    out = []
    for i, dim in enumerate(shape):
        n = math.prod(mesh.shape[a] for a in axes_of(spec[i])) \
            if i < len(spec) else 1
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} ({dim}) does not "
                             f"divide over {spec[i]} ({n})")
        out.append(dim // n)
    return tuple(out)


def rules_for(mesh: Mesh, *, shard_kv_seq: bool = False,
              fsdp: bool = False,
              act_replicated: bool = False) -> ShardingRules:
    """Rules over ``mesh``, its batch axes read off the axis names."""
    names = tuple(mesh.axis_names)
    batch_axes = tuple(n for n in names if n in ("pod", "data"))
    if "model" not in names:
        raise ValueError(f"mesh must have a 'model' axis, got {names}")
    return ShardingRules(mesh=mesh, batch_axes=batch_axes or (names[0],),
                         shard_kv_seq=shard_kv_seq, fsdp=fsdp,
                         act_replicated=act_replicated)


def mesh_coords(mesh: Mesh, rank: int) -> Dict[str, int]:
    """Device ``rank``'s (row-major in ``mesh.devices``) index along
    each mesh axis."""
    idx = np.unravel_index(rank, tuple(mesh.shape.values()))
    return {a: int(i) for a, i in zip(mesh.axis_names, idx)}


def shard_leaf(t: torch.Tensor, spec: PartitionSpec, mesh: Mesh,
               rank: int) -> torch.Tensor:
    """Device ``rank``'s contiguous block of ``t`` under ``spec``, a copy
    of its own (the whole tensor can then be freed)."""
    coords = mesh_coords(mesh, rank)
    block = shard_shape(spec, t.shape, mesh)
    out = t
    for dim, assignment in enumerate(spec):
        axes = axes_of(assignment)
        if not axes:
            continue
        i = 0
        for a in axes:                 # the axes' combined index, major first
            i = i * mesh.shape[a] + coords[a]
        out = out.narrow(dim, i * block[dim], block[dim])
    return out.clone(memory_format=torch.contiguous_format)


def shard_tree(specs, tree, rules: ShardingRules, rank: int):
    """``tree`` (leaves matching ``specs``, a tree of
    :class:`~repro_torch.models.params.ParamSpec`) with every leaf cut to
    device ``rank``'s block; a leaf already at its block's shape is kept
    as it is (no copy), any other shape raises."""
    if isinstance(specs, dict):
        if set(specs) != set(tree):
            raise ValueError(f"tree keys differ: {sorted(specs)} vs "
                             f"{sorted(tree)}")
        return {k: shard_tree(specs[k], tree[k], rules, rank) for k in specs}
    if isinstance(specs, (list, tuple)):
        if len(specs) != len(tree):
            raise ValueError("tree lists differ in length")
        return type(specs)(shard_tree(s, t, rules, rank)
                           for s, t in zip(specs, tree))
    spec = rules.spec(specs.logical, specs.shape)
    shape = tuple(tree.shape)
    block = shard_shape(spec, specs.shape, rules.mesh)
    if shape == block:          # already the block (every leaf on 1 x 1)
        return tree
    if shape == specs.shape:
        return shard_leaf(tree, spec, rules.mesh, rank)
    raise ValueError(f"leaf of shape {shape} is neither {specs.shape} nor "
                     f"its block under {spec}")


def check_executable(cfg, rules: ShardingRules):
    """Refuse what is not executed across cards (each refusal names its
    ROADMAP item): a data axis of more than one device, and on a model
    axis of more than one a family other than the dense decoder (with or
    without a sliding window), the default rules' d_model-sharded
    residual, and any head, KV-head, d_ff or vocab count the model axis
    does not divide (the reference's head-dim and replication
    fallbacks)."""
    data = math.prod(rules.mesh.shape[a] for a in rules.batch_axes
                     if a in rules.mesh.shape)
    if data > 1:
        raise NotImplementedError(
            f"a mesh of {data} devices along its batch axes inside one "
            f"model ({multi_card_item('data')})")
    m = rules.mesh.shape[rules.model_axis]
    if m == 1:
        return
    if cfg.arch_type not in ("dense",) or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.arch_type}{', MoE' if cfg.moe else ''}) "
            f"over a model axis of {m} ({multi_card_item('families')})")
    if rules.fsdp:
        raise NotImplementedError(
            f"FSDP over a model axis of {m} ({multi_card_item('data')})")
    if not rules.act_replicated or rules.shard_kv_seq:
        raise NotImplementedError(
            f"only the act_replicated rules (a replicated residual, no "
            f"KV-sequence sharding) run over a model axis of {m} "
            f"({multi_card_item('rules')})")
    for name, n in (("n_heads", cfg.n_heads), ("n_kv_heads",
                                               cfg.n_kv_heads),
                    ("d_ff", cfg.d_ff), ("padded_vocab", cfg.padded_vocab)):
        if n % m:
            raise NotImplementedError(
                f"{cfg.name}: {name} {n} does not divide over a model axis "
                f"of {m} ({multi_card_item('rules')})")
