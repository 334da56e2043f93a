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
tensor under a spec. The reference's ``constrain`` (an activation's
sharding inside a jitted program) has no counterpart while the model
runs on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.launch.mesh import Mesh

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
