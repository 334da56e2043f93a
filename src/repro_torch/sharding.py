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
tensor under a spec, :func:`spec_ranges` a rank's block of a leaf,
:func:`cut_leaf` and :func:`shard_tree` the tensors themselves (JAX's
``NamedSharding`` convention: device ``i`` along an axis holds block
``i``).

What runs across cards (:mod:`repro_torch.distributed`) is a dense
decoder on any ``D x M`` mesh under any rules :func:`rules_for` gives:
the ``act_replicated`` (Megatron) layout, the default rules' d_model-
sharded residual, ``attn_row_parallel``'s row-sharded ``wq/wk/wv``, the
head-dim and replication fallbacks and ``shard_kv_seq`` on the model
axis; on the data axis each rank's block of the batch rows (``BATCH ->
data``) and, under ``fsdp``, each weight's block of its ``W_IN`` dim,
gathered whole a layer. :func:`check_executable` refuses the rest.
:func:`layout_for` reads off the rules' specs what a config runs under
(:class:`Layout`), and every layer reads that plan.
The reference's ``constrain`` has no counterpart: the collectives that
keep each activation in its layout are written into the layers.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, multi_card_item

AxisAssignment = Union[str, Tuple[str, ...], None]
PartitionSpec = Tuple[AxisAssignment, ...]
Range = Tuple[int, int]

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


def cut_leaf(t: torch.Tensor, ranges: Sequence[Range]) -> torch.Tensor:
    """``t`` narrowed to ``[first, end)`` in each dim, a copy of its own
    (the whole tensor can then be freed)."""
    for dim, (a, b) in enumerate(ranges):
        if (a, b) != (0, t.shape[dim]):
            t = t.narrow(dim, a, b - a)
    return t.clone(memory_format=torch.contiguous_format)


def shard_tree(specs, tree, rules: ShardingRules, rank: int,
               layout: Optional["Layout"] = None):
    """``tree`` (leaves matching ``specs``, a tree of
    :class:`~repro_torch.models.params.ParamSpec`) with every leaf cut to
    device ``rank``'s block (``layout``'s :meth:`Layout.cut` where
    given, else the spec's, :func:`spec_ranges`); a leaf already at its
    block's shape is kept
    as it is (no copy), any other shape raises."""
    if isinstance(specs, dict):
        if set(specs) != set(tree):
            raise ValueError(f"tree keys differ: {sorted(specs)} vs "
                             f"{sorted(tree)}")
        return {k: shard_tree(specs[k], tree[k], rules, rank, layout)
                for k in specs}
    if isinstance(specs, (list, tuple)):
        if len(specs) != len(tree):
            raise ValueError("tree lists differ in length")
        return type(specs)(shard_tree(s, t, rules, rank, layout)
                           for s, t in zip(specs, tree))
    ranges = layout.cut(specs.logical, specs.shape, rules) \
        if layout is not None else \
        spec_ranges(specs.logical, specs.shape, rules, rank)
    shape = tuple(tree.shape)
    block = tuple(b - a for a, b in ranges)
    if shape == block:          # already the block (every leaf on 1 x 1)
        return tree
    if shape == specs.shape:
        return cut_leaf(tree, ranges)
    raise ValueError(f"leaf of shape {shape} is neither {specs.shape} nor "
                     f"its block {block}")


def spec_ranges(logical: Sequence[Optional[str]], shape: Sequence[int],
                rules: ShardingRules, rank: int) -> List[Range]:
    """Device ``rank``'s ``[first, end)`` of each dim of a tensor with
    these logical axes and shape: its spec's block."""
    spec = rules.spec(logical, shape)
    block = shard_shape(spec, shape, rules.mesh)
    coords = mesh_coords(rules.mesh, rank)
    out = []
    for dim, assignment in enumerate(spec):
        i = 0
        for a in axes_of(assignment):
            i = i * rules.mesh.shape[a] + coords[a]
        out.append((i * block[dim], (i + 1) * block[dim]))
    return out


def data_size(rules: ShardingRules) -> int:
    """The devices along the rules' batch axes: the data ranks a batch's
    rows are split over."""
    return math.prod(rules.mesh.shape[a] for a in rules.batch_axes
                     if a in rules.mesh.shape)


def check_executable(cfg, rules: ShardingRules):
    """Refuse what is not executed across cards (each refusal names its
    ROADMAP item): a family other than the dense decoder (with or
    without a sliding window) over more than one device, on the data
    axis or the model axis. Any rules run for it, every count through
    the reference's fallbacks (:func:`layout_for`), FSDP included."""
    data = data_size(rules)
    m = rules.mesh.shape[rules.model_axis]
    if cfg.arch_type == "dense" and cfg.moe is None:
        return
    what = f"{cfg.name} ({cfg.arch_type}{', MoE' if cfg.moe else ''})"
    if data > 1:
        raise NotImplementedError(
            f"{what} over a data axis of {data} "
            f"({multi_card_item('data')})")
    if m > 1:
        raise NotImplementedError(
            f"{what} over a model axis of {m} "
            f"({multi_card_item('families')})")


@dataclasses.dataclass(frozen=True)
class Layout:
    """What a dense decoder runs under given rules on one rank of the
    model axis (:func:`layout_for`): each entry read off the rules' spec
    of a parameter, so the plan is never written a second time.

    ``residual``: the residual stream between blocks (and each norm's
    scale and bias, the learned positions) holds the rank's block of
    d_model (the default rules over more than one device); else it is
    replicated. Each weight names the dim the model axis shards, or
    ``"full"``: ``wq`` ``"rows"`` (its d_model input:
    ``attn_row_parallel`` under the default rules, partial sums
    all-reduced), ``"heads"`` or ``"head_dim"`` (the head-dim fallback,
    all-gathered before the attention math); ``wkv`` likewise, or
    ``"held"``: where the KV heads fall back while the query heads are
    sharded, ``wk/wv`` (their biases, the K/V cache and the pool) hold
    the KV heads the rank's query heads read, whole (a departure from
    the reference's hd-sharded or replicated block: the hd-sharded one
    would need an all-gather of ``k/v`` a layer); ``wo``
    ``"heads"``, ``"head_dim"`` or ``"d_model"`` (its output: the
    rank's block of the residual, no reduction). ``heads`` are the query
    heads the rank's projection yields, ``attn_heads`` those a prefill's
    attention (and a decode's, unless ``kv_seq``) runs over, ``kv_heads``
    the KV heads the rank holds, ``[first, end)`` each. ``kv_seq``: the
    KV cache's sequence on the model axis (``shard_kv_seq`` over more
    than one device): each rank holds every KV head for its share of
    each block's rows, and a decode combines the ranks' softmax
    partials. ``ffn``: d_ff sharded (else the MLP is replicated).
    ``tok``/``logits``: the embedding's and the unembedding weight's
    sharded dim (``"vocab"``, ``"d_model"`` or ``"full"``).

    ``size``/``rank``: the model axis's devices and the rank's place on
    it; ``data``/``data_rank``: the batch axes' (a ``BATCH`` leaf's spec:
    data rank ``d`` serves rows ``[d * B/D, (d + 1) * B/D)``,
    :meth:`rows`); ``device``: the rank's place in the whole mesh, whose
    coordinates cut every leaf. ``w_in``: under ``fsdp`` over more than
    one data rank, each weight whose ``W_IN`` dim the data axes shard,
    with that dim in one layer's leaf (``wq``, ``wk``, ``wv`` 0, ``wo``
    2, ``w1``, ``w3`` 0, ``w2`` 1, ``unemb`` 0): the rank holds its block
    and the layers gather it whole over the data axis just before the
    matmul that reads it (:func:`~repro_torch.distributed.
    gather_weight`); empty otherwise."""
    size: int
    rank: int
    residual: bool
    wq: str
    wkv: str
    wo: str
    heads: Range
    attn_heads: Range
    attn_kv: Range
    kv_heads: Range
    kv_seq: bool
    ffn: bool
    tok: str
    logits: str
    data: int = 1
    data_rank: int = 0
    device: int = 0
    w_in: Tuple[Tuple[str, int], ...] = ()

    def block(self, n: int) -> Range:
        """``[first, end)`` of the rank's block of ``n``."""
        c = n // self.size
        return self.rank * c, (self.rank + 1) * c

    def rows(self, n: int) -> Range:
        """``[first, end)`` of the rank's block of ``n`` batch rows (all of
        them with one data rank)."""
        c = n // self.data
        return self.data_rank * c, (self.data_rank + 1) * c

    def gathered(self, name: str) -> Optional[int]:
        """The dim of weight ``name`` (a layer's leaf) the layers gather
        over the data axis (FSDP), or None."""
        return dict(self.w_in).get(name)

    def cut(self, logical: Sequence[Optional[str]], shape: Sequence[int],
            rules: ShardingRules) -> List[Range]:
        """The rank's ``[first, end)`` of each dim of a leaf: its spec's
        block, except that a cache or pool leaf (it has ``KV_SEQ``) holds
        the rank's KV heads whole (and its share of the sequence under
        ``kv_seq``), and a KV-head leaf under ``"held"`` (``wk``, ``wv``,
        ``bk``, ``bv``) the KV heads the rank holds, whole. Where the
        spec would shard the head dim instead, these are departures. A
        cache leaf's batch rows are the rank's data block."""
        if KV_SEQ in logical or (self.wkv == "held" and KV_HEADS in logical):
            out = [(0, n) for n in shape]
            out[list(logical).index(KV_HEADS)] = self.kv_heads
            if KV_SEQ in logical and self.kv_seq:
                d = list(logical).index(KV_SEQ)
                out[d] = self.block(shape[d])
            if BATCH in logical:
                d = list(logical).index(BATCH)
                out[d] = spec_ranges((BATCH,), (shape[d],), rules,
                                     self.device)[0]
            return out
        return spec_ranges(logical, shape, rules, self.device)


def _sharded_dim(rules: ShardingRules, leaf) -> Optional[int]:
    """The dim of a :class:`~repro_torch.models.params.ParamSpec` leaf
    its spec puts on the model axis (whatever the axis's size), if any."""
    spec = rules.spec(leaf.logical, leaf.shape)
    return next((i for i, a in enumerate(spec)
                 if rules.model_axis in axes_of(a)), None)


def _data_dim(rules: ShardingRules, leaf) -> Optional[int]:
    """The dim of a leaf its spec puts on the batch axes, if any."""
    spec = rules.spec(leaf.logical, leaf.shape)
    return next((i for i, a in enumerate(spec)
                 if set(axes_of(a)) & set(rules.batch_axes)), None)


def layout_for(cfg, rules: ShardingRules, device: int) -> Layout:
    """The plan of what ``cfg`` runs under ``rules`` on device ``device``
    of the mesh (:class:`Layout`), read off the specs of its parameters
    and of a batch. A dim over an axis of one device is kept as the
    ``act_replicated`` layout keeps it, and the residual is sharded only
    over more than one (so a world of one computes as the plain model,
    bit for bit); ``shard_kv_seq`` holds at any size."""
    from repro_torch.configs.base import ATTN
    from repro_torch.models.params import (attn_specs, block_specs,
                                           param_specs)
    m = rules.mesh.shape[rules.model_axis]
    rank = mesh_coords(rules.mesh, device)[rules.model_axis] \
        if rules.model_axis in rules.mesh.shape else 0
    data = data_size(rules)
    data_rank = spec_ranges((BATCH,), (data,), rules, device)[0][0]
    specs = param_specs(cfg)
    attn = attn_specs(cfg)
    dim = functools.partial(_sharded_dim, rules)
    wq = {0: "rows", 1: "heads", 2: "head_dim", None: "full"}[
        dim(attn["wq"])]
    wkv = {0: "rows", 1: "heads", 2: "head_dim", None: "full"}[
        dim(attn["wk"])]
    wo = {0: "heads", 1: "head_dim", 2: "d_model", None: "full"}[
        dim(attn["wo"])]
    h, k = cfg.n_heads, cfg.n_kv_heads
    g = h // k
    kv_seq = rules.shard_kv_seq
    heads = (0, h)
    if h % m == 0:
        n = h // m
        heads = (rank * n, (rank + 1) * n)
    # attention runs over the rank's heads where they read whole KV heads
    # or a share of one (the kernels' uniform grouping), else over all
    n = heads[1] - heads[0]
    attn_heads = heads if n % g == 0 or g % n == 0 else (0, h)
    attn_kv = (attn_heads[0] // g, (attn_heads[1] - 1) // g + 1)
    kv_heads = (0, k) if kv_seq else attn_kv
    if wkv in ("head_dim", "full") and kv_heads != (0, k):
        wkv = "held"
    tok_dim = dim(specs["embed"]["tok"])
    tok = {0: "vocab", 1: "d_model", None: "full"}[tok_dim]
    if cfg.tie_embeddings:
        logits = tok
    else:
        logits = "vocab" if dim(specs["embed"]["unemb"]) == 1 else "full"
    w_in = []
    if data > 1:
        ffn = block_specs(cfg, ATTN)["ffn"]
        leaves = {**attn, **ffn}
        if not cfg.tie_embeddings:
            leaves["unemb"] = specs["embed"]["unemb"]
        w_in = [(name, d) for name, leaf in leaves.items()
                if (d := _data_dim(rules, leaf)) is not None]
    return Layout(
        size=m, rank=rank,
        residual=m > 1 and dim(specs["final_norm"]["scale"]) == 0,
        wq=wq, wkv=wkv, wo=wo, heads=heads, attn_heads=attn_heads,
        attn_kv=attn_kv, kv_heads=kv_heads, kv_seq=kv_seq,
        ffn=dim(block_specs(cfg, ATTN)["ffn"]["w1"]) == 1,
        tok=tok, logits=logits, data=data, data_rank=data_rank,
        device=device, w_in=tuple(w_in))
