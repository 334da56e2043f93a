"""Parameter declaration, initialisation and the weight bridge.

``param_specs(cfg)`` declares every parameter with the reference's
shapes, dtypes, init styles and fan-ins (``repro.models.model``
``abstract_params`` and ``repro.models.params`` ``pspec``/``materialize``):
the tree is ``{"embed", "stack", "rem", ["shared"], "final_norm"}``.
``cfg.block_plan()`` is cut into one period of block kinds
(:func:`plan_structure`), repeated ``n_rep`` times, and a remainder:
``stack`` holds one dict a slot of the period, whose leaves carry a
leading ``n_rep`` dimension, ``rem`` one unstacked dict a remainder
block, and ``shared`` the one attention block a hybrid's
``SHARED_ATTN`` occurrences all use (their own ``stack`` slot is empty).
A block is ``{"ln1", "attn", "ln2", "ffn"}`` (``ffn`` the MoE leaves in
an MoE config's ``ATTN`` blocks; a VLM's ``CROSS`` blocks have the same
tree with a dense MLP) or, for ``SSM``, ``{"ln1", "ssm"}``.

``init_params`` fills that tree from a ``torch.Generator`` on the target
device; ``params_from_numpy`` carries a reference parameter tree (as
numpy) across unchanged, so both packages can run on the same weights,
``params_to_numpy`` carries one back, and ``cache_from_numpy`` does the
same for a reference decode cache. numpy has no bfloat16: a bfloat16
leaf crosses as 2-byte words (``|V2``, as ``np.load`` reads the
reference's bfloat16 arrays back). ``parameter_tree`` makes the tree's
leaves the model's parameters (what training differentiates, the
optimizer updates and a checkpoint saves), and ``tree_leaves`` lists
them under the reference's flat checkpoint keys.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import (ATTN, CROSS, SHARED_ATTN, SSM,
                                      ArchConfig)
from repro_torch.sharding import (BATCH, CONV_CH, D_FF, D_MODEL, EXPERTS,
                                  HEAD_DIM, HEADS, KV_HEADS, KV_SEQ, LAYERS,
                                  SSM_HEADS, STATE, VOCAB, W_IN, cut_leaf,
                                  layout_for, spec_ranges)

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # a logical axis a dim (sharding)
    init: str = "normal"          # normal | zeros | ones | a_log | dt_bias
    fan_in: int = 0               # scale of the normal init: 1/sqrt(fan_in)
    dtype: Optional[str] = None   # None: the config's dtype


def _spec(shape, logical, init="normal", fan_in=0, dtype=None) -> ParamSpec:
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical axes "
                         f"{tuple(logical)} differ in rank")
    # the reference's default fan-in: the second-to-last dim
    return ParamSpec(tuple(int(s) for s in shape), tuple(logical), init,
                     fan_in or (shape[-2] if len(shape) >= 2 else shape[-1]),
                     dtype)


def plan_structure(cfg: ArchConfig) -> Tuple[Tuple[str, ...], int, int]:
    """``(slots of one period, n_rep, n_remainder)`` of the block plan
    (the reference's ``plan_structure``): a hybrid's period is
    ``attn_every`` blocks, a VLM's ``cross_every``, every other plan's
    one block."""
    plan = cfg.block_plan()
    p = {"hybrid": cfg.attn_every, "vlm": cfg.cross_every}.get(
        cfg.arch_type, 1)
    n_rep = cfg.n_layers // p
    return plan[:p], n_rep, cfg.n_layers - n_rep * p


def layer_sources(cfg: ArchConfig) -> List[Tuple[str, int, Optional[int]]]:
    """Each layer's ``(kind, index, rep)`` in plan order: ``("stack", j,
    r)`` for slot ``j`` of period ``r``, ``("rem", i, None)`` for the
    ``i``-th remainder block; where its parameters (and a reference
    cache's entry) live."""
    slots, n_rep, rem = plan_structure(cfg)
    out = [("stack", j, r) for r in range(n_rep) for j in range(len(slots))]
    return out + [("rem", i, None) for i in range(rem)]


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """``(d_inner, ssm heads, conv channels)`` (the reference's
    ``ssm._dims``)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, d_in + 2 * s.ngroups * s.d_state


def _norm_specs(cfg: ArchConfig) -> Tree:
    p = {"scale": _spec((cfg.d_model,), (D_MODEL,), "ones")}
    if cfg.norm == "layernorm":
        p["bias"] = _spec((cfg.d_model,), (D_MODEL,), "zeros")
    return p


def attn_specs(cfg: ArchConfig) -> Tree:
    """Column-parallel QKV (heads on the model axis where they divide it,
    else head_dim), a row-parallel output projection; with
    ``attn_row_parallel`` the d_model (input) dim is sharded instead."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.attn_row_parallel:
        din, hdim, dout = D_MODEL, None, D_MODEL
    else:
        din, hdim, dout = W_IN, HEAD_DIM, W_IN
    attn = {"wq": _spec((d, h, hd), (din, HEADS, hdim), fan_in=d),
            "wk": _spec((d, k, hd), (din, KV_HEADS, hdim), fan_in=d),
            "wv": _spec((d, k, hd), (din, KV_HEADS, hdim), fan_in=d),
            "wo": _spec((h, hd, d), (HEADS, hdim, dout), fan_in=h * hd)}
    if cfg.qkv_bias:
        attn["bq"] = _spec((h, hd), (HEADS, None), "zeros")
        attn["bk"] = _spec((k, hd), (KV_HEADS, None), "zeros")
        attn["bv"] = _spec((k, hd), (KV_HEADS, None), "zeros")
    return attn


def _mlp_specs(cfg: ArchConfig) -> Tree:
    """Megatron column -> row parallel: w1/w3 shard d_ff, w2 contracts
    over it."""
    d, f = cfg.d_model, cfg.d_ff
    ffn = {"w1": _spec((d, f), (W_IN, D_FF)),
           "w2": _spec((f, d), (D_FF, W_IN), fan_in=f)}
    if cfg.act == "swiglu":
        ffn["w3"] = _spec((d, f), (W_IN, D_FF))
    return ffn


def _moe_specs(cfg: ArchConfig) -> Tree:
    """Experts over the batch axes (expert parallel), d_ff over the model
    axis, d_model replicated."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": _spec((d, e), (None, None), dtype="float32"),
         "w1": _spec((e, d, f), (EXPERTS, None, D_FF), fan_in=d),
         "w2": _spec((e, f, d), (EXPERTS, D_FF, None), fan_in=f)}
    if cfg.act == "swiglu":
        p["w3"] = _spec((e, d, f), (EXPERTS, None, D_FF), fan_in=d)
    if cfg.moe.dense_residual:
        p["dense"] = _mlp_specs(cfg)
    return p


def _ssm_specs(cfg: ArchConfig) -> Tree:
    s, d = cfg.ssm, cfg.d_model
    d_in, nh, conv_ch = ssm_dims(cfg)
    total = 2 * d_in + 2 * s.ngroups * s.d_state + nh
    return {"in_proj": _spec((d, total), (D_MODEL, W_IN), fan_in=d),
            "conv_w": _spec((s.conv_width, conv_ch), (None, CONV_CH),
                            fan_in=s.conv_width),
            "conv_b": _spec((conv_ch,), (CONV_CH,), "zeros"),
            "a_log": _spec((nh,), (SSM_HEADS,), "a_log", dtype="float32"),
            "d_skip": _spec((nh,), (SSM_HEADS,), "ones", dtype="float32"),
            "dt_bias": _spec((nh,), (SSM_HEADS,), "dt_bias",
                             dtype="float32"),
            "norm": _spec((d_in,), (D_MODEL,), "ones"),
            # row-parallel: contracts over the head-sharded d_in
            "out_proj": _spec((d_in, d), (D_FF, W_IN), fan_in=d_in)}


def block_specs(cfg: ArchConfig, kind: str) -> Tree:
    """One block's parameters by kind (the reference's
    ``block_abstract``); a ``SHARED_ATTN`` block holds none of its own."""
    if kind == SSM:
        return {"ln1": _norm_specs(cfg), "ssm": _ssm_specs(cfg)}
    if kind == SHARED_ATTN:
        return {}
    ffn = _moe_specs(cfg) if cfg.moe is not None and kind == ATTN \
        else _mlp_specs(cfg)
    return {"ln1": _norm_specs(cfg), "attn": attn_specs(cfg),
            "ln2": _norm_specs(cfg), "ffn": ffn}


def _stacked(tree: Tree, n: int) -> Tree:
    return map_tree(lambda s: dataclasses.replace(
        s, shape=(n,) + s.shape, logical=(LAYERS,) + s.logical), tree)


def param_specs(cfg: ArchConfig) -> Tree:
    cfg.validate()
    vp, d = cfg.padded_vocab, cfg.d_model
    embed = {"tok": _spec((vp, d), (VOCAB, D_MODEL), fan_in=d)}
    if cfg.pos == "learned":
        embed["pos"] = _spec((cfg.max_position, d), (None, D_MODEL),
                             fan_in=d)
    if not cfg.tie_embeddings:
        # vocab (output) sharded: logits never replicate over V
        embed["unemb"] = _spec((d, vp), (W_IN, VOCAB))
    slots, n_rep, _ = plan_structure(cfg)
    plan = cfg.block_plan()
    tree = {"embed": embed,
            "stack": [_stacked(block_specs(cfg, k), n_rep) for k in slots],
            "rem": [block_specs(cfg, k) for k in plan[n_rep * len(slots):]]}
    if SHARED_ATTN in plan:
        tree["shared"] = {"ln1": _norm_specs(cfg), "attn": attn_specs(cfg),
                          "ln2": _norm_specs(cfg), "ffn": _mlp_specs(cfg)}
    tree["final_norm"] = _norm_specs(cfg)
    return tree


def map_tree(fn, tree):
    """``tree`` (nested dicts, lists and tuples) with ``fn`` applied to
    every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def _path(prefix: str, k) -> str:
    return f"{prefix}/{k}" if prefix else str(k)


def tree_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Every leaf with its path, in the order and spelling of the
    reference's flat checkpoint keys (``jax.tree_util``'s: dict keys
    sorted, list and tuple indices, ``/`` between the parts)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [kv for k, v in items for kv in tree_leaves(v, _path(prefix, k))]


def map_tree_with_path(fn, tree, prefix: str = ""):
    """``tree`` with ``fn(path, leaf)`` applied to every leaf, ``path`` as
    :func:`tree_leaves` spells it."""
    if isinstance(tree, dict):
        return {k: map_tree_with_path(fn, v, _path(prefix, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree_with_path(fn, v, _path(prefix, i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _map2(fn, a, b):
    if isinstance(a, dict):
        if set(a) != set(b):
            raise ValueError(f"parameter keys differ: {sorted(a)} vs "
                             f"{sorted(b)}")
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        if len(a) != len(b):
            raise ValueError("parameter tree lists differ in length")
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def spec_dtype(cfg: ArchConfig, spec: ParamSpec) -> torch.dtype:
    return getattr(torch, spec.dtype) if spec.dtype else cfg.activation_dtype


# the dry-run's materialized cases draw a normal leaf whose float32 draw is
# larger than this in slices of its flat view, each written into the leaf
# in its own dtype: a full-width leaf (deepseek-coder-33b's stacked w1,
# 34 GB in float32) never has a float32 copy beside it
DRAW_SLICE_BYTES = 1 << 28


def draw_leaf(spec: ParamSpec, dtype: torch.dtype,
              generator: torch.Generator, device: torch.device,
              slice_bytes: Optional[int] = None) -> torch.Tensor:
    """One leaf drawn as the reference's ``materialize`` draws it: normal
    leaves ``N(0, 1) / sqrt(fan_in)`` in float32 (with ``slice_bytes``,
    in slices of at most that many float32 bytes; else in one draw, the
    stream every seeded model of the port has drawn), ``a_log`` ``log
    U[1, 16)``, ``dt_bias`` the inverse softplus of ``exp U[log 1e-3,
    log 1e-1)``."""
    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        return u.mul_(hi - lo).add_(lo)

    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "a_log":
        return torch.log(uniform(spec.shape, 1.0, 16.0)).to(dtype)
    if spec.init == "dt_bias":
        dt = torch.exp(uniform(spec.shape, math.log(1e-3), math.log(1e-1)))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    scale = 1.0 / math.sqrt(max(spec.fan_in, 1))

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32).mul_(scale)

    numel = math.prod(spec.shape)
    if slice_bytes is None or numel * 4 <= slice_bytes:
        return normal(spec.shape).to(dtype)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    flat, step = out.view(-1), slice_bytes // 4
    for i in range(0, numel, step):
        part = flat[i:i + step]
        part.copy_(normal(part.shape))
    return out


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device: Optional[torch.device] = None,
                slice_bytes: Optional[int] = None) -> Tree:
    """Random weights drawn on ``device`` (the generator's device by
    default), each leaf in its own dtype (:func:`draw_leaf`, in slices of
    ``slice_bytes`` if given)."""
    device = torch.device(device or generator.device)
    return map_tree(lambda spec: draw_leaf(spec, spec_dtype(cfg, spec),
                                           generator, device, slice_bytes),
                    param_specs(cfg))


def rank_layout(cfg: ArchConfig, rules, rank: int):
    """The plan a dense decoder runs under ``rules`` on device ``rank``
    (:func:`~repro_torch.sharding.layout_for`); None for another family
    (which runs only on a model axis of one device)."""
    if cfg.arch_type != "dense" or cfg.moe is not None:
        return None
    return layout_for(cfg, rules, rank)


def rank_ranges(cfg: ArchConfig, rules, rank: int):
    """``leaf -> [first, end)`` of each dim of device ``rank``'s block
    of a leaf: the plan's cut (:meth:`~repro_torch.sharding.Layout.cut`:
    the spec's block, or the KV heads the rank holds where they fall
    back), or the spec's block for another family."""
    lay = rank_layout(cfg, rules, rank)
    if lay is None:
        return lambda spec: spec_ranges(spec.logical, spec.shape, rules, rank)
    return lambda spec: lay.cut(spec.logical, spec.shape, rules)


def draw_block(spec: ParamSpec, dtype: torch.dtype,
               generator: torch.Generator, device: torch.device,
               ranges, slice_bytes: Optional[int] = None) -> torch.Tensor:
    """The block ``ranges`` (``[first, end)`` a dim) of the leaf
    :func:`draw_leaf` draws, from the same stream: with ``slice_bytes``
    and at most one dim cut, the leaf is drawn slice by slice and only
    the block's part of each slice kept, so the whole leaf is never held
    (a K/V cache larger than a card); otherwise drawn whole and cut."""
    cut = [d for d, (a, b) in enumerate(ranges) if (a, b) != (0,
                                                             spec.shape[d])]
    numel = math.prod(spec.shape)
    if spec.init != "normal" or slice_bytes is None or len(cut) != 1 or \
            numel * 4 <= slice_bytes:
        return cut_leaf(draw_leaf(spec, dtype, generator, device,
                                  slice_bytes), ranges)
    d = cut[0]
    a, b = ranges[d]
    inner = math.prod(spec.shape[d + 1:])
    row = spec.shape[d] * inner            # one index of the dims before d
    lo, hi = a * inner, b * inner          # the block within a row
    out = torch.empty((math.prod(spec.shape[:d]), (b - a) * inner),
                      dtype=dtype, device=device)
    scale = 1.0 / math.sqrt(max(spec.fan_in, 1))
    step = slice_bytes // 4
    for i in range(0, numel, step):
        n = min(step, numel - i)
        part = torch.randn((n,), generator=generator, device=device,
                           dtype=torch.float32).mul_(scale)
        for r in range(i // row, (i + n - 1) // row + 1):
            s0, s1 = max(r * row + lo, i), min(r * row + hi, i + n)
            if s0 < s1:
                out[r, s0 - r * row - lo:s1 - r * row - lo].copy_(
                    part[s0 - i:s1 - i])
    return out.reshape(*spec.shape[:d], b - a, *spec.shape[d + 1:])


def init_shard(cfg: ArchConfig, generator: torch.Generator, rules,
               rank: int, *, device: Optional[torch.device] = None,
               slice_bytes: Optional[int] = None) -> Tree:
    """Device ``rank``'s block of :func:`init_params` under ``rules``
    (:func:`rank_ranges`): every leaf drawn, in order, exactly as
    :func:`init_params` draws it (so the blocks are the one-device
    weights', seed for seed), then cut, one leaf at a time (no float32
    copy of a whole leaf is kept: with ``slice_bytes`` none is made)."""
    device = torch.device(device or generator.device)
    ranges = rank_ranges(cfg, rules, rank)
    return map_tree(lambda spec: draw_block(
        spec, spec_dtype(cfg, spec), generator, device, ranges(spec),
        slice_bytes), param_specs(cfg))


# ------------------------------------------------- shardings and meta ----
def tree_specs(tree: Tree, rules) -> Tree:
    """Each :class:`ParamSpec` leaf's ``PartitionSpec`` under ``rules``
    (the reference's ``tree_shardings``)."""
    return map_tree(lambda s: rules.spec(s.logical, s.shape), tree)


def tree_meta(cfg: ArchConfig, tree: Tree) -> Tree:
    """Each :class:`ParamSpec` leaf as a tensor on the meta device: shape
    and dtype, nothing allocated (the reference's ``tree_sds``)."""
    return map_tree(lambda s: torch.empty(s.shape, dtype=spec_dtype(cfg, s),
                                          device="meta"), tree)


def param_shardings(cfg: ArchConfig, rules) -> Tree:
    return tree_specs(param_specs(cfg), rules)


def param_sds(cfg: ArchConfig) -> Tree:
    return tree_meta(cfg, param_specs(cfg))


def to_tensor(a) -> torch.Tensor:
    a = np.array(a, order="C")         # a writable copy
    # numpy has no native bfloat16: the reference's arrays carry
    # ml_dtypes' (named "bfloat16"), and np.load reads them as |V2
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 as its 2-byte words
    (``|V2``), which :func:`params_from_numpy` reads back."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def params_from_numpy(cfg: ArchConfig, tree: Tree, *,
                      device: Optional[torch.device] = None,
                      rules=None, rank: int = 0) -> Tree:
    """Carry a reference parameter tree (numpy leaves, same nesting) into
    torch tensors in the same layouts, each leaf in its own dtype (a
    float32 router stays float32 in a bfloat16 model), checking every
    shape; with ``rules``, only device ``rank``'s block of each leaf
    (:func:`rank_ranges`, cut on the host)."""
    ranges = rank_ranges(cfg, rules, rank) if rules is not None else None

    def conv(spec: ParamSpec, leaf) -> torch.Tensor:
        t = to_tensor(leaf)
        if tuple(t.shape) != spec.shape:
            raise ValueError(f"parameter shape {tuple(t.shape)} != "
                             f"expected {spec.shape}")
        if ranges is not None:
            t = cut_leaf(t, ranges(spec))
        return t.to(device=device or "cpu", dtype=spec_dtype(cfg, spec))

    return _map2(conv, param_specs(cfg), tree)


def params_to_numpy(cfg: ArchConfig, tree: Tree) -> Tree:
    """The inverse of :func:`params_from_numpy`: the tree (the
    reference's nesting and stacked shapes, checked) as host numpy
    arrays, each in its own dtype, bfloat16 as 2-byte words."""
    def conv(spec: ParamSpec, leaf: torch.Tensor) -> np.ndarray:
        if tuple(leaf.shape) != spec.shape:
            raise ValueError(f"parameter shape {tuple(leaf.shape)} != "
                             f"expected {spec.shape}")
        return to_numpy(leaf)

    return _map2(conv, param_specs(cfg), tree)


def parameter_tree(tree: Tree) -> Tree:
    """The tree with every leaf an ``nn.Parameter`` on that leaf's
    storage (no copy). Its leaves are the model's parameters: a layer
    reads views of them (``leaf[rep]`` for a stacked one), so a
    gradient lands on the stacked leaf, and the optimizer and the
    checkpoint see the reference's layout. They require no gradient
    until training turns it on."""
    return map_tree(lambda t: nn.Parameter(t, requires_grad=False), tree)


def cache_layers(cfg: ArchConfig) -> Dict[str, List[int]]:
    """The layers that hold attention K/V (``"kv"``: ``ATTN`` and
    ``SHARED_ATTN`` blocks), those that hold SSM state (``"ssm"``) and
    those that hold a request's image K/V (``"cross"``: ``CROSS``
    blocks), each in plan order: the port's caches and pool stack each
    kind's entries along its own leading dimension."""
    plan = cfg.block_plan()
    return {"kv": [i for i, k in enumerate(plan) if k in (ATTN, SHARED_ATTN)],
            "ssm": [i for i, k in enumerate(plan) if k == SSM],
            "cross": [i for i, k in enumerate(plan) if k == CROSS]}


# each per-request state leaf (a dense-state slot of the pool, not paged)
# by the layer kind of cache_layers that holds it
STATE_KINDS = {"h": "ssm", "conv": "ssm", "xk": "cross", "xv": "cross"}
STATE_DTYPES = {"h": torch.float32}    # the others: the model's dtype
# state a decode step reads and never writes (a CROSS layer's image K/V,
# written once by its request's prefill)
READ_ONLY_STATE = ("xk", "xv")
# a CROSS entry's leaves under the reference's names
CROSS_NAMES = {"k": "xk", "v": "xv"}


def state_shapes(cfg: ArchConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    """One layer's per-request state for ``batch`` rows, each leaf the
    plan holds (the reference's ``_cache_entry_abstract``): for SSM
    layers ``h [batch, heads, head_dim, d_state]`` (float32) and ``conv
    [batch, conv_width - 1, conv channels]``; for ``CROSS`` layers the
    image K/V ``xk``/``xv [batch, n_img_tokens, K, hd]`` (the model's
    dtype). :data:`STATE_KINDS` names the layers that hold each."""
    layers = cache_layers(cfg)
    out: Dict[str, Tuple[int, ...]] = {}
    if layers["ssm"]:
        _, nh, conv_ch = ssm_dims(cfg)
        s = cfg.ssm
        out["h"] = (batch, nh, s.head_dim, s.d_state)
        out["conv"] = (batch, s.conv_width - 1, conv_ch)
    if layers["cross"]:
        for name in ("xk", "xv"):
            out[name] = (batch, cfg.n_img_tokens, cfg.n_kv_heads, cfg.hd)
    return out


def state_leaves(cfg: ArchConfig, batch: int
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Every state leaf of the plan with its layers stacked in front:
    ``{name: ((n_layers,) + state_shapes[name], dtype)}``."""
    layers = cache_layers(cfg)
    return {name: ((len(layers[STATE_KINDS[name]]),) + shape,
                   STATE_DTYPES.get(name, cfg.activation_dtype))
            for name, shape in state_shapes(cfg, batch).items()}


# each cache leaf's logical axes, its layers stacked in front (the
# reference's ``_cache_entry_abstract`` with ``LAYERS`` prepended)
CACHE_LOGICAL = {
    "k": (LAYERS, BATCH, KV_SEQ, KV_HEADS, HEAD_DIM),
    "v": (LAYERS, BATCH, KV_SEQ, KV_HEADS, HEAD_DIM),
    "h": (LAYERS, BATCH, SSM_HEADS, None, STATE),
    "conv": (LAYERS, BATCH, None, CONV_CH),
    "xk": (LAYERS, BATCH, None, KV_HEADS, HEAD_DIM),
    "xv": (LAYERS, BATCH, None, KV_HEADS, HEAD_DIM),
}


def abstract_cache(cfg: ArchConfig, batch: int, kv_len: int) -> Tree:
    """The dense decode cache (``Model.init_cache``'s flat layout) as
    :class:`ParamSpec` leaves with the reference's logical axes; under a
    sliding window ``W`` the K/V has ``min(kv_len, W)`` slots. Drawn
    (``init`` normal, fan-in 1), it is a seeded random cache."""
    if cfg.sliding_window:
        kv_len = min(kv_len, cfg.sliding_window)
    leaves: Dict[str, Tuple[Tuple[int, ...], Optional[str]]] = {}
    n_kv = len(cache_layers(cfg)["kv"])
    if n_kv:
        for name in ("k", "v"):
            leaves[name] = ((n_kv, batch, kv_len, cfg.n_kv_heads, cfg.hd),
                            None)
    for name, (shape, dtype) in state_leaves(cfg, batch).items():
        leaves[name] = (shape, "float32" if name in STATE_DTYPES else None)
    return {name: ParamSpec(shape, CACHE_LOGICAL[name], "normal", 1, dtype)
            for name, (shape, dtype) in leaves.items()}


def cache_shardings(cfg: ArchConfig, rules, batch: int,
                    kv_len: int) -> Tree:
    return tree_specs(abstract_cache(cfg, batch, kv_len), rules)


def cache_sds(cfg: ArchConfig, batch: int, kv_len: int) -> Tree:
    return tree_meta(cfg, abstract_cache(cfg, batch, kv_len))


def cache_from_numpy(cfg: ArchConfig, cache: Tree, *,
                     device: Optional[torch.device] = None
                     ) -> Dict[str, torch.Tensor]:
    """Carry a reference decode cache (``{"stack": [...], "rem": [...]}``
    with numpy leaves, as ``prefill`` and ``init_cache`` return it) into
    the port's flat cache: ``k``/``v`` ``[n_kv_layers, B, S, K, hd]`` in
    plan order where the plan has self-attention, ``h``/``conv``
    ``[n_ssm_layers, B, ...]`` where it has SSM blocks and ``xk``/``xv``
    ``[n_cross_layers, B, n_img_tokens, K, hd]`` where it has ``CROSS``
    blocks (their entries' ``k``/``v``); checking the layout."""
    slots, n_rep, rem = plan_structure(cfg)
    if len(cache["stack"]) != len(slots) or len(cache["rem"]) != rem:
        raise ValueError(f"a {cfg.arch_type} cache has {len(slots)} "
                         f"stacked entries and {rem} remainder entries")
    plan = cfg.block_plan()
    per: Dict[str, List[torch.Tensor]] = {}
    for kind, (where, i, r) in zip(plan, layer_sources(cfg)):
        entry = cache["stack"][i] if where == "stack" else cache["rem"][i]
        for name, leaf in entry.items():
            if kind == CROSS:
                name = CROSS_NAMES[name]
            t = to_tensor(leaf)
            per.setdefault(name, []).append(t[r] if r is not None else t)
    out = {}
    for name, parts in per.items():
        t = torch.stack(parts)
        if name in ("k", "v"):
            want = (len(parts), cfg.n_kv_heads, cfg.hd)
            if t.dim() != 5 or (t.shape[0], *t.shape[3:]) != want:
                raise ValueError(
                    f"cache {name} shape {tuple(t.shape)} is not "
                    f"[{want[0]}, B, S, {want[1]}, {want[2]}]")
            dtype = cfg.activation_dtype
        else:
            shape = state_shapes(cfg, t.shape[1])[name]
            if tuple(t.shape[1:]) != shape:
                raise ValueError(f"cache {name} shape {tuple(t.shape)} is "
                                 f"not [{len(parts)}, {shape}]")
            dtype = STATE_DTYPES.get(name, cfg.activation_dtype)
        out[name] = t.to(device=device or "cpu", dtype=dtype)
    return out
