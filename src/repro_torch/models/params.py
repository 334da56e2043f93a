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

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | a_log | dt_bias
    fan_in: int = 0               # scale of the normal init: 1/sqrt(fan_in)
    dtype: Optional[str] = None   # None: the config's dtype


def _spec(shape, init="normal", fan_in=0, dtype=None) -> ParamSpec:
    # the reference's default fan-in: the second-to-last dim
    return ParamSpec(tuple(int(s) for s in shape), init,
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
    p = {"scale": _spec((cfg.d_model,), "ones")}
    if cfg.norm == "layernorm":
        p["bias"] = _spec((cfg.d_model,), "zeros")
    return p


def attn_specs(cfg: ArchConfig) -> Tree:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = {"wq": _spec((d, h, hd), fan_in=d),
            "wk": _spec((d, k, hd), fan_in=d),
            "wv": _spec((d, k, hd), fan_in=d),
            "wo": _spec((h, hd, d), fan_in=h * hd)}
    if cfg.qkv_bias:
        attn["bq"] = _spec((h, hd), "zeros")
        attn["bk"] = _spec((k, hd), "zeros")
        attn["bv"] = _spec((k, hd), "zeros")
    return attn


def _mlp_specs(cfg: ArchConfig) -> Tree:
    d, f = cfg.d_model, cfg.d_ff
    ffn = {"w1": _spec((d, f)), "w2": _spec((f, d), fan_in=f)}
    if cfg.act == "swiglu":
        ffn["w3"] = _spec((d, f))
    return ffn


def _moe_specs(cfg: ArchConfig) -> Tree:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": _spec((d, e), dtype="float32"),
         "w1": _spec((e, d, f), fan_in=d),
         "w2": _spec((e, f, d), fan_in=f)}
    if cfg.act == "swiglu":
        p["w3"] = _spec((e, d, f), fan_in=d)
    if cfg.moe.dense_residual:
        p["dense"] = _mlp_specs(cfg)
    return p


def _ssm_specs(cfg: ArchConfig) -> Tree:
    s, d = cfg.ssm, cfg.d_model
    d_in, nh, conv_ch = ssm_dims(cfg)
    total = 2 * d_in + 2 * s.ngroups * s.d_state + nh
    return {"in_proj": _spec((d, total), fan_in=d),
            "conv_w": _spec((s.conv_width, conv_ch), fan_in=s.conv_width),
            "conv_b": _spec((conv_ch,), "zeros"),
            "a_log": _spec((nh,), "a_log", dtype="float32"),
            "d_skip": _spec((nh,), "ones", dtype="float32"),
            "dt_bias": _spec((nh,), "dt_bias", dtype="float32"),
            "norm": _spec((d_in,), "ones"),
            "out_proj": _spec((d_in, d), fan_in=d_in)}


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
    return map_tree(lambda s: dataclasses.replace(s, shape=(n,) + s.shape), tree)


def param_specs(cfg: ArchConfig) -> Tree:
    cfg.validate()
    vp, d = cfg.padded_vocab, cfg.d_model
    embed = {"tok": _spec((vp, d), fan_in=d)}
    if cfg.pos == "learned":
        embed["pos"] = _spec((cfg.max_position, d), fan_in=d)
    if not cfg.tie_embeddings:
        embed["unemb"] = _spec((d, vp))
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


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device: Optional[torch.device] = None) -> Tree:
    """Random weights drawn on ``device`` (the generator's device by
    default), each leaf in its own dtype, as in the reference's
    ``materialize``: normal leaves are ``N(0, 1) / sqrt(fan_in)`` drawn
    in float32; ``a_log`` is ``log U[1, 16)``; ``dt_bias`` is the inverse
    softplus of ``exp U[log 1e-3, log 1e-1)``."""
    device = torch.device(device or generator.device)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        return u.mul_(hi - lo).add_(lo)

    def make(spec: ParamSpec) -> torch.Tensor:
        dtype = spec_dtype(cfg, spec)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "a_log":
            return torch.log(uniform(spec.shape, 1.0, 16.0)).to(dtype)
        if spec.init == "dt_bias":
            dt = torch.exp(uniform(spec.shape, math.log(1e-3),
                                   math.log(1e-1)))
            return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        w = torch.randn(spec.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(1.0 / math.sqrt(max(spec.fan_in, 1))).to(dtype)

    return map_tree(make, param_specs(cfg))


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
                      device: Optional[torch.device] = None) -> Tree:
    """Carry a reference parameter tree (numpy leaves, same nesting) into
    torch tensors in the same layouts, each leaf in its own dtype (a
    float32 router stays float32 in a bfloat16 model), checking every
    shape."""
    def conv(spec: ParamSpec, leaf) -> torch.Tensor:
        t = to_tensor(leaf)
        if tuple(t.shape) != spec.shape:
            raise ValueError(f"parameter shape {tuple(t.shape)} != "
                             f"expected {spec.shape}")
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
