"""Parameter declaration, initialisation and the weight bridge.

``param_specs(cfg)`` declares every parameter of a dense decoder with the
reference's shapes, init styles and fan-ins (``repro.models.params``
``pspec``/``materialize``): the tree is ``{"embed", "stack", "rem",
"final_norm"}``; ``stack`` holds one dict whose leaves carry a leading
layer dimension and ``rem`` is empty for the dense family.
``init_params`` fills that tree from a ``torch.Generator`` on the target
device; ``params_from_numpy`` carries a reference parameter tree (as
numpy) across unchanged, so both packages can run on the same weights,
and ``cache_from_numpy`` does the same for a dense decode cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, require_slice

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones
    fan_in: int = 0               # scale of the normal init: 1/sqrt(fan_in)


def _spec(shape, init="normal", fan_in=0) -> ParamSpec:
    # the reference's default fan-in: the second-to-last dim
    return ParamSpec(tuple(int(s) for s in shape), init,
                     fan_in or (shape[-2] if len(shape) >= 2 else shape[-1]))


def _norm_specs(cfg: ArchConfig) -> Tree:
    p = {"scale": _spec((cfg.d_model,), "ones")}
    if cfg.norm == "layernorm":
        p["bias"] = _spec((cfg.d_model,), "zeros")
    return p


def _block_specs(cfg: ArchConfig) -> Tree:
    d, h, k, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.d_ff)
    attn = {"wq": _spec((d, h, hd), fan_in=d),
            "wk": _spec((d, k, hd), fan_in=d),
            "wv": _spec((d, k, hd), fan_in=d),
            "wo": _spec((h, hd, d), fan_in=h * hd)}
    if cfg.qkv_bias:
        attn["bq"] = _spec((h, hd), "zeros")
        attn["bk"] = _spec((k, hd), "zeros")
        attn["bv"] = _spec((k, hd), "zeros")
    ffn = {"w1": _spec((d, f)), "w2": _spec((f, d), fan_in=f)}
    if cfg.act == "swiglu":
        ffn["w3"] = _spec((d, f))
    return {"ln1": _norm_specs(cfg), "attn": attn, "ln2": _norm_specs(cfg),
            "ffn": ffn}


def param_specs(cfg: ArchConfig) -> Tree:
    require_slice(cfg)
    cfg.validate()
    vp, d, L = cfg.padded_vocab, cfg.d_model, cfg.n_layers
    embed = {"tok": _spec((vp, d), fan_in=d)}
    if cfg.pos == "learned":
        embed["pos"] = _spec((cfg.max_position, d), fan_in=d)
    if not cfg.tie_embeddings:
        embed["unemb"] = _spec((d, vp))
    stack = {grp: {name: ParamSpec((L,) + s.shape, s.init, s.fan_in)
                   for name, s in leaves.items()}
             for grp, leaves in _block_specs(cfg).items()}
    return {"embed": embed, "stack": [stack], "rem": [],
            "final_norm": _norm_specs(cfg)}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


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


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device: Optional[torch.device] = None) -> Tree:
    """Random weights drawn on ``device`` (the generator's device by
    default): normal leaves are ``N(0, 1) / sqrt(fan_in)`` drawn in float32
    and cast to ``cfg.dtype``, as in the reference's ``materialize``."""
    device = torch.device(device or generator.device)
    dtype = cfg.activation_dtype

    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        w = torch.randn(spec.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(1.0 / math.sqrt(max(spec.fan_in, 1))).to(dtype)

    return _map(make, param_specs(cfg))


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a, order="C")         # a writable copy
    if a.dtype.name == "bfloat16":       # numpy has no native bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(cfg: ArchConfig, tree: Tree, *,
                      device: Optional[torch.device] = None) -> Tree:
    """Carry a reference parameter tree (numpy leaves, same nesting) into
    torch tensors in the same layouts, checking every shape."""
    def conv(spec: ParamSpec, leaf) -> torch.Tensor:
        t = _to_tensor(leaf)
        if tuple(t.shape) != spec.shape:
            raise ValueError(f"parameter shape {tuple(t.shape)} != "
                             f"expected {spec.shape}")
        return t.to(device=device or "cpu", dtype=cfg.activation_dtype)

    return _map2(conv, param_specs(cfg), tree)


def cache_from_numpy(cfg: ArchConfig, cache: Tree, *,
                     device: Optional[torch.device] = None
                     ) -> Dict[str, torch.Tensor]:
    """Carry a reference dense cache (``{"stack": [{"k", "v"}], "rem":
    []}`` with numpy ``[L, B, S, K, hd]`` leaves, as ``prefill`` and
    ``init_cache`` return it) into the port's ``{"k", "v"}``, checking the
    layout."""
    require_slice(cfg)
    if len(cache["stack"]) != 1 or cache["rem"]:
        raise ValueError("a dense decoder's cache has one stacked entry "
                         "and no remainder")
    out = {}
    for name in ("k", "v"):
        t = _to_tensor(cache["stack"][0][name])
        if t.dim() != 5 or (t.shape[0], *t.shape[3:]) != (
                cfg.n_layers, cfg.n_kv_heads, cfg.hd):
            raise ValueError(f"cache {name} shape {tuple(t.shape)} is not "
                             f"[{cfg.n_layers}, B, S, {cfg.n_kv_heads}, "
                             f"{cfg.hd}]")
        out[name] = t.to(device=device or "cpu", dtype=cfg.activation_dtype)
    return out
