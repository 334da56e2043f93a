"""Per-(architecture x input-shape x mesh) dry-run cases (counterpart of
``repro.launch.input_specs``).

:func:`build_case` returns what the dry-run prices: the step function
over the port's :class:`~repro_torch.models.model.Model`, every argument
as a tensor on the meta device at its global shape (nothing allocated),
each argument leaf's ``PartitionSpec`` and the outputs', the donated
arguments, the model FLOPs and the chosen microbatches. It applies the
reference's shape-dependent config adjustments:

  * ``long_500k`` on dense/VLM archs switches self-attention to a sliding
    window of 8192 (an 8192-slot ring); SSM/hybrid archs run it natively;
  * ``q_block`` is tuned per shape (the reference's blocked attention;
    the port's flash kernel ignores it);
  * encoder-only archs (hubert) have no decode step: decode shapes raise
    ``SkipCase``, and "prefill" is the encoder's forward.

Sharding policy, as the reference's: the KV cache shards its sequence
dim on the model axis when the KV heads do not divide it
(``shard_kv_seq``, decode only); training always shards weights and
optimizer state over the data axes (FSDP), serving only when the bf16
weights exceed half a device's memory under pure tensor parallelism. The
device is a :class:`~repro_torch.core.hardware.Hardware` (the H100 by
default; the reference's is a TPU).

:func:`materialize` allocates a case's arguments on a real mesh, seeded:
on one device, for the cases that fit one card; on a ``1 x M`` mesh of
devices, in each rank's process (:mod:`repro_torch.distributed`), the
rank's blocks, drawn as the one-device case draws them, and the case's
step then runs the model's rank over the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.hardware import H100_SXM5_80GB, Hardware
from repro_torch.core.roofline import model_flops_for
from repro_torch.launch.mesh import Mesh, multi_card_item
from repro_torch.models.params import (DRAW_SLICE_BYTES, abstract_cache,
                                       cache_shardings, cache_sds, draw_block,
                                       draw_leaf, map_tree, param_shardings,
                                       param_sds, param_specs, rank_ranges,
                                       spec_dtype)
from repro_torch.sharding import (BATCH, VOCAB, PartitionSpec, ShardingRules,
                                  check_executable, rules_for)
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train import (TrainState, make_train_step,
                                        opt_state_sds, opt_state_shardings)

class SkipCase(Exception):
    """This (arch x shape) pair is documented as not applicable."""


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

SLIDING_WINDOW_LONG = 8192


@dataclasses.dataclass
class DryRunCase:
    arch: str
    shape: ShapeSpec
    cfg: ArchConfig
    rules: ShardingRules
    fn: Callable          # fn(*args) on real tensors (materialize)
    args: Tuple           # meta tensors at global shapes
    specs: Tuple          # each argument leaf's PartitionSpec
    outs: Any             # the outputs as meta tensors
    out_specs: Any
    donate: Tuple[int, ...] = ()
    model_flops: float = 0.0
    microbatches: int = 1
    moment_dtype: str = "float32"
    hbm_budget_bytes: float = H100_SXM5_80GB.hbm_bytes

    @property
    def kind(self) -> str:
        """The census's step kind: train, prefill, encode or decode."""
        if self.shape.kind == "prefill" and self.cfg.arch_type == "encoder":
            return "encode"
        return self.shape.kind

    @property
    def kv_len(self) -> int:
        """The decode cache's slots (a sliding window's ring)."""
        return min(self.shape.seq, self.cfg.sliding_window or self.shape.seq)


def _needs_kv_seq_shard(cfg: ArchConfig, model_size: int) -> bool:
    return cfg.n_kv_heads % model_size != 0


def _needs_fsdp_serve(cfg: ArchConfig, model_size: int,
                      hw: Hardware = H100_SXM5_80GB) -> bool:
    return cfg.num_params() * 2 / model_size > hw.hbm_bytes * 0.5


def _auto_qblock(cfg: ArchConfig, shape: ShapeSpec, data_shards: int,
                 budget_bytes: float = 1.0e9, kv_tile: int = 1024) -> int:
    """Largest power-of-two query block whose f32 score tile
    [B/dp, qb, H, kv_tile] fits the per-device budget."""
    b_loc = max(1, shape.batch // data_shards)
    per_row = b_loc * cfg.n_heads * min(shape.seq, kv_tile) * 4
    qb = int(budget_bytes // max(per_row, 1))
    return max(16, min(512, 1 << max(qb.bit_length() - 1, 4)))


def adjusted_cfg(arch: str, shape: ShapeSpec, data_shards: int = 16
                 ) -> ArchConfig:
    cfg = get_config(arch)
    changes: Dict[str, Any] = {}
    if shape.name == "long_500k" and cfg.arch_type in ("dense", "vlm"):
        changes["sliding_window"] = SLIDING_WINDOW_LONG
    if shape.kind in ("prefill", "train"):
        eff = dataclasses.replace(cfg, sliding_window=None)
        changes["q_block"] = _auto_qblock(eff, shape, data_shards)
    if shape.name == "long_500k" and cfg.arch_type == "hybrid":
        # full-attention hybrid blocks at 500k context: small query tiles
        changes["q_block"] = 128
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    return cfg


VARIANTS = ("kv_repeat", "head_pad64", "attn_row_parallel",
            "head_pad64_kv_repeat", "attn_row_parallel_kv_seq_off",
            "kv_repeat_act_replicated")


def apply_variant(cfg: ArchConfig, variant: Optional[str]) -> ArchConfig:
    """The reference's layout variants (same function, another layout)."""
    if not variant:
        return cfg
    if variant == "kv_repeat":
        return dataclasses.replace(cfg, attn_kv_repeat=True)
    if variant in ("head_pad64", "head_pad64_kv_repeat"):
        if cfg.n_heads != 56:
            raise ValueError("head padding variant targets 56-head archs")
        return dataclasses.replace(
            cfg, n_heads=64, attn_kv_repeat=variant.endswith("kv_repeat"))
    if variant in ("attn_row_parallel", "attn_row_parallel_kv_seq_off"):
        return dataclasses.replace(cfg, attn_row_parallel=True)
    if variant == "kv_repeat_act_replicated":
        return dataclasses.replace(cfg, attn_kv_repeat=True)
    raise ValueError(variant)


def _batch_meta(cfg: ArchConfig, rules: ShardingRules, batch: int,
                seq: int, train: bool):
    """A step's input batch as meta tensors, and its specs (batch dim on
    the batch axes where they divide it)."""
    meta: Dict[str, torch.Tensor] = {}
    spec: Dict[str, PartitionSpec] = {}

    def add(name, shape, dtype):
        meta[name] = torch.empty(shape, dtype=dtype, device="meta")
        spec[name] = rules.spec((BATCH,) + (None,) * (len(shape) - 1),
                                shape)
    if cfg.embedding_inputs:
        add("embeds", (batch, seq, cfg.d_model), torch.bfloat16)
    else:
        add("tokens", (batch, seq), torch.int32)
    if train:
        add("labels", (batch, seq), torch.int32)
    if cfg.arch_type == "vlm":
        add("img_embeds", (batch, cfg.n_img_tokens, cfg.d_model),
            torch.bfloat16)
    return meta, spec


def _model(cfg: ArchConfig, params, rules: ShardingRules, group=None):
    """The case's model over ``params``: on their device, or, on a mesh
    of several real devices, ``group``'s rank of it."""
    from repro_torch.models.model import Model
    mesh = rules.mesh
    if mesh.devices is not None and mesh.size > 1:
        return Model(cfg, params, mesh=mesh, rules=rules, group=group)
    leaf = params["final_norm"]["scale"]
    return Model(cfg, params, device=leaf.device)


def _train_microbatches(cfg: ArchConfig, shape: ShapeSpec, data_shards: int,
                        model_size: int) -> int:
    """The reference's gradient-accumulation depth: per-layer saved
    activations under ~2.5 GB a device (SSM/hybrid blocks ~5x wider)."""
    width_mult = 5 if cfg.ssm is not None else 1
    saved_x = (cfg.n_layers * (shape.batch // data_shards) * shape.seq *
               max(cfg.d_model // model_size, 1) * 2 * width_mult)
    micro = 2 if cfg.num_params() > 30e9 else 1    # big-model headroom
    while saved_x / micro > 2.5e9 and micro < 8 and \
            (shape.batch // data_shards) % (micro * 2) == 0:
        micro *= 2
    return micro


def case_for(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh, *,
             arch: Optional[str] = None, moment_dtype: str = "float32",
             act_replicated: bool = False,
             hw: Hardware = H100_SXM5_80GB, group=None) -> DryRunCase:
    """The case of an already adjusted ``cfg`` at ``shape`` on ``mesh``
    (:func:`build_case` without the registry lookup, for reduced
    configs); on a mesh of several real devices its ``fn`` runs as
    ``group``'s rank (:class:`~repro_torch.distributed.MeshGroup`)."""
    model_size = mesh.shape["model"]
    data_shards = mesh.size // model_size
    fsdp = shape.kind == "train" or _needs_fsdp_serve(cfg, model_size, hw)
    shard_kv = shape.kind == "decode" and _needs_kv_seq_shard(cfg,
                                                              model_size)
    rules = rules_for(mesh, shard_kv_seq=shard_kv, fsdp=fsdp,
                      act_replicated=act_replicated)
    params, params_sp = param_sds(cfg), param_shardings(cfg, rules)
    mf = model_flops_for(cfg, shape.kind, shape.batch, shape.seq,
                         train=(shape.kind == "train"),
                         n_params=cfg.active_params())
    common = dict(arch=arch or cfg.name, shape=shape, cfg=cfg, rules=rules,
                  model_flops=mf, hbm_budget_bytes=hw.hbm_bytes)
    B, V = shape.batch, cfg.vocab_size
    logit_spec = rules.spec((BATCH, VOCAB), (B, V))

    if shape.kind == "train":
        micro = _train_microbatches(cfg, shape, data_shards, model_size)
        step_fn = make_train_step(cfg, AdamWConfig(), microbatches=micro)

        def fn(params, opt_state, batch):
            state = TrainState(_model(cfg, params, rules, group), opt_state)
            metrics = step_fn(state, batch)
            return state.params, state.opt_state, metrics
        batch, batch_sp = _batch_meta(cfg, rules, B, shape.seq, True)
        opt, opt_sp = opt_state_sds(cfg, moment_dtype), \
            opt_state_shardings(cfg, rules)
        scalar = torch.empty((), dtype=torch.float32, device="meta")
        return DryRunCase(
            fn=fn, args=(params, opt, batch),
            specs=(params_sp, opt_sp, batch_sp),
            outs=(params, opt, {"loss": scalar, "grad_norm": scalar}),
            out_specs=(params_sp, opt_sp, {"loss": (), "grad_norm": ()}),
            donate=(0, 1), microbatches=micro, moment_dtype=moment_dtype,
            **common)

    if shape.kind == "prefill":
        batch, batch_sp = _batch_meta(cfg, rules, B, shape.seq, False)
        if cfg.arch_type == "encoder":
            def fn(params, batch):
                return _model(cfg, params, rules, group).forward(
                    tokens=batch.get("tokens"), embeds=batch.get("embeds"))
            logits = torch.empty((B, shape.seq, V), dtype=torch.float32,
                                 device="meta")
            return DryRunCase(
                fn=fn, args=(params, batch), specs=(params_sp, batch_sp),
                outs=logits,
                out_specs=rules.spec((BATCH, None, VOCAB), logits.shape),
                **common)
        kv_len = min(shape.seq, cfg.sliding_window or shape.seq)

        def fn(params, batch):
            return _model(cfg, params, rules, group).prefill(
                batch.get("tokens"), cache_len=kv_len,
                embeds=batch.get("embeds"),
                img_embeds=batch.get("img_embeds"))
        logits = torch.empty((B, V), dtype=torch.float32, device="meta")
        return DryRunCase(
            fn=fn, args=(params, batch), specs=(params_sp, batch_sp),
            outs=(logits, cache_sds(cfg, B, kv_len)),
            out_specs=(logit_spec, cache_shardings(cfg, rules, B, kv_len)),
            **common)

    # decode: ONE token a sequence at position seq - 1 over the cache
    kv_len = min(shape.seq, cfg.sliding_window or shape.seq)

    def fn(params, cache, tokens, pos):
        logits = _model(cfg, params, rules, group).decode_step(tokens, cache,
                                                               pos)
        return logits, cache
    cache, cache_sp = cache_sds(cfg, B, kv_len), \
        cache_shardings(cfg, rules, B, kv_len)
    tokens = torch.empty((B,), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    logits = torch.empty((B, V), dtype=torch.float32, device="meta")
    return DryRunCase(
        fn=fn, args=(params, cache, tokens, pos),
        specs=(params_sp, cache_sp, rules.spec((BATCH,), (B,)), ()),
        outs=(logits, cache), out_specs=(logit_spec, cache_sp),
        donate=(1,), **common)


def build_case(arch: str, shape_name: str, mesh: Mesh, *,
               moment_dtype: str = "float32",
               variant: Optional[str] = None,
               hw: Hardware = H100_SXM5_80GB) -> DryRunCase:
    shape = SHAPES[shape_name]
    if get_config(arch).arch_type == "encoder" and shape.kind == "decode":
        raise SkipCase(f"{arch} is encoder-only: no autoregressive decode "
                       f"step exists for {shape_name}")
    model_size = mesh.shape["model"]
    cfg = adjusted_cfg(arch, shape, mesh.size // model_size)
    cfg = apply_variant(cfg, variant)
    return case_for(cfg, shape, mesh, arch=arch, moment_dtype=moment_dtype,
                    act_replicated=bool(variant and
                                        "act_replicated" in variant), hw=hw)


def materialize(case: DryRunCase, mesh: Mesh,
                generator: torch.Generator,
                rank: Optional[int] = None) -> Tuple:
    """The case's arguments allocated on ``mesh``, seeded from
    ``generator`` (on the device): the weights as
    :func:`~repro_torch.models.params.init_params` draws them (each large
    leaf in slices, no float32 copy beside it), a random cache (normal
    K/V and state), random token ids, a decode step's position ``seq -
    1`` (a ring's slot wraps), zero optimizer moments and step.

    On a mesh of several devices, device ``rank``'s blocks (a rank of
    the mesh, :mod:`repro_torch.distributed`) under the case's own rules
    (:func:`~repro_torch.models.params.rank_ranges`: the specs' blocks,
    or the KV heads a rank holds where they fall back): every weight and
    cache leaf is drawn in the one-device order, in slices, and only the
    rank's block of each slice kept
    (:func:`~repro_torch.models.params.draw_block`: a cache no one card
    holds is never whole), so each rank holds its block of the one-device
    case's arguments. What the mesh does not run raises
    (:func:`~repro_torch.sharding.check_executable`; a training case)."""
    if mesh.devices is None:
        raise ValueError("materialize needs a mesh over real devices")
    cfg, rules = case.cfg, case.rules
    if mesh.size > 1:
        if case.kind == "train":
            raise NotImplementedError(
                f"a training case over {mesh.size} devices "
                f"({multi_card_item('train')})")
        check_executable(cfg, rules)
        if rank is None:
            raise ValueError(
                f"a case over {mesh.size} devices needs a rank: run it in "
                f"a process of the mesh (distributed.spawn) as its rank")
    device = torch.device(mesh.devices.flat[rank or 0])
    ranges = rank_ranges(cfg, rules, rank) if mesh.size > 1 else None

    def draw(spec):
        if ranges is None:
            return draw_leaf(spec, spec_dtype(cfg, spec), generator, device,
                             slice_bytes=DRAW_SLICE_BYTES)
        return draw_block(spec, spec_dtype(cfg, spec), generator, device,
                          ranges(spec), slice_bytes=DRAW_SLICE_BYTES)

    def batch(meta: Dict[str, torch.Tensor]):
        out = {}
        for name, t in meta.items():
            if t.dtype == torch.int32:
                out[name] = torch.randint(
                    0, cfg.vocab_size, t.shape, generator=generator,
                    device=device, dtype=torch.int32)
            else:
                out[name] = torch.randn(t.shape, generator=generator,
                                        device=device, dtype=torch.float32
                                        ).to(t.dtype)
        return out

    params = map_tree(draw, param_specs(cfg))
    if case.kind == "decode":
        B = case.shape.batch
        cache = map_tree(draw, abstract_cache(cfg, B, case.kv_len))
        tokens = torch.randint(0, cfg.vocab_size, (B,), generator=generator,
                               device=device, dtype=torch.int32)
        pos = torch.tensor(case.shape.seq - 1, dtype=torch.int32,
                           device=device)
        return params, cache, tokens, pos
    if case.kind == "train":
        m, v, step = case.args[1]
        zeros = map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                               device=device), (m, v))
        return params, (*zeros, torch.zeros((), dtype=step.dtype,
                                            device=device)), \
            batch(case.args[2])
    return params, batch(case.args[1])
