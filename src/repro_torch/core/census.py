"""Analytic per-step cost census: the port's counterpart of the
reference's HLO census (``repro.core.analysis``; ``ClassCost`` and
``OpCensus`` are copies).

The reference compiles each step ahead of time and reads its FLOPs and
HBM bytes off the optimized XLA program. A CUDA graph has no such
program, so the port computes each step's cost from the model config and
the step's bucket, in the reference's kernel classes:

* ``matmul``: the QKV, output-projection and MLP GEMMs, ``2·M·N·K`` over
  the bucket's padded rows (as XLA counts them), plus the MLP
  activation's elementwise operations (the reference files them under
  the same scope); bytes: the weights, and each GEMM's input and output.
* ``head``: the unembed GEMM over the rows whose logits the step returns
  (every row of a decode step, the last row of a prefill). In a prefill
  program also the embedding lookup's elementwise work (the clamped
  gathers' selects and index checks and the positional add), which the
  reference's census files under ``head`` in its prefill programs and
  under ``other`` in its decode programs, where XLA fuses the lookup
  elsewhere; bytes: the unembed weight, the logits, the gathered
  embedding rows.
* ``attention``: the attention kernels' K/V reads and the new rows' pool
  writes (formula below), and the dense copies a bucket fixes.
* ``other``: norms, residual adds and the sampler (a coarse count); in
  a VLM prefill also the ``CROSS`` layers' image K/V projection and its
  write into the request's slot (the reference's ``cross_kv`` scope,
  which its census's class rules leave in ``other``).

A ``CROSS`` layer's query projection and its attention onto the
request's ``n_img`` image K/V rows are ``attention`` (the reference's
``cross_attn`` scope); its output projection (the reference's
``attn_out``) and its MLP are ``matmul``.
They are fixed by the bucket: every padded row reads its slot's image
K/V (``n_img`` rows a layer, FLOPs ``4·H·hd·n_img`` a row), and a decode
step first gathers them out of the slots (each row's read from the pool
and written once).

**Bytes are the port's own formula**, the one behind the kernel bounds in
``PERF.md``: each weight is read once a step (once an iteration of a
verify step), each activation written once and read once, and K/V is
counted over the step's live context, never over the bucket's padded
table. With ``kv_row = 2·K·hd·itemsize`` (one token's K and V in one
layer), a step's attention bytes are, over its ``L`` layers,

    L · [ reads · kv_row                  the kernel's K/V reads
          + rows · kv_row                 the new rows' pool writes
          + 2 · rows · H · hd · itemsize  q in, out
          + 4 · (entries + rows) ]        table entries, lengths

For a decode step ``rows`` are its live requests, ``reads`` the sum of
their lengths (position + 1, the row just written included) and
``entries`` their live block-table entries; FLOPs ``4·reads·H·hd`` a
layer. For a prefill ``rows`` are the prompt tokens computed and
``reads`` those rows plus the valid prefix; FLOPs ``4·H·hd`` a layer
times the causal pairs, ``rows·(rows+1)/2 + rows·prefix``. These live
terms (:func:`attention_cost`) come from the step's data, which the
engine knows on the host at staging (:class:`LiveWork`); everything else
(:func:`step_census`) is fixed by the bucket. The gather step's dense
copy of ``B · pad_blocks`` blocks and a prefill's gathered prefix of
``nb_pad`` blocks are each read from the pool and written once.

A verify step (``spec_verify``) is ``K_pad + 1`` decode iterations: each
reads the weights and the context the step started from (the draft rows
it appends, at most ``K_pad·(K_pad+1)/2`` a request, are not counted).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ATTN, CROSS, SHARED_ATTN, SSM, ArchConfig
from repro_torch.models.moe import capacity, token_chunks
from repro_torch.models.params import (attn_specs, block_specs, param_specs,
                                       ssm_dims)


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


# the reference's step variants (its StepCensusCache keys)
DECODE_VARIANTS = ("decode", "decode_gather", "spec_verify")
PREFILL_VARIANTS = ("prefill", "prefix_prefill", "chunk_prefill")
VARIANTS = DECODE_VARIANTS + PREFILL_VARIANTS

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}
LOGIT_BYTES = 4                  # logits are float32
# elementwise operations an element of the MLP activation (relu: one max;
# swiglu: the sigmoid, its product and the gate product; tanh-gelu's
# polynomial); only relu is held against the reference's census
_ACT_OPS = {"relu": 1, "swiglu": 6, "gelu": 8}
_NORM_OPS = {"layernorm": 8, "rmsnorm": 4}


@dataclasses.dataclass(frozen=True)
class LiveWork:
    """What one step's data makes its attention do, beyond its bucket
    (see the module docstring): ``rows`` live decode rows or prompt
    tokens computed, ``context`` the KV tokens the kernel reads besides
    a prefill's own rows (a decode step's summed lengths, a prefill's
    valid prefix), ``entries`` the live block-table entries read."""
    rows: int
    context: int
    entries: int = 0


def itemsize(cfg: ArchConfig) -> int:
    return _DTYPE_BYTES[cfg.dtype]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_numel(v) for v in tree)
    return _numel(tree.shape)


def param_count(cfg: ArchConfig, active: bool = False) -> int:
    """Every parameter of the model; with ``active``, an MoE model's
    parameters a token uses (its ``top_k`` experts of each MoE layer, as
    the reference's ``active_params`` counts them)."""
    total = _tree_numel(param_specs(cfg))
    if active and cfg.moe is not None:
        n_moe = cfg.block_plan().count(ATTN)
        total -= (cfg.moe.num_experts - cfg.moe.top_k) * n_moe \
            * _mlp_weights(cfg)
    return total


def _mlp_weights(cfg: ArchConfig) -> int:
    """One dense MLP's (or one expert's) GEMM weights."""
    return (3 if cfg.act == "swiglu" else 2) * cfg.d_model * cfg.d_ff


def layer_counts(cfg: ArchConfig) -> Dict[str, int]:
    """The plan's layers by what they run: ``kv`` self-attention layers
    (``ATTN`` and each ``SHARED_ATTN`` occurrence), ``cross`` a VLM's
    cross-attention layers, ``mlp`` dense FFNs (the dense family's, the
    shared block's, the ``CROSS`` blocks' and an MoE model's dense
    residual branch), ``moe`` routed FFNs and ``ssm`` Mamba2 mixers."""
    plan = cfg.block_plan()
    n_attn, n_shared = plan.count(ATTN), plan.count(SHARED_ATTN)
    n_cross = plan.count(CROSS)
    moe = cfg.moe is not None
    return {"kv": n_attn + n_shared, "cross": n_cross,
            "mlp": n_shared + n_cross
            + (n_attn if not moe or cfg.moe.dense_residual else 0),
            "moe": n_attn if moe else 0,
            "ssm": plan.count(SSM)}


def variant_shape(variant: str, bucket: Tuple, block_size: int
                  ) -> Tuple[int, int, int, int]:
    """``(rows, out_rows, copy_tokens, iterations)`` of a bucket: the
    padded rows each GEMM runs over, the rows whose logits come back, the
    tokens of the dense K/V copy the bucket makes, and the decode
    iterations (``K_pad + 1`` for a verify step).

    Buckets, as the engine keys them: ``decode`` ``(batch_pad,
    nb_pad)``; ``spec_verify`` ``(batch_pad, nb_pad, K_pad)``;
    ``decode_gather`` ``(B, pad_blocks)``; ``prefill`` ``(S,)``;
    ``prefix_prefill`` and ``chunk_prefill`` ``(S, nb_pad)``, ``nb_pad``
    the prefix blocks gathered."""
    if variant == "decode":
        return bucket[0], bucket[0], 0, 1
    if variant == "spec_verify":
        return bucket[0], bucket[0], 0, bucket[2] + 1
    if variant == "decode_gather":
        return bucket[0], bucket[0], bucket[0] * bucket[1] * block_size, 1
    if variant == "prefill":
        return bucket[0], 1, 0, 1
    if variant in ("prefix_prefill", "chunk_prefill"):
        return bucket[0], 1, bucket[1] * block_size, 1
    raise ValueError(f"unknown step variant {variant!r} (one of "
                     f"{VARIANTS})")


def expert_rows(cfg: ArchConfig, variant: str, rows: int) -> int:
    """Rows an MoE layer's expert GEMMs run over in a step of ``rows``
    padded rows: ``E * C`` a token chunk, ``C`` at the prefill capacity
    factor in a prefill and at the serve factor in a decode step (the
    dispatch buffer every expert reads, whatever the routing)."""
    moe = cfg.moe
    cf = moe.capacity_factor if variant in PREFILL_VARIANTS \
        else cfg.serve_capacity_factor
    n = token_chunks(rows)
    return n * moe.num_experts * capacity(cf, moe.top_k, rows // n,
                                          moe.num_experts)


def _ssm_cost(cfg: ArchConfig, variant: str, rows: int) -> ClassCost:
    """One Mamba2 layer: the in/out projections, the conv, the gated
    norm, and the SSD einsums (a prefill's chunked scan over its rows
    padded to whole chunks) or the decode state update; bytes: the
    weights, the activations and the state (a decode step reads and
    writes each row's, a prefill writes its own; the gather step also
    copies each row's out of its slot and back)."""
    s, isz = cfg.ssm, itemsize(cfg)
    d = cfg.d_model
    d_in, nh, conv_ch = ssm_dims(cfg)
    P, N, G, W = s.head_dim, s.d_state, s.ngroups, s.conv_width
    width = 2 * d_in + 2 * G * N + nh
    state = nh * P * N * 4 + (W - 1) * conv_ch * isz
    flops = rows * (2 * d * width + 2 * d_in * d + 2 * W * conv_ch
                    + 8 * d_in)
    if variant in PREFILL_VARIANTS:
        Q = min(s.chunk, rows)
        n_chunks = -(-rows // Q)
        flops += n_chunks * (2 * Q * Q * G * N + 3 * Q * Q * nh
                             + 2 * Q * Q * nh * P + 6 * Q * nh * P * N)
        state_bytes = state
    else:
        flops += rows * 6 * nh * P * N
        state_bytes = 2 * rows * state
        if variant == "decode_gather":
            state_bytes *= 2
    weights = _tree_numel(block_specs(cfg, SSM)["ssm"])
    acts = rows * (d + width + 2 * conv_ch + 2 * d_in + d)
    return ClassCost(flops=float(flops),
                     bytes=float((weights + acts) * isz + state_bytes))


def _cross_cost(cfg: ArchConfig, variant: str,
                rows: int) -> Tuple[ClassCost, ClassCost]:
    """One ``CROSS`` layer over ``rows`` padded rows: ``(attention,
    other)``. Attention: the query projection (its weights, input and
    output), and the attention onto ``n_img`` image K/V rows a row (a
    decode step's kernel reads each row's, after the slot gather has
    read and written them once; a prefill's reads the request's). Other,
    in a prefill: the image K/V projection (its weights, the image
    embeddings, the K/V out) and the K/V's write into the slot. (The
    output projection is ``matmul``'s, counted with the MLPs.)"""
    isz, d, H, K, hd = itemsize(cfg), cfg.d_model, cfg.n_heads, \
        cfg.n_kv_heads, cfg.hd
    N = cfg.n_img_tokens
    kv_row = 2 * K * hd * isz
    q_w = d * H * hd + (H * hd if cfg.qkv_bias else 0)
    attn = ClassCost(
        flops=float(rows * (2.0 * d * H * hd + 4 * H * hd * N)),
        bytes=float(q_w * isz + rows * (d + H * hd) * isz
                    + 2 * rows * H * hd * isz))
    other = ClassCost()
    if variant in PREFILL_VARIANTS:
        attn.bytes += N * kv_row
        other = ClassCost(flops=float(2.0 * N * d * 2 * K * hd),
                          bytes=float((2 * d * K * hd + N * d) * isz
                                      + 3 * N * kv_row))
    else:
        attn.bytes += 3 * rows * N * kv_row
    return attn, other


def step_census(cfg: ArchConfig, variant: str, bucket: Tuple,
                block_size: int) -> OpCensus:
    """The cost a step's bucket fixes: every class but attention's live
    terms (:func:`attention_cost`), which a sample adds."""
    rows, out_rows, copy_tokens, iters = variant_shape(variant, bucket,
                                                       block_size)
    isz = itemsize(cfg)
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    f, V = cfg.d_ff, cfg.padded_vocab
    n = layer_counts(cfg)
    up = (2 if cfg.act == "swiglu" else 1) * f
    act_ops = _ACT_OPS.get(cfg.act, 1)
    specs = param_specs(cfg)
    embed = specs["embed"]
    learned = "pos" in embed
    unemb = _numel((embed.get("unemb") or embed["tok"]).shape)
    c = OpCensus()

    mm = c.per_class["matmul"]
    attn_w = d * (H + 2 * K) * hd + H * hd * d
    ew = 0
    if cfg.qkv_bias:
        ew += (H + 2 * K) * hd
    if cfg.pos == "rope":
        # the rotations of q and k, and the angles they share
        ew += 3 * (H + K) * hd + hd + 1
    mm.flops = n["kv"] * rows * (2.0 * attn_w + ew) \
        + n["mlp"] * rows * (2.0 * _mlp_weights(cfg) + f * act_ops) \
        + n["cross"] * rows * 2.0 * H * hd * d
    norm_p = _tree_numel(specs["final_norm"])
    attn_p = _tree_numel(attn_specs(cfg))
    mm.bytes = (n["kv"] * (attn_p + rows * (2 * d + (2 * H + 2 * K) * hd))
                + n["mlp"] * (_mlp_weights(cfg)
                              + rows * (2 * d + up + f))
                + n["cross"] * H * hd * (d + rows) + n["cross"] * rows * d
                ) * isz
    if n["moe"]:
        E, k = cfg.moe.num_experts, cfg.moe.top_k
        ec = expert_rows(cfg, variant, rows)
        mm.flops += n["moe"] * ec * (2.0 * _mlp_weights(cfg) + f * act_ops)
        mm.bytes += n["moe"] * (E * _mlp_weights(cfg)
                                + ec * (2 * d + up + f)) * isz
        moe = c.per_class["moe_dispatch"]
        # the float32 router and its softmax; the dispatch buffer's
        # write and read; the combine's gather, weights and sum
        moe.flops = n["moe"] * (rows * (2.0 * d * E + 5 * E)
                                + 3.0 * rows * k * d)
        moe.bytes = n["moe"] * (d * E * 4 + rows * E * 4 + rows * d * isz
                                + 2 * ec * d * isz
                                + rows * k * d * isz + rows * d * isz)
    if n["ssm"]:
        c.per_class["ssm"].add(_ssm_cost(cfg, variant, rows), n["ssm"])

    head = c.per_class["head"]
    head.flops = 2.0 * out_rows * d * V
    lookups = 2 if learned else 1
    embed_ops = rows * (lookups * d + (d if learned else 0)
                        + (7 if learned else 6))
    head.bytes = (unemb + out_rows * d + lookups * rows * d) * isz \
        + out_rows * V * LOGIT_BYTES

    other = c.per_class["other"]
    norm = _NORM_OPS.get(cfg.norm, 8)
    n_norms = 2 * (n["kv"] + n["cross"]) + n["ssm"] + 1
    n_res = 2 * (n["kv"] + n["cross"]) + n["ssm"]
    other.flops = n_norms * rows * d * norm + n_res * rows * d \
        + out_rows * V
    other.bytes = (n_norms * 2 * rows * d + n_res * 3 * rows * d
                   + n_norms * norm_p) * isz + out_rows * V * LOGIT_BYTES
    if variant in PREFILL_VARIANTS:
        head.flops += embed_ops
    else:
        other.flops += embed_ops

    attn = c.per_class["attention"]
    attn.bytes = 2.0 * copy_tokens * n["kv"] * 2 * K * hd * isz
    if n["cross"]:
        x_attn, x_other = _cross_cost(cfg, variant, rows)
        attn.add(x_attn, n["cross"])
        other.add(x_other, n["cross"])

    for cls in c.per_class.values():
        cls.flops *= iters
        cls.bytes *= iters
    c.flops = sum(v.flops for v in c.per_class.values())
    c.bytes = sum(v.bytes for v in c.per_class.values())
    c.per_class = dict(c.per_class)
    c.per_collective = {}
    return c


def attention_cost(cfg: ArchConfig, variant: str, bucket: Tuple,
                   live: LiveWork, block_size: int) -> ClassCost:
    """A step's live attention terms (the module docstring's formula)
    from its :class:`LiveWork`."""
    _, _, _, iters = variant_shape(variant, bucket, block_size)
    H, hd, L = cfg.n_heads, cfg.hd, layer_counts(cfg)["kv"]
    rows = live.rows
    if variant in PREFILL_VARIANTS:
        reads = rows + live.context
        pairs = rows * (rows + 1) / 2 + rows * live.context
    else:
        reads = pairs = live.context
    per_layer = _kernel_bytes(cfg, reads, rows, live.entries) \
        + rows * 2 * cfg.n_kv_heads * hd * itemsize(cfg)
    return ClassCost(flops=float(iters * L * 4 * H * hd * pairs),
                     bytes=float(iters * L * per_layer))


def _kernel_bytes(cfg: ArchConfig, reads: int, rows: int,
                  entries: int) -> float:
    isz = itemsize(cfg)
    return float(reads * 2 * cfg.n_kv_heads * cfg.hd * isz
                 + 2 * rows * cfg.n_heads * cfg.hd * isz
                 + 4 * (entries + rows))


def kernel_bytes(cfg: ArchConfig, live: LiveWork) -> float:
    """The bytes one layer's decode attention kernel must move for a
    step's :class:`LiveWork` (K/V reads, q and out, table entries and
    lengths; the pool writes are the step's, not the kernel's): the
    figure ``chip_smoke.py``'s paged-kernel bound divides by the memory
    rate."""
    return _kernel_bytes(cfg, live.context, live.rows, live.entries)


def with_attention(census: OpCensus, attn: ClassCost) -> OpCensus:
    """A copy of a bucket's census with a sample's live attention terms
    added."""
    per_class = {k: dataclasses.replace(v) for k, v in
                 census.per_class.items()}
    per_class.setdefault("attention", ClassCost()).add(attn)
    return OpCensus(flops=census.flops + attn.flops,
                    bytes=census.bytes + attn.bytes,
                    coll_bytes=census.coll_bytes, per_class=per_class,
                    per_collective=dict(census.per_collective))
