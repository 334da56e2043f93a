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
* ``other``: norms, residual adds and the sampler (a coarse count).

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

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import param_specs


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
_ACT_OPS = {"relu": 1, "swiglu": 3, "gelu": 8}
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


def param_count(cfg: ArchConfig) -> int:
    """Every parameter of the model (the port's dense decoders)."""
    specs = param_specs(cfg)
    total = sum(_numel(s.shape) for s in specs["embed"].values())
    for grp in specs["stack"][0].values():
        total += sum(_numel(s.shape) for s in grp.values())
    total += sum(_numel(s.shape) for s in specs["final_norm"].values())
    return total


def _layer_params(cfg: ArchConfig) -> Dict[str, int]:
    """One layer's parameter counts by group (``attn``, ``ffn``, norms),
    and its GEMM weights' (biases excluded)."""
    stack = param_specs(cfg)["stack"][0]
    L = cfg.n_layers
    out = {grp: sum(_numel(s.shape) for s in leaves.values()) // L
           for grp, leaves in stack.items()}
    out["gemm"] = sum(_numel(s.shape) // L
                      for grp in ("attn", "ffn")
                      for name, s in stack[grp].items()
                      if name.startswith("w"))
    return out


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


def step_census(cfg: ArchConfig, variant: str, bucket: Tuple,
                block_size: int) -> OpCensus:
    """The cost a step's bucket fixes: every class but attention's live
    terms (:func:`attention_cost`), which a sample adds."""
    rows, out_rows, copy_tokens, iters = variant_shape(variant, bucket,
                                                       block_size)
    isz = itemsize(cfg)
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    f, L, V = cfg.d_ff, cfg.n_layers, cfg.padded_vocab
    gated = cfg.act == "swiglu"
    lp = _layer_params(cfg)
    embed = param_specs(cfg)["embed"]
    learned = "pos" in embed
    unemb = _numel((embed.get("unemb") or embed["tok"]).shape)
    c = OpCensus()

    mm = c.per_class["matmul"]
    up = (2 if gated else 1) * f
    ew = rows * f * _ACT_OPS.get(cfg.act, 1)
    if cfg.qkv_bias:
        ew += rows * (H + 2 * K) * hd
    mm.flops = L * (2.0 * rows * lp["gemm"] + ew)
    acts = (rows * d + rows * (H + 2 * K) * hd      # qkv in, out
            + rows * H * hd + rows * d              # o in, out
            + rows * d + rows * up                  # up in, out
            + rows * f + rows * d)                  # down in, out
    mm.bytes = L * (lp["attn"] + lp["ffn"] + acts) * isz

    head = c.per_class["head"]
    head.flops = 2.0 * out_rows * d * V
    lookups = 2 if learned else 1
    embed_ops = rows * (lookups * d + (d if learned else 0)
                        + (7 if learned else 6))
    head.bytes = (unemb + out_rows * d + lookups * rows * d) * isz \
        + out_rows * V * LOGIT_BYTES

    other = c.per_class["other"]
    norm = _NORM_OPS.get(cfg.norm, 8)
    other.flops = (2 * L + 1) * rows * d * norm + 2 * L * rows * d \
        + out_rows * V
    other.bytes = ((2 * L + 1) * 2 * rows * d + 2 * L * 3 * rows * d
                   + (2 * L + 1) * lp["ln1"]) * isz \
        + out_rows * V * LOGIT_BYTES
    if variant in PREFILL_VARIANTS:
        head.flops += embed_ops
    else:
        other.flops += embed_ops

    attn = c.per_class["attention"]
    attn.bytes = 2.0 * copy_tokens * L * 2 * K * hd * isz

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
    H, hd, L = cfg.n_heads, cfg.hd, cfg.n_layers
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
