"""Analytic per-step cost census, beside the measured one.

The reference compiles each step ahead of time and reads its FLOPs and
HBM bytes off the optimized XLA program (``repro.core.analysis``). The
port measures the same figures from the operations a step dispatches
(:mod:`repro_torch.core.analysis`, whose ``ClassCost`` and ``OpCensus``
this module fills): a bucket's eager first use runs under that census,
which the live roofline keeps beside this one, and the dry-run's
one-device cases run their step under it on meta tensors. This module
computes each step's cost from the model config and the step's bucket,
with no step run: the figure every roofline sample reads (its live
attention terms come from the step's data, which the measured census
does not read from the device), and the dry-run's per-device census on
a mesh, collectives included, which no single card can run. In the
reference's kernel classes:

* ``matmul``: the QKV, output-projection and MLP GEMMs, ``2·M·N·K`` over
  the bucket's padded rows (as XLA counts them), plus the MLP
  activation's elementwise operations (the reference files them under
  the same scope); bytes: the weights, and each GEMM's input and output.
* ``head``: the unembed GEMM over the rows whose logits the step returns
  (every row of a decode step, the last row of a prefill). In a prefill
  program also the embedding lookup (its gathered rows, and its
  elementwise work: the clamped gathers' selects and index checks and
  the positional add), which the reference runs under its ``embed``
  scope in a prefill and under none in a decode step
  (``_decode_embed``), where its census files it under ``other``;
  bytes: the unembed weight, the logits.
* ``attention``: the attention kernels' K/V reads and the new rows' pool
  writes (formula below), and the dense copies a bucket fixes.
* ``other``: norms, residual adds and the sampler (a coarse count), a
  decode step's embedding lookup; in a VLM prefill also the ``CROSS``
  layers' image K/V projection and its write into the request's slot
  (the reference's ``cross_kv`` scope, which its census's class rules
  leave in ``other``).

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
import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ATTN, CROSS, SHARED_ATTN, SSM, ArchConfig
from repro_torch.core.analysis import ClassCost, OpCensus
from repro_torch.kernels.decode_attention import split_plan
# the module, not its names: the models import this package (for
# ``analysis.scope``) while they load
from repro_torch.models import moe as moe_layer
from repro_torch.models.params import (abstract_cache, block_specs,
                                       param_specs, plan_structure,
                                       spec_dtype, ssm_dims, tree_leaves)
from repro_torch.sharding import BATCH, LAYERS, axes_of


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
    spec = cfg.moe
    cf = spec.capacity_factor if variant in PREFILL_VARIANTS \
        else cfg.serve_capacity_factor
    n = moe_layer.token_chunks(rows)
    return n * spec.num_experts * moe_layer.capacity(
        cf, spec.top_k, rows // n, spec.num_experts)


def _ssm_state_bytes(cfg: ArchConfig) -> int:
    """One row's SSM state in one layer: ``h`` (float32) and the conv
    tail."""
    s = cfg.ssm
    _, nh, conv_ch = ssm_dims(cfg)
    return nh * s.head_dim * s.d_state * 4 + (s.conv_width - 1) * conv_ch \
        * itemsize(cfg)


class _Census:
    """One step's census, built term by term, per device under ``rules``
    (the whole step without them): a product's work divides by its
    weight's spec, its rows by ``b``, the batch axes' share of the
    ``batch``. A train step's terms are taken ``passes`` times, its
    weights read once a microbatch (``micro``) and a pass."""

    def __init__(self, cfg: ArchConfig, rules=None, batch: int = 1,
                 passes: int = 1, micro: int = 1, train: bool = False):
        self.cfg, self.rules, self.isz = cfg, rules, itemsize(cfg)
        self.passes, self.micro, self.train = passes, micro, train
        self.b = 1 if rules is None else \
            rules.axis_size(rules.spec((BATCH,), (batch,))[0])
        self.c = OpCensus()
        for cls in ("matmul", "attention", "head", "other"):
            self.c.per_class[cls]

    def spec(self, logical, shape):
        if self.rules is None:
            return (None,) * len(shape)
        return self.rules.spec(logical, shape)

    def sizes(self, spec, dims, batch_axes: bool) -> int:
        """The product of the mesh sizes at ``dims``, counting only the
        batch axes (``batch_axes``) or only the others."""
        if self.rules is None:
            return 1
        n = 1
        for i in dims:
            for a in axes_of(spec[i]):
                if (a in self.rules.batch_axes) == batch_axes:
                    n *= self.rules.mesh.shape[a]
        return n

    def leaf_sizes(self, leaf, dims, batch_axes: bool = False) -> int:
        """:meth:`sizes` of a leaf's own spec (its ``LAYERS`` dim
        dropped)."""
        shape, logical = _unstacked(leaf)
        return self.sizes(self.spec(logical, shape), dims, batch_axes)

    def add(self, cls: str, flops: float, nbytes: float):
        cc = self.c.per_class[cls]
        cc.flops += flops
        cc.bytes += nbytes

    def coll(self, kind: str, nbytes: float):
        if nbytes > 0:
            factor = 2.0 if kind == "all-reduce" else 1.0
            self.c.coll_bytes += nbytes * factor
            self.c.per_collective[kind] += nbytes * factor

    def matmul(self, cls, leaf, contract, out, n_rows, count,
               expert_dim=None, ew=0.0, wbytes=None, out_isz=None,
               x_in=True, bias=None):
        """``count`` uses of the product of ``n_rows`` rows with the leaf;
        ``contract``/``out`` its dims, ``expert_dim`` an MoE weight's
        experts dim, ``ew`` elementwise operations a row of the output,
        ``out_isz`` the output's itemsize, ``bias`` a leaf added to the
        output. Without ``x_in`` the input is not counted again (the
        product shares it with the one before). Its collectives are the
        :func:`dryrun_census` formula's."""
        shape, logical = _unstacked(leaf)
        sp = self.spec(logical, shape)
        sk = self.sizes(sp, contract, False)
        sn = self.sizes(sp, out, False)
        kin = _numel([shape[i] for i in contract])
        nout = _numel([shape[i] for i in out])
        w_local = kin * nout / (sk * sn)
        r = n_rows / self.b
        if expert_dim is not None:       # each expert row meets one expert
            es = self.sizes(sp, (expert_dim,), True)
            w_local *= shape[expert_dim] / es
            r = n_rows / max(self.b, es)
        isz, passes, micro = self.isz, self.passes, self.micro
        w_bytes = w_local * (wbytes or isz)
        if bias is not None:
            w_bytes += _numel(bias.shape[-len(out):]) / sn * isz
        flops = (2.0 * kin * nout / (sk * sn) + ew / sn) * r * passes * count
        nbytes = (w_bytes * micro + r * ((kin / sk * isz if x_in else 0.0)
                                         + nout / sn * (out_isz or isz))
                  ) * passes * count
        self.add(cls, flops, nbytes)
        fsdp = self.sizes(sp, range(len(shape)), True)
        if expert_dim is not None:
            fsdp //= es
        gathered = w_local * (wbytes or isz) * count
        if fsdp > 1:
            self.coll("all-gather", gathered * micro * (3 if self.train
                                                          else 1))
            if self.train:
                self.coll("reduce-scatter", gathered * micro)
        if sk > 1:
            self.coll("all-reduce", r * nout / sn * isz * count
                      * (2 if self.train else 1))
        if self.train and sn > 1:
            self.coll("all-reduce", r * kin / sk * isz * count)
        if self.train and self.b > 1 and fsdp == 1 and expert_dim is None:
            self.coll("all-reduce", gathered)

    def done(self, iters: int = 1) -> OpCensus:
        c = self.c
        for cls in c.per_class.values():
            cls.flops *= iters
            cls.bytes *= iters
        c.flops = sum(v.flops for v in c.per_class.values())
        c.bytes = sum(v.bytes for v in c.per_class.values())
        c.per_class = dict(c.per_class)
        c.per_collective = dict(c.per_collective)
        return c


def _unstacked(leaf):
    """A leaf's shape and logical axes without its stacked ``LAYERS``
    dim."""
    if leaf.logical and leaf.logical[0] == LAYERS:
        return leaf.shape[1:], leaf.logical[1:]
    return leaf.shape, leaf.logical


def _model_terms(cen: _Census, rows: int, out_rows: int, seq: int,
                 seqs: int, prefill: bool, gather: bool = False):
    """Every term of a step over ``rows`` rows (``seqs`` sequences of
    ``seq``) but its attention proper: the attention layers' and a
    ``CROSS`` layer's output projections and the MLPs (``matmul``), the
    routed experts (``matmul``, the router and dispatch
    ``moe_dispatch``), the Mamba2 mixers (``ssm``: projections, the
    other weights, the scan or state update; the gather step's state
    copy out of its slot and back), the unembed over ``out_rows`` rows
    and the embedding lookups (``head``), norms, residuals and the
    sampler (``other``), the embedding's elementwise work in ``head``
    for a prefill and in ``other`` for a decode step. Each activation is
    written once and read once (the module docstring's rule)."""
    cfg, isz, b, passes = cen.cfg, cen.isz, cen.b, cen.passes
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    f, V = cfg.d_ff, cfg.padded_vocab
    n = layer_counts(cfg)
    specs = param_specs(cfg)
    act = f * _ACT_OPS.get(cfg.act, 1)
    if n["kv"]:
        attn = specs["shared"]["attn"] if "shared" in specs else \
            _first_block(specs, "attn")
        ew = 0.0
        if cfg.qkv_bias:
            ew += (H + 2 * K) * hd
        if cfg.pos == "rope":
            # the rotations of q and k, and the angles they share
            ew += 3 * (H + K) * hd + hd + 1
        cen.matmul("matmul", attn["wq"], (0,), (1, 2), rows, n["kv"], ew=ew,
                   bias=attn.get("bq"))
        for w in ("wk", "wv"):
            cen.matmul("matmul", attn[w], (0,), (1, 2), rows, n["kv"],
                       x_in=False, bias=attn.get("b" + w[1]))
        cen.matmul("matmul", attn["wo"], (0, 1), (2,), rows, n["kv"])
    if n["cross"]:
        cen.matmul("matmul", _first_block(specs, "attn")["wo"], (0, 1),
                   (2,), rows, n["cross"])
    if n["mlp"]:
        mlp = _mlp_block(specs, cfg)
        cen.matmul("matmul", mlp["w1"], (0,), (1,), rows, n["mlp"], ew=act)
        if "w3" in mlp:
            cen.matmul("matmul", mlp["w3"], (0,), (1,), rows, n["mlp"],
                       x_in=False)
        cen.matmul("matmul", mlp["w2"], (0,), (1,), rows, n["mlp"])
    if n["moe"]:
        moe, E, k = _first_block(specs, "ffn"), cfg.moe.num_experts, \
            cfg.moe.top_k
        ec = expert_rows(cfg, "prefill" if prefill else "decode", rows)
        # the float32 router and its softmax
        cen.matmul("moe_dispatch", moe["router"], (0,), (1,), rows, n["moe"],
                   ew=5.0 * E, wbytes=4, out_isz=4)
        for w, ew in (("w1", act), ("w3", 0.0), ("w2", 0.0)):
            if w in moe:
                cen.matmul("matmul", moe[w], (1,), (2,), ec, n["moe"],
                           expert_dim=0, ew=ew, x_in=w != "w3")
        # the dispatch buffer's write and read; the combine's gather,
        # weights and sum
        es = cen.leaf_sizes(moe["w1"], (0,), True)
        local = ec * d * isz / max(b, es)
        cen.add("moe_dispatch", 3.0 * rows / b * k * d * passes * n["moe"],
                (2 * local + rows / b * (k + 1) * d * isz) * passes
                * n["moe"])
        if es > 1:
            cen.coll("all-to-all", 2 * local * n["moe"]
                     * (2 if cen.train else 1))
    if n["ssm"]:
        ssm = _first_block(specs, "ssm")
        cen.matmul("ssm", ssm["in_proj"], (0,), (1,), rows, n["ssm"])
        cen.matmul("ssm", ssm["out_proj"], (0,), (1,), rows, n["ssm"],
                   x_in=False)
        hs = cen.leaf_sizes(ssm["a_log"], (0,))
        rest = sum(_numel(_unstacked(leaf)[0]) for name, leaf in ssm.items()
                   if name not in ("in_proj", "out_proj"))
        scan = _ssm_scan_cost(cfg, "prefill" if prefill else "decode", seq,
                              seqs)
        if gather:
            scan.bytes += 2 * rows * _ssm_state_bytes(cfg)
        cen.add("ssm", scan.flops * passes * n["ssm"] / (b * hs),
                (rest * isz * cen.micro + scan.bytes / b) * passes
                * n["ssm"] / hs)

    embed = specs["embed"]
    if "unemb" in embed:
        cen.matmul("head", embed["unemb"], (0,), (1,), out_rows, 1,
                   out_isz=LOGIT_BYTES)
    else:
        cen.matmul("head", embed["tok"], (1,), (0,), out_rows, 1,
                   out_isz=LOGIT_BYTES)
    learned = "pos" in embed
    lookups = 2 if learned else 1
    cen.add("head" if prefill else "other", 0.0,
            lookups * rows * d * isz * passes / b)
    # the clamped gathers' selects and index checks, the positional add
    embed_ops = rows * (lookups * d + (d if learned else 0)
                        + (7 if learned else 6))
    cen.add("head" if prefill else "other", embed_ops * passes / b, 0.0)

    norm = _NORM_OPS.get(cfg.norm, 8)
    norm_p = _tree_numel(specs["final_norm"])
    n_norms = 2 * (n["kv"] + n["cross"]) + n["ssm"] + 1
    n_res = 2 * (n["kv"] + n["cross"]) + n["ssm"]
    cen.add("other", (n_norms * rows * d * norm + n_res * rows * d
                      + out_rows * V) * passes / b,
            ((n_norms * 2 * rows * d + n_res * 3 * rows * d) * isz
             + out_rows * V * LOGIT_BYTES) * passes / b
            + n_norms * norm_p * isz * cen.micro * passes)


def _cross_terms(cen: _Census, rows: int, seqs: int, reads: str):
    """The ``CROSS`` layers' query projection and their attention onto
    ``n_img`` image K/V rows a row (``attention``; each sequence's image
    K/V read once in a prefill, each row's in a decode step: ``reads``
    ``"prefill"``, ``"decode"``, or ``"gather"`` where a slot gather has
    first read and written them once); in a prefill also the image K/V
    projection of the ``seqs`` sequences and its write into the slot
    (``other``). (The output projection is :func:`_model_terms`'.)"""
    cfg, isz, b, passes = cen.cfg, cen.isz, cen.b, cen.passes
    H, K, hd, N = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_img_tokens
    n = layer_counts(cfg)["cross"]
    kv_row = 2 * K * hd * isz
    xattn = _first_block(param_specs(cfg), "attn")  # a CROSS block's shapes
    cen.matmul("attention", xattn["wq"], (0,), (1, 2), rows, n,
               bias=xattn.get("bq"))
    a = cen.leaf_sizes(xattn["wq"], (1, 2))
    image = {"prefill": seqs, "decode": rows, "gather": 3 * rows}[reads] \
        * N * kv_row
    cen.add("attention", 4.0 * H * hd * N * rows * passes * n / (b * a),
            (2 * rows * H * hd * isz + image) * passes * n / (b * a))
    if reads == "prefill":
        cen.matmul("other", xattn["wk"], (0,), (1, 2), seqs * N, n)
        cen.matmul("other", xattn["wv"], (0,), (1, 2), seqs * N, n,
                   x_in=False)
        cen.add("other", 0.0, 2 * seqs * N * kv_row * passes * n / b)


def step_census(cfg: ArchConfig, variant: str, bucket: Tuple,
                block_size: int) -> OpCensus:
    """The cost a step's bucket fixes: every class but attention's live
    terms (:func:`attention_cost`), which a sample adds."""
    rows, out_rows, copy_tokens, iters = variant_shape(variant, bucket,
                                                       block_size)
    prefill = variant in PREFILL_VARIANTS
    cen = _Census(cfg)
    _model_terms(cen, rows, out_rows, rows if prefill else 1,
                 1 if prefill else rows, prefill,
                 gather=variant == "decode_gather")
    n = layer_counts(cfg)
    cen.add("attention", 0.0, 2.0 * copy_tokens * n["kv"] * 2
            * cfg.n_kv_heads * cfg.hd * cen.isz)
    if n["cross"]:
        _cross_terms(cen, rows, 1, "prefill" if prefill else "gather")
    c = cen.done(iters)
    c.per_collective = {}
    return c


def mesh_collectives(cfg: ArchConfig, layout, variant: str, rows: int,
                     out_rows: int, rules=None,
                     outputs: bool = False) -> Dict[str, float]:
    """The collective bytes one step of a dense decoder issues on a rank
    of a mesh under its plan ``layout``
    (:class:`~repro_torch.sharding.Layout`), by kind, in the census's
    convention (an all-reduce twice its payload, an all-gather its
    output, a reduce-scatter its input): ``rows`` rows through the stack
    (a decode step's batch, a prefill's ``B x S``), ``out_rows`` of them
    through the final norm and the unembedding. What
    :mod:`repro_torch.distributed` records for the layers' calls, term
    by term: the lookup's partial rows; a norm's float32 row sums over a
    d_model-sharded residual; the gathered input of the projections (not
    a row-parallel ``wq``) and of the MLP; a row-parallel ``q/k/v``'s
    all-reduce or a head-dim-sharded one's all-gather; the query heads
    gathered where attention runs over more than the rank's (every head,
    a decode over a sharded KV sequence); that decode's ``[B, H, hd +
    2]`` float32 partials; ``wo``'s and ``w2``'s partial sums
    (reduce-scattered over a sharded residual, else all-reduced); the
    logits. Over a data axis of D ranks ``rows``/``out_rows`` are the
    rank's own, and the data group adds, under FSDP (the plan's
    ``w_in``; ``rules`` gives each weight's block), each gathered
    weight's whole bytes a layer (the unembedding's once a step); with
    ``outputs``, an engine step's gather of its outputs over the data
    axis (:meth:`~repro_torch.serving.steps.StepFunctions._sample`: a
    decode step's ``out_rows`` int32 tokens and one finiteness word a
    rank; a prefill's float32 logits)."""
    isz, d, hd, m = itemsize(cfg), cfg.d_model, cfg.hd, layout.size
    h, k = cfg.n_heads, cfg.n_kv_heads
    stats = 8 if cfg.norm == "layernorm" else 4
    seq_decode = layout.kv_seq and variant in DECODE_VARIANTS
    want = (0, h) if seq_decode else layout.attn_heads
    step: Dict[str, float] = dict.fromkeys(
        ("all-reduce", "all-gather", "reduce-scatter"), 0.0)
    layer = dict(step)

    def add(into: Dict[str, float], kind: str, nbytes: float):
        into[kind] += 2 * nbytes if kind == "all-reduce" else nbytes

    def partial(into: Dict[str, float], nbytes: float):
        add(into, "reduce-scatter" if layout.residual else "all-reduce",
            nbytes)

    if layout.tok == "vocab":
        partial(step, rows * d * isz)
    if layout.residual:
        add(layer, "all-reduce", 2 * rows * stats)         # ln1, ln2
        add(layer, "all-gather", rows * d * isz)           # the MLP's input
        if layout.wq != "rows":
            add(layer, "all-gather", rows * d * isz)       # the projections'
    for kind, n in ((layout.wq, h), (layout.wkv, k), (layout.wkv, k)):
        if kind == "rows":
            add(layer, "all-reduce", rows * n * hd * isz)
        elif kind == "head_dim":
            add(layer, "all-gather", rows * n * hd * isz)
    if want != layout.heads:
        add(layer, "all-gather",
            rows * m * (layout.heads[1] - layout.heads[0]) * hd * isz)
    if seq_decode:
        add(layer, "all-gather", m * rows * h * (hd + 2) * 4)
    if layout.wo in ("heads", "head_dim"):
        partial(layer, rows * d * isz)
    if layout.ffn:
        partial(layer, rows * d * isz)
    n = layer_counts(cfg)["kv"]
    for kind, nbytes in layer.items():
        step[kind] += n * nbytes
    if layout.residual:
        add(step, "all-reduce", out_rows * stats)          # the final norm
        if layout.logits != "d_model":
            add(step, "all-gather", out_rows * d * isz)
    if layout.logits == "vocab":
        add(step, "all-gather", out_rows * cfg.padded_vocab * LOGIT_BYTES)
    elif layout.logits == "d_model":
        add(step, "all-reduce", out_rows * cfg.padded_vocab * LOGIT_BYTES)
    if layout.w_in:
        leaves = dict(block_specs(cfg, ATTN)["attn"],
                      **block_specs(cfg, ATTN)["ffn"],
                      unemb=param_specs(cfg)["embed"].get("unemb"))
        for name, _ in layout.w_in:
            leaf = leaves[name]
            block = math.prod(b - a for a, b in layout.cut(
                leaf.logical, leaf.shape, rules))
            nbytes = layout.data * block * torch.empty(
                (), dtype=spec_dtype(cfg, leaf)).element_size()
            add(step, "all-gather", nbytes if name == "unemb" else n * nbytes)
    if outputs and layout.data > 1:
        add(step, "all-gather", layout.data * (
            (out_rows + 1) * 4 if variant in DECODE_VARIANTS
            else out_rows * cfg.vocab_size * LOGIT_BYTES))
    return step


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


# ------------------------------------------------------------- dry-run ----
# The dry-run's step kinds (``repro.launch.input_specs``' cases): a train
# step (forward, each period recomputed, backward, AdamW), a whole-prompt
# prefill, the encoder's forward and a static decode step of one token
# over a contiguous (or ring) cache.
DRYRUN_KINDS = ("train", "prefill", "encode", "decode")
TRAIN_PASSES = 4          # forward, recompute, backward (two products)
_ADAMW_OPS = 14           # AdamW's float32 operations a parameter


@dataclasses.dataclass(frozen=True)
class StepShape:
    """What one dry-run step computes: ``kind`` (:data:`DRYRUN_KINDS`)
    over ``batch`` sequences of ``seq`` tokens (a decode step: one token
    a sequence at position ``seq - 1`` over ``kv_len`` cache slots), the
    train step in ``microbatches`` pieces with moments of
    ``moment_bytes``."""
    kind: str
    batch: int
    seq: int
    kv_len: int = 0
    microbatches: int = 1
    moment_bytes: int = 4


def dryrun_census(cfg: ArchConfig, step: StepShape,
                  rules=None) -> OpCensus:
    """One dry-run step's cost, per device under ``rules`` (the whole
    step without them), from the serving steps' own terms
    (:func:`_model_terms`, :func:`_cross_terms`, the attention bytes of
    :func:`attention_cost`'s formula with no block table): without rules
    a decode step is :func:`step_census`'s paged decode step with its
    live attention, a one-sequence prefill its serial prefill. How each
    term divides:

    * each weight's product over the step's rows (``2·rows·K·N``; a train
      step ``TRAIN_PASSES`` times) runs on ``rows / b`` rows (``b`` the
      batch axes' share of the batch) and ``1 / m`` of the weight (``m``
      the model-axis sizes of its spec); its bytes are that slice of the
      weight and of its input and output activations. An MoE expert GEMM
      divides its rows by the larger of ``b`` and the experts' shard;
    * attention (pairs x ``4·H·hd``; a decode step's K/V read over its
      ``kv_len`` slots) divides by ``b`` and the model axis where the
      cache (decode) or the query heads (otherwise) are sharded on it;
    * the SSM scan or state update divides by ``b`` and the heads' shard;
      norms, residuals, the embedding and the sampler by ``b`` only;
    * AdamW (train) reads and writes each parameter's shard once.

    Collectives (per device, the reference census's convention: an
    all-reduce's payload counted twice), a lower bound on what a
    partitioner moves, reshardings of activations not counted:

    * ``all-gather`` of each weight sharded over the batch axes (FSDP)
      at each use (3 a microbatch of a train step: forward, recompute,
      backward; 1 otherwise), the gathered slice's bytes; in a train step
      a ``reduce-scatter`` of its gradient a microbatch, the same bytes;
      the gradient of a leaf not sharded over the batch axes is
      all-reduced over them when the batch is (``all-reduce``);
    * ``all-reduce`` of a product's local output where the weight's
      contracting dims are sharded on the model axis (forward and
      recompute), and in the backward of its input gradient where the
      output dims are;
    * ``all-to-all`` of the MoE dispatch buffer out and back where the
      experts are sharded (twice more in a train step's backward);
    * ``all-reduce`` of the attention's float32 partials ``(acc, m, l)``
      where the KV sequence is sharded (``shard_kv_seq``, decode).
    """
    if step.kind not in DRYRUN_KINDS:
        raise ValueError(f"unknown dry-run kind {step.kind!r} (one of "
                         f"{DRYRUN_KINDS})")
    B, S = step.batch, step.seq
    train = step.kind == "train"
    decode = step.kind == "decode"
    rows = B if decode else B * S
    out_rows = {"decode": B, "prefill": B}.get(step.kind, rows)
    cen = _Census(cfg, rules, B, passes=TRAIN_PASSES if train else 1,
                  micro=step.microbatches if train else 1, train=train)
    isz, b, passes = cen.isz, cen.b, cen.passes
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n = layer_counts(cfg)
    specs = param_specs(cfg)
    _model_terms(cen, rows, out_rows, 1 if decode else S,
                 B, not decode)

    # --- self-attention: the kernel's K/V reads, q and out, lengths, and
    # the new rows' cache writes (the paged formula with no table)
    if n["kv"]:
        kv_row = 2 * K * hd * isz
        if decode:
            cache = abstract_cache(cfg, B, step.kv_len)["k"]
            sp = cen.spec(cache.logical, cache.shape)
            a = cen.sizes(sp, (2, 3, 4), False)
            reads = min(S, cache.shape[2])
            flops = 4.0 * H * hd * B * reads
            nbytes = _kernel_bytes(cfg, B * reads, B, 0) + B * kv_row
            if rules is not None and rules.shard_kv_seq and \
                    cen.sizes(sp, (2,), False) > 1:
                cen.coll("all-reduce", B / b * H * (hd + 2) * 4 * n["kv"])
        else:
            attn = specs["shared"]["attn"] if "shared" in specs else \
                _first_block(specs, "attn")
            a = cen.leaf_sizes(attn["wq"], (1, 2))
            W = cfg.sliding_window
            if not cfg.causal:
                pairs = S * S
            elif W is None or W >= S:
                pairs = S * (S + 1) / 2
            else:
                pairs = W * (W + 1) / 2 + (S - W) * W
            flops = 4.0 * H * hd * B * pairs * passes
            nbytes = _kernel_bytes(cfg, B * S, B * S, 0) * passes
            if step.kind == "prefill":       # the cache written out
                nbytes += B * min(S, W or S) * kv_row
        cen.add("attention", flops * n["kv"] / (b * a),
                nbytes * n["kv"] / (b * a))
    if n["cross"]:
        _cross_terms(cen, rows, B, "decode" if decode else "prefill")

    # --- AdamW: each parameter's shard read and written once
    if train:
        flops = nbytes = 0.0
        for _, leaf in tree_leaves(specs):
            sp = cen.spec(leaf.logical, leaf.shape)
            local = _numel(leaf.shape) / (
                cen.sizes(sp, range(len(leaf.shape)), True)
                * cen.sizes(sp, range(len(leaf.shape)), False))
            p_isz = 4 if leaf.dtype == "float32" else isz
            flops += _ADAMW_OPS * local
            nbytes += local * (3 * p_isz + 4 * step.moment_bytes)
        cen.add("optimizer", flops, nbytes)
    return cen.done()


def _first_block(specs, group: str):
    for entry in list(specs["stack"]) + list(specs["rem"]):
        if group in entry:
            return entry[group]
    raise KeyError(group)


def _mlp_block(specs, cfg: ArchConfig):
    """A dense MLP's leaves: the shared block's, a CROSS block's, an MoE
    model's residual branch or the dense family's."""
    if "shared" in specs:
        return specs["shared"]["ffn"]
    if cfg.moe is not None:
        return _first_block(specs, "ffn")["dense"]
    return _first_block(specs, "ffn")


def _ssm_scan_cost(cfg: ArchConfig, variant: str, seq: int,
                   seqs: int) -> ClassCost:
    """A Mamba2 layer's work besides its two projections, for ``seqs``
    sequences: the conv, the gated norm and the SSD chunked scan over
    ``seq`` rows each (a prefill) or the decode state update (its state
    read and written a row)."""
    s, isz = cfg.ssm, itemsize(cfg)
    d_in, nh, conv_ch = ssm_dims(cfg)
    P, N, G, W = s.head_dim, s.d_state, s.ngroups, s.conv_width
    state = _ssm_state_bytes(cfg)
    rows = seq * seqs
    flops = rows * (2 * W * conv_ch + 8 * d_in)
    if variant in PREFILL_VARIANTS:
        Q = min(s.chunk, seq)
        n_chunks = -(-seq // Q) * seqs
        flops += n_chunks * (2 * Q * Q * G * N + 3 * Q * Q * nh
                             + 2 * Q * Q * nh * P + 6 * Q * nh * P * N)
        state_bytes = state * seqs
    else:
        flops += rows * 6 * nh * P * N
        state_bytes = 2 * rows * state
    acts = rows * (2 * conv_ch + 2 * d_in) * isz
    return ClassCost(flops=float(flops), bytes=float(acts + state_bytes))


def dryrun_temp_bytes(cfg: ArchConfig, step: StepShape, rules=None,
                      output_bytes: float = 0.0) -> float:
    """The working set of a dry-run step beyond its arguments, per device
    (the port's ``temp_bytes``; ``b`` the batch axes' share of the batch,
    ``vs`` the vocab's model-axis shard, ``isz`` the model's itemsize):

    * decode: the logits, ``B/b · V/vs · (isz + 4)`` (the product and its
      float32 copy), plus the largest layer's transients: an attention
      layer's ``B/b · (((H + 2K)·hd + H·hd)/a + 4d)·isz`` (``a`` the model
      axis's share of the query heads) and the contiguous kernel's
      float32 split scratch ``B·K·n_split·G·(hd + 2)·4``, a dense MLP's
      ``3·B/b·f/fs·isz`` (``fs`` d_ff's share), an MoE layer's dispatch
      buffer and hidden ``expert_rows·(2d + 3f)·isz / b``, an SSM
      layer's three float32 state-sized tensors of the update
      ``3·B/b·H·P·N·4`` and its projection ``B/b·width·isz``; the cache
      is written in place;
    * prefill and encode: the outputs (``output_bytes``; a prefill's
      cache twice, each layer's entry and the stacked cache), the hidden
      rows twice and one layer's transients over ``B/b · S`` rows;
    * train: the gradients (the parameters' shard in their dtypes; a
      float32 accumulator beside them with microbatches), then the
      larger of the backward's working set, over one microbatch's ``R``
      rows: each period's saved input ``R·d·isz``, the logits and their
      gradient ``R·V/vs·(isz + 12)``, one period recomputed (its layers'
      transients) and the attention backward's dense float32 scores,
      probabilities and their gradients ``4·B_m·H/a·S²·4``; and AdamW's
      float32 temporaries, four of the largest parameter shard.
    """
    isz = itemsize(cfg)
    B, S = step.batch, step.seq
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    f, V = cfg.d_ff, cfg.padded_vocab
    n = layer_counts(cfg)
    div = _Census(cfg, rules, B)
    b = div.b
    specs = param_specs(cfg)
    unemb = specs["embed"].get("unemb")
    v_leaf = unemb if unemb is not None else specs["embed"]["tok"]
    v_dim = 1 if unemb is not None else 0
    vs = div.sizes(div.spec(v_leaf.logical, v_leaf.shape), (v_dim,), False)
    up = 3 if cfg.act == "swiglu" else 2
    # the model axis's share of the query heads and of d_ff
    a = fs = 1
    if n["kv"] or n["cross"]:
        wq = (specs["shared"]["attn"] if "shared" in specs
              else _first_block(specs, "attn"))["wq"]
        a = div.sizes(div.spec(wq.logical[-3:], wq.shape[-3:]), (1, 2),
                      False)
    if n["mlp"]:
        w1 = _mlp_block(specs, cfg)["w1"]
        fs = div.sizes(div.spec(w1.logical[-2:], w1.shape[-2:]), (1,),
                       False)

    def layer(rows: float) -> float:
        """The largest layer's transients over ``rows`` rows a device."""
        out = 0.0
        if n["kv"] or n["cross"]:
            out = rows * (((H + 2 * K) * hd + H * hd) / a + 4 * d) * isz
        if n["mlp"]:
            out = max(out, rows * up * f / fs * isz)
        if n["moe"]:
            ec = expert_rows(cfg, "decode" if step.kind == "decode"
                             else "prefill", int(rows * b))
            out = max(out, ec * (2 * d + 3 * f) * isz / b)
        if n["ssm"]:
            s = cfg.ssm
            d_in, nh, conv_ch = ssm_dims(cfg)
            width = 2 * d_in + 2 * s.ngroups * s.d_state + nh
            if step.kind == "decode":
                ws = 3 * rows * nh * s.head_dim * s.d_state * 4
            else:       # the chunk states of the scan, float32
                ws = rows / min(s.chunk, S) * nh * s.head_dim \
                    * s.d_state * 4 * 2
            out = max(out, ws + rows * width * isz)
        return out

    if step.kind == "decode":
        scratch = 0.0
        if n["kv"]:
            reads = min(S, step.kv_len) if step.kv_len else S
            plan = split_plan(B, max(reads, 1), K, H // K, hd)
            scratch = _numel(plan.scratch_shape) * 4
        return B / b * V / vs * (isz + 4) + layer(B / b) + scratch
    if step.kind in ("prefill", "encode"):
        extra = output_bytes if step.kind == "encode" else 2 * output_bytes
        return extra + 2 * B / b * S * d * isz + layer(B / b * S)
    # train
    micro = step.microbatches
    local = []
    grads = 0.0
    for _, leaf in tree_leaves(specs):
        sp = div.spec(leaf.logical, leaf.shape)
        shard = _numel(leaf.shape) / (
            div.sizes(sp, range(len(leaf.shape)), True)
            * div.sizes(sp, range(len(leaf.shape)), False))
        local.append(shard)
        grads += shard * (4 if leaf.dtype == "float32" else isz)
    if micro > 1:
        grads += 4 * sum(local)
    R = B / b / micro * S
    slots, n_rep, _ = plan_structure(cfg)
    periods = n_rep + cfg.n_layers - n_rep * len(slots)
    act = periods * R * d * isz + R * V / vs * (isz + 12) \
        + len(slots) * layer(R) + 2 * R * d * isz
    if n["kv"] or n["cross"]:
        act += 4 * (B / b / micro) * H / a * S * S * 4
    return grads + max(act, 4 * 4 * max(local))

