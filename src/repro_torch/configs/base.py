"""Architecture configuration system (the port's own copy).

Every selectable architecture is an ``ArchConfig``: a plain frozen
dataclass, field-for-field the reference package's, so configurations
compare equal across the two packages. Model code consumes *only* this
object. ``activation_dtype`` is the one framework-specific member: it
returns a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# block kinds of ArchConfig.block_plan (the reference's names)
ATTN = "attn"          # self-attention block (causal or bidirectional)
CROSS = "cross"        # cross-attention block (VLM image layers)
SSM = "ssm"            # Mamba2 SSD block
SHARED_ATTN = "shared_attn"  # attention block with weights shared across occurrences


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # Arctic-style parallel dense FFN residual branch next to the MoE branch.
    dense_residual: bool = False
    # weight for the auxiliary load-balance loss during training
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64          # P — channels per SSD head
    expand: int = 2             # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128            # SSD chunk length for the blocked scan
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str              # dense | encoder | vlm | ssm | moe | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # positional / activation / norm flavour
    pos: str = "rope"           # rope | learned | none
    act: str = "swiglu"         # swiglu | gelu | relu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    qkv_bias: bool = False      # qwen-style QKV bias
    rope_theta: float = 10000.0
    max_position: int = 1 << 20
    tie_embeddings: bool = False
    # causal decoder vs bidirectional encoder
    causal: bool = True
    # sliding-window attention (None = full attention)
    sliding_window: Optional[int] = None
    # MoE / SSM / hybrid / VLM structure
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: one shared-weight attention block every `attn_every` blocks
    attn_every: int = 0
    # vlm: one cross-attention block every `cross_every` layers
    cross_every: int = 0
    n_img_tokens: int = 1601    # stubbed vision-frontend output length
    # modality frontend stub: inputs are embeddings, not token ids
    embedding_inputs: bool = False
    dtype: str = "bfloat16"
    # query block size of the reference's blocked-attention scan
    q_block: int = 512
    # sharding-only variants of the reference (kept so configurations
    # compare equal; they have no effect on one card)
    attn_kv_repeat: bool = False
    attn_row_parallel: bool = False
    # MoE dispatch capacity factor at serving time
    serve_capacity_factor: float = 2.0
    # citation / provenance for the assigned-architecture table
    source: str = ""

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab padded to a multiple of 256; padded logit
        columns are masked to -1e30 before argmax."""
        return -(-self.vocab_size // 256) * 256

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_decoder(self) -> bool:
        return self.arch_type != "encoder"

    def block_plan(self) -> Tuple[str, ...]:
        """The sequence of block kinds, length == n_layers."""
        if self.arch_type == "ssm":
            return (SSM,) * self.n_layers
        if self.arch_type == "hybrid":
            # every `attn_every`-th block is the shared attention block
            return tuple(SHARED_ATTN if self.attn_every
                         and (i + 1) % self.attn_every == 0 else SSM
                         for i in range(self.n_layers))
        if self.arch_type == "vlm":
            return tuple(CROSS if self.cross_every
                         and (i + 1) % self.cross_every == 0 else ATTN
                         for i in range(self.n_layers))
        return (ATTN,) * self.n_layers

    def num_params(self) -> int:
        """Analytic parameter count (the reference's; the memory the
        replication planner and the performance model count)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        counts = 0
        plan = self.block_plan()
        n_attn = sum(1 for k in plan if k in (ATTN, CROSS))
        n_shared = 1 if any(k == SHARED_ATTN for k in plan) else 0
        n_ssm = sum(1 for k in plan if k == SSM)
        # attention blocks
        attn_p = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.qkv_bias:
            attn_p += (self.n_heads + 2 * self.n_kv_heads) * hd
        # mlp per block
        if self.moe:
            e = self.moe.num_experts
            mlp_p = e * (3 if self.act == "swiglu" else 2) * d * f + d * e
            if self.moe.dense_residual:
                mlp_p += (3 if self.act == "swiglu" else 2) * d * f
        else:
            mlp_p = (3 if self.act == "swiglu" else 2) * d * f
        counts += n_attn * (attn_p + mlp_p + 2 * d)
        counts += n_shared * (attn_p + mlp_p + 2 * d)
        if n_ssm:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            ssm_p = d * (2 * d_in + 2 * s.ngroups * s.d_state + nheads) \
                + d_in * d + s.conv_width * (d_in + 2 * s.ngroups * s.d_state) \
                + 2 * nheads + d
            counts += n_ssm * ssm_p
        counts += v * d * (1 if self.tie_embeddings else 2)
        if self.pos == "learned":
            counts += self.max_position * d
        counts += d  # final norm
        return counts

    def active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if not self.moe:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        e, k = self.moe.num_experts, self.moe.top_k
        per_expert = (3 if self.act == "swiglu" else 2) * d * f
        return self.num_params() - (e - k) * per_expert * self.n_layers

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes appended per generated token (per request)."""
        plan = self.block_plan()
        n_kv_layers = sum(1 for k in plan if k in (ATTN, CROSS, SHARED_ATTN))
        return n_kv_layers * 2 * self.n_kv_heads * self.hd * dtype_bytes

    def validate(self) -> None:
        if self.d_model <= 0 or self.n_layers <= 0:
            raise ValueError(f"{self.name}: d_model and n_layers must be > 0")
        if self.arch_type != "ssm" \
                and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(
                f"{self.name}: n_heads must be divisible by n_kv_heads")


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 256,
            d_ff: int = 512, vocab: int = 512, n_heads: int = 4,
            n_kv_heads: Optional[int] = None, max_experts: int = 4) -> ArchConfig:
    """A smoke-test-sized variant of the same family (CPU-friendly)."""
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    nk = n_kv_heads if n_kv_heads is not None else max(1, n_heads // min(ratio, n_heads))
    moe = None
    if cfg.moe:
        moe = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, max_experts),
            top_k=min(cfg.moe.top_k, min(cfg.moe.num_experts, max_experts)),
        )
    ssm = None
    if cfg.ssm:
        ssm = dataclasses.replace(cfg.ssm, d_state=min(cfg.ssm.d_state, 16),
                                  head_dim=16, chunk=32)
    attn_every = min(cfg.attn_every, 2) if cfg.attn_every else 0
    cross_every = min(cfg.cross_every, 2) if cfg.cross_every else 0
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=d_model, d_ff=d_ff,
        vocab_size=vocab, n_heads=n_heads, n_kv_heads=nk, head_dim=0,
        moe=moe, ssm=ssm, attn_every=attn_every, cross_every=cross_every,
        n_img_tokens=16, max_position=4096, dtype="float32",
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
    )

