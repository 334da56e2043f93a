"""Architecture configuration system (the port's own copy).

Every selectable architecture is an ``ArchConfig``: a plain frozen
dataclass, field-for-field the reference package's, so configurations
compare equal across the two packages. Model code consumes *only* this
object. ``activation_dtype`` is the one framework-specific member: it
returns a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


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


def require_slice(cfg: ArchConfig) -> None:
    """Refuse configurations the port does not serve yet.

    The port covers the dense decoder family on full attention. Every
    other family, and sliding-window attention (whose ring-buffer decode
    the reference's engine cannot run either), waits for ROADMAP.md's
    "Non-dense families" slice.
    """
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} is not ported yet "
            f"(ROADMAP.md, next slices: non-dense families)")
    if cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention is not ported yet "
            f"(ROADMAP.md, next slices: non-dense families, sliding-window "
            f"ring decode)")
    if not cfg.causal:
        # prefill masks padded keys only through causality
        raise NotImplementedError(
            f"{cfg.name}: bidirectional attention is not ported yet "
            f"(ROADMAP.md, next slices: non-dense families)")
