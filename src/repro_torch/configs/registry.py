"""Architecture registry (the port's own copy): the 10 assigned
architectures (public-literature pool, citations in brackets) + the
paper's own 4 evaluation models. Entries equal the reference package's
field for field.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

# --------------------------------------------------------------------------
# Assigned architectures (exact dims from the assignment table).
# --------------------------------------------------------------------------
ASSIGNED: Dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ASSIGNED[cfg.name] = cfg
    return cfg


_reg(ArchConfig(
    name="hubert-xlarge", arch_type="encoder", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab_size=504, act="gelu",
    norm="layernorm", pos="learned", causal=False, embedding_inputs=True,
    max_position=1 << 15,
    source="encoder-only, same arch as w2v2 [arXiv:2106.07447]"))

_reg(ArchConfig(
    name="deepseek-coder-33b", arch_type="dense", n_layers=62, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=19200, vocab_size=32256,
    source="llama-arch GQA kv=8 [arXiv:2401.14196]"))

_reg(ArchConfig(
    name="phi3-mini-3.8b", arch_type="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32064,
    source="RoPE SwiGLU GQA [arXiv:2404.14219]"))

_reg(ArchConfig(
    name="llama-3.2-vision-90b", arch_type="vlm", n_layers=100, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab_size=128256, cross_every=5,
    n_img_tokens=1601,
    source="cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision]"))

_reg(ArchConfig(
    name="internlm2-1.8b", arch_type="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab_size=92544,
    source="GQA [arXiv:2403.17297]"))

_reg(ArchConfig(
    name="mamba2-1.3b", arch_type="ssm", n_layers=48, d_model=2048,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=128, ngroups=1),
    tie_embeddings=True, pos="none",
    source="SSD state-space duality [arXiv:2405.21060]"))

_reg(ArchConfig(
    name="olmoe-1b-7b", arch_type="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8),
    source="64 experts top-8 [arXiv:2409.02060]"))

_reg(ArchConfig(
    name="zamba2-7b", arch_type="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab_size=32000, attn_every=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4,
                  chunk=128, ngroups=1),
    source="Mamba2 + shared attn blocks [arXiv:2411.15242]"))

_reg(ArchConfig(
    name="arctic-480b", arch_type="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True),
    source="128e top-2 + dense residual [hf:Snowflake/snowflake-arctic-base]"))

_reg(ArchConfig(
    name="qwen2.5-3b", arch_type="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, d_ff=11008, vocab_size=151936, qkv_bias=True,
    source="GQA kv=2, QKV bias [hf:Qwen/Qwen2.5-0.5B]"))

# --------------------------------------------------------------------------
# The paper's own evaluation models (Section IV): OPT-1.3B/2.7B, Llama-2-7B/13B.
# OPT: learned positions, LayerNorm, ReLU MLP, MHA. Llama-2: RoPE/SwiGLU/RMSNorm.
# --------------------------------------------------------------------------
PAPER_MODELS: Dict[str, ArchConfig] = {}


def _regp(cfg: ArchConfig) -> ArchConfig:
    PAPER_MODELS[cfg.name] = cfg
    return cfg


_regp(ArchConfig(
    name="opt-1.3b", arch_type="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=50272, act="relu",
    norm="layernorm", pos="learned", max_position=4096,
    source="OPT [arXiv:2205.01068]"))

_regp(ArchConfig(
    name="opt-2.7b", arch_type="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=50272, act="relu",
    norm="layernorm", pos="learned", max_position=4096,
    source="OPT [arXiv:2205.01068]"))

_regp(ArchConfig(
    name="llama-2-7b", arch_type="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab_size=32000,
    source="Llama-2 [arXiv:2307.09288]"))

_regp(ArchConfig(
    name="llama-2-13b", arch_type="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=13824, vocab_size=32000,
    source="Llama-2 [arXiv:2307.09288]"))

ALL: Dict[str, ArchConfig] = {**ASSIGNED, **PAPER_MODELS}


def get_config(name: str) -> ArchConfig:
    if name not in ALL:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ALL)}")
    return ALL[name]

