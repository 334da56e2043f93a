"""Quickstart: build a reduced model, run a forward pass, prefill + decode
a few tokens, and print the paper's roofline verdict for the full config.

The counterpart of ``examples/quickstart.py``. The decode steps run on
the dense cache, through the contiguous-decode kernel on the card. The
verdict is for the card's own ``Hardware`` (on the CPU the H100 SXM5
entry, from the data sheet), where the reference prints a TPU v5e's.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--arch qwen2.5-3b]
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart --full
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.core import Hardware, decode_step_terms
from repro_torch.device import resolve_device
from repro_torch.examples import (Lines, add_port_options, card_hardware,
                                  parser)
from repro_torch.models.model import Model

B, S = 2, 16            # the prompt batch
CACHE_LEN = 24
DECODE_STEPS = 6


def prompt(cfg: ArchConfig, seed: int = 1) -> torch.Tensor:
    """The example's prompt tokens ``[2, 16]``, drawn on the CPU."""
    return torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def embeddings(cfg: ArchConfig, seed: int = 2) -> torch.Tensor:
    """An encoder's input embeddings ``[2, 16, d_model]``."""
    return torch.randn((B, S, cfg.d_model),
                       generator=torch.Generator().manual_seed(seed)) * 0.02


def run(model: Model, full: ArchConfig, tokens: torch.Tensor, hw: Hardware,
        hw_label: str, embeds: Optional[torch.Tensor] = None,
        echo: bool = True) -> Dict:
    """The forward, the prefill and the greedy decode of ``model`` on
    ``tokens`` (``embeds`` for an encoder), then the decode-step verdict of
    ``full`` on ``hw``. Returns ``lines``, ``logits`` (the forward's),
    ``aux``, ``tokens`` (the decoded ids, or None) and ``terms``."""
    cfg = model.cfg
    out = Lines(echo)
    out(f"arch={full.name} ({full.arch_type}), {full.n_layers}L "
        f"d={full.d_model} params={full.num_params()/1e9:.2f}B "
        f"(active {full.active_params()/1e9:.2f}B)")
    batch: Dict[str, torch.Tensor] = {"tokens": tokens}
    if cfg.arch_type == "vlm":
        batch["img_embeds"] = torch.zeros((B, cfg.n_img_tokens,
                                           cfg.d_model))
    if cfg.embedding_inputs:
        batch = {"embeds": embeds}
    with torch.no_grad():
        logits, aux = model.train_forward(batch)
    out(f"forward OK: logits {tuple(logits.shape)}, aux={float(aux):.4f}")

    toks = None
    if cfg.is_decoder:
        last, cache = model.prefill(tokens, cache_len=CACHE_LEN,
                                    img_embeds=batch.get("img_embeds"))
        toks = [int(last[0].argmax())]
        for t in range(S, S + DECODE_STEPS):
            lg = model.decode_step(
                torch.full((B,), toks[-1], dtype=torch.int32), cache, pos=t)
            toks.append(int(lg[0].argmax()))
        out(f"decoded tokens: {toks}")

    # the paper's analysis on the FULL config (no allocation needed)
    terms = None
    if full.is_decoder:
        terms = decode_step_terms(full, batch=64, ctx=2048, hw=hw)
        out(f"\n{hw.name} ({hw_label}) single-card decode step @B=64, "
            f"ctx=2048:")
        for name, c in terms.classes.items():
            bound = "memory" if c["memory_s"] > c["compute_s"] else "compute"
            out(f"  {name:10s} AI={terms.ai(name):8.2f} FLOP/B -> "
                f"{bound}-bound")
    return {"lines": out, "logits": logits, "aux": float(aux),
            "tokens": toks, "terms": terms}


def build_parser():
    ap = parser("quickstart", __doc__)
    ap.add_argument("--arch", default="qwen2.5-3b")
    return add_port_options(ap)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    full = get_config(args.arch)
    cfg = full if args.full else reduced(full)
    hw, label = card_hardware(device)
    return run(Model(cfg, device=device), full, prompt(cfg), hw, label,
               embeds=embeddings(cfg) if cfg.embedding_inputs else None)


if __name__ == "__main__":
    main()
