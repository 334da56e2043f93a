"""End-to-end training driver: train a ~100M-param dense model for a few
hundred steps with the full substrate (data pipeline, AdamW + cosine
schedule, checkpointing).

The counterpart of ``examples/train_tiny.py``: the reference's shrunk
qwen-family decoder in float32, ``synthetic_batches`` from seed 0 and
``make_train_step`` (attention through the flash kernel's autograd
Function on the card). The configuration is already the example's full
width, so ``--full`` changes nothing. On the card each printed step adds
its device time (CUDA events around it) and tokens/s over that time.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_tiny --device cpu --steps 3 --batch 2 --seq 64
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.examples import Lines, add_port_options, parser
from repro_torch.models.model import Model
from repro_torch.training import (AdamWConfig, adamw_init, make_train_step,
                                  save_checkpoint, synthetic_batches)
from repro_torch.training.train import TrainState

LOG_EVERY = 20


def tiny_config() -> ArchConfig:
    """~100M params: a shrunk qwen-family decoder."""
    return dataclasses.replace(
        get_config("qwen2.5-3b"), n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab_size=32000, dtype="float32",
        q_block=128)


def run(model: Model, steps: int, batch: int, seq: int,
        checkpoint: Optional[str], echo: bool = True) -> Dict:
    """Train ``model`` in place for ``steps`` steps and save a checkpoint
    to ``checkpoint`` (None saves none). Returns ``lines``, ``losses`` and
    ``grad_norms`` (every step's) and ``records`` (one a printed step:
    ``step``, ``loss``, ``grad_norm``, ``tokens_per_s`` over the wall
    clock and, on the card, ``device_ms`` and ``device_tokens_per_s``)."""
    out = Lines(echo)
    cfg = model.cfg
    out(f"model: {cfg.num_params()/1e6:.1f}M params")
    state = TrainState(model=model, opt_state=adamw_init(model.params))
    opt = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=steps)
    step = make_train_step(cfg, opt)
    data = synthetic_batches(cfg, batch=batch, seq=seq)
    cuda = model.device.type == "cuda"

    losses, norms, records = [], [], []
    t0 = time.time()
    for i in range(steps):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        m = step(state, next(data))
        if cuda:
            ev[1].record()
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        if i % LOG_EVERY == 0 or i == steps - 1:
            rec = {"step": i, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]),
                   "tokens_per_s": batch * seq * (i + 1) / (time.time() - t0)}
            line = (f"step {i:4d}  loss {rec['loss']:.4f}  "
                    f"gnorm {rec['grad_norm']:.2f}  "
                    f"{rec['tokens_per_s']:.0f} tok/s")
            if cuda:
                ev[1].synchronize()
                ms = ev[0].elapsed_time(ev[1])
                rec.update(device_ms=ms,
                           device_tokens_per_s=batch * seq / ms * 1e3)
                line += (f"  device {ms:.2f} ms  "
                         f"{rec['device_tokens_per_s']:.0f} tok/s")
            out(line)
            records.append(rec)
    if checkpoint:
        save_checkpoint(checkpoint, state.params, state.opt_state, steps)
        out(f"checkpoint saved to {checkpoint}")
    return {"lines": out, "losses": [float(x) for x in losses],
            "grad_norms": [float(x) for x in norms], "records": records,
            "state": state}


def build_parser():
    ap = parser("train_tiny", __doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint", default="experiments/tiny_ckpt.npz")
    return add_port_options(
        ap, full_help="accepted for a uniform command line: the example's "
                      "configuration is already at full width")


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    return run(Model(tiny_config(), device=device), args.steps, args.batch,
               args.seq, args.checkpoint)


if __name__ == "__main__":
    main()
