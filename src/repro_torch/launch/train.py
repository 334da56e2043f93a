"""Training launcher for the card (the port of ``repro.launch.train``,
with the same options and defaults and the same ``step ... loss ...
gnorm ... (s/step)`` lines).

It trains on the card unless given ``--device cpu``; without a CUDA
device and without that flag it raises. Weights are random, drawn from
seed 0 by :func:`make_model`; the data is ``synthetic_batches`` from seed
0. On the card each logged line adds the step's device time (CUDA events
around it), tokens/s over that time, MFU (``model_flops_for(...,
train=True)`` over that time at the card's data-sheet bf16 rate) and
the peak device memory allocated so far.

Examples::

  PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \\
      --batch 8 --seq 1024 --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --reduced --device cpu --steps 20 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.hardware import H100_SXM5_80GB
from repro_torch.core.roofline import model_flops_for
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.training import (AdamWConfig, adamw_init, make_train_step,
                                  save_checkpoint, synthetic_batches)
from repro_torch.training.train import TrainState


def make_model(cfg, device: torch.device) -> Model:
    """The trained model: random weights drawn from seed 0 on ``device``."""
    return Model(cfg, device=device,
                 generator=torch.Generator(device).manual_seed(0))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train a model on synthetic data on the card.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size the model (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="the device to train on: the card (the default) "
                         "or 'cpu'; without a CUDA device only an explicit "
                         "'cpu' runs")
    return ap


def main(argv: Optional[List[str]] = None) -> List[Dict[str, float]]:
    """Train; returns one record a logged step (``step``, ``loss``,
    ``grad_norm``, ``s_per_step`` and, on the card, ``device_ms``,
    ``tokens_per_s``, ``mfu``, ``peak_gb``)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = make_model(cfg, device)
    state = TrainState(model=model, opt_state=adamw_init(model.params))
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                      total_steps=args.steps)
    step_fn = make_train_step(cfg, opt)
    data = synthetic_batches(cfg, batch=args.batch, seq=args.seq)
    cuda = device.type == "cuda"
    flops = model_flops_for(cfg, "train", args.batch, args.seq, train=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    records = []
    t0 = time.time()
    for i in range(args.steps):
        batch = next(data)
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        metrics = step_fn(state, batch)
        if cuda:
            ev[1].record()
        if i % args.log_every == 0 or i == args.steps - 1:
            rec = {"step": i, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "s_per_step": (time.time() - t0) / (i + 1)}
            line = (f"step {i:5d}  loss {rec['loss']:.4f}  "
                    f"gnorm {rec['grad_norm']:.3f}  "
                    f"({rec['s_per_step']:.2f}s/step)")
            if cuda:
                ev[1].synchronize()
                ms = ev[0].elapsed_time(ev[1])
                rec.update(device_ms=ms,
                           tokens_per_s=args.batch * args.seq / ms * 1e3,
                           mfu=flops / (ms * 1e-3 * H100_SXM5_80GB.peak_flops),
                           peak_gb=torch.cuda.max_memory_allocated(device)
                           / 1e9)
                line += (f"  device {ms:.2f} ms  "
                         f"{rec['tokens_per_s']:.0f} tok/s  "
                         f"MFU {rec['mfu'] * 100:.1f}%  "
                         f"peak {rec['peak_gb']:.2f} GB")
            print(line, flush=True)
            records.append(rec)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state.params, state.opt_state,
                        args.steps)
        print(f"saved {args.checkpoint}")
    return records


if __name__ == "__main__":
    main()
