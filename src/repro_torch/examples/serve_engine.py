"""Serve a small model with batched requests through the real
continuous-batching engine (paged KV cache, FCFS admission), sweeping the
BCA-tunable max_batch knob to expose the throughput/latency trade-off.

The counterpart of ``examples/serve_engine.py``: reduced OPT-1.3B (full
width with ``--full``), every decode step through the paged kernel and
every prefill through the flash kernel on the card.

    PYTHONPATH=src python -m repro_torch.examples.serve_engine
    PYTHONPATH=src python -m repro_torch.examples.serve_engine --device cpu
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.examples import Lines, add_port_options, parser
from repro_torch.models.model import Model
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                 Request, sharegpt_like)

ARCH = "opt-1.3b"
BATCHES = (1, 4, 8)


def engine_config(max_batch: int) -> EngineConfig:
    return EngineConfig(max_batch=max_batch, block_size=16,
                        kv_pool_tokens=1 << 14, max_model_len=128,
                        prefill_bucket=32)


def workload(vocab: int) -> List[Request]:
    return sharegpt_like(8, vocab, seed=0, mean_in=20, mean_out=20,
                         max_len=80, sigma=0.3)


def run(model: Model, batches: Sequence[int] = BATCHES,
        echo: bool = True) -> Dict:
    """One engine a ``max_batch`` over the same 8 requests. Returns
    ``lines``, ``outputs`` and ``metrics`` (each keyed by ``max_batch``;
    ``outputs`` a list of each request's output tokens)."""
    out = Lines(echo)
    outputs, metrics = {}, {}
    for mb in batches:
        engine = ContinuousBatchingEngine(model, engine_config(mb),
                                          device=model.device)
        reqs = workload(model.cfg.vocab_size)
        metrics[mb] = engine.run(reqs)
        outputs[mb] = [list(r.output_tokens) for r in reqs]
        out(f"max_batch={mb}: {metrics[mb].row()}")
    return {"lines": out, "outputs": outputs, "metrics": metrics}


def build_parser():
    return add_port_options(parser("serve_engine", __doc__))


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    full = get_config(ARCH)
    return run(Model(full if args.full else reduced(full), device=device))


if __name__ == "__main__":
    main()
