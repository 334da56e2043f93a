"""Speculative decoding on the paged KV pool: serve a repetitive
workload twice — plain decode vs prompt-lookup drafting + multi-token
verify — and show that the outputs are bit-identical while the
speculative run commits several tokens per verify step. Also prints the
BCA speculation advisor's break-even recommendation for the batch.

The counterpart of ``examples/speculative_decode.py`` over reduced
OPT-1.3B (full width with ``--full``), with its assertion.

    PYTHONPATH=src python -m repro_torch.examples.speculative_decode
    PYTHONPATH=src python -m repro_torch.examples.speculative_decode --device cpu
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.core import H100_PAPER, Hardware, speculation_advisor
from repro_torch.device import resolve_device
from repro_torch.examples import Lines, add_port_options, parser
from repro_torch.models.model import Model
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                 Request, repetitive_workload)

ARCH = "opt-1.3b"


def engine_config(speculate: bool) -> EngineConfig:
    return EngineConfig(max_batch=4, block_size=8, kv_pool_tokens=1 << 13,
                        max_model_len=256, prefill_bucket=32,
                        speculate=speculate, spec_k=4)


def workload(vocab: int) -> List[Request]:
    # pure template text (repeat_rate=1.0, one phrase pool) — the
    # prompt-lookup drafter's target shape
    return repetitive_workload(6, vocab, seed=3, prompt_len=64,
                               max_new_tokens=32, repeat_rate=1.0,
                               phrase_len=8, pool_size=1)


def run(model: Model, full: ArchConfig, hw: Hardware = H100_PAPER,
        echo: bool = True) -> Dict:
    """The advisor's line for ``full`` on ``hw``, then the workload served
    with speculation off and on. Returns ``lines``, ``outputs`` and
    ``metrics`` (keyed by ``speculate``)."""
    out = Lines(echo)
    out(speculation_advisor(full, hw, batch=4).summary())
    outs, metrics = {}, {}
    for spec in (False, True):
        engine = ContinuousBatchingEngine(model, engine_config(spec),
                                          device=model.device)
        reqs = workload(model.cfg.vocab_size)
        m = metrics[spec] = engine.run(reqs)
        outs[spec] = [list(r.output_tokens) for r in reqs]
        tag = "speculate" if spec else "plain    "
        line = f"{tag}: {m.row()}"
        if spec:
            line += f"  {m.spec_row()}"
        out(line)
    assert outs[False] == outs[True], "speculation changed the outputs!"
    out("outputs bit-identical with and without speculation")
    return {"lines": out, "outputs": outs, "metrics": metrics}


def build_parser():
    return add_port_options(parser("speculative_decode", __doc__))


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    full = get_config(ARCH)
    return run(Model(full if args.full else reduced(full), device=device),
               full)


if __name__ == "__main__":
    main()
