"""Streaming quickstart: the online serving facade over the real engine.

Submits three requests with different SamplingParams (greedy, sampled,
and one that will be cancelled), streams the first one token-delta by
token-delta, aborts the third mid-flight, then drains the rest — the
submit/stream/abort/drain surface the README's "Serving API" section
documents.

The counterpart of ``examples/stream_generate.py``, over reduced
OPT-1.3B (full width with ``--full``), with its assertions.

    PYTHONPATH=src python -m repro_torch.examples.stream_generate
    PYTHONPATH=src python -m repro_torch.examples.stream_generate --device cpu
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.examples import Lines, add_port_options, parser
from repro_torch.models.model import Model
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                 SamplingParams, ServingAPI)

ARCH = "opt-1.3b"


def engine_config() -> EngineConfig:
    return EngineConfig(max_batch=4, block_size=16, kv_pool_tokens=1 << 13,
                        max_model_len=128, prefill_bucket=32)


def run(model: Model, echo: bool = True) -> Dict:
    """Submit, stream, abort and drain. Returns ``lines``, ``outputs``
    (request id -> ``GenerationOutput``), ``ids`` (the greedy, sampled
    and aborted requests' ids) and ``metrics``."""
    out = Lines(echo)
    rng = np.random.default_rng(0)
    prompt = lambda n: rng.integers(0, model.cfg.vocab_size, n)  # noqa: E731

    api = ServingAPI(ContinuousBatchingEngine(model, engine_config(),
                                              device=model.device))
    greedy = api.submit(prompt(24), SamplingParams(max_new_tokens=12))
    sampled = api.submit(
        prompt(24), SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                                   seed=7, max_new_tokens=12))
    doomed = api.submit(prompt(24), SamplingParams(max_new_tokens=500))

    out("-- streaming the greedy request (others decode alongside):")
    for ev in api.stream(greedy):
        out(f"   req {ev.req_id}: +{list(ev.new_token_ids)}"
            + (f"  -> finished ({ev.finish_reason}, "
               f"{len(ev.token_ids)} tokens)" if ev.finished else ""))

    out(f"-- aborting req {doomed.req_id} mid-flight "
        f"({doomed.request.generated} tokens so far)")
    api.abort(doomed)

    outs = api.drain()
    for rid in sorted(outs):
        o = outs[rid]
        out(f"   req {rid}: {len(o.token_ids)} tokens, "
            f"finish_reason={o.finish_reason}")
    assert outs[doomed.req_id].finish_reason == "abort"
    assert outs[sampled.req_id].finish_reason == "length"
    m = api.metrics()
    out(f"-- session: {m.row()}")
    out(f"-- session: {m.finish_row()}")
    return {"lines": out, "outputs": outs, "metrics": m,
            "ids": {"greedy": greedy.req_id, "sampled": sampled.req_id,
                    "aborted": doomed.req_id}}


def build_parser():
    return add_port_options(parser("stream_generate", __doc__))


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    full = get_config(ARCH)
    return run(Model(full if args.full else reduced(full), device=device))


if __name__ == "__main__":
    main()
