"""The paper's full loop on its own models: profile curves -> BCA (Eq. 2)
-> memory freed -> replication plan -> simulated Table IV.

The counterpart of ``examples/bca_replication.py``; it prints the same
lines. The loop is analytic, over the paper's H100 (``H100_PAPER``), and
already reads the models' full configurations, so ``--full`` changes
nothing; like every entry point of the port it runs only with a card or
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.bca_replication
    PYTHONPATH=src python -m repro_torch.examples.bca_replication --device cpu
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core import (H100_PAPER, BatchingConfigurationAdvisor,
                              Hardware, ReplicationPlanner, decode_curves,
                              max_batch_for, replication_sweep,
                              simulate_decode, slo_from_reference)
from repro_torch.device import resolve_device
from repro_torch.examples import Lines, add_port_options, parser

CTX = 331
MODELS = ("opt-1.3b", "opt-2.7b")


def run(names: Sequence[str] = MODELS, hw: Hardware = H100_PAPER,
        ctx: int = CTX, echo: bool = True) -> Lines:
    """The loop for each model; returns the printed lines."""
    out = Lines(echo)
    for name in names:
        cfg = get_config(name)
        mb = min(max_batch_for(cfg, hw, ctx=ctx), 512)
        curves = decode_curves(cfg, hw, ctx=ctx, max_batch=mb)
        out(f"\n=== {name} (MAX batch {mb}) ===")
        for label, f in (("strict", 2.0), ("relaxed", 4.0)):
            slo = slo_from_reference(curves, 32, f)
            res = BatchingConfigurationAdvisor(curves, slo_s=slo,
                                               eps=0.1).solve()
            out(f"  BCA {label:8s}: {res.summary()}")
            out(f"    -> KV freed vs MAX: {res.kv_freed_fraction*100:.1f}% "
                f"of capacity")
        # the plan reads the loop's last result, the relaxed one, as the
        # reference's does (its ``res`` outlives the ``for``)
        plan = ReplicationPlanner(hw, cfg, ctx=ctx).plan(res.b_opt,
                                                         max_replicas=4)
        out(f"  replication plan: {plan.summary()}")
        t_max = simulate_decode(cfg, hw, batch=mb, n_replicas=1,
                                ctx=ctx).throughput_tok_s
        out(f"  MAX single replica: {t_max:.0f} tok/s")
        for r in replication_sweep(cfg, hw, batch=res.b_opt, ctx=ctx,
                                   max_replicas=plan.n_replicas):
            gain = r.throughput_tok_s / t_max - 1
            out(f"  {r.summary()}  ({gain:+.1%} vs MAX)")
    return out


def build_parser():
    return add_port_options(
        parser("bca_replication", __doc__),
        full_help="accepted for a uniform command line: the loop already "
                  "reads the full configurations")


def main(argv: Optional[List[str]] = None) -> Lines:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    return run()


if __name__ == "__main__":
    main()
