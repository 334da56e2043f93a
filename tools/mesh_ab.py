#!/usr/bin/env python3
"""Serve the same requests over a ``1 x M`` mesh from two checkouts of
this repo in turn, on the same cards, to compare their engines' host and
device time within one call (two calls land on different machines).

From the root of either checkout, on a machine with M CUDA cards::

    python3 tools/mesh_ab.py --old OLD --new NEW [--cards 4]
        [--layers 16] [--requests 128] [--rounds 2]

Runs OLD, NEW, NEW, OLD (``--rounds`` times that pair of pairs), each in
a process of its own with that checkout's ``src`` and ``chip_smoke.py``
first on its path: the checkout builds its kernels, then serves
deepseek-coder-33b (bf16, full width, cut to ``--layers``, drawn from
seed 0) over ``cuda:0..M-1`` under the act_replicated rules,
``--requests`` ShareGPT-length requests at t=0, batch 128 and a
131,072-token pool (``chip_smoke.MESH_DEEP_ENGINE``), through its own
``chip_smoke.mesh_serve_rank`` with steady marks. Each run prints one
JSON line (tok/s, ITL p50/p95, a steady decode step's device ms and the
cards' idle share on rank 0); the last line gives each checkout's
medians. Needs the cards; imports no JAX."""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def run(root: Path, cards: int, layers: int, requests: int) -> dict:
    """One serve from checkout ``root``, in this process."""
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.distributed import devices_mesh, spawn
    from repro_torch.models.params import DRAW_SLICE_BYTES
    from repro_torch.serving import EngineConfig
    cs.phase_build()
    cfg = cs.mesh_deep_cfg(layers)
    reqs = cs.mesh_workload(cfg.vocab_size, requests)
    r0 = spawn(cs.mesh_rank_jobs, devices_mesh(cards), [(
        cs.mesh_serve_rank, (cfg, EngineConfig(**cs.MESH_DEEP_ENGINE),
                             reqs, DRAW_SLICE_BYTES, None, True))])[0][0]
    st = r0["steady"] or {}
    return {"root": str(root), "tok_s": r0["tok_s"], "itl": r0["itl"],
            "ttft": r0["ttft"], "output_tokens": r0["output_tokens"],
            "step_ms": st.get("ms"), "idle": st.get("idle"),
            "steps": st.get("steps")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--new", type=Path)
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if args.run is not None:
        print(json.dumps(run(args.run.resolve(), args.cards, args.layers,
                             args.requests)), flush=True)
        return 0
    if args.old is None or args.new is None:
        ap.error("--old and --new are required")
    rows = {"old": [], "new": []}
    for _ in range(args.rounds):
        for side in ("old", "new", "new", "old"):
            root = getattr(args, side).resolve()
            out = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--run",
                 str(root), "--cards", str(args.cards), "--layers",
                 str(args.layers), "--requests", str(args.requests)],
                cwd=root, capture_output=True, text=True)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-8000:],
                      file=sys.stderr)
                return out.returncode
            line = json.loads(out.stdout.strip().splitlines()[-1])
            rows[side].append(line)
            print(json.dumps({"side": side, **line}), flush=True)
    print(json.dumps({side: {key: statistics.median(
        r[key] for r in rs if r[key] is not None)
        for key in ("tok_s", "step_ms", "idle")}
        for side, rs in rows.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
