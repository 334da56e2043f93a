#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s tensor-parallel phases alone, on a machine
with one or more CUDA cards: build the kernels, load OPT-1.3B, serve the
paged serve's 32 requests on one card (the baseline the mesh phase
compares with), then ``phase_mesh`` (the world of one in every engine
mode and as a sliced cluster's replica; with several cards, the float32,
OPT-1.3B and deepseek-coder-33b meshes), then, with four cards,
``phase_mesh_modes``: deepseek-coder-33b over 1 x 4 in every engine mode,
then R=2 replicas of 1 x 2 against the paged engine over 1 x 4 measured
in the same run. With ``--rules``, ``phase_mesh_rules`` alone: the
reference's own sharding rules over 1 x 4 (deepseek-coder-33b under the
default rules beside act_replicated, qwen2.5-3b under the default rules
and under shard_kv_seq, the dry-run's qwen2.5-3b decode_32k case). With
``--seq``, ``phase_mesh_seq`` alone: every engine mode over a KV sequence
sharded on the model axis (qwen2.5-3b under shard_kv_seq over 1 x 4:
overlapped and chunked, the prefix cache, speculation, the gather mode
and a long-context serve of 16 prompts of 32,000 tokens chunked by
2048), its check prompts' logits on the paged, chunked and gather paths
against one card's. With ``--data``, data parallelism inside one engine
alone (``tools/mesh_data.py``): the float32 2-layer model over 2 x 1
against one card (``chip_smoke.mesh_data``), OPT-1.3B over 4 x 1 at
batch 512 beside R=4 replicas of 1 x 1, deepseek-coder-33b over 4 x 1
under FSDP and over 2 x 2 beside 1 x 4. From the repository root::

    python3 tools/mesh_smoke.py            # everything
    python3 tools/mesh_smoke.py --modes    # phase_mesh_modes alone
    python3 tools/mesh_smoke.py --modes --layers 4 --requests 32
                                           # a short first call
    python3 tools/mesh_smoke.py --rules    # phase_mesh_rules alone
    python3 tools/mesh_smoke.py --seq      # phase_mesh_seq alone
    python3 tools/mesh_smoke.py --seq --layers 4 --requests 32
                                           # a short first call
    python3 tools/mesh_smoke.py --data     # data parallelism alone
    python3 tools/mesh_smoke.py --data opt # OPT-1.3B's MAX against R=4
    python3 tools/mesh_smoke.py --data --layers 4 --requests 32
                                           # a short first call

Exits non-zero if a check fails."""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    import subprocess
    import torch
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", action="store_true",
                    help="only the engine modes and the cluster across "
                         "four cards (phase_mesh_modes)")
    ap.add_argument("--rules", action="store_true",
                    help="only the reference's own sharding rules across "
                         "four cards (phase_mesh_rules)")
    ap.add_argument("--seq", action="store_true",
                    help="only every engine mode over a KV sequence "
                         "sharded on the model axis across four cards "
                         "(phase_mesh_seq)")
    ap.add_argument("--data", nargs="?", const="all",
                    choices=("all", "opt", "deep"),
                    help="only data parallelism inside one engine across "
                         "four cards (tools/mesh_data.py): all of it, or "
                         "OPT-1.3B's MAX against R=4 alone, or "
                         "deepseek-coder-33b's meshes alone")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the served models to this many layers")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests a serve (default: 128 ShareGPT-length "
                         "requests; with --data, 512 for OPT-1.3B and 128 "
                         "for deepseek-coder-33b)")
    args = ap.parse_args(argv)
    n_requests = args.requests or cs.MESH_DEEP_REQUESTS
    # each line as it is printed: a run cut at its limit keeps its log
    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        print("mesh_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.phase("0, build", cs.phase_build)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for i, line in enumerate(card):
        print(f"[device {i}] {line}")
    card = card[0]
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.data:
        import mesh_data
        cs.phase("4, mesh data 2 x 1", cs.mesh_data, card)
        out = cs.phase("4, mesh data", mesh_data.phase_mesh_data, card,
                       args.layers, args.requests, args.data)
        if out is None:
            return 1
        print(f"[done] the mesh data phase passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}")
        return 0
    if args.seq:
        out = cs.phase("4, mesh seq modes", cs.phase_mesh_seq, card,
                       args.layers, n_requests)
        if out is None:
            return 1
        print(f"[done] the mesh seq modes phase passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}")
        return 0
    if args.rules:
        out = cs.phase("4, mesh rules", cs.phase_mesh_rules, card,
                       args.layers, n_requests)
        if out is None:
            return 1
        print(f"[done] the mesh rules phase passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}")
        return 0
    if not args.modes:
        model = cs.full_model()
        reqs = cs.serve_workload()
        _, metrics, _ = cs.serve(model, reqs, "paged", card)
        cs.release()
        cs.phase("4, mesh", cs.phase_mesh, model, card,
                 dict(reqs=reqs, metrics=metrics))
        del model
        cs.release()
    out = cs.phase("4, mesh modes", cs.phase_mesh_modes, card, args.layers,
                   n_requests)
    if out is None and torch.cuda.device_count() >= cs.MESH_DEEP_CARDS:
        return 1
    print(f"[done] the mesh phases passed in "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
