#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s tensor-parallel phase alone, on a machine with
one or more CUDA cards: build the kernels, load OPT-1.3B, serve the
paged serve's 32 requests on one card (the baseline the mesh phase
compares with), then ``phase_mesh``. From the repository root::

    python3 tools/mesh_smoke.py

With one card it runs the world-of-one check only; with four, every
mesh of the phase. Exits non-zero if a check fails."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import subprocess
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("mesh_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.phase("0, build", cs.phase_build)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = cs.full_model()
    reqs = cs.serve_workload()
    _, metrics, _ = cs.serve(model, reqs, "paged", card)
    cs.release()
    cs.phase("4, mesh", cs.phase_mesh, model, card,
             dict(reqs=reqs, metrics=metrics))
    print(f"[done] the mesh phase passed in {time.perf_counter() - t0:.1f} s"
          f" on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
