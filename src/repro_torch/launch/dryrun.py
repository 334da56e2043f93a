"""The dry-run: build every (architecture x input shape x mesh) case on
the meta device (shapes and dtypes, nothing allocated) and price it per
device with the analytic census and memory terms (counterpart of
``repro.launch.dryrun``, which lowers and compiles each case for a TPU
mesh and reads the compiled program).

It touches no device: every argument is a meta tensor, so it runs on a
machine without a card. Each record has the reference's keys, priced on
``H100_SXM5_80GB``: ``memory`` (``argument_bytes`` and ``output_bytes``
exact from the shard shapes, ``temp_bytes`` the analytic working set of
:func:`~repro_torch.core.census.dryrun_temp_bytes`, ``peak_bytes`` their
sum with the arguments), the per-device census and its three roofline
terms, ``fits_hbm`` against the card's memory; ``lower_s`` is the
seconds to build the case and ``compile_s`` to build and price it. The
reference's two CPU-artifact keys (``cpu_upcast_artifact_bytes``,
``peak_bytes_tpu_adjusted``) have no counterpart.

A case on the one-device mesh also records ``dispatched``: its step run
on the meta arguments under a dispatch census
(:func:`~repro_torch.core.analysis.census_of`), the FLOPs, bytes and
launches by class of the operations it dispatches and the peak of its
temporaries, the measured counterparts of the census and of
``temp_bytes`` (the reference reads both off its compiled program). On
a mesh of more than one device it is ``"not measured"``: a per-device
program needs the sharded model (``dispatched_needs``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape decode_32k [--multi-pod] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs import ASSIGNED
from repro_torch.core.analysis import Dispatched, census_of
from repro_torch.core.census import (StepShape, dryrun_census,
                                     dryrun_temp_bytes)
from repro_torch.core.hardware import H100_SXM5_80GB, Hardware
from repro_torch.core.roofline import roofline_report
from repro_torch.launch.input_specs import (SHAPES, DryRunCase, SkipCase,
                                            build_case)
from repro_torch.launch.mesh import (MULTI_CARD_ITEM, Mesh, make_mesh,
                                     make_production_mesh, mesh_chips)
from repro_torch.sharding import shard_shape

MESHES = ("pod16x16", "pod2x16x16", "1x1")


def mesh_named(name: str) -> Mesh:
    """The reference's two production meshes, or a one-device mesh, all
    abstract."""
    if name == "1x1":
        return make_mesh((1, 1), ("data", "model"))
    if name not in MESHES:
        raise ValueError(f"unknown mesh {name!r} (one of {MESHES})")
    return make_production_mesh(multi_pod=name == "pod2x16x16")


def leaf_pairs(tree, specs) -> Iterator[Tuple[torch.Tensor, tuple]]:
    """Each tensor of ``tree`` with its spec (``specs`` nested as the
    tree, a spec at each tensor's place)."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_pairs(v, specs[k])
    else:
        for v, s in zip(tree, specs):
            yield from leaf_pairs(v, s)


def shard_bytes(tree, specs, mesh: Mesh) -> float:
    """The bytes one device holds of ``tree`` under ``specs``."""
    total = 0
    for t, spec in leaf_pairs(tree, specs):
        n = 1
        for s in shard_shape(spec, t.shape, mesh):
            n *= s
        total += n * t.element_size()
    return float(total)


def case_step(case: DryRunCase) -> StepShape:
    return StepShape(case.kind, case.shape.batch, case.shape.seq,
                     kv_len=case.kv_len if case.kind == "decode" else 0,
                     microbatches=case.microbatches,
                     moment_bytes=getattr(torch, case.moment_dtype).itemsize)


def case_memory(case: DryRunCase) -> Dict[str, float]:
    """Per-device memory of a case (the counterpart of the reference's
    ``memory_from_compiled``): ``peak_bytes = argument + temp``."""
    mesh = case.rules.mesh
    arg = shard_bytes(case.args, case.specs, mesh)
    out = shard_bytes(case.outs, case.out_specs, mesh)
    temp = dryrun_temp_bytes(case.cfg, case_step(case), case.rules,
                             output_bytes=out)
    return {"argument_bytes": arg, "output_bytes": out,
            "temp_bytes": float(temp), "peak_bytes": arg + float(temp)}


def dispatched_record(d: Dispatched) -> dict:
    """A dispatch census as a record: totals, and FLOPs, bytes and
    launches by class; the hand-written kernels' launches; the peak of the
    temporaries."""
    per_class = {cls: {"flops": c.flops, "bytes": c.bytes,
                       "launches": d.launches.per_class.get(cls, 0)}
                 for cls, c in d.census.per_class.items()}
    return {"flops": d.census.flops, "bytes": d.census.bytes,
            "coll_bytes": d.census.coll_bytes, "per_class": per_class,
            "launches": d.launches.total,
            "kernel_launches": dict(d.launches.kernels),
            "temp_bytes": float(d.temp_bytes)}


def run_case(arch: str, shape: str, mesh_name: str, out_dir: Optional[str],
             verbose: bool = True, variant: Optional[str] = None,
             hw: Hardware = H100_SXM5_80GB, dispatched: bool = True) -> dict:
    """Build and price one case into a record; on the one-device mesh
    with ``dispatched`` also run its step on the meta arguments under a
    dispatch census (a train case dispatches ~10^5 operations, tens of
    seconds on the host)."""
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "?",
           "variant": variant or "baseline"}
    t0 = time.time()
    try:
        mesh = mesh_named(mesh_name)
        # arctic's 468B parameters at these device counts: bf16 moments,
        # as the reference's dry-run takes them
        moment = "bfloat16" if arch == "arctic-480b" else "float32"
        case = build_case(arch, shape, mesh, moment_dtype=moment,
                          variant=variant, hw=hw)
        t1 = time.time()
        mem = case_memory(case)
        census = dryrun_census(case.cfg, case_step(case), case.rules)
        rep = roofline_report(
            census, hw, arch=arch, shape=shape, mesh=mesh_name,
            chips=mesh_chips(mesh), model_flops=case.model_flops,
            memory_bytes_per_chip=mem["peak_bytes"])
        t2 = time.time()
        if mesh.size > 1:
            rec.update(dispatched="not measured",
                       dispatched_needs=MULTI_CARD_ITEM)
        elif dispatched:
            rec["dispatched"] = dispatched_record(
                census_of(case.fn, *case.args))
        fits = mem["peak_bytes"] <= hw.hbm_bytes
        rec.update(
            status="ok", lower_s=round(t1 - t0, 3),
            compile_s=round(t2 - t0, 3),
            memory=mem,
            flops_per_chip=census.flops, bytes_per_chip=census.bytes,
            coll_bytes_per_chip=census.coll_bytes,
            per_collective=census.per_collective,
            compute_s=rep.compute_s, memory_s=rep.memory_s,
            collective_s=rep.collective_s, dominant=rep.dominant,
            model_flops=rep.model_flops, useful_ratio=rep.useful_ratio,
            per_class_ai=rep.per_class_ai,
            per_class_terms=rep.per_class_terms,
            moment_dtype=moment, microbatches=case.microbatches,
            fits_hbm=fits, fits_hbm_raw=fits,
        )
        if verbose:
            print(f"[{arch} x {shape} x {mesh_name}] OK "
                  f"price={rec['compile_s']}s "
                  f"mem/chip={mem['peak_bytes']/1e9:.2f}GB "
                  f"(args {mem['argument_bytes']/1e9:.2f}GB) "
                  f"terms(ms): C={rep.compute_s*1e3:.2f} "
                  f"M={rep.memory_s*1e3:.2f} X={rep.collective_s*1e3:.2f} "
                  f"-> {rep.dominant}, fits {hw.name}: {fits}", flush=True)
    except SkipCase as e:
        rec.update(status="skip", reason=str(e))
        if verbose:
            print(f"[{arch} x {shape} x {mesh_name}] SKIP: {e}", flush=True)
    except Exception as e:  # noqa: BLE001 - every case is recorded
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-3000:])
        if verbose:
            print(f"[{arch} x {shape} x {mesh_name}] ERROR: "
                  f"{type(e).__name__}: {str(e)[:300]}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{variant}" if variant else ""
        fn = os.path.join(out_dir,
                          f"{arch}__{shape}__{mesh_name}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1, default=float)
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="a layout variant (see input_specs.VARIANTS)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.all:
        archs, shapes = list(ASSIGNED), list(SHAPES)
        meshes = ["pod16x16", "pod2x16x16"]
    else:
        if not args.arch:
            raise SystemExit("give --arch (or --all)")
        archs = [args.arch]
        shapes = [args.shape] if args.shape else list(SHAPES)
        meshes = ["pod16x16", "pod2x16x16"] if args.both_meshes else \
            ["pod2x16x16" if args.multi_pod else "pod16x16"]
    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                rec = run_case(arch, shape, mesh_name, args.out,
                               variant=args.variant)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skip"
                n_err += rec["status"] == "error"
    print(f"done: {n_ok} ok, {n_skip} skip, {n_err} error", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
