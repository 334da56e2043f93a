#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and hold its CUDA kernels
against their plain PyTorch versions.

Run from the repository root, on a machine with one CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA::

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases:

0. build every kernel of ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   a source, all at once) and print each kernel's registers and spills;
1. print the card (``nvidia-smi``) and turn TF32 off for the comparisons;
2. each kernel against its plain version on the card: a paged-decode
   sweep over G, hd, block size and dtype (permuted placement, trash
   entries past each allocation, length-0 rows, full tables) and wide
   tables cut into several splits (lengths 0, 1, mid-block, on a split
   boundary, full and past the table; entries past each row's bound out
   of the pool, so that a read of one faults); the flash
   kernel's single-tile case on its own line, the reference's flash
   cases and a bf16 grid over head dims, head groups, masks and sequence
   shapes; the contiguous-decode grid of the reference's tests (plus
   G = 7 and hd 80/96), its length-0 rows against the TPU kernel's
   formula and long caches cut into several splits; each at its serving
   shape;
3. a model check at OPT-1.3B's full width in float32, cut to 2 layers:
   one prefill per prompt, then 4 paged and 4 gather-mode decode steps,
   each through the kernels and then through the plain versions; logits
   and greedy tokens must agree;
4. the main paths at full width and depth (24-layer OPT-1.3B, bfloat16,
   random weights from a seed), each run with every kernel's launch
   counter set to 0 just before and read just after: the paged serve of
   32 ShareGPT-length requests, the gather-fallback serve of the first
   16 (and, for token agreement, the paged serve of the same 16, in
   bfloat16 and again in float32), and a
   static batch of 32 prompts with 64 decode steps on a dense cache;
   each serve is followed by a ``torch.profiler`` window of 10 steady
   decode steps at batch 16 (device busy time by kernel kind against
   host wall time), and the flash kernel symbol a prefill launches
   (bfloat16 and float32) is printed from a profile;
5. time each kernel, its plain version and one PyTorch library call at
   the serving shapes (device time of back-to-back calls, and one call
   end to end, both on CUDA events; a plain version's one call), beside
   the least time the card could take (flash at every serve bucket, with
   TFLOP/s; paged decode at the serving shape and at one 8000-token
   request through a 512-block table; contiguous decode at the gather
   shape, at one 8192-token request and at the static batch's shape); the
   decode kernels and their library calls twice, L2-cold (back-to-back
   calls on 24 copies of their inputs in turn, as a step's 24 layers) and
   L2-warm (one copy); and one whole gather decode step against one paged
   step at batch 16 (with the gather copy's share);
6. print the card, a ``{"kernels": [...]}`` line and, last, the ``ok``
   line. Any failure raises: the script then exits non-zero and prints
   no ``ok`` line. Without a CUDA device it exits 1 at once.
"""
import contextlib
import dataclasses
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate (data sheet)
BF16_FLOP_S = 989e12         # H100 SXM dense bf16 tensor rate (data sheet)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # the reference's kernel tolerances
RTOL = 1e-2
ROW_ATOL = 1e-2              # paged multi-split atol: of a row's largest |out|
MODEL_TOL = 1e-3             # float32 logits, kernels vs plain, full width
MODEL = "opt-1.3b"           # the served configuration, full width


def close(a, b, what, atol=None):
    """Max abs error of ``a`` against ``b``; raises past atol + rtol*|b|
    (the reference tests' assert_allclose rule; atol by dtype unless
    given, as a number or a tensor broadcast against ``b``)."""
    import torch
    if atol is None:
        atol = TOL[str(b.dtype).replace("torch.", "")]
    af, bf = a.float(), b.float()
    err = (af - bf).abs()
    if not bool(torch.isfinite(af).all()):
        raise AssertionError(f"{what}: non-finite output")
    if bool((err > atol + RTOL * bf.abs()).any()):
        raise AssertionError(f"{what}: max abs err {err.max().item():.3e} "
                             f"past atol + {RTOL} x |reference|")
    return err.max().item()


def time_ms(fn, runs=30, warmup=5):
    """Median device time of ``fn`` over ``runs`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs=20, warmup=5):
    """Mean device time of one call of ``fn``, the host's share left out:
    the calls are queued behind a device-side sleep that outlasts the
    host's time to issue them, so they run back to back between two CUDA
    events. Raises if the device caught up with the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    issue_ms = 2 * runs * (time.perf_counter() - t0) * 1e3 + 1.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(issue_ms * 2e6))   # >= issue_ms at clocks <= 2 GHz
    start.record()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if queued_ms >= issue_ms:
        raise AssertionError(f"issuing {runs} calls took {queued_ms:.1f} ms, "
                             f"past the {issue_ms:.1f} ms sleep")
    return start.elapsed_time(end) / runs


def busy_ms(fn, runs=5):
    """Device busy time of one call of ``fn`` (an engine step, which
    synchronises): ``torch.profiler``'s device operation durations over
    ``runs`` calls, summed and divided by ``runs``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        raise AssertionError("profiler recorded no device activity")
    return sum(e.time_range.end - e.time_range.start for e in ops) / 1e3 / runs


def timed(fn, runs=20):
    """(device ms, end-to-end ms) of one call of ``fn``, a kernel or a
    library call (a few launches a call)."""
    return device_ms(fn, runs=runs), time_ms(fn, runs=runs)


LAYERS = 24                  # OPT-1.3B: a decode step calls each kernel 24x


def copies(tensors, n=LAYERS):
    """``n`` copies of each tensor in ``tensors``, made on the device."""
    return [[t.clone() for t in tensors] for _ in range(n)]


def l2_cold_ms(fn, inputs):
    """Mean device time of one call ``fn(*inputs[i])``, the calls back to
    back as in :func:`device_ms` but each on the next of ``inputs`` in
    turn, as a decode step calls a kernel on its 24 layers: with 24
    copies of tens of MB, a call finds none of its inputs in the 50 MB
    L2 (the single-buffer figure of :func:`device_ms` is L2-warm)."""
    turn = itertools.cycle(inputs)
    return device_ms(lambda: fn(*next(turn)), runs=len(inputs))


def bound(nbytes, flops, flop_rate=BF16_FLOP_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------- inputs ----
def paged_inputs(B, K, G, hd, BS, nb, dtype, lengths, seed, device="cuda"):
    """Random q and pools with each row's blocks at permuted physical ids;
    table entries past a row's allocation name the trash block (last)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    need = [min(max(0, -(-int(n) // BS)), nb) for n in lengths]
    NB = sum(need) + 8 + 1
    perm = torch.randperm(NB - 1, generator=gen)
    table = torch.full((B, nb), NB - 1, dtype=torch.int32)
    used = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[used:used + n]
        used += n
    mk = lambda *s: torch.randn(*s, generator=gen).to(dtype)  # noqa: E731
    q, kp, vp = mk(B, K * G, hd), mk(NB, BS, K, hd), mk(NB, BS, K, hd)
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(device) for t in (q, kp, vp, table, lens)]


def decode_inputs(B, S, K, G, hd, dtype, lengths, seed, device="cuda"):
    """Random q and dense ``[B, S, K, hd]`` caches."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen).to(dtype)  # noqa: E731
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(device) for t in (mk(B, K * G, hd), mk(B, S, K, hd),
                                   mk(B, S, K, hd), lens)]


def flash_inputs(B, Sq, Skv, K, G, hd, dtype, seed, device="cuda"):
    import torch
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen).to(dtype)  # noqa: E731
    return [t.to(device) for t in (mk(B, Sq, K * G, hd), mk(B, Skv, K, hd),
                                   mk(B, Skv, K, hd))]


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the kernels' plain versions."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import \
        gqa_decode_attention_torch
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.kernels.paged_decode_attention import \
        paged_gqa_decode_attention_torch
    saved = (ops.paged_decode_attention, ops.prefill_attention,
             ops.decode_attention)
    ops.paged_decode_attention = paged_gqa_decode_attention_torch
    ops.prefill_attention = flash_attention_torch
    ops.decode_attention = gqa_decode_attention_torch
    try:
        yield
    finally:
        (ops.paged_decode_attention, ops.prefill_attention,
         ops.decode_attention) = saved


def launch_counters():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.decode_attention import gqa_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_gqa_decode_attention
    return {"paged_decode_attention": paged_gqa_decode_attention,
            "flash_attention": flash_attention,
            "decode_attention": gqa_decode_attention}


def reset_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in launch_counters().items()}


@contextlib.contextmanager
def finite_logits(model):
    """Fold every prefill and decode step's logits into one on-device
    finiteness flag (no sync per step); yields the flag."""
    import torch
    finite = torch.ones((), dtype=torch.bool, device="cuda")

    def checked(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            logits = out[0] if isinstance(out, tuple) else out
            finite.logical_and_(torch.isfinite(logits).all())
            return out
        return call
    model.prefill = checked(model.prefill)
    model.decode_step = checked(model.decode_step)
    try:
        yield finite
    finally:
        del model.prefill, model.decode_step


# ------------------------------------------------------------- phases ----
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"[build] {len(paths)} libraries in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    # one line a kernel: its name (demangled where cu++filt is at hand),
    # then ptxas's spill and register lines for it
    filt = Path(_build._nvcc()).with_name("cu++filt")
    for name in paths:
        kernel, stats = None, []
        for line in _build.log_path(name).read_text().splitlines() + [""]:
            entry = line.split("Compiling entry function '")
            if len(entry) > 1 or not line:
                if kernel is not None:
                    print(f"[build] {name}: {kernel}: {'; '.join(stats)}")
                if len(entry) > 1:
                    kernel, stats = entry[1].split("'")[0], []
                    if filt.exists():   # "void ns::name<args>(params)"
                        kernel = subprocess.run(
                            [str(filt), kernel], capture_output=True,
                            text=True).stdout.strip()
                        kernel = kernel[:kernel.find(">(") + 1 or None]
                        kernel = kernel.split("::")[-1]
                    else:   # the identifier and its mangled arguments
                        kernel = re.sub(r".*?\d+([a-z_]+_kernel)I(\w+?)EEv.*",
                                        r"\1<\2>", kernel)
            elif "registers" in line or "spill" in line:
                stats.append(line.replace("ptxas info    :", "").strip())


def phase_kernels(errs):
    import torch
    from repro_torch.kernels.paged_decode_attention import (
        paged_gqa_decode_attention, paged_gqa_decode_attention_torch,
        paged_split_plan)
    n = 0
    for G in (1, 2, 4, 7, 8):
        for hd in (64, 80, 96, 128):
            for BS in (16, 32):
                for dtype in (torch.float32, torch.bfloat16):
                    nb = 4
                    lengths = [nb * BS, 1 + (G * hd + BS) % (nb * BS - 1), 0,
                               BS + 1]
                    args = paged_inputs(4, 2, G, hd, BS, nb, dtype, lengths,
                                        seed=n)
                    out = paged_gqa_decode_attention(*args)
                    ref = paged_gqa_decode_attention_torch(*args)
                    torch.cuda.synchronize()
                    if not bool((out[2] == 0).all()):
                        raise AssertionError("length-0 row is not zero")
                    e = close(out, ref, f"paged G={G} hd={hd} BS={BS} {dtype}")
                    errs["paged"]["sweep"] = max(errs["paged"]["sweep"], e)
                    n += 1
    print(f"[kernels] paged decode: {n} sweep cases within tolerance "
          f"(f32 {TOL['float32']}, bf16 {TOL['bfloat16']}, rtol {RTOL}); "
          f"max abs err {errs['paged']['sweep']:.3e}")
    phase_paged_splits(errs)
    args = serve_decode_inputs()
    e = close(paged_gqa_decode_attention(*args),
              paged_gqa_decode_attention_torch(*args), "paged serving shape")
    errs["paged"]["serving_shape"] = e
    plan = paged_split_plan(16, args[3].shape[1], 16, 32, 1, 64)
    print(f"[kernels] paged decode at the serving shape (B=16, K=32, G=1, "
          f"hd=64, BS=16, bf16, {plan.n_split} splits of "
          f"{plan.rows_per_split}): max abs err {e:.3e}")

    phase_flash_kernel(errs)
    phase_decode_kernel(errs)


def phase_paged_splits(errs):
    """The paged kernel over wide tables that its plan cuts into several
    splits, every (G, hd) at both dtypes and both block sizes: rows of
    length 0, 1, ending mid-block, ending on a split boundary, filling the
    table and past it; then batches of 32 with one split a row, where a
    warp's share spans more than the 32 table entries it holds and its
    window moves. Table entries past each row's bound name an id out of
    the pool for the kernel (a read would fault) and the trash block for
    the plain version. Each request's atol is cut to ``ROW_ATOL`` of its
    own largest output where that is tighter than the dtype's: rows over
    thousands of tokens average their values down to about 1e-2, below
    bf16's 3e-2, which would then pass a dropped split."""
    import itertools
    import torch
    from repro_torch.kernels.paged_decode_attention import (
        paged_gqa_decode_attention, paged_gqa_decode_attention_torch,
        paged_split_plan)

    def check(B, K, G, hd, BS, nb, dtype, lengths, seed, what):
        plan = paged_split_plan(B, nb, BS, K, G, hd)
        what = (f"{what} G={G} hd={hd} BS={BS} nb={nb} {dtype} lengths="
                f"{lengths[:4]}{'...' if B > 4 else ''} ({plan.n_split} "
                f"splits of {plan.rows_per_split})")
        args = paged_inputs(B, K, G, hd, BS, nb, dtype, lengths, seed=seed)
        q, kp, vp, table, lens = args
        past = torch.where(table == kp.shape[0] - 1, 2 ** 30, table)
        out = paged_gqa_decode_attention(q, kp, vp, past, lens)
        ref = paged_gqa_decode_attention_torch(*args)
        torch.cuda.synchronize()
        for b, length in enumerate(lengths):
            if length == 0 and not bool((out[b] == 0).all()):
                raise AssertionError(f"{what}: length-0 row is not zero")
        atol = (ROW_ATOL * ref.float().flatten(1).abs().amax(1)).clamp(
            max=TOL[str(dtype).replace("torch.", "")])
        return plan, close(out, ref, what, atol.view(-1, 1, 1))

    e_split, n, K = 0.0, 0, 2
    for i, (G, hd, BS, dtype) in enumerate(itertools.product(
            (1, 2, 4, 7, 8), (64, 80, 96, 128), (16, 32),
            (torch.float32, torch.bfloat16))):
        nb = (256, 512)[i // 4 % 2]
        S = nb * BS
        rows = paged_split_plan(2, nb, BS, K, G, hd).rows_per_split
        for lengths in ([0, S], [1, rows + BS // 2 + 1], [rows, 2 * rows],
                        [S + 7]):
            plan, e = check(len(lengths), K, G, hd, BS, nb, dtype, lengths,
                            1000 + n, "paged split")
            if plan.n_split < 2:
                raise AssertionError(f"paged nb={nb} BS={BS}: one split")
            e_split = max(e_split, e)
            n += 1
    # B*K >= 528: one split of the whole table; a warp's share of a long
    # row is a quarter of it, past 32 blocks
    B, K, BS, nb, n_win = 32, 32, 16, 512, 0
    S = nb * BS
    for hd, dtype in itertools.product((64, 128),
                                       (torch.float32, torch.bfloat16)):
        lengths = [S, S - 7, S // 2 + 9, 2100] + [
            (37 * j * j + 11 * j) % 700 for j in range(B - 4)]
        plan, e = check(B, K, 1, hd, BS, nb, dtype, lengths, 2000 + n_win,
                        "paged window")
        if min(plan.rows_per_split, S) // 4 <= 32 * BS:
            raise AssertionError(f"paged window B={B} K={K}: a warp's "
                                 f"share spans at most 32 blocks")
        e_split = max(e_split, e)
        n_win += 1
    errs["paged"]["multi_split"] = e_split
    print(f"[kernels] paged decode: {n} multi-split cases (B 1/2, K 2, G "
          f"1/2/4/7/8 x hd 64/80/96/128 x BS 16/32 x f32/bf16, table width "
          f"256/512; lengths 0, 1, mid-block, a split boundary, the full "
          f"table and past it) and {n_win} window cases (B {B}, K {K}, G 1, "
          f"hd 64/128, f32/bf16, BS {BS}, table width {nb}, one split, "
          f"rows up to {S} tokens: a warp's table window moves) within "
          f"tolerance, each request's atol min(dtype's, {ROW_ATOL} x its "
          f"largest output); entries past each bound out of the pool, "
          f"length-0 rows exactly 0; max abs err {e_split:.3e}")


def phase_flash_kernel(errs):
    """The flash kernel: the single-tile case alone first (a swizzle or
    descriptor fault shows there by itself), the reference's cases (f32
    on the CUDA-core body, bf16 on the tensor-core body), a bf16 grid over
    head dims, head groups, masks and sequence shapes, and the serving
    shapes."""
    import itertools
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)

    def check(B, Sq, Skv, K, G, hd, causal, window, dtype, seed, what):
        q, k, v = flash_inputs(B, Sq, Skv, K, G, hd, dtype, seed=seed)
        return close(flash_attention(q, k, v, causal=causal, window=window),
                     flash_attention_torch(q, k, v, causal=causal,
                                           window=window), what)

    e = check(1, 64, 64, 1, 1, 64, False, None, torch.bfloat16, 99,
              "flash single tile")
    errs["flash"]["single_tile"] = e
    print(f"[kernels] flash single tile (B=1, Sq=Skv=64, one head, hd 64, "
          f"non-causal, bf16, tensor-core body): max abs err {e:.3e}")
    cases = [(2, 64, 64, 2, 2, 64, True, None, torch.float32),
             (1, 96, 96, 1, 4, 32, True, 40, torch.float32),
             (2, 64, 64, 4, 1, 64, False, None, torch.bfloat16),
             (1, 128, 128, 2, 4, 128, True, None, torch.bfloat16),
             (3, 32, 96, 1, 2, 64, True, None, torch.float32),
             (1, 100, 100, 2, 1, 64, True, None, torch.float32)]
    for i, case in enumerate(cases):
        e = check(*case, seed=100 + i, what=f"flash case {i}")
        errs["flash"]["reference_cases"] = max(
            errs["flash"]["reference_cases"], e)
    grid = list(itertools.product(
        (32, 64, 80, 96, 128), ((2, 1), (1, 4), (2, 4), (1, 8)),
        ((True, None), (False, None), (True, 40)),
        ((64, 64), (100, 100), (32, 96), (128, 128), (1024, 1024))))
    e_grid = 0.0
    for n, (hd, (K, G), (causal, window), (Sq, Skv)) in enumerate(grid):
        e_grid = max(e_grid, check(
            1 if Sq > 128 else 2, Sq, Skv, K, G, hd, causal, window,
            torch.bfloat16, 200 + n,
            f"flash bf16 hd={hd} K={K} G={G} causal={causal} "
            f"window={window} Sq={Sq} Skv={Skv}"))
    errs["flash"]["bf16_grid"] = e_grid
    for S in (64, 128, 256, 512, 1024):
        e = check(1, S, S, 32, 1, 64, True, None, torch.bfloat16, S,
                  f"flash serving shape S={S}")
        errs["flash"]["serving_shape"] = max(errs["flash"]["serving_shape"],
                                             e)
    print(f"[kernels] flash prefill: {len(cases)} reference cases (max abs "
          f"err {errs['flash']['reference_cases']:.3e}); {len(grid)} bf16 "
          f"grid cases (hd 32/64/80/96/128 x (K,G) (2,1)/(1,4)/(2,4)/(1,8) "
          f"x causal/non-causal/window 40 x (Sq,Skv) (64,64)/(100,100)/"
          f"(32,96)/(128,128)/(1024,1024)), max abs err {e_grid:.3e}; S in "
          f"64..1024 at H=K=32, hd=64, bf16 (max abs err "
          f"{errs['flash']['serving_shape']:.3e}); within tolerance")


def phase_decode_kernel(errs):
    """The contiguous decode kernel: the reference's DECODE_CASES grid
    unstrided, with G = 7 and hd 80/96 added; length-0 rows against the
    TPU kernel's formula; the gather serve's shape."""
    import itertools
    import torch
    from repro_torch.kernels.decode_attention import (
        gqa_decode_attention, gqa_decode_attention_torch, split_plan)
    e_grid = e_zero = 0.0
    grid = list(itertools.product(
        (1, 2, 5), (64, 100, 256), ((1, 8), (2, 4), (4, 1), (8, 1), (2, 7)),
        (64, 80, 96, 128), (32, 256), (torch.float32, torch.bfloat16)))
    gen = torch.Generator().manual_seed(0)
    for n, (B, S, (K, G), hd, bs, dtype) in enumerate(grid):
        lengths = torch.randint(1, S + 1, (B,), generator=gen).tolist()
        lengths[0] = S
        q, k, v, lens = decode_inputs(B, S, K, G, hd, dtype, lengths, seed=n)
        e = close(gqa_decode_attention(q, k, v, lens, block_s=bs),
                  gqa_decode_attention_torch(q, k, v, lens, block_s=bs),
                  f"decode B={B} S={S} K={K} G={G} hd={hd} bs={bs} {dtype}")
        e_grid = max(e_grid, e)
    n_zero = 0
    for S, bs, G, hd, dtype in itertools.product(
            (64, 100, 256), (32, 256), (1, 7), (64, 80),
            (torch.float32, torch.bfloat16)):
        q, k, v, lens = decode_inputs(3, S, 2, G, hd, dtype,
                                      [0, S, 1 + S // 3], seed=S + bs + G)
        out = gqa_decode_attention(q, k, v, lens, block_s=bs)
        e = close(out, gqa_decode_attention_torch(q, k, v, lens, block_s=bs),
                  f"decode length-0 S={S} bs={bs} G={G} {dtype}")
        Sp = -(-S // min(bs, S)) * min(bs, S)
        quirk = (v[0].float().sum(0) / Sp).repeat_interleave(G, dim=0)
        e = max(e, close(out[0], quirk.to(dtype),
                         f"decode length-0 row vs sum(V)/Sp, S={S} bs={bs}"))
        e_zero = max(e_zero, e)
        n_zero += 1
    errs["decode"]["reference_grid"] = e_grid
    errs["decode"]["length0_rows"] = e_zero
    # several splits a row: long caches at small batch, with rows of
    # length 0, of length 1 and shorter than the first split
    e_split, n_split = 0.0, 0
    for S, (K, G), hd, dtype in itertools.product(
            (4096, 8192), ((2, 4), (8, 1)), (64, 128),
            (torch.float32, torch.bfloat16)):
        first = split_plan(2, S, K, G, hd).rows_per_split
        for lengths in ([0], [1], [first // 2], [S], [0, S], [1, first - 3],
                        [S - 5, first + 17]):
            B = len(lengths)
            plan = split_plan(B, S, K, G, hd)
            if plan.n_split < 2:
                raise AssertionError(f"S={S} B={B} K={K}: one split")
            q, k, v, lens = decode_inputs(B, S, K, G, hd, dtype, lengths,
                                          seed=S + n_split)
            e_split = max(e_split, close(
                gqa_decode_attention(q, k, v, lens),
                gqa_decode_attention_torch(q, k, v, lens),
                f"decode split S={S} K={K} G={G} hd={hd} {dtype} "
                f"lengths={lengths} ({plan.n_split} splits of "
                f"{plan.rows_per_split})"))
            n_split += 1
    errs["decode"]["multi_split"] = e_split
    print(f"[kernels] contiguous decode: {len(grid)} grid cases (B 1/2/5, S "
          f"64/100/256, (K,G) (1,8)/(2,4)/(4,1)/(8,1)/(2,7), hd "
          f"64/80/96/128, block_s 32/256, f32 and bf16) max abs err "
          f"{e_grid:.3e}; {n_zero} cases with a length-0 row equal to "
          f"sum(V)/Sp, max abs err {e_zero:.3e}; {n_split} multi-split "
          f"cases (B 1/2, S 4096/8192, (K,G) (2,4)/(8,1), hd 64/128, f32 "
          f"and bf16; lengths 0, 1, under the first split, S) max abs err "
          f"{e_split:.3e}; within tolerance")
    q, k, v, lens = gather_decode_inputs()
    e = close(gqa_decode_attention(q, k, v, lens),
              gqa_decode_attention_torch(q, k, v, lens),
              "decode at the gather serve's shape")
    errs["decode"]["serving_shape"] = e
    print(f"[kernels] contiguous decode at the gather serve's shape (B=16, "
          f"S_pad={k.shape[1]}, K=32, G=1, hd=64, bf16, {int(lens.sum())} "
          f"context tokens): max abs err {e:.3e}")


def run_model(model, prompts, steps, mode):
    """Prefill each prompt at batch 1 into a paged pool, then ``steps``
    greedy decode steps: ``paged`` in a batch bucket with a padding row,
    or ``gather`` as the engine's fallback runs them (dense copy,
    ``lengths = pos + 1``, scatter back). Returns the logits of every
    call and the greedy tokens."""
    import torch
    from repro_torch.kvcache.paged import PagedKVCache
    from repro_torch.serving.engine import _bucket, _pow2_bucket
    cfg = model.cfg
    pool = PagedKVCache(cfg, num_blocks=128, block_size=16,
                        device="cuda")
    logits_all, tokens = [], []
    for rid, p in enumerate(prompts):
        S = _bucket(len(p), 64)
        toks = torch.zeros((1, S), dtype=torch.long)
        toks[0, :len(p)] = torch.from_numpy(p)
        pool.manager.allocate(rid, len(p) + 1)
        logits, cache = model.prefill(toks.cuda(),
                                      torch.tensor([len(p)], device="cuda"),
                                      cache_len=S)
        pool.write_prefill(rid, cache)
        logits_all.append(logits)
        tokens.append(int(logits.argmax(-1)))
    history = [list(tokens)]
    positions = [len(p) for p in prompts]
    rids = list(range(len(prompts)))
    batch_pad = _pow2_bucket(len(prompts) + 1)
    for _ in range(steps):
        for rid in rids:
            pool.manager.append_token(rid, positions[rid] + 1)
        if mode == "paged":
            nb_pad = _pow2_bucket(
                max(len(pool.manager.tables[r]) for r in rids), lo=4)
            view = pool.view(rids, positions, nb_pad, batch_pad)
            inp = torch.zeros((batch_pad,), dtype=torch.long)
            inp[:len(rids)] = torch.tensor(tokens)
            logits = model.decode_step(inp.cuda(), view)[:len(rids)]
        else:
            cache = pool.gather(rids, pool.manager.blocks_needed(
                _bucket(max(positions) + 1, 64)))
            pos = torch.tensor(positions, device="cuda")
            logits = model.decode_step(torch.tensor(tokens, device="cuda"),
                                       cache, pos, lengths=pos + 1)
            pool.scatter_new_token(rids, positions, cache)
        logits_all.append(logits)
        tokens = logits.argmax(-1).tolist()
        history.append(tokens)
        positions = [p + 1 for p in positions]
    return logits_all, history


def phase_model(errs):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("opt-1.3b"), n_layers=2,
                              dtype="float32")
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(1))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (161, 97)]
    paged_tok = None
    for mode, kernel in (("paged", "paged_decode_attention"),
                         ("gather", "decode_attention")):
        reset_launches()
        kern, kern_tok = run_model(model, prompts, 4, mode)
        want = {"paged_decode_attention": 0, "decode_attention": 0,
                "flash_attention": 2 * 2, kernel: 4 * 2}
        if read_launches() != want:
            raise AssertionError(f"model check ({mode}) did not run the "
                                 f"kernels: {read_launches()} != {want}")
        with plain_attention():
            plain, plain_tok = run_model(model, prompts, 4, mode)
        if read_launches() != want:
            raise AssertionError(f"the plain {mode} run launched a kernel")
        err = max((a - b).abs().max().item() for a, b in zip(kern, plain))
        if not all(bool(torch.isfinite(a).all()) for a in kern):
            raise AssertionError(f"model check ({mode}): non-finite logits")
        if err > MODEL_TOL or kern_tok != plain_tok:
            raise AssertionError(
                f"model check ({mode}): logits differ by {err:.3e} "
                f"(tolerance {MODEL_TOL}) or tokens differ: {kern_tok} vs "
                f"{plain_tok}")
        paged_tok = paged_tok or kern_tok
        if kern_tok != paged_tok:
            raise AssertionError(f"gather-mode tokens {kern_tok} differ from "
                                 f"the paged steps' {paged_tok}")
        key = "paged" if mode == "paged" else "decode"
        errs[key]["model_check"] = err
        errs["flash"]["model_check"] = max(
            errs["flash"].get("model_check", 0.0), err)
        print(f"[model] OPT-1.3B width, 2 layers, float32: 2 prefills + 4 "
              f"{mode} decode steps, kernels vs plain versions: logits max "
              f"abs err {err:.3e} (tolerance {MODEL_TOL}), greedy tokens "
              f"equal {kern_tok[-1]}"
              + (" and equal to the paged steps'" if mode == "gather"
                 else ""))
    del model
    torch.cuda.empty_cache()


def serve_workload():
    from repro_torch.configs import get_config
    from repro_torch.serving.workload import sharegpt_like
    return sharegpt_like(32, get_config(MODEL).vocab_size, seed=0,
                         mean_in=161, mean_out=338, max_len=1024)


def decode_lengths():
    """The decode shapes' context: the first 16 requests of the serve
    workload at half their output budget."""
    return [r.prompt_len + r.max_new_tokens // 2
            for r in serve_workload()[:16]]


def serve_decode_inputs():
    """The paged kernel's serving shape: the 16 decode lengths, blocks at
    permuted ids."""
    import torch
    lengths = decode_lengths()
    nb = 4
    while nb * 16 < max(lengths):
        nb *= 2
    return paged_inputs(16, 32, 1, 64, 16, nb, torch.bfloat16, lengths,
                        seed=7)


def gather_decode_inputs():
    """The contiguous kernel's serving shape: the 16 decode lengths in a
    dense cache padded as the gather step pads it (``S_pad`` a multiple
    of four 16-token blocks)."""
    import torch
    lengths = decode_lengths()
    S_pad = -(-max(lengths) // 64) * 64
    return decode_inputs(16, S_pad, 32, 1, 64, torch.bfloat16, lengths,
                         seed=8)


def full_model(dtype=None):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(MODEL)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    t0 = time.perf_counter()
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}, {sum(p.numel() for p in model.parameters()) / 1e9:.3f}"
          f" B parameters, random init in {time.perf_counter() - t0:.1f} s")
    return model


def serve_config(decode_mode="paged"):
    from repro_torch.serving import EngineConfig
    return EngineConfig(max_batch=16, block_size=16, kv_pool_tokens=32768,
                        max_model_len=2048, prefill_bucket=64,
                        decode_mode=decode_mode)


def serve(model, reqs, decode_mode, card):
    """Serve ``reqs`` to completion with the launch counters set to 0
    just before and read just after; every request must finish by
    length with in-range tokens, every logit must be finite, and each
    kernel must have launched exactly once a layer of each step of its
    kind. Returns the engine, its metrics and the launch counts."""
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    cfg = model.cfg
    engine = ContinuousBatchingEngine(model, serve_config(decode_mode))
    torch.cuda.synchronize()
    with finite_logits(model) as finite:
        reset_launches()
        metrics = engine.run(reqs)
        torch.cuda.synchronize()
        launches = read_launches()
        if not bool(finite):
            raise AssertionError(f"{decode_mode} serve: NaN or inf logits")
    for r in reqs:
        if r.finish_reason != "length" or r.generated != r.max_new_tokens:
            raise AssertionError(f"request {r.req_id}: {r.finish_reason}, "
                                 f"{r.generated}/{r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"request {r.req_id}: token out of range")
    steps = engine.decode_steps * cfg.n_layers
    want = {"paged_decode_attention": steps if decode_mode == "paged" else 0,
            "decode_attention": steps if decode_mode == "gather" else 0,
            "flash_attention": engine.prefills * cfg.n_layers}
    if launches != want or not engine.decode_steps:
        raise AssertionError(f"{decode_mode} serve: launch counts "
                             f"{launches} != {want}")
    tag = f"[serve {decode_mode}]"
    print(f"{tag} on {card}: {len(reqs)} requests, "
          f"{metrics.output_tokens} output tokens, {engine.decode_steps} "
          f"decode steps, {engine.prefills} prefills, {metrics.preemptions} "
          f"preemptions; launches {launches} = steps (or prefills) x "
          f"{cfg.n_layers} layers")
    print(f"{tag} eager PyTorch, no CUDA graphs, on {card}: "
          f"throughput {metrics.throughput:.1f} tok/s, output "
          f"{metrics.output_throughput:.1f} tok/s, wall {metrics.wall_s:.2f} s,"
          f" mean batch {metrics.avg_batch:.2f}, KV peak "
          f"{metrics.max_kv_fraction * 100:.1f}%")
    print(f"{tag} on {card}: TTFT {metrics.ttft.row()}; ITL "
          f"{metrics.itl.row()}; E2E {metrics.e2e.row(scale=1.0, unit='s')}")
    return engine, metrics, launches


def phase_serve(model, card):
    """The paged serve of all 32 requests, then its decode profile and
    the flash kernel its prefills launch."""
    import torch
    reqs = serve_workload()
    engine, _, launches = serve(model, reqs, "paged", card)
    prefill_sizes = sorted({-(-r.prompt_len // 64) * 64 for r in reqs})
    del engine
    torch.cuda.empty_cache()
    profile_decode(model, "paged", card)
    prefill_symbol(model, card)
    return launches, prefill_sizes, reqs


def prefill_symbol(model, card, prompt=128):
    """The flash kernel symbol that one admission prefill launches, read
    from a ``torch.profiler`` trace: the tensor-core body for bfloat16,
    the CUDA-core body for float32, and nothing else."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, prompt))).cuda()
    lens = torch.tensor([prompt], device="cuda")
    model.prefill(toks, lens, cache_len=prompt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.prefill(toks, lens, cache_len=prompt)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "flash" in e.name})
    want = ("flash_wgmma_kernel" if cfg.dtype == "bfloat16"
            else "flash_kernel<float")
    if not names or not all(want in n for n in names):
        raise AssertionError(f"{cfg.dtype} prefill launched {names}, not "
                             f"{want}")
    print(f"[prefill] on {card}: a {cfg.dtype} prefill of {prompt} tokens "
          f"launched {names}")


def agreement(a_reqs, b_reqs):
    """How far two serves of the same requests agree: identical outputs,
    the share of output tokens equal position by position, and the mean
    position of each differing request's first different token."""
    same = sum(a.output_tokens == b.output_tokens
               for a, b in zip(a_reqs, b_reqs))
    pairs = [(x, y) for a, b in zip(a_reqs, b_reqs)
             for x, y in zip(a.output_tokens, b.output_tokens)]
    firsts = [next(i for i, (x, y) in enumerate(
        zip(a.output_tokens, b.output_tokens)) if x != y)
        for a, b in zip(a_reqs, b_reqs) if a.output_tokens != b.output_tokens]
    first = (f"first difference at output token "
             f"{statistics.mean(firsts):.1f} on average" if firsts
             else "no request differs")
    return (f"{same}/{len(a_reqs)} requests identical, "
            f"{sum(x == y for x, y in pairs) / len(pairs) * 100:.2f}% of "
            f"{len(pairs)} output tokens equal position by position, "
            f"{first}")


def phase_gather_serve(model, card, paged_all):
    """The gather-fallback serve of the first 16 requests and its decode
    profile, then the paged serve of the same 16 for token agreement
    (beside, as a control, the same 16 in the 32-request paged serve,
    where other batches surround them), and the same agreement with the
    model in float32."""
    import torch
    reqs = serve_workload()[:16]
    engine, _, launches = serve(model, reqs, "gather", card)
    del engine
    torch.cuda.empty_cache()
    profile_decode(model, "gather", card)
    paged_reqs = serve_workload()[:16]
    engine, _, _ = serve(model, paged_reqs, "paged", card)
    del engine
    torch.cuda.empty_cache()
    print(f"[serve gather] {model.cfg.dtype} token agreement, gather vs the "
          f"paged serve of the same 16 requests: "
          f"{agreement(reqs, paged_reqs)}")
    print(f"[serve gather] control, paged vs paged (the same 16 requests "
          f"served alone and among 32): "
          f"{agreement(paged_all[:16], paged_reqs)}")
    # the same pair in float32 at full depth: rounding, not the data path,
    # is what may still tell the two modes apart
    f32 = full_model(dtype="float32")
    runs = {}
    for mode in ("gather", "paged"):
        runs[mode] = serve_workload()[:16]
        engine, _, _ = serve(f32, runs[mode], mode, card)
        del engine
        torch.cuda.empty_cache()
    print(f"[serve gather] float32 token agreement, gather vs paged on the "
          f"same 16 requests: {agreement(runs['gather'], runs['paged'])}")
    prefill_symbol(f32, card)
    del f32
    torch.cuda.empty_cache()
    return launches


def phase_static(model, card, batch=32, prompt=128, steps=64):
    """The static-batch loop: one prefill of ``batch`` prompts into a
    dense cache, then ``steps`` decode steps at one position for the
    whole batch, greedy."""
    import torch
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (batch, prompt))).cuda()
    torch.cuda.synchronize()
    with finite_logits(model) as finite:
        reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(toks, cache_len=prompt + steps)
        nxt = logits.argmax(-1)
        out = [nxt]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(steps):
            nxt = model.decode_step(nxt, cache, prompt + i).argmax(-1)
            out.append(nxt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read_launches()
        if not bool(finite):
            raise AssertionError("static batch: NaN or inf logits")
    out = torch.stack(out)
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError("static batch: token out of range")
    want = {"paged_decode_attention": 0, "flash_attention": cfg.n_layers,
            "decode_attention": steps * cfg.n_layers}
    if launches != want:
        raise AssertionError(f"static batch: launch counts {launches} != "
                             f"{want}")
    print(f"[static] on {card}: {batch} prompts x {prompt} tokens, one "
          f"prefill ({(t1 - t0) * 1e3:.1f} ms) and {steps} decode steps at "
          f"one position on a dense [{cfg.n_layers}, {batch}, "
          f"{prompt + steps}, {cfg.n_kv_heads}, {cfg.hd}] cache: "
          f"{(t2 - t1) * 1e3 / steps:.3f} ms a step, "
          f"{batch * steps / (t2 - t1):.1f} output tok/s; launches "
          f"{launches}")
    del cache
    torch.cuda.empty_cache()
    return launches


def kernel_kind(name):
    # the paged kernels' symbols (paged_decode_split_kernel,
    # paged_decode_merge_kernel) hold the contiguous ones' names: test first
    if "paged_decode_" in name:
        return "paged attention kernel"
    if "decode_split_kernel" in name or "decode_merge_kernel" in name:
        return "contiguous decode attention kernel"
    if "flash" in name:
        return "flash kernel"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90")):
        return "GEMMs"
    return "other (norms, elementwise, indexing, copies)"


def profile_decode(model, decode_mode, card, steps=10):
    """Where a steady decode step's time goes: ``torch.profiler`` over
    ``steps`` engine steps at batch 16 (after 20 warm steps and as many
    unprofiled, timed ones), device busy time by kernel kind against the
    host's wall time of an unprofiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(model, serve_config(decode_mode))
    for r in serve_workload()[:16]:
        engine.add_request(r)
    for _ in range(21):                  # admits all 16, then warm steps
        engine.step(0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()             # the same window, unprofiled
    for _ in range(steps):
        engine.step(0.0)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step(0.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("profiler recorded no device activity")
    by_kind = {}
    for e in kernels:
        kind = kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / steps
    busy = sum(by_kind.values())
    ctx = sum(engine._pos.values())
    parts = ", ".join(f"{k} {v:.3f} ms ({v / busy * 100:.1f}%)"
                      for k, v in sorted(by_kind.items(),
                                         key=lambda kv: -kv[1]))
    print(f"[profile {decode_mode}] on {card}: {steps} decode steps at batch "
          f"{len(engine.running)} ({ctx} context tokens at the end), "
          f"torch.profiler: device busy {busy:.3f} ms/step, "
          f"{len(kernels) / steps:.0f} device ops/step; host wall "
          f"{plain_wall_ms:.3f} ms/step unprofiled ({wall_ms:.3f} profiled),"
          f" so the device idles {(1 - busy / plain_wall_ms) * 100:.1f}% of "
          f"an unprofiled step")
    print(f"[profile {decode_mode}] device time per step: {parts}")
    del engine
    torch.cuda.empty_cache()


def phase_times(card, prefill_sizes, serve_reqs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    times = {}
    long_request = paged_inputs(1, 32, 1, 64, 16, 512, torch.bfloat16,
                                [8000], seed=11)
    paged = [time_paged(card, what, *args) for what, args in (
        ("the paged serve's shape", serve_decode_inputs()),
        ("one long request through a wide table", long_request))]
    times["paged_decode_attention"] = dict(paged[0], other_shapes=paged[1:])

    shapes = [("the gather serve's shape", gather_decode_inputs()),
              ("one long request", decode_inputs(
                  1, 8192, 32, 1, 64, torch.bfloat16, [8192], seed=9)),
              ("the static batch at its middle step", decode_inputs(
                  32, 192, 32, 1, 64, torch.bfloat16, [160] * 32, seed=10))]
    decode = [time_decode(card, what, *args) for what, args in shapes]
    times["decode_attention"] = dict(decode[0], other_shapes=decode[1:])

    counts = {}
    for r in serve_reqs:
        s = -(-r.prompt_len // 64) * 64
        counts[s] = counts.get(s, 0) + 1
    main_s = max(counts, key=lambda s: (counts[s], s))
    by_bucket = []
    for S in sorted(set(prefill_sizes) | {1024}):
        q, k, v = flash_inputs(1, S, S, 32, 1, 64, torch.bfloat16, seed=S)
        nbytes = 4 * q.numel() * q.element_size()
        flops = 4 * 64 * 32 * S * (S + 1) / 2     # the causal half
        b_ms, b_by = bound(nbytes, flops)
        k_ms, k_call = timed(lambda: flash_attention(q, k, v))
        p_ms = time_ms(lambda: flash_attention_torch(q, k, v), runs=10)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        l_ms, l_call = timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        print(f"[times] on {card}: flash prefill B=1 S={S} H=K=32 hd=64 "
              f"bf16 ({counts.get(S, 0)} serve prefills): device time: "
              f"kernel {k_ms * 1e3:.1f} us, SDPA {l_ms * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}); kernel "
              f"{flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s and "
              f"{nbytes / (k_ms * 1e-3) / 1e9:.0f} GB/s achieved (SDPA "
              f"{flops / (l_ms * 1e-3) / 1e12:.2f} TFLOP/s); one call end "
              f"to end: kernel {k_call * 1e3:.1f} us, SDPA "
              f"{l_call * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us")
        row = dict(S=S, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                   bound_ms=b_ms, bound_by=b_by, call_ms=k_call,
                   library_call_ms=l_call,
                   tflop_s=flops / (k_ms * 1e-3) / 1e12,
                   gb_s=nbytes / (k_ms * 1e-3) / 1e9)
        by_bucket.append(row)
        if S == main_s:
            times["flash_attention"] = dict(
                row, shape=f"B=1 S={S} H=K=32 hd=64 bf16 (the most frequent "
                           f"serve prefill bucket)",
                library_call="scaled_dot_product_attention(is_causal=True)")
    times["flash_attention"]["by_bucket"] = by_bucket
    return times


def time_paged(card, what, q, kp, vp, table, lens):
    """The paged decode kernel and its plain version at one shape, with
    SDPA on the gathered contiguous cache as a yardstick (not the same
    function: the gather is left out), beside the bytes bound; prints one
    line and returns the numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_decode_attention import (
        paged_gqa_decode_attention, paged_gqa_decode_attention_torch,
        paged_split_plan)
    B, H, hd = q.shape
    _, BS, K, _ = kp.shape
    nb = table.shape[1]
    tokens = int(lens.sum())
    isz = q.element_size()
    nbytes = (2 * tokens * K * hd * isz + 2 * q.numel() * isz
              + table.numel() * 4 + lens.numel() * 4)
    b_ms, b_by = bound(nbytes, 4 * tokens * H * hd)
    k_warm, k_call = timed(lambda: paged_gqa_decode_attention(
        q, kp, vp, table, lens))
    pools = copies((kp, vp))
    k_ms = l2_cold_ms(lambda kp_l, vp_l: paged_gqa_decode_attention(
        q, kp_l, vp_l, table, lens), pools)
    del pools
    # a plain version issues hundreds of launches a call, more than the
    # launch queue holds behind a sleep: one call end to end
    p_ms = time_ms(lambda: paged_gqa_decode_attention_torch(
        q, kp, vp, table, lens), runs=10)
    S = nb * BS
    kc = kp[table.long()].reshape(B, S, K, hd).transpose(1, 2).contiguous()
    vc = vp[table.long()].reshape(B, S, K, hd).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = lambda kc_l, vc_l: F.scaled_dot_product_attention(  # noqa: E731
        q4, kc_l, vc_l, attn_mask=mask)
    l_warm, l_call = timed(lambda: sdpa(kc, vc))
    caches = copies((kc, vc))
    l_ms = l2_cold_ms(sdpa, caches)
    del caches, kc, vc
    torch.cuda.empty_cache()
    plan = paged_split_plan(B, nb, BS, K, H // K, hd)
    row = dict(
        ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
        call_ms=k_call, library_call_ms=l_call, ms_l2_warm=k_warm,
        library_ms_l2_warm=l_warm, gb_s=nbytes / (k_ms * 1e-3) / 1e9,
        n_split=plan.n_split,
        shape=f"B={B} H=K={K} hd={hd} BS={BS} bf16, {tokens} context "
              f"tokens, table width {nb} ({what})",
        library_call="scaled_dot_product_attention on the gathered "
                     "contiguous cache with a length mask (gather excluded)")
    print(f"[times] on {card}: paged decode at {row['shape']}, "
          f"{plan.n_split} splits of {plan.rows_per_split} rows: device "
          f"time, L2-cold ({LAYERS} pools in turn): kernel "
          f"{k_ms * 1e3:.1f} us, SDPA yardstick {l_ms * 1e3:.1f} us, bound "
          f"{b_ms * 1e3:.1f} us ({b_by}), {row['gb_s']:.0f} GB/s achieved; "
          f"L2-warm (one pool): kernel {k_warm * 1e3:.1f} us, SDPA "
          f"{l_warm * 1e3:.1f} us; one call end to end (CUDA events): kernel "
          f"{k_call * 1e3:.1f} us, SDPA {l_call * 1e3:.1f} us, plain "
          f"{p_ms * 1e3:.1f} us")
    return row


def time_decode(card, what, q, k, v, lens):
    """The contiguous decode kernel, its plain version and SDPA for the
    same function at one shape, beside the bytes bound; prints one line
    and returns the numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        gqa_decode_attention, gqa_decode_attention_torch, split_plan)
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    isz = q.element_size()
    tokens = int(lens.sum())
    nbytes = (2 * tokens * K * hd * isz + 2 * q.numel() * isz
              + lens.numel() * 4)
    b_ms, b_by = bound(nbytes, 4 * tokens * H * hd)
    k_warm, k_call = timed(lambda: gqa_decode_attention(q, k, v, lens))
    caches = copies((k, v))
    k_ms = l2_cold_ms(lambda k_l, v_l: gqa_decode_attention(q, k_l, v_l, lens),
                      caches)
    del caches
    # a plain version issues hundreds of launches a call, more than the
    # launch queue holds behind a sleep: one call end to end
    p_ms = time_ms(lambda: gqa_decode_attention_torch(q, k, v, lens), runs=10)
    # the same function in one library call, on the same cache in SDPA's
    # [B, K, S, hd] layout (the transposing copy is made before timing)
    kc, vc = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(S, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = lambda kc_l, vc_l: F.scaled_dot_product_attention(  # noqa: E731
        q4, kc_l, vc_l, attn_mask=mask, enable_gqa=True)
    l_warm, l_call = timed(lambda: sdpa(kc, vc))
    caches = copies((kc, vc))
    l_ms = l2_cold_ms(sdpa, caches)
    del caches, kc, vc
    torch.cuda.empty_cache()
    plan = split_plan(B, S, K, H // K, hd)
    row = dict(
        ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
        call_ms=k_call, library_call_ms=l_call, ms_l2_warm=k_warm,
        library_ms_l2_warm=l_warm,
        gb_s=nbytes / (k_ms * 1e-3) / 1e9, n_split=plan.n_split,
        shape=f"B={B} H=K={K} hd={hd} S_pad={S} bf16, {tokens} context "
              f"tokens ({what})",
        library_call="scaled_dot_product_attention(attn_mask=length mask, "
                     "enable_gqa=True) on the same cache, transposed to "
                     "[B,K,S,hd] before timing")
    print(f"[times] on {card}: contiguous decode at {row['shape']}, "
          f"{plan.n_split} splits of {plan.rows_per_split} rows: device "
          f"time, L2-cold ({LAYERS} caches in turn): kernel "
          f"{k_ms * 1e3:.1f} us, SDPA {l_ms * 1e3:.1f} us, bound "
          f"{b_ms * 1e3:.1f} us ({b_by}), {row['gb_s']:.0f} GB/s achieved; "
          f"L2-warm (one cache): kernel {k_warm * 1e3:.1f} us, SDPA "
          f"{l_warm * 1e3:.1f} us; one call end to end (CUDA events): kernel "
          f"{k_call * 1e3:.1f} us, SDPA {l_call * 1e3:.1f} us, plain "
          f"{p_ms * 1e3:.1f} us")
    return row


def phase_step_compare(model, card):
    """One whole engine decode step at batch 16, paged against gather
    (the port's counterpart of ``benchmarks/decode_datapath.py``), on one
    pool holding the 16 requests at half their output budget, timed in
    turns (paged, gather, gather, paged); then the gather copy and the
    scatter alone."""
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.engine import _bucket
    from repro_torch.serving.scheduler import StepPlan
    cfg = model.cfg
    engine = ContinuousBatchingEngine(model, serve_config())
    reqs = serve_workload()[:16]
    rids = [r.req_id for r in reqs]
    positions = decode_lengths()
    gen = torch.Generator("cuda").manual_seed(3)
    for leaf in engine.pool.pool.values():
        leaf.normal_(generator=gen)
    for r, pos in zip(reqs, positions):
        engine.pool.manager.allocate(r.req_id, pos + 1)
        engine._tokens[r.req_id] = r.req_id + 1
        engine._pos[r.req_id] = pos
    plan = StepPlan(reqs=reqs, rids=rids, positions=positions, n_prefill=0,
                    t0=0.0)
    steps = {"paged": engine._decode_paged, "gather": engine._decode_gather}
    ms = {"paged": [], "gather": []}
    for mode in ("paged", "gather", "gather", "paged"):
        ms[mode].append(time_ms(lambda: steps[mode](plan), runs=20))
    busy = {mode: busy_ms(lambda: fn(plan)) for mode, fn in steps.items()}
    pad_blocks = engine.pool.manager.blocks_needed(
        _bucket(max(positions) + 1, 4 * 16))
    cache = engine.pool.gather(rids, pad_blocks)
    g_ms = time_ms(lambda: engine.pool.gather(rids, pad_blocks), runs=20)
    s_ms = time_ms(lambda: engine.pool.scatter_new_token(rids, positions,
                                                         cache), runs=20)
    # gather() uploads its table from pageable memory, which synchronises
    # the stream; the copy's device time is that of its indexing alone
    trash = engine.pool.trash_block
    table = torch.tensor([t + [trash] * (pad_blocks - len(t)) for t in (
        engine.pool.manager.tables[r] for r in rids)], device="cuda")
    g_dev = device_ms(lambda: [leaf[:, table]
                               for leaf in engine.pool.pool.values()])
    view_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    paged, gather = statistics.mean(ms["paged"]), statistics.mean(ms["gather"])
    print(f"[step] on {card}: one decode step at batch 16, "
          f"{sum(positions)} context tokens, full-width {cfg.name} "
          f"{cfg.dtype}, {cfg.n_layers} layers: paged {ms['paged'][0]:.3f} / "
          f"{ms['paged'][1]:.3f} ms, gather {ms['gather'][0]:.3f} / "
          f"{ms['gather'][1]:.3f} ms (turns paged, gather, gather, paged); "
          f"gather / paged {gather / paged:.2f}x; device busy a step "
          f"(torch.profiler): paged {busy['paged']:.3f} ms, gather "
          f"{busy['gather']:.3f} ms")
    print(f"[step] on {card}: the gather copy ([{cfg.n_layers}, 16, "
          f"{pad_blocks * 16}, {cfg.n_kv_heads}, {cfg.hd}] K and V, "
          f"{view_bytes / 1e9:.2f} GB written, as many read): device "
          f"{g_dev:.3f} ms ({2 * view_bytes / (g_dev * 1e-3) / 1e9:.0f} GB/s),"
          f" end to end {g_ms:.3f} ms; the scatter back: end to end "
          f"{s_ms:.3f} ms; copy and scatter are "
          f"{(g_ms + s_ms) / gather * 100:.1f}% of the gather step's time; "
          f"the copy is {g_dev / busy['gather'] * 100:.1f}% of its device "
          f"busy time")
    del engine, cache
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    phase_build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    errs = {"paged": {"sweep": 0.0}, "decode": {},
            "flash": {"reference_cases": 0.0, "serving_shape": 0.0}}
    phase_kernels(errs)
    phase_model(errs)
    model = full_model()
    by_path = {"paged_serve": None, "gather_serve": None,
               "static_batch": None}
    by_path["paged_serve"], prefill_sizes, paged_all = phase_serve(model,
                                                                   card)
    by_path["gather_serve"] = phase_gather_serve(model, card, paged_all)
    by_path["static_batch"] = phase_static(model, card)
    phase_step_compare(model, card)
    del model
    torch.cuda.empty_cache()
    times = phase_times(card, prefill_sizes, serve_workload())
    kernels = []
    meta = {   # source, the TPU kernel's entry, the path whose run counts
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_decode_attention.py:78", "paged_serve"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:76", "paged_serve"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:67", "gather_serve"),
    }
    for name, key in (("paged_decode_attention", "paged"),
                      ("flash_attention", "flash"),
                      ("decode_attention", "decode")):
        t = times[name]
        source, replaces, path = meta[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": by_path[path][name],
            "max_abs_err": max(errs[key].values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library_call": t["library_call"],
            "call_ms": t["call_ms"], "library_call_ms": t["library_call_ms"],
            "shape": t["shape"], "max_abs_err_by_phase": errs[key],
            "launches_path": path,
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            **{key: t[key] for key in (
                "ms_l2_warm", "library_ms_l2_warm", "gb_s", "n_split",
                "by_bucket", "other_shapes") if key in t}})
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
