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
   cases, a bf16 grid over head dims, head groups, masks and sequence
   shapes and a grid with a length a request (the model's prefill
   without a prefix); the flash kernel's prefix-masked entry, its prefix
   length read from a device tensor, over G, hd, dtype, prefix pad, valid
   prefix length (0, 1, mid-block, the whole pad), suffix length and
   lengths short of it, bit for bit against the plain entry (its own
   build) without a prefix, and captured in a CUDA graph, then replayed
   at other prefix lengths bit for bit against direct calls; the
   contiguous-decode grid of the
   reference's tests (plus G = 7 and hd 80/96/112), its length-0 rows
   against the TPU kernel's formula and long caches cut into several
   splits; each at its serving shape; slice 13's shapes (the flash
   kernel not causal, 128 rows onto the VLM's 1601 image rows and
   hubert's 8 x 1024 with lengths at hd 80, windowed at S=10240 under a
   window of 8192; the contiguous kernel at the VLM's cross decode, B=16
   over 1601 rows at G 8, and the ring decode, B=4 over 8192 slots);
   the contiguous kernel at the dry-run's four dense long_500k shapes
   (B=1 over a full 8192-slot ring: G 1 hd 96, G 2, G 7 and G 8 at hd
   128), each row within 1e-2 of its largest plain output, and three
   planted faults (a 256-row split dropped, a head's row mixed up,
   zeros) each failing that tolerance; the sampler's threefry bits on
   the card against the CPU's over a (seed, position) sweep;
3. a model check at OPT-1.3B's full width in float32, cut to 2 layers:
   one prefill per prompt, then 4 paged and 4 gather-mode decode steps,
   each through the kernels and then through the plain versions; logits
   and greedy tokens must agree; then shared-prefix and long-prompt
   serves with the prefix cache on and off, chunked and serial, every
   step replayed from CUDA graphs (prefills and chunks included), every
   step eager, and overlapped, which must give the same tokens; then 8
   repetitive requests greedy, and sampled with the prefix cache and
   chunked prefill, speculation off and on, four ways (graphs, eager,
   graphs with overlap, the kernels' plain versions): every run's
   tokens equal; then co-located clusters of fresh engines (12
   ShareGPT-shaped requests): one replica sync against the bare engine,
   two replicas round-robin sync against a bare engine serving each
   replica's share, threaded, and overlapped (sync and threaded), and
   threaded with replica 1 killed mid-serve, greedy and sampled, with
   and without a respawn (replica 1 must serve again): equal tokens
   everywhere, launches counted across the replicas' threads; then the
   non-dense families at full width in float32, cut to two layers
   (zamba2 to two periods of six): olmoe-1b-7b, mamba2-1.3b and
   zamba2-7b (head dim 112), 2 prefills and 4 paged and 4 gather decode
   steps each through the kernels and their plain versions, tokens
   identical and logits within ``MODEL_TOL``;
4. the main paths at full width and depth (24-layer OPT-1.3B, bfloat16,
   random weights from a seed), each run with every kernel's launch
   counter set to 0 just before and read just after (a CUDA graph's
   launches, recorded at its capture, are added at each replay), every
   logit finite (eager calls folded here, replayed steps by their graph):
   the paged serve of 32 ShareGPT-length requests (every step, prefills
   included, replayed from one CUDA graph a bucket, the engine's
   default), the shared-prefix serve (4 tenants x 8, prefix 256, suffix
   32) with the prefix cache on and off, the long/short serve (16 short
   prompts of 24, 8 long of 768) chunked by 192 and serial, the paged
   serve's 32 requests sampled (temperature 0.8, top-k 50, top-p 0.95);
   the greedy and the sampled serve again with CUDA graphs and overlap
   (tokens equal to the graphs' serves) and with every step eager, the
   eager serves cut to 48 new tokens a request and held token for token
   to a graphs serve of the same cut requests; the prefix and the
   chunked serve again eager (tokens equal to the graphs'); the gather-fallback serve
   of the first 16 with graphs, eager (cut as above) and overlapped (and, for token
   agreement, the paged serve of the same 16, in bfloat16 and again in
   float32); a static batch of 32 prompts with 64 decode steps on a
   dense cache; the speculative serve (16 repetitive requests, prompt
   96, 128 new tokens, batch 4, ``spec_k`` 8), greedy and sampled,
   speculation off and on (graphs cold and warm, graphs with overlap),
   with a profile window of verify
   steps (busy against wall a decode iteration; the paged kernel's
   replayed launches against the counters and the trace) and the token
   agreement with speculation off; then observability (``[obs]``): the
   paged serve's 32 requests with ``Observability(audit_memory=True,
   windows=True)`` attached, with graphs and overlap and with graphs
   sync, tokens equal to the observer off, each step variant's live
   roofline (no bandwidth or compute share above 1), the memory-gap
   partition exact on every step, the Chrome trace written to
   ``chiprun_out/obs_trace.json`` and validated; the CUDA-event device
   time of 10 steady decode steps between 0.95 x the profiler's busy
   time and the host wall time of a step; output tok/s with the
   observer off and on in turns on a warm overlapped engine; and a
   deadline and shedding serve (``max_waiting``, end-to-end and TTFT
   deadlines, ``try_add_request``; the counters add up, an expired
   request keeps its partial output); then replication (``[cluster]``):
   64 ShareGPT-length requests at t=0 on one MAX engine (``max_batch``
   32, a 32768-token pool) and on 2 and 4 co-located replicas splitting
   that budget (batch 16 and 8), each threaded, round-robin, graphs +
   overlap, served cold (graphs captured on the replicas' threads) and
   then measured with an observer attached (aggregate tok/s, ITL and
   TTFT, each replica's steps, stream busy time, device idle share and
   memory, the weights once); a ``torch.profiler`` window of the R=2
   replicas stepping on their own threads (per-stream busy time must
   exceed the device's busy union; the paged kernel's counter, the
   trace and steps x layers must agree); the R=2 serve in sync mode
   (token agreement with the threaded one); the R=2 cluster serving the
   first 16 requests with replica 1 killed mid-serve, observed,
   respawned and not (every request finished, redrives, the trace's
   events); and the BCA loop:
   ``measure_curves`` at batch 4, 8, 16 and 32 on short serves,
   ``decide`` on the card's peaks with at most 4 replicas, and the
   decided cluster served; then the serving API and the launcher
   (``[api]``, ``[launcher_*]``): the paged serve's 32 requests through
   ``ServingAPI`` on an overlapped engine, the first streamed and the
   rest drained (tokens equal to ``engine.run``'s graphs + overlap
   serve), the first 16 through ``AsyncServingAPI`` on 16 concurrent
   streams with the longest aborted mid-stream, the first 16 through the
   facade over an R=2 cluster with replica 1 killed (nothing lost), and
   ``repro_torch.launch.serve.main`` three times in process (64 requests
   overlapped; ``--bca --replicas auto --stream`` with a trace, a
   Prometheus file and the memory audit, both validated; two replicas
   with prefix affinity and the prefix cache), each run's launches
   against its engines' steps. Each paged and gather way is followed by a
   ``torch.profiler`` window of 10 steady decode steps at batch 16
   (device busy time by kernel kind against host wall time; with graphs
   and no overlap, the decode kernel's replayed launches against the
   trace's count of its symbol), and the flash kernel symbol a prefill
   launches (bfloat16 and float32) is printed from a profile. Then a
   profile of the whole prefix and chunked serves on warm engines (busy
   against wall, graphs and eager); the prefix cache off and on in
   turns, three serves a side on one warm engine a side (TTFT); and one
   prefill at each serve shape through the engine's step, replayed and
   eager (host wall, device busy, idle, flash launches against the
   trace). Each serve
   prints the device memory its engine holds (KV pool, graph pools).
   Last, the non-dense families at full width and depth in bfloat16
   (``[families ...]``), each built, served and released before the
   next: olmoe-1b-7b (64 experts, top 8, capacity-routed), mamba2-1.3b
   and zamba2-7b (Mamba2 state in per-slot pool leaves, a shared
   attention block at head dim 112), each a paged serve of 16
   ShareGPT-length requests cut to 128 new tokens (graphs + overlap,
   batch 16) and a gather serve of the first 8, launches exact (the
   decode kernel once an attention layer a step: 16, 0 and 13; the
   flash kernel once an attention layer a prefill), every block and
   state slot home; output tok/s, ITL p50, the memory held (weights,
   K/V pool, dense state, graph pools), paged-vs-gather token
   agreement; and a profile window
   of 10 steady steps at batch 16 (busy, host wall, idle share, busy by
   kernel kind), then 3 eager steps under named scopes for the expert
   GEMMs' and the SSM state update's share of the device time. Then
   slice 13 (``[slice13 ...]``): llama-3.2-vision-90b at full width cut
   to two periods (10 layers, 8 self-attention and 2 cross, bf16, 21.3
   GB; 13.1 MB of image K/V a slot), a paged serve of 16 ShareGPT-length
   requests (graphs + overlap, batch 16) and a gather serve of the first
   8 through the engine's zero image stub, launches exact (8 paged and 2
   contiguous a paged step, 10 contiguous a gather step, 10 flash a
   prefill), every block and slot home, ITL beside the census bound;
   the VLM in float32 at one period (5 layers) with seeded random image
   embeddings, a prefill and 16 decode steps through the kernels and
   their plain versions, tokens identical; hubert-xlarge at full width
   and depth (48 layers), ``Model.forward`` on 8 x 1024 seeded
   embeddings with lengths, bf16 (its relative error against the plain
   run within 3e-2, ms a call beside the operations' bound) and float32
   (within ``MODEL_TOL``); internlm2-1.8b at full width and depth with
   a sliding window of 8192, the static-batch loop on 4 prompts of
   10240 tokens (the ring wraps at prefill) and 256 greedy steps (one
   flash launch a layer a prefill, one contiguous a layer a step), and
   in float32 at 2 layers, kernels against plain across the wrap, tokens
   identical. Then training (``[train ...]``): ``FlashAttentionFn`` (the
   flash kernel inside an autograd Function) at OPT-1.3B's training shape
   (B=8, S=1024, H=K=32, hd 64, causal), bf16 and float32, its output
   equal to the kernel's bit for bit and its dq/dk/dv within ``TOL`` of
   autograd of the plain version, its backward's device time beside the
   kernel's forward, the plain version and SDPA; OPT-1.3B and olmoe-1b-7b
   at full width in float32, 2 layers: the first batch's loss and
   gradients, then three AdamW steps, through the kernels and through
   their plain versions (losses within 1e-5, every gradient leaf within
   1e-4 of its largest magnitude, parameters within ``MODEL_TOL``, the
   flash kernel launched twice an attention layer a pass, the attention
   weights' gradients non-zero); microbatches 2 against 1 (loss within
   1e-4); a bf16 checkpoint saved and loaded, equal bit for bit; and the
   main path, ``repro_torch.launch.train`` in process at OPT-1.3B's full
   width and depth (bf16 weights, float32 moments, synthetic batches of 8
   x 1024, 10 steps, lr 3e-4, warmup 2): each step's loss, grad norm,
   device ms, tokens/s, MFU and peak memory, the loss falling, the flash
   kernel launched exactly 2 x 24 a step (the forward and each block's
   recompute); then one step profiled (busy by kernel kind against the
   host wall); the dry-run's predicted peak for that step (OPT-1.3B, 8 x
   1024, a 1 x 1 mesh) beside the measured one. Then the dry-run
   (``[dryrun ...]``): every arch x shape on the pod16x16, pod2x16x16 and
   1 x 1 meshes built on meta tensors and priced on the H100 (one line a
   case; no error, only hubert's decode shapes skipped), then each
   one-device decode case it says fits the card (phi3-mini-3.8b,
   internlm2-1.8b, deepseek-coder-33b and qwen2.5-3b at long_500k,
   mamba2-1.3b at long_500k and decode_32k) at full width and depth in
   bf16: its arguments materialized from a seed (the bytes held within
   0.1% of the predicted arguments), 4 greedy decode steps through the
   kernels (each attention call held to its plain version row by row,
   contiguous launches exactly attention layers x 4, the peak within 10%
   of the predicted peak) and through their plain versions (tokens equal
   but at a tie of 4 bf16 ulps, logits within ``DEEP_TOL`` of the
   largest), and the same steps through two other correct attentions
   (the plain one in 256-row tiles, SDPA: within ``DEEP_TOL``) and two
   planted faults (past it), and the step's device ms beside the
   dry-run's ``max(compute, memory)``; each case's step censused on the
   card and on its meta arguments, equal class by class, its
   temporaries against the allocator's peak less the arguments, and
   mamba2's state passes (``[census dryrun]``). The dispatch census
   (``[census]``, after phase 5's compares, on the loaded OPT-1.3B): the
   paged greedy step at batch 16 and 3151 context tokens censused at its
   first use by an observed engine and on the steps' meta twin (equal
   class by class: FLOPs, bytes, launches, temporaries), 3 eager steps
   under ``torch.profiler`` filed by the model scopes around each
   kernel's launching operation, each class's GB/s against the card's
   memory rate, the census's launches against the trace's kernels. The
   port's examples (``[examples ...]``, after the census, on the loaded
   OPT-1.3B where an example serves it): each of the seven
   ``repro_torch.examples`` modules' ``run`` at full width, every
   launch counted from 0 around it and exact (each engine it builds
   once a layer a step; the quickstart's forward and prefill 2 x 36
   flash launches and 6 x 36 contiguous ones on qwen2.5-3b in bf16, its
   logits within ``DEEP_TOL`` of the plain versions' run;
   ``train_tiny``'s 50 steps 2 x 8 flash launches a step, the loss
   falling, the checkpoint written), each example's own assertions
   (speculation on and off bit-identical, the stream's finish reasons,
   the cluster's completions on R=2 co-located replicas), and each
   kernel against its plain version at a shape only an example gives it
   (the paged kernel at block size 8, the contiguous one at K 2, G 8,
   hd 128, the flash kernel at G 3 in float32);
5. time each kernel, its plain version and one PyTorch library call at
   the serving shapes (device time of back-to-back calls, and one call
   end to end, both on CUDA events; a plain version's one call), beside
   the least time the card could take (flash at every serve bucket, with
   TFLOP/s, and with its length at a serial prefill of the paged serve;
   its prefix-masked entry at the prefix serve's suffix and the chunked
   serve's middle chunk; both beside SDPA with the same boolean mask;
   paged decode at the serving shape, at one 8000-token request
   through a 512-block table and at olmoe's (K 16, hd 128) and zamba2's
   (K 32, hd 112) serving shapes; contiguous decode at the gather shape, at
   one 8192-token request, at the static batch's shape, at the VLM's
   cross decode and at the ring decode; the flash kernel's plain entry
   at slice 13's three shapes beside SDPA with the same mask; contiguous
   decode at the dry-run's four long_500k shapes); the decode
   kernels and their library calls twice, L2-cold (back-to-back calls on
   24 copies of their inputs in turn, as a step's 24 layers) and L2-warm
   (one copy); one paged and one gather step at batch 16, each replayed
   from its graph against the same step eager (tokens, logits), greedy
   and sampled; each prefill shape replayed against the same prefill
   eager (logits, first token, the pool rows written), each suffix
   bucket also at two prefix lengths it was not captured at; one
   whole gather decode step against one paged step, replayed and eager,
   at batch 16 (with the gather copy's share); one verify step at
   ``(4, nb_pad, 8)`` replayed against eager (tokens, acceptance,
   logits, pool rows: bit for bit), its iteration 0 against the plain
   paged step (bit for bit), and its device busy time against 9 paged
   steps';
6. print the card, a ``{"kernels": [...]}`` line and, last, the ``ok``
   line. Any failure raises: the script then exits non-zero and prints
   no ``ok`` line. Without a CUDA device it exits 1 at once. Each phase
   prints its seconds (``[phase]``).
"""
import contextlib
import dataclasses
import gc
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
TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # the reference's kernel tolerances
RTOL = 1e-2
ROW_ATOL = 1e-2              # paged multi-split atol: of a row's largest |out|
MODEL_TOL = 1e-3             # float32 logits, kernels vs plain, full width
MODEL = "opt-1.3b"           # the served configuration, full width
# the non-dense families, each served at full width and depth
FAMILIES = ("olmoe-1b-7b", "mamba2-1.3b", "zamba2-7b")
# the float32 model check's depth: two layers, zamba2 two periods of six
# (its shared attention block twice)
MODEL_CHECK_LAYERS = {MODEL: 2, "olmoe-1b-7b": 2, "mamba2-1.3b": 2,
                      "zamba2-7b": 12}


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


def row_close(a, ref, what):
    """``close`` with each row's atol ``ROW_ATOL`` of that row's largest
    |ref| (a row: one query head's output, the last dim), where the
    dtype's atol would be as large as the outputs themselves; returns the
    max abs err and the largest |ref|."""
    rf = ref.float().abs()
    return (close(a, ref, what, ROW_ATOL * rf.amax(-1, keepdim=True)),
            rf.max().item())


def planted_decode_faults(q, k, v, lengths):
    """Wrong outputs a contiguous decode kernel could give on these
    inputs, each of which the row tolerance must reject: the kernel with
    a split dropped (:func:`fault_split_dropped`) or a head's row mixed
    up (:func:`fault_head_mixed`), and zeros."""
    import torch
    return {"a split dropped": fault_split_dropped(q, k, v, lengths),
            "a head's row mixed up": fault_head_mixed(q, k, v, lengths),
            "zeros": torch.zeros_like(q)}


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


def device_ms(fn, runs=20, warmup=5, attempts=3):
    """Mean device time of one call of ``fn``, the host's share left out:
    the calls are queued behind a device-side sleep that outlasts the
    host's time to issue them, so they run back to back between two CUDA
    events. A window whose issue outlasted its sleep (the device may have
    caught up: a host stall) is measured again behind a sleep twice as
    long; raises if ``attempts`` windows in a row did."""
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
    for _ in range(attempts):
        # no collection while the calls are issued: a pause of the
        # collector's would outlast the sleep (the process holds many
        # objects by phase 5)
        collecting = gc.isenabled()
        gc.disable()
        try:
            torch.cuda._sleep(int(issue_ms * 2e6))  # >= issue_ms at <= 2 GHz
            start.record()
            t0 = time.perf_counter()
            for _ in range(runs):
                fn()
            end.record()
            queued_ms = (time.perf_counter() - t0) * 1e3
        finally:
            if collecting:
                gc.enable()
        end.synchronize()
        if queued_ms < issue_ms:
            return start.elapsed_time(end) / runs
        print(f"[times] issuing {runs} calls took {queued_ms:.1f} ms, past "
              f"the {issue_ms:.1f} ms sleep: measured again")
        issue_ms *= 2
    raise AssertionError(f"issuing {runs} calls outlasted the sleep "
                         f"{attempts} times in a row (last {queued_ms:.1f} "
                         f"ms)")


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
           if is_device_work(e)]
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


def card_peaks():
    """The card's data-sheet peaks: the port's ``H100_SXM5_80GB`` entry
    (dense bf16 tensor rate, device memory rate), the one source the
    live roofline reads too."""
    from repro_torch.core.hardware import H100_SXM5_80GB
    return H100_SXM5_80GB


def bound(nbytes, flops, flop_rate=None):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type (bf16 by default)."""
    hw = card_peaks()
    flop_rate = hw.peak_flops if flop_rate is None else flop_rate
    t_bytes, t_ops = nbytes / hw.hbm_bw, flops / flop_rate
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
    from repro_torch.kernels.flash_attention import (
        flash_attention_torch, flash_prefix_attention_torch)
    from repro_torch.kernels.paged_decode_attention import \
        paged_gqa_decode_attention_torch
    saved = (ops.paged_decode_attention, ops.prefill_attention,
             ops.prefill_prefix_attention, ops.decode_attention)
    ops.paged_decode_attention = paged_gqa_decode_attention_torch
    ops.prefill_attention = flash_attention_torch
    ops.prefill_prefix_attention = flash_prefix_attention_torch
    ops.decode_attention = gqa_decode_attention_torch
    try:
        yield
    finally:
        (ops.paged_decode_attention, ops.prefill_attention,
         ops.prefill_prefix_attention, ops.decode_attention) = saved


def launch_counters():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.decode_attention import gqa_decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_prefix_attention)
    from repro_torch.kernels.paged_decode_attention import \
        paged_gqa_decode_attention
    return {"paged_decode_attention": paged_gqa_decode_attention,
            "flash_attention": flash_attention,
            "flash_prefix_attention": flash_prefix_attention,
            "decode_attention": gqa_decode_attention}


def reset_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in launch_counters().items()}


@contextlib.contextmanager
def finite_logits(model):
    """Fold every eager prefill and decode step's logits into one
    on-device finiteness flag (no sync per step); yields the flag. A
    replayed step runs no Python: its graph folds its own logits into the
    engine's ``steps.finite`` at every replay, so a call being captured
    is left alone here (the graph must not write into this flag)."""
    import torch
    finite = torch.ones((), dtype=torch.bool, device="cuda")

    def checked(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            if not torch.cuda.is_current_stream_capturing():
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


def release():
    """Free what the last engine held: an engine sits in a reference
    cycle (engine, scheduler, executor), so its CUDA graphs and their
    memory pools go only with a collection."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


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
        for hd in (64, 80, 96, 112, 128):
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
    phase_flash_prefix(errs)
    phase_decode_kernel(errs)
    phase_family_kernels(errs)
    phase_slice13_kernels(errs)
    phase_long_decode_kernels(errs)
    phase_threefry()


# the dry-run's long_500k decode cases that fit one card: (model, K, G,
# hd, attention layers); B=1 over an 8192-slot ring, bf16
LONG_DECODE = (("phi3-mini-3.8b", 32, 1, 96, 32),
               ("internlm2-1.8b", 8, 2, 128, 24),
               ("deepseek-coder-33b", 8, 7, 128, 62),
               ("qwen2.5-3b", 2, 8, 128, 36))
LONG_SLOTS = 8192


def phase_long_decode_kernels(errs):
    """The contiguous decode kernel at the four dense long_500k shapes
    (B=1, a full 8192-slot ring; G 1 hd 96, G 2, G 7 and G 8 at hd 128),
    bf16, against its plain version within :func:`row_close`'s row
    tolerance; each of :func:`planted_decode_faults` must fail it."""
    import torch
    from repro_torch.kernels.decode_attention import (
        gqa_decode_attention, gqa_decode_attention_torch, split_plan)
    for n, (name, K, G, hd, _) in enumerate(LONG_DECODE):
        args = decode_inputs(1, LONG_SLOTS, K, G, hd, torch.bfloat16,
                             [LONG_SLOTS], seed=70 + n)
        out, ref = gqa_decode_attention(*args), gqa_decode_attention_torch(
            *args)
        what = f"contiguous decode at {name}'s long_500k shape"
        e, top = row_close(out, ref, what)
        errs["decode"][f"long_500k_{name}"] = e
        caught = []
        for fault, wrong in planted_decode_faults(*args).items():
            try:
                row_close(wrong, ref, f"{what}, {fault}")
            except AssertionError:
                err = (wrong.float() - ref.float()).abs().max().item()
                caught.append(f"{fault} {err:.2e}")
                continue
            raise AssertionError(f"{what}: the row tolerance passes a "
                                 f"planted fault, {fault}")
        plan = split_plan(1, LONG_SLOTS, K, G, hd)
        print(f"[kernels] long_500k: contiguous decode at {name}'s shape "
              f"(B=1, S={LONG_SLOTS}, K {K}, G {G}, hd {hd}, bf16; "
              f"{plan.n_split} splits of {plan.rows_per_split}), kernel vs "
              f"plain: max abs err {e:.3e}, largest |plain| {top:.3e} "
              f"(atol {ROW_ATOL} x each row's largest |plain|, rtol "
              f"{RTOL}); planted faults rejected, max abs err: "
              f"{', '.join(caught)}")
    torch.cuda.synchronize()


def phase_slice13_kernels(errs):
    """The flash kernel's plain entry and the contiguous decode kernel at
    the shapes slice 13's paths give them, bf16, against their plain
    versions: the VLM's cross-attention prefill (not causal, 128 rows
    onto 1601 image rows, H 64, K 8, hd 128) and decode (B=16, every
    length 1601, G 8); hubert's bidirectional forward (B=8, S=1024,
    lengths 1024 down to 800, H = K = 16, hd 80); the windowed prefill
    (one S=10240 row block, window 8192, K 8, G 2, hd 128) and the ring
    decode (B=4 over 8192 slots, G 2)."""
    import torch
    from repro_torch.kernels.decode_attention import (
        gqa_decode_attention, gqa_decode_attention_torch, split_plan)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    cases = []
    q, k, v = flash_inputs(1, 128, 1601, 8, 8, 128, torch.bfloat16, seed=51)
    errs["flash"]["vlm_cross_prefill"] = close(
        flash_attention(q, k, v, causal=False),
        flash_attention_torch(q, k, v, causal=False),
        "flash, not causal, Sq=128 onto Skv=1601")
    cases.append(("flash, not causal, Sq=128, Skv=1601, H 64, K 8, hd 128",
                  errs["flash"]["vlm_cross_prefill"]))
    q, k, v = flash_inputs(8, 1024, 1024, 16, 1, 80, torch.bfloat16, seed=52)
    lengths = torch.tensor([1024 - 32 * i for i in range(8)],
                           dtype=torch.int32, device="cuda")
    errs["flash"]["hubert_bidirectional"] = close(
        flash_attention(q, k, v, causal=False, lengths=lengths),
        flash_attention_torch(q, k, v, causal=False, lengths=lengths),
        "flash, not causal, S=1024 with lengths, hd 80")
    cases.append(("flash, not causal, B=8, S=1024, lengths 1024..800, "
                  "H = K = 16, hd 80", errs["flash"]["hubert_bidirectional"]))
    q, k, v = flash_inputs(1, 10240, 10240, 8, 2, 128, torch.bfloat16,
                           seed=53)
    errs["flash"]["window_prefill"] = close(
        flash_attention(q, k, v, window=8192),
        flash_attention_torch(q, k, v, window=8192),
        "flash, causal, S=10240, window 8192")
    cases.append(("flash, causal, S=10240, window 8192, K 8, G 2, hd 128",
                  errs["flash"]["window_prefill"]))
    for tag, B, S, G in (("vlm_cross_decode", 16, 1601, 8),
                         ("ring_decode", 4, 8192, 2)):
        args = decode_inputs(B, S, 8, G, 128, torch.bfloat16, [S] * B,
                             seed=54 + G)
        errs["decode"][tag] = close(gqa_decode_attention(*args),
                                    gqa_decode_attention_torch(*args),
                                    f"contiguous decode B={B} S={S} G={G}")
        plan = split_plan(B, S, 8, G, 128)
        cases.append((f"contiguous decode, B={B}, S={S}, K 8, G {G}, hd "
                      f"128 ({plan.n_split} splits of {plan.rows_per_split})",
                      errs["decode"][tag]))
    torch.cuda.synchronize()
    for what, e in cases:
        print(f"[kernels] slice 13: {what}, bf16, kernel vs plain: max abs "
              f"err {e:.3e} (tolerance {TOL['bfloat16']})")


def phase_family_kernels(errs):
    """The three kernels at the shapes the non-dense families' and the
    VLM's bf16 serves give their self-attention, against their plain
    versions: paged decode at the paged serve's (B=16), contiguous decode
    at the gather serve's (the first 8 requests, the batch unpadded) and
    the flash kernel's plain entry at each serial prefill of the paged
    serve (B=1, the prompt's bucket of 64 with its length); each model's
    heads (the VLM's cross-attention shapes are
    :func:`phase_slice13_kernels`')."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        gqa_decode_attention, gqa_decode_attention_torch)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    from repro_torch.kernels.paged_decode_attention import (
        paged_gqa_decode_attention, paged_gqa_decode_attention_torch)
    for name in FAMILIES + (VLM,):
        heads = family_heads(name)
        if heads is None:
            continue
        K, G, hd = heads
        tag = f"{name}_serving_shape"
        args = serve_decode_inputs(K, G, hd)
        errs["paged"][tag] = close(
            paged_gqa_decode_attention(*args),
            paged_gqa_decode_attention_torch(*args),
            f"paged decode at {name}'s paged serve")
        q, k, v, lens = gather_decode_inputs(8, K, G, hd)
        errs["decode"][tag] = close(
            gqa_decode_attention(q, k, v, lens),
            gqa_decode_attention_torch(q, k, v, lens),
            f"contiguous decode at {name}'s gather serve")
        s_pad = k.shape[1]
        prefills = sorted({(-(-r.prompt_len // 64) * 64, r.prompt_len)
                           for r in family_workload(get_config(name))})
        e_flash = 0.0
        for S, n in prefills:
            q, k, v = flash_inputs(1, S, S, K, G, hd, torch.bfloat16, seed=n)
            lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
            e_flash = max(e_flash, close(
                flash_attention(q, k, v, lengths=lengths),
                flash_attention_torch(q, k, v, lengths=lengths),
                f"flash at {name}'s prefill S={S} length {n}"))
        errs["flash"][tag] = e_flash
        print(f"[kernels] at {name}'s serving shapes (H={K * G}, K={K}, "
              f"hd={hd}, bf16), kernels vs plain versions: paged decode "
              f"(B=16, table width {args[3].shape[1]}) max abs err "
              f"{errs['paged'][tag]:.3e}; contiguous decode (B=8, S_pad="
              f"{s_pad}) max abs err {errs['decode'][tag]:.3e}; flash's "
              f"plain entry "
              f"at the {len(prefills)} serial prefills (S "
              f"{prefills[0][0]}..{prefills[-1][0]}) max abs err "
              f"{e_flash:.3e}; within tolerance")


SPLIT_ROWS = 7               # rows a paged multi-split case


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

    # the rows of each (G, hd, BS, dtype) in one batch of SPLIT_ROWS: rows
    # are independent in the kernel and the plain version, and the plain
    # version's loop over the table, not the batch, sets the time
    e_split, n, K = 0.0, 0, 2
    for i, (G, hd, BS, dtype) in enumerate(itertools.product(
            (1, 2, 4, 7, 8), (64, 80, 96, 112, 128), (16, 32),
            (torch.float32, torch.bfloat16))):
        nb = (128, 256)[i // 4 % 2]
        S = nb * BS
        rows = paged_split_plan(SPLIT_ROWS, nb, BS, K, G,
                                hd).rows_per_split
        lengths = [0, S, 1, rows + BS // 2 + 1, rows, 2 * rows, S + 7]
        plan, e = check(SPLIT_ROWS, K, G, hd, BS, nb, dtype, lengths,
                        1000 + n, "paged split")
        if plan.n_split < 2 or plan.rows_per_split != rows:
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
    print(f"[kernels] paged decode: {n} multi-split cases (B "
          f"{SPLIT_ROWS}, K 2, G 1/2/4/7/8 x hd 64/80/96/112/128 x BS 16/32 "
          f"x f32/bf16, table width 128/256; rows of length 0, 1, "
          f"mid-block, a split boundary and twice it, the full table and "
          f"past it) and {n_win} window cases (B {B}, K {K}, G 1, "
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

    def check(B, Sq, Skv, K, G, hd, causal, window, dtype, seed, what,
              lengths=None):
        q, k, v = flash_inputs(B, Sq, Skv, K, G, hd, dtype, seed=seed)
        kw = dict(causal=causal, window=window)
        if lengths is not None:
            kw["lengths"] = torch.tensor(lengths, dtype=torch.int32,
                                         device="cuda")
        return close(flash_attention(q, k, v, **kw),
                     flash_attention_torch(q, k, v, **kw), what)

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
        (32, 64, 80, 96, 112, 128), ((2, 1), (1, 4), (2, 4), (1, 8)),
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
    # with a length a request (the model's prefill without a prefix): the
    # second request's keys cut short of the sequence
    len_grid = list(itertools.product(
        (32, 64, 80, 96, 112, 128), (torch.float32, torch.bfloat16),
        ((True, None), (False, None), (True, 40)), (64, 100, 192)))
    e_len = 0.0
    for n, (hd, dtype, (causal, window), S) in enumerate(len_grid):
        short = S - 5 - n % 7
        e_len = max(e_len, check(
            2, S, S, 2, 1 + n % 4, hd, causal, window, dtype, 400 + n,
            f"flash with lengths hd={hd} {dtype} causal={causal} "
            f"window={window} S={S} lengths=({S}, {short})",
            lengths=(S, short)))
    errs["flash"]["lengths"] = e_len
    for S in (64, 128, 256, 512, 1024):
        e = check(1, S, S, 32, 1, 64, True, None, torch.bfloat16, S,
                  f"flash serving shape S={S}")
        errs["flash"]["serving_shape"] = max(errs["flash"]["serving_shape"],
                                             e)
    print(f"[kernels] flash prefill: {len(cases)} reference cases (max abs "
          f"err {errs['flash']['reference_cases']:.3e}); {len(grid)} bf16 "
          f"grid cases (hd 32/64/80/96/112/128 x (K,G) "
          f"(2,1)/(1,4)/(2,4)/(1,8) "
          f"x causal/non-causal/window 40 x (Sq,Skv) (64,64)/(100,100)/"
          f"(32,96)/(128,128)/(1024,1024)), max abs err {e_grid:.3e}; S in "
          f"64..1024 at H=K=32, hd=64, bf16 (max abs err "
          f"{errs['flash']['serving_shape']:.3e}); {len(len_grid)} cases "
          f"with a length a request (hd 32-128 x f32/bf16 x causal/"
          f"non-causal/window 40 x S 64/100/192, the second length 5-11 "
          f"short), max abs err {e_len:.3e}; within tolerance")


def prefix_inputs(B, S, K, G, hd, P, pl, suffix_lengths, dtype, seed,
                  device="cuda"):
    """Random q over a suffix of ``S`` and K/V over ``P`` prefix slots
    (the first ``pl`` valid, the rest garbage) then the suffix; lengths
    in ids, ``pl + suffix_lengths[b]``."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen).to(dtype)  # noqa: E731
    lens = torch.tensor([pl + n for n in suffix_lengths], dtype=torch.int32)
    return [t.to(device) for t in (mk(B, S, K * G, hd), mk(B, P + S, K, hd),
                                   mk(B, P + S, K, hd), lens)]


def device_int(n):
    """``n`` as a 0-dim int32 tensor on the card (how the engine's steps
    hand the flash kernel's prefix entry its prefix length)."""
    import torch
    return torch.tensor(n, dtype=torch.int32).cuda()


def phase_flash_prefix(errs):
    """The flash kernel's prefix-masked entry, its prefix length read from
    the device, against its plain version: every prefix pad x valid
    prefix length (0, 1, mid-block, the whole pad) x suffix length at both
    dtypes, the (G, hd) pairs in turn, then every (G, hd, dtype) at a
    shape in turn; two requests a case, the second's length short of its
    suffix. Then the entry without a prefix (every length the sequence's)
    against the plain entry, bit for bit; then one call captured in a CUDA
    graph and replayed at prefix lengths it was not captured at, bit for
    bit against the same call made directly."""
    import itertools
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_prefix_attention, flash_prefix_attention_torch)
    heads = list(itertools.product((1, 2, 4, 7, 8), (64, 80, 96, 112, 128)))
    dtypes = (torch.float32, torch.bfloat16)
    shapes = [(P, pl, S) for P in (16, 32, 64, 512)
              for pl in (0, 1, P // 2 + 3, P) for S in (16, 64, 192)]
    cases = [(heads[n % len(heads)], dt, shape) for n, (dt, shape) in
             enumerate(itertools.product(dtypes, shapes))]
    cases += [((G, hd), dt, shapes[n % len(shapes)]) for n, ((G, hd), dt) in
              enumerate(itertools.product(heads, dtypes))]
    e_max = 0.0
    for n, ((G, hd), dtype, (P, pl, S)) in enumerate(cases):
        short = max(1, S - 5 - n % 7)
        q, k, v, lens = prefix_inputs(2, S, 2, G, hd, P, pl, (S, short),
                                      dtype, seed=3000 + n)
        kw = dict(prefix_pad=P, prefix_len=pl, lengths=lens)
        out = flash_prefix_attention(q, k, v, **dict(
            kw, prefix_len=device_int(pl)))
        e_max = max(e_max, close(
            out, flash_prefix_attention_torch(q, k, v, **kw),
            f"flash prefix G={G} hd={hd} {dtype} P_pad={P} prefix_len={pl} "
            f"S={S} lengths={lens.tolist()}"))
    errs["flash_prefix"]["sweep"] = e_max
    n_same = 0
    for hd, G, Sq, dtype in itertools.product(
            (32, 64, 80, 96, 112, 128), (1, 4), (64, 100, 192), dtypes):
        q, k, v = flash_inputs(2, Sq, Sq, 2, G, hd, dtype, seed=hd + Sq + G)
        for lens in ((Sq, Sq), (Sq, Sq - 3 - hd % 7)):
            lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
            a = flash_prefix_attention(q, k, v, prefix_pad=0,
                                       prefix_len=device_int(0),
                                       lengths=lens)
            if not torch.equal(a, flash_attention(q, k, v, lengths=lens)):
                raise AssertionError(
                    f"flash prefix entry without a prefix differs from the "
                    f"plain entry: hd={hd} G={G} Sq={Sq} {dtype} lengths "
                    f"{lens.tolist()}")
            n_same += 1
    n_graph = phase_flash_prefix_graph()
    print(f"[kernels] flash prefix entry: {len(cases)} cases (P_pad "
          f"16/32/64/512 x prefix_len 0/1/mid-block/P_pad x S 16/64/192 x "
          f"f32/bf16, then every G 1/2/4/7/8 x hd 64/80/96/112/128 x dtype; "
          f"B=2, K=2, the second length short of S, the prefix's masked "
          f"tail random) within tolerance, max abs err {e_max:.3e}; "
          f"without a prefix equal bit for bit to the plain causal entry "
          f"(its own build) with the same lengths in {n_same} of {n_same} "
          f"cases (hd 32-128, G 1/4, S 64/100/192, f32/bf16, lengths full "
          f"and one short); prefix length read from the device in every "
          f"case; a call captured in a CUDA graph at prefix_len 384 and "
          f"replayed at {n_graph} other lengths equal bit for bit to the "
          f"direct call at each")


def phase_flash_prefix_graph():
    """The prefix entry captured in a CUDA graph (the chunked serve's
    middle chunk: S=192 over P_pad 512, prefix length 384, bf16), then
    the length tensor rewritten and the graph replayed: each replay must
    equal a direct call at that length bit for bit (a length frozen at
    capture would mask with 384). Returns the lengths replayed."""
    import torch
    from repro_torch.kernels.flash_attention import flash_prefix_attention
    q, k, v, _ = prefix_inputs(1, 192, 32, 1, 64, 512, 384, (192,),
                               torch.bfloat16, seed=77)
    pl, lens = device_int(384), device_int(384 + 192).reshape(1)
    kw = dict(prefix_pad=512, prefix_len=pl, lengths=lens)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_prefix_attention(q, k, v, **kw)          # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_prefix_attention(q, k, v, **kw)
    flash_prefix_attention.launches -= 1               # captured, not run
    others = (0, 1, 200, 383, 385, 500, 512)
    for n in others:
        pl.fill_(n)
        lens.fill_(n + 192)
        graph.replay()
        want = flash_prefix_attention(q, k, v, prefix_pad=512,
                                      prefix_len=n, lengths=lens)
        if not torch.equal(out, want):
            raise AssertionError(f"flash prefix entry replayed at "
                                 f"prefix_len {n}: differs from the direct "
                                 f"call (a length frozen at capture?)")
    del graph
    return len(others)


def phase_threefry():
    """The sampler's threefry key, random bits and uniforms on the card
    equal the CPU's (and so JAX's, which the CPU tests hold them to) over
    a (seed, position) sweep; the Gumbel draw within 1e-6."""
    import torch
    from repro_torch.models import sampler
    seeds = torch.tensor([0, 1, 7, 123456, 2 ** 32 - 1, 31, 32, 4097])
    pos = torch.tensor([0, 1, 5, 161, 1023, 2 ** 31 - 1, 338, 2048])
    seeds, pos = (t.repeat_interleave(8) if i == 0 else t.repeat(8)
                  for i, t in enumerate((seeds, pos)))
    V = 50272
    out = {}
    for dev in ("cpu", "cuda"):
        keys = sampler.fold_in(sampler.prng_key(seeds.to(dev)), pos.to(dev))
        out[dev] = (keys, sampler.random_bits(keys, V),
                    sampler.uniform(keys, V, sampler.F32_TINY, 1.0),
                    sampler.gumbel(keys, V))
    for name, a, b in zip(("keys", "bits", "uniforms"), out["cpu"][:3],
                          out["cuda"][:3]):
        if not torch.equal(a, b.cpu()):
            raise AssertionError(f"threefry {name} on the card differ from "
                                 f"the CPU's")
    g = (out["cpu"][3] - out["cuda"][3].cpu()).abs().max().item()
    if g > 1e-6:
        raise AssertionError(f"gumbel on the card differs by {g:.3e}")
    print(f"[kernels] sampler: threefry keys, {V} random bits and uniforms "
          f"a key equal to the CPU's bit for bit over {len(seeds)} (seed, "
          f"position) pairs; gumbel max abs diff {g:.3e}")


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
        (64, 80, 96, 112, 128), (32, 256), (torch.float32, torch.bfloat16)))
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
          f"64/80/96/112/128, block_s 32/256, f32 and bf16) max abs err "
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


def run_model(model, prompts, steps, mode, img=None, feed=None):
    """Prefill each prompt at batch 1 into a paged pool (a VLM's with its
    row of ``img``, whose image K/V go into the request's slot), then
    ``steps`` greedy decode steps: ``paged`` in a batch bucket with a
    padding row, or ``gather`` as the engine's fallback runs them (dense
    copy, ``lengths = pos + 1``, scatter back). Each step takes the
    greedy tokens of the call before, or those of ``feed`` (an earlier
    run's). Returns the logits of every call and the greedy tokens."""
    import torch
    from repro_torch.kvcache.paged import PagedKVCache
    from repro_torch.serving.engine import _bucket, _pow2_bucket
    cfg = model.cfg
    pool = PagedKVCache(cfg, num_blocks=128, block_size=16,
                        device="cuda", max_batch=len(prompts))
    logits_all, tokens = [], []
    for rid, p in enumerate(prompts):
        S = _bucket(len(p), 64)
        toks = torch.zeros((1, S), dtype=torch.long)
        toks[0, :len(p)] = torch.from_numpy(p)
        pool.manager.allocate(rid, len(p) + 1)
        logits, cache = model.prefill(
            toks.cuda(), torch.tensor([len(p)], device="cuda"), cache_len=S,
            img_embeds=None if img is None else img[rid:rid + 1])
        pool.write_prefill(rid, cache)
        logits_all.append(logits)
        tokens.append(int(logits.argmax(-1)))
    history = [list(tokens)]
    positions = [len(p) for p in prompts]
    rids = list(range(len(prompts)))
    batch_pad = _pow2_bucket(len(prompts) + 1)
    for _ in range(steps):
        if feed is not None:
            tokens = feed[len(history) - 1]
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


def phase_model(errs, name, n_layers, seed=1, steps=4):
    """One configuration at full width in float32, cut to ``n_layers``:
    two prefills and ``steps`` paged, then ``steps`` gather, decode steps
    through the kernels and through their plain versions; logits within
    ``MODEL_TOL``, greedy tokens identical, the gather steps' tokens equal
    to the paged steps', and the kernels launched once an attention or
    cross layer a call by the kernel run and never by the plain run. A
    VLM prefills with seeded random image embeddings, so its decode steps
    read non-zero image K/V from the pool's slots; the same run with zero
    embeddings (fed the same tokens) must move every call's logits by
    more than ``MODEL_TOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(name), n_layers=n_layers,
                              dtype="float32")
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(seed))
    n_attn, n_cross = attention_layers(cfg), cross_layers(cfg)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (161, 97)]
    img = torch.randn((len(prompts), cfg.n_img_tokens, cfg.d_model),
                      generator=torch.Generator("cuda").manual_seed(seed + 1),
                      device="cuda") if n_cross else None
    tag = "model_check" if name == MODEL else f"{name}_model_check"
    paged_tok = None
    for mode, kernel in (("paged", "paged_decode_attention"),
                         ("gather", "decode_attention")):
        reset_launches()
        kern, kern_tok = run_model(model, prompts, steps, mode, img)
        want = {"paged_decode_attention": 0, "decode_attention": 0,
                "flash_attention": 2 * (n_attn + n_cross),
                "flash_prefix_attention": 0}
        want[kernel] += steps * n_attn
        want["decode_attention"] += steps * n_cross
        if read_launches() != want:
            raise AssertionError(f"model check {name} ({mode}) did not run "
                                 f"the kernels: {read_launches()} != {want}")
        with plain_attention():
            plain, plain_tok = run_model(model, prompts, steps, mode, img)
        if read_launches() != want:
            raise AssertionError(f"the plain {mode} run of {name} launched "
                                 f"a kernel")
        err = max((a - b).abs().max().item() for a, b in zip(kern, plain))
        if not all(bool(torch.isfinite(a).all()) for a in kern):
            raise AssertionError(f"model check {name} ({mode}): non-finite "
                                 f"logits")
        if err > MODEL_TOL or kern_tok != plain_tok:
            raise AssertionError(
                f"model check {name} ({mode}): logits differ by {err:.3e} "
                f"(tolerance {MODEL_TOL}) or tokens differ: {kern_tok} vs "
                f"{plain_tok}")
        paged_tok = paged_tok or kern_tok
        if kern_tok != paged_tok:
            raise AssertionError(f"{name}: gather-mode tokens {kern_tok} "
                                 f"differ from the paged steps' {paged_tok}")
        moved = ""
        if n_cross:
            zero, _ = run_model(model, prompts, steps, mode,
                                torch.zeros_like(img), feed=kern_tok)
            least = min((a - b).abs().max().item()
                        for a, b in zip(kern, zero))
            if not least > MODEL_TOL:
                raise AssertionError(
                    f"model check {name} ({mode}): zero image embeddings "
                    f"move a call's logits by only {least:.3e}: the image "
                    f"K/V were not read")
            moved = (f"; the image moves every call's logits by at least "
                     f"{least:.3e}")
        if n_attn:
            keys = {"paged" if mode == "paged" else "decode", "flash"}
            for key in keys | ({"decode"} if n_cross else set()):
                errs[key][tag] = max(errs[key].get(tag, 0.0), err)
        print(f"[model] {name} width, {n_layers} layers ({n_attn} with "
              f"attention" + (f", {n_cross} cross" if n_cross else "")
              + f"), float32: 2 prefills + {steps} {mode} decode steps, "
              f"kernels vs plain versions: logits max abs err {err:.3e} "
              f"(tolerance {MODEL_TOL}), greedy tokens equal {kern_tok[-1]}"
              + (" and equal to the paged steps' at every step"
                 if mode == "gather" else "")
              + f"; launches {want}{moved}")
    del model
    release()


def phase_model_prefill_modes(errs):
    """At OPT-1.3B's width in float32, cut to 2 layers: the shared-prefix
    workload (4 tenants x 4, prefix 256, suffix 32) and a long/short one
    (6 short prompts of 24, 3 long of 300), served serially without the
    prefix cache, with it, chunked by 40 tokens (chunks end mid-block),
    both, with every step eager, overlapped, and overlapped with both;
    every run must give the serial run's tokens (every step but the eager
    run's replayed from CUDA graphs, prefills and chunks included), and
    the flash kernel's prefix-masked entry must carry every prefill and
    chunk over a prefix, its plain entry every other."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.workload import (long_short_workload,
                                              shared_prefix_workload)
    cfg = dataclasses.replace(get_config("opt-1.3b"), n_layers=2,
                              dtype="float32")
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(2))
    workloads = {
        "shared prefix": lambda: shared_prefix_workload(
            4, 4, cfg.vocab_size, prefix_len=256, suffix_len=32,
            max_new_tokens=8, seed=1),
        "long/short": lambda: long_short_workload(
            6, 3, cfg.vocab_size, short_len=24, long_len=300, short_new=8,
            long_new=4, every=2, seed=1)}
    modes = {"serial": {}, "prefix cache": dict(prefix_cache=True),
             "chunked 40": dict(prefill_chunk_tokens=40),
             "chunked 40 + prefix cache": dict(prefill_chunk_tokens=40,
                                               prefix_cache=True),
             "eager steps": dict(cuda_graphs=False),
             "overlap": dict(overlap=True),
             "overlap, chunked 40 + prefix cache": dict(
                 overlap=True, prefill_chunk_tokens=40, prefix_cache=True)}
    for wl, make in workloads.items():
        tokens = {}
        for mode, kw in modes.items():
            reqs = make()
            engine = ContinuousBatchingEngine(
                model, serve_config(max_batch=8, **kw))
            reset_launches()
            engine.run(reqs)
            torch.cuda.synchronize()
            want = prefill_launches(engine)
            got = {k: read_launches()[k] for k in want}
            if got != want:
                raise AssertionError(f"2-layer {wl} {mode}: flash launches "
                                     f"{got} != {want}")
            tokens[mode] = [r.output_tokens for r in reqs]
            if tokens[mode] != tokens["serial"]:
                raise AssertionError(f"2-layer float32 {wl}: {mode} tokens "
                                     f"differ from serial prefill's")
            hits = engine.prefix.stats.hit_tokens if engine.prefix else 0
            print(f"[model] OPT-1.3B width, 2 layers, float32, {wl} "
                  f"({len(reqs)} requests), {mode}: tokens equal to serial "
                  f"prefill's; {engine.prefill_tokens_computed} prefill "
                  f"tokens computed, {hits} from the cache, {engine.chunks} "
                  f"chunks, {engine.suffix_prefills} over a prefix; "
                  f"{step_mode(engine)}")
    del model
    release()


def spec_workload(vocab, n=16, prompt_len=96, max_new_tokens=128, seed=0,
                  sampling=None):
    """Speculation's target shape (``benchmarks/speculative.py``'s
    workload): self-repetitive prompts, phrases of 8 tokens from a pool
    of 3 a request, 95% of them repeats."""
    from repro_torch.serving.workload import repetitive_workload
    return repetitive_workload(n, vocab, prompt_len=prompt_len,
                               max_new_tokens=max_new_tokens,
                               repeat_rate=0.95, phrase_len=8, pool_size=3,
                               seed=seed, sampling=sampling)


# a low temperature and top-k 3: some sampled tokens repeat the context,
# so sampled drafts are accepted past the key block's first offset
SPEC_SAMPLED = dict(temperature=0.5, top_k=3, top_p=0.9, seed=0)


def phase_model_speculative(errs):
    """At OPT-1.3B's width in float32, cut to 2 layers: 8 repetitive
    requests (prompt 96, 32 new tokens, batch 4, ``spec_k`` 8) greedy, and
    sampled with the prefix cache and chunked prefill (chunks of 40) on,
    speculation off and on, four ways: CUDA graphs, every step eager,
    graphs with overlap, and every step eager through the kernels' plain
    versions (sampled at temperature 0.5, top-k 3, top-p 0.9, where
    drafts are accepted). Every run must give the first run's tokens,
    launch each kernel once a layer of each step of its kind (the paged
    kernel ``K_pad + 1`` times a verify step; none in the plain runs),
    keep its logits finite and bring every block home."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.workload import SamplingParams
    cfg = dataclasses.replace(get_config("opt-1.3b"), n_layers=2,
                              dtype="float32")
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(3))
    kinds = {"greedy": (None, {}),
             "sampled, prefix cache + chunked 40": (
                 SamplingParams(**SPEC_SAMPLED),
                 dict(prefix_cache=True, prefill_chunk_tokens=40))}
    ways = {"graphs": {}, "eager steps": dict(cuda_graphs=False),
            "graphs + overlap": dict(overlap=True),
            "plain versions": dict(cuda_graphs=False)}
    for kind, (sp, kind_kw) in kinds.items():
        first = None
        for way, way_kw in ways.items():
            for spec in (False, True):
                reqs = spec_workload(cfg.vocab_size, n=8, max_new_tokens=32,
                                     seed=1, sampling=sp)
                engine = ContinuousBatchingEngine(model, serve_config(
                    max_batch=4, speculate=spec, spec_k=8, **kind_kw,
                    **way_kw))
                plain = way == "plain versions"
                with plain_attention() if plain else contextlib.nullcontext():
                    reset_launches()
                    m = engine.run(reqs)
                    torch.cuda.synchronize()
                tag = (f"2-layer float32 {kind}, {way}, speculation "
                       f"{'on' if spec else 'off'}")
                steps = (engine.decode_steps + engine.verify_iterations) * 2
                want = {"paged_decode_attention": steps,
                        "decode_attention": 0, **prefill_launches(engine)}
                if plain:
                    want = dict.fromkeys(want, 0)
                if read_launches() != want:
                    raise AssertionError(f"{tag}: launches {read_launches()}"
                                         f" != {want}")
                if not bool(engine.steps.finite):
                    raise AssertionError(f"{tag}: NaN or inf logits")
                if engine.prefix is not None:
                    engine.prefix.clear()
                mgr = engine.pool.manager
                if mgr.free_blocks != mgr.num_blocks:
                    raise AssertionError(f"{tag}: {mgr.free_blocks} of "
                                         f"{mgr.num_blocks} blocks free")
                if spec and not m.spec_steps:
                    raise AssertionError(f"{tag}: no verify step ran")
                first = first or reqs
                diff = first_difference(first, reqs)
                if diff:
                    raise AssertionError(f"{tag}: tokens differ from the "
                                         f"graphs run's without speculation "
                                         f"at {diff}")
                print(f"[model] OPT-1.3B width, {tag}: tokens equal to the "
                      f"graphs run without speculation; {engine.decode_steps}"
                      f" plain steps, {m.spec_row()}, "
                      f"{engine.verify_iterations} verify iterations; "
                      f"{step_mode(engine)}")
                del engine
                release()
    del model
    release()


def cluster_engines(cluster, before=()):
    """Every engine a cluster ran: its replicas' and the dead engines a
    respawn replaced (``before``: the engines it started with)."""
    engines = list(before)
    for rep in cluster.replicas:
        if all(rep.engine is not e for e in engines):
            engines.append(rep.engine)
    return engines


def serve_cluster(cluster, reqs, tag, faults=0, drive=None):
    """Serve ``reqs`` on ``cluster`` (``cluster.run``, or ``drive(cluster,
    reqs)``, which returns the metrics) with the launch counters set to 0
    just before and read just after: every request must finish by length,
    every engine's logits stay finite, every healthy replica's blocks come
    home, the cluster must see ``faults`` failures, and each kernel must
    have launched exactly once a layer of each step of its kind, summed
    over every engine the cluster ran (the replicas step on their own
    threads and streams; dead engines count what they ran). Returns the
    metrics and the launch counts."""
    import torch
    before = [rep.engine for rep in cluster.replicas]
    reset_launches()
    m = (drive or type(cluster).run)(cluster, reqs)
    torch.cuda.synchronize()
    launches = read_launches()
    engines = cluster_engines(cluster, before)
    for r in reqs:
        if r.finish_reason != "length" or r.generated != r.max_new_tokens:
            raise AssertionError(f"{tag}: request {r.req_id}: "
                                 f"{r.finish_reason}, {r.generated}/"
                                 f"{r.max_new_tokens} tokens")
    if m.faults != faults or m.lost:
        raise AssertionError(f"{tag}: {m.faults} faults (want {faults}), "
                             f"{m.lost} requests lost")
    for e in engines:
        if not bool(e.steps.finite):
            raise AssertionError(f"{tag}: NaN or inf logits")
    want = expected_launches(engines)
    for rep in cluster.replicas:
        mgr = rep.engine.pool.manager
        cached = rep.engine.prefix.cached_blocks if rep.engine.prefix else 0
        if rep.healthy and mgr.free_blocks + cached != mgr.num_blocks:
            raise AssertionError(f"{tag}: replica {rep.idx} holds "
                                 f"{mgr.num_blocks - mgr.free_blocks} blocks")
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches} != {want}")
    return m, launches


def phase_model_cluster():
    """At OPT-1.3B's width in float32, cut to 2 layers: 12 ShareGPT-shaped
    requests (mean 64 in, 32 out) through co-located clusters of engines
    that replay CUDA graphs, every cluster's engines fresh (so a threaded
    cluster captures its graphs inside its own traffic): a 1-replica sync
    cluster against the bare engine; two replicas round-robin, sync,
    against a bare engine serving each replica's share, threaded, and
    overlapped (sync and threaded); a threaded cluster with replica 1
    killed mid-serve, greedy and sampled, and again with ``respawn=True``
    (replica 1 must serve again). Every run's tokens must equal its
    no-fault counterpart's; launches are counted across the threads."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     FaultInjector, FaultSpec,
                                     ReplicatedCluster, SamplingParams)
    from repro_torch.serving.workload import sharegpt_like
    cfg = dataclasses.replace(get_config("opt-1.3b"), n_layers=2,
                              dtype="float32")
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(3))
    kw = dict(max_batch=4, kv_pool_tokens=16384)

    def wl(sampling=None):
        return sharegpt_like(12, cfg.vocab_size, seed=5, mean_in=64,
                             mean_out=32, max_len=256, sampling=sampling)

    def check(tag, got, want):
        diff = first_difference(want, got)
        if diff:
            raise AssertionError(f"{tag}: tokens differ at {diff}")
        print(f"[model] OPT-1.3B width, 2-layer float32 cluster: {tag}: "
              f"tokens equal")

    bare = wl()
    ContinuousBatchingEngine(model, serve_config(**kw)).run(bare)
    one = wl()
    serve_cluster(ReplicatedCluster.colocated(model, serve_config(**kw), 1,
                                              mode="sync"), one, "R=1 sync")
    check("R=1 sync against the bare engine", one, bare)
    two = wl()
    c = ReplicatedCluster.colocated(model, serve_config(**kw), 2,
                                    mode="sync")
    serve_cluster(c, two, "R=2 sync")
    for share in (0, 1):
        alone = [r for i, r in enumerate(wl()) if i % 2 == share]
        ContinuousBatchingEngine(model, serve_config(**kw)).run(alone)
        check(f"R=2 sync, replica {share}'s requests against a bare "
              f"engine", [r for i, r in enumerate(two) if i % 2 == share],
              alone)
    for mode, overlap in (("thread", False), ("sync", True),
                          ("thread", True)):
        reqs = wl()
        c = ReplicatedCluster.colocated(
            model, serve_config(**kw, overlap=overlap), 2, mode=mode)
        serve_cluster(c, reqs, f"R=2 {mode}")
        check(f"R=2 {mode}{', overlapped' if overlap else ''} against R=2 "
              f"sync", reqs, two)
    sampled = wl(SamplingParams(**SAMPLED))
    serve_cluster(ReplicatedCluster.colocated(model, serve_config(**kw), 2,
                                              mode="sync"), sampled,
                  "R=2 sync sampled")
    for kind, want, sp in (("greedy", two, None),
                           ("sampled", sampled, SamplingParams(**SAMPLED))):
        for respawn in (False, True):
            inj = FaultInjector([FaultSpec("kill", replica=1, step=6)])
            c = ReplicatedCluster.colocated(
                model, serve_config(**kw, overlap=True), 2, mode="thread",
                faults=inj, respawn=respawn)
            dead = c.replicas[1].engine
            reqs = wl(sp)
            m, _ = serve_cluster(c, reqs, f"R=2 kill {kind}", faults=1)
            rep = c.replicas[1]
            if not m.redriven or len(inj.fired) != 1:
                raise AssertionError(f"kill {kind}: {m.redriven} redriven, "
                                     f"{len(inj.fired)} fired")
            if respawn and not (rep.healthy and rep.engine is not dead
                                and rep.engine.decode_steps > 0
                                and rep.requests):
                raise AssertionError(f"kill {kind}: replica 1 did not serve "
                                     f"again after its respawn")
            after = (f" and respawned ({m.redriven} requests redriven, "
                     f"{len(rep.requests)} served after the respawn)"
                     if respawn else f" ({m.redriven} requests redriven)")
            check(f"R=2 threaded + overlap, {kind}, replica 1 killed at "
                  f"step 6{after} against the run with no fault", reqs, want)
    del model, c, dead
    release()


def serve_workload(sampling=None):
    from repro_torch.configs import get_config
    from repro_torch.serving.workload import sharegpt_like
    return sharegpt_like(32, get_config(MODEL).vocab_size, seed=0,
                         mean_in=161, mean_out=338, max_len=1024,
                         sampling=sampling)


def decode_lengths():
    """The decode shapes' context: the first 16 requests of the serve
    workload at half their output budget."""
    return [r.prompt_len + r.max_new_tokens // 2
            for r in serve_workload()[:16]]


def serve_decode_inputs(K=32, G=1, hd=64, seed=7):
    """The paged kernel's serving shape: the 16 decode lengths, blocks at
    permuted ids; OPT-1.3B's heads, or a family's (the families' serves
    draw the same lengths)."""
    import torch
    lengths = decode_lengths()
    nb = 4
    while nb * 16 < max(lengths):
        nb *= 2
    return paged_inputs(16, K, G, hd, 16, nb, torch.bfloat16, lengths,
                        seed=seed)


def gather_decode_inputs(B=16, K=32, G=1, hd=64, seed=8):
    """The contiguous kernel's serving shape: the first ``B`` decode
    lengths (16 in OPT-1.3B's gather serve, 8 in a family's) in a dense
    cache padded as the gather step pads it (``S_pad`` a multiple of four
    16-token blocks; the batch unpadded)."""
    import torch
    lengths = decode_lengths()[:B]
    S_pad = -(-max(lengths) // 64) * 64
    return decode_inputs(B, S_pad, K, G, hd, torch.bfloat16, lengths,
                         seed=seed)


def family_heads(name):
    """A family's attention heads ``(K, G, hd)`` (olmoe 16, 1, 128;
    zamba2 32, 1, 112; the VLM 8, 8, 128), or None where it has no
    attention (mamba2)."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if not attention_layers(cfg):
        return None
    return cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd


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


def serve_config(decode_mode="paged", **kw):
    from repro_torch.serving import EngineConfig
    return EngineConfig(**{**dict(
        max_batch=16, block_size=16, kv_pool_tokens=32768,
        max_model_len=2048, prefill_bucket=64, decode_mode=decode_mode),
        **kw})


def serve(model, reqs, decode_mode, card, tag=None, obs=None, **ecfg_kw):
    """Serve ``reqs`` to completion on a new engine (:func:`run_served`),
    with the ``Observability`` ``obs`` attached if given, then print the
    device memory the engine holds, which it also keeps as
    ``engine.graph_pool_bytes`` (the graph pools and step buffers).
    Returns the engine, its metrics and the launch counts."""
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    torch.cuda.synchronize()
    release()
    base = torch.cuda.memory_reserved()
    engine = ContinuousBatchingEngine(model,
                                      serve_config(decode_mode, **ecfg_kw))
    if obs is not None:
        obs.attach(engine)
    torch.cuda.synchronize()
    tag = f"[serve {tag or decode_mode}]"
    metrics, launches = run_served(engine, reqs, card, tag)
    release()
    held = torch.cuda.memory_reserved() - base
    kv = sum(t.numel() * t.element_size() for t in engine.pool.pool.values())
    engine.graph_pool_bytes = held - kv
    print(f"{tag} memory: the engine holds {held / 1e9:.3f} GB of device "
          f"memory reserved after the serve: the pool (K/V and any dense "
          f"state) {kv / 1e9:.3f} GB, "
          f"the graph pools and step buffers {(held - kv) / 1e9:.3f} GB")
    return engine, metrics, launches


def run_served(engine, reqs, card, tag, drive=None):
    """Serve ``reqs`` to completion on ``engine`` (``engine.run``, or
    ``drive(engine, reqs)``, which returns the metrics) with the launch
    counters set to 0 just before and read just after; every request must
    finish by length with in-range tokens, every logit must be finite, every
    block must be back in the pool (the prefix cache's aside), and each
    kernel must have launched exactly once a layer of each step of its
    kind: the decode kernel of the mode a decode step (the paged kernel
    ``K_pad + 1`` times a verify step), the flash kernel's prefix-masked
    entry a prefill or chunk over a prefix, its plain entry every other
    prefill or chunk. Returns the metrics and the launch counts."""
    import torch
    model = engine.model
    cfg = model.cfg
    with finite_logits(model) as finite:
        reset_launches()
        metrics = (drive or type(engine).run)(engine, reqs)
        torch.cuda.synchronize()
        launches = read_launches()
        if not bool(finite) or not bool(engine.steps.finite):
            raise AssertionError(f"{tag}: NaN or inf logits")
    for r in reqs:
        if r.finish_reason != "length" or r.generated != r.max_new_tokens:
            raise AssertionError(f"request {r.req_id}: {r.finish_reason}, "
                                 f"{r.generated}/{r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"request {r.req_id}: token out of range")
    mgr = engine.pool.manager
    cached = engine.prefix.cached_blocks if engine.prefix else 0
    if mgr.free_blocks + cached != mgr.num_blocks:
        raise AssertionError(f"{tag}: {mgr.free_blocks} free + {cached} "
                             f"cached of {mgr.num_blocks} blocks after the "
                             f"serve")
    steps = engine.decode_steps + engine.verify_iterations
    want = expected_launches([engine])
    if launches != want or not steps:
        raise AssertionError(f"{tag}: launch counts {launches} != {want}")
    spec = ""
    if engine.speculator is not None:
        spec = (f", {metrics.spec_steps} verify steps of "
                f"{engine.verify_iterations} decode iterations "
                f"({metrics.spec_row()})")
    print(f"{tag} on {card}: {len(reqs)} requests, "
          f"{metrics.output_tokens} output tokens, {engine.decode_steps} "
          f"decode steps{spec}, {engine.prefills} prefills, {engine.chunks} "
          f"prefill chunks ({engine.suffix_prefills} of them over a "
          f"prefix), {metrics.preemptions} preemptions; launches "
          f"{launches} = steps (or prefills and chunks) x "
          f"{attention_layers(cfg)} attention layers"
          + (f" (and {cross_layers(cfg)} cross-attention layers)"
             if cross_layers(cfg) else ""))
    print(f"{tag} {step_mode(engine)}, on {card}: "
          f"throughput {metrics.throughput:.1f} tok/s, output "
          f"{metrics.output_throughput:.1f} tok/s, wall {metrics.wall_s:.2f} s,"
          f" mean batch {metrics.avg_batch:.2f}, KV peak "
          f"{metrics.max_kv_fraction * 100:.1f}%")
    print(f"{tag} on {card}: TTFT {metrics.ttft.row()}; ITL "
          f"{metrics.itl.row()}; E2E {metrics.e2e.row(scale=1.0, unit='s')}")
    return metrics, launches


def graph_kinds(steps):
    """The graphs a ``StepFunctions`` captured, counted by kind: paged
    decode, gather decode, prefill without and over a prefix."""
    kinds = {}
    for key in steps.graphs:
        kind = key[0] if isinstance(key[0], str) else "paged"
        kinds[kind] = kinds.get(kind, 0) + 1
    return ", ".join(f"{n} {k}" for k, n in sorted(kinds.items()))


def step_mode(engine):
    """How an engine ran its steps: eager, or replayed from CUDA graphs
    (how many captured of each kind, in how long), and whether
    overlapped."""
    st = engine.steps
    mode = ("eager PyTorch steps, no CUDA graphs"
            if not st.graphs_on else
            f"CUDA graphs ({len(st.graphs)} captured: "
            f"{graph_kinds(st) or 'none'}, in {st.capture_s:.2f} s; "
            f"{st.replays} replays)")
    if engine.ecfg.overlap:
        mode += (f", overlapped ({engine.commit_waits} of "
                 f"{engine.decode_steps + engine.spec_steps} commits waited "
                 f"for the device)")
    return mode


def attention_layers(cfg):
    """The layers that run self-attention kernels (every layer of a dense
    or MoE model, a hybrid's shared-block occurrences, none of an SSM, a
    VLM's ``ATTN`` layers)."""
    from repro_torch.core.census import layer_counts
    return layer_counts(cfg)["kv"]


def cross_layers(cfg):
    """A VLM's cross-attention layers (none elsewhere): each runs the
    flash kernel's plain entry in a prefill and the contiguous decode
    kernel in every decode step, paged or gather."""
    from repro_torch.core.census import layer_counts
    return layer_counts(cfg)["cross"]


def expected_launches(engines):
    """The launches ``engines`` must have made since the counters were set
    to 0: each kernel once a layer of each step of its kind, summed (the
    decode kernel of the engine's mode a decode step, the paged kernel
    ``K_pad + 1`` times a verify step, the contiguous kernel once a
    cross layer a decode step, the flash entries as
    :func:`prefill_launches`)."""
    want = dict.fromkeys(launch_counters(), 0)
    for e in engines:
        decode = ("paged_decode_attention" if e.decode_mode == "paged"
                  else "decode_attention")
        steps = e.decode_steps + e.verify_iterations
        want[decode] += steps * attention_layers(e.model.cfg)
        want["decode_attention"] += steps * cross_layers(e.model.cfg)
        for k, v in prefill_launches(e).items():
            want[k] += v
    return want


def prefill_launches(engine):
    """The flash launches an engine's prefills must have made: its
    prefix-masked entry once a layer for each prefill or chunk over a
    prefix, its plain entry for each other (and once a cross layer for
    every prefill)."""
    cfg = engine.model.cfg
    n, x = attention_layers(cfg), cross_layers(cfg)
    return {"flash_attention": (engine.prefills + engine.chunks
                                - engine.suffix_prefills) * n
            + engine.prefills * x,
            "flash_prefix_attention": engine.suffix_prefills * n}


def phase_serve(model, card):
    """The paged serve of all 32 requests (CUDA graphs, sync), then the
    flash kernel its prefills launch (its decode profiles are
    :func:`phase_graph_modes`'). Returns the launch counts, the prefill
    buckets and the serve (its requests and metrics)."""
    reqs = serve_workload()
    engine, m, launches = serve(model, reqs, "paged", card)
    prefill_sizes = sorted({-(-r.prompt_len // 64) * 64 for r in reqs})
    del engine
    release()
    prefill_symbol(model, card)
    return launches, prefill_sizes, dict(reqs=reqs, metrics=m)


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
                    if is_device_work(e)
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


def prefix_workload(model, seed=0):
    """The shared-prefix serve's requests: 4 tenants x 8, prefix 256,
    suffix 32, 32 new tokens."""
    from repro_torch.serving.workload import shared_prefix_workload
    return shared_prefix_workload(4, 8, model.cfg.vocab_size, prefix_len=256,
                                  suffix_len=32, max_new_tokens=32, seed=seed)


def chunked_workload(model, seed=0):
    """The long/short serve's requests: 16 prompts of 24 and 8 of 768,
    one long after every 2 short, 24 and 6 new tokens."""
    from repro_torch.serving.workload import long_short_workload
    return long_short_workload(16, 8, model.cfg.vocab_size, short_len=24,
                               long_len=768, short_new=24, long_new=6,
                               every=2, seed=seed)


def phase_prefix_serve(model, card):
    """The shared-prefix serve (the reference benchmark's shape: 4
    tenants x 8, prefix 256, suffix 32, 32 new tokens, batch 8) with the
    prefix cache off and on: prefill tokens computed, hit rate, TTFT,
    throughput and token agreement; the cache must compute fewer prefill
    tokens. Returns the cache-on run's launch counts."""
    runs = {}
    for on in (False, True):
        reqs = prefix_workload(model)
        tag = f"prefix cache {'on' if on else 'off'}"
        engine, m, launches = serve(model, reqs, "paged", card, tag=tag,
                                    max_batch=8, prefix_cache=on)
        hit = f"hit rate {m.prefix.hit_rate * 100:.1f}% ({m.prefix.hits} " \
              f"of {m.prefix.lookups} admissions)" if on else "no cache"
        print(f"[serve {tag}] on {card}: {engine.prefill_tokens_computed} "
              f"prefill tokens computed, {hit}; TTFT p50 "
              f"{m.ttft.p50 * 1e3:.2f} ms p95 {m.ttft.p95 * 1e3:.2f} ms; "
              f"output {m.output_throughput:.1f} tok/s; ITL p50 "
              f"{m.itl.p50 * 1e3:.2f} ms p95 {m.itl.p95 * 1e3:.2f} ms")
        n_layers = model.cfg.n_layers
        if launches["flash_prefix_attention"] != (
                n_layers * engine.suffix_prefills if on else 0):
            raise AssertionError(f"[serve {tag}]: prefix entry launches "
                                 f"{launches} for {engine.suffix_prefills} "
                                 f"suffix prefills")
        print(f"[serve {tag}] prefix entry launches "
              f"{launches['flash_prefix_attention']} = "
              f"{engine.suffix_prefills} suffix prefills x {n_layers} "
              f"layers, plain entry {launches['flash_attention']}")
        runs[on] = (reqs, engine.prefill_tokens_computed, launches)
        del engine
        release()
    if runs[True][1] >= runs[False][1]:
        raise AssertionError(f"the prefix cache computed {runs[True][1]} "
                             f"prefill tokens, not fewer than {runs[False][1]}")
    print(f"[serve prefix cache] {model.cfg.dtype} token agreement, cache on "
          f"vs off: {agreement(runs[True][0], runs[False][0])}")
    eager = prefix_workload(model)
    engine, _, _ = serve(model, eager, "paged", card,
                         tag="prefix cache on, eager", max_batch=8,
                         prefix_cache=True, cuda_graphs=False)
    del engine
    release()
    diff = first_difference(runs[True][0], eager)
    if diff:
        raise AssertionError(f"prefix serve, every step eager: tokens differ "
                             f"from the graphs serve at {diff}")
    print(f"[serve prefix cache] every step eager equal to CUDA graphs on all "
          f"{sum(r.generated for r in eager)} tokens")
    return runs[True][2]


def phase_chunked_serve(model, card):
    """The long/short serve (the reference benchmark's shape: 16 short
    prompts of 24 and 8 long of 768, one long after every 2 short, 24 and
    6 new tokens, batch 4) chunked by 192 tokens and serially: ITL, the
    scheduler stall, throughput and token agreement. Returns the chunked
    run's launch counts."""
    runs = {}
    for chunk in (None, 192):
        reqs = chunked_workload(model)
        tag = f"chunked {chunk}" if chunk else "serial prefill"
        engine, m, launches = serve(model, reqs, "paged", card, tag=tag,
                                    max_batch=4, prefill_chunk_tokens=chunk)
        print(f"[serve {tag}] on {card}: ITL p50 {m.itl.p50 * 1e3:.2f} ms "
              f"p95 {m.itl.p95 * 1e3:.2f} ms p99 {m.itl.p99 * 1e3:.2f} ms; "
              f"stall (admission + prefill a step) mean "
              f"{m.stall_s_mean * 1e3:.2f} ms p95 {m.stall.p95 * 1e3:.2f} ms; "
              f"{m.prefill_tokens_per_step:.1f} prompt and "
              f"{m.decode_tokens_per_step:.2f} decode tokens a step; output "
              f"{m.output_throughput:.1f} tok/s, total "
              f"{m.throughput:.1f} tok/s; TTFT p95 {m.ttft.p95 * 1e3:.2f} ms")
        runs[chunk] = (reqs, launches)
        del engine
        release()
    print(f"[serve chunked] {model.cfg.dtype} token agreement, chunked vs "
          f"serial: {agreement(runs[192][0], runs[None][0])}")
    eager = chunked_workload(model)
    engine, _, _ = serve(model, eager, "paged", card,
                         tag="chunked 192, eager", max_batch=4,
                         prefill_chunk_tokens=192, cuda_graphs=False)
    del engine
    release()
    diff = first_difference(runs[192][0], eager)
    if diff:
        raise AssertionError(f"chunked serve, every step eager: tokens "
                             f"differ from the graphs serve at {diff}")
    print(f"[serve chunked] every step eager equal to CUDA graphs on all "
          f"{sum(r.generated for r in eager)} tokens")
    return runs[192][1]


def warm_engine(model, make, **ecfg_kw):
    """An engine whose buckets the serve ``make`` builds are captured: it
    serves ``make(seed=1)`` (the same shapes, other tokens) first, then
    its prefix cache is emptied and its counters reset, so that a serve
    of ``make(seed=0)`` starts as on a fresh engine, graphs aside."""
    from repro_torch.serving import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(model, serve_config(**ecfg_kw))
    engine.run(make(model, seed=1))
    rewarm(engine)
    return engine


def rewarm(engine):
    """Empty a warm engine's prefix cache and reset its counters."""
    import torch
    torch.cuda.synchronize()
    if engine.prefix is not None:
        engine.prefix.clear()
    engine.reset_stats()


def serve_profile(engine, make):
    """Device busy seconds of a serve of ``make(seed=0)`` on a warm
    engine under ``torch.profiler`` (device activity only), by kernel
    kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rewarm(engine)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.run(make(engine.model))
        torch.cuda.synchronize()
    by_kind = {}
    for e in prof.events():
        if is_device_work(e):
            kind = kernel_kind(e.name)
            by_kind[kind] = by_kind.get(kind, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e6
    if not by_kind:
        raise AssertionError("profiler recorded no device activity")
    return by_kind


def phase_serve_profiles(model, card):
    """The prefix serve (cache on) and the chunked serve (chunks of
    192), with CUDA graphs on a warm engine (:func:`warm_engine`) and
    with every step eager on a fresh one: first every serve timed, then the prefix cache
    off and on in turns (off, on, on, off, off, on) on one warm engine
    with graphs a side, its prefix cache emptied and its counters reset
    before each serve (:func:`rewarm`; TTFT, the stall, prefill tokens,
    the means of each side), and only then the first serves with graphs
    again under ``torch.profiler``: device busy time by kernel kind against the
    unprofiled serve's host wall, and the idle share (an eager serve's
    trace, some 150k kernels, takes tens of seconds to read: its device
    work is the same, and its idle share is that of the steps'
    profiles)."""
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    serves = {}
    for what, make, kw in (
            ("prefix serve, cache on", prefix_workload,
             dict(max_batch=8, prefix_cache=True)),
            ("chunked serve, chunks of 192", chunked_workload,
             dict(max_batch=4, prefill_chunk_tokens=192))):
        for way, extra in (("graphs", {}), ("eager", dict(cuda_graphs=False))):
            # an eager engine captures nothing: a warm-up serve would
            # only repeat the serve
            engine = warm_engine(model, make, **kw) if way == "graphs" \
                else ContinuousBatchingEngine(model,
                                              serve_config(**kw, **extra))
            m = engine.run(make(model))
            torch.cuda.synchronize()
            serves[f"{what}, {way}"] = (engine, make, m)
            print(f"[profile {what}, {way}] on {card}, {step_mode(engine)}"
                  f"{', warm' if way == 'graphs' else ''}: serve wall "
                  f"{m.wall_s * 1e3:.1f} ms; "
                  f"{engine.prefills} prefills and {engine.chunks} chunks "
                  f"({engine.suffix_prefills} over a prefix), "
                  f"{engine.decode_steps} decode steps; TTFT p50 "
                  f"{m.ttft.p50 * 1e3:.2f} p95 {m.ttft.p95 * 1e3:.2f} ms; "
                  f"stall mean {m.stall_s_mean * 1e3:.2f} p95 "
                  f"{m.stall.p95 * 1e3:.2f} ms; ITL p50 "
                  f"{m.itl.p50 * 1e3:.2f} p95 {m.itl.p95 * 1e3:.2f} ms; "
                  f"output {m.output_throughput:.1f} tok/s")
    ttft = {False: [], True: []}
    warm = {on: warm_engine(model, prefix_workload, max_batch=8,
                            prefix_cache=on) for on in (False, True)}
    for on in (False, True, True, False, False, True):
        engine = warm[on]
        rewarm(engine)
        m = engine.run(prefix_workload(model))
        torch.cuda.synchronize()
        ttft[on].append((m.ttft.p50, m.ttft.p95, m.stall.p95))
        print(f"[prefix ttft] on {card}: cache {'on' if on else 'off'}, warm "
              f"graphs: TTFT p50 {m.ttft.p50 * 1e3:.2f} p95 "
              f"{m.ttft.p95 * 1e3:.2f} ms; stall p95 "
              f"{m.stall.p95 * 1e3:.2f} ms; {engine.prefill_tokens_computed} "
              f"prefill tokens computed; wall {m.wall_s * 1e3:.1f} ms; output "
              f"{m.output_throughput:.1f} tok/s")
    del warm, engine
    release()
    mean = {on: [statistics.mean(x[i] for x in ttft[on]) * 1e3
                 for i in range(3)] for on in ttft}
    print(f"[prefix ttft] on {card}: means of 3 serves a side, cache off / "
          f"on: TTFT p50 {mean[False][0]:.2f} / {mean[True][0]:.2f} ms, p95 "
          f"{mean[False][1]:.2f} / {mean[True][1]:.2f} ms; stall p95 "
          f"{mean[False][2]:.2f} / {mean[True][2]:.2f} ms")
    for tag, (engine, make, m) in serves.items():
        if not engine.steps.graphs_on:
            continue
        by_kind = serve_profile(engine, make)
        busy = sum(by_kind.values())
        parts = ", ".join(f"{k} {v * 1e3:.1f} ms ({v / busy * 100:.1f}%)"
                          for k, v in sorted(by_kind.items(),
                                             key=lambda kv: -kv[1]))
        print(f"[profile {tag}] on {card}: device busy {busy * 1e3:.1f} ms "
              f"(torch.profiler, the same serve again) against the "
              f"unprofiled serve's wall {m.wall_s * 1e3:.1f} ms: idle "
              f"{(1 - busy / m.wall_s) * 100:.1f}%; device time: {parts}")
    del serves, engine
    release()


# (what, prompt tokens this call, prompt position it starts at): the
# serves' prefill shapes
PREFILL_SHAPES = (("a serial prefill of the paged serve (prompt 161)", 161, 0),
                  ("a serial prefill of 1000 tokens", 1000, 0),
                  ("the prefix serve's suffix", 32, 256),
                  ("the chunked serve's middle chunk", 192, 384))


def prefill_pool(engine, seed=3):
    """Random contents in an engine's pool and one request (id 0) whose
    1040-token table covers every prefill shape; returns its prompt."""
    import torch
    gen = torch.Generator("cuda").manual_seed(seed)
    for leaf in engine.pool.pool.values():
        leaf.normal_(generator=gen)
    engine.pool.manager.allocate(0, 1040)
    return np.random.default_rng(seed).integers(
        0, engine.model.cfg.vocab_size, 1040)


def prefill_call(engine, prompt, n, start):
    """One prefill step of ``n`` prompt tokens from ``start`` on request
    0, as the engine calls it; returns a closure and the bucket."""
    from repro_torch.serving.steps import pow2_bucket
    nb = -(-start // engine.ecfg.block_size)
    toks = prompt[start:start + n].tolist()
    key = engine.steps.prefill_key(n, start, pow2_bucket(nb))
    return (lambda: engine.steps.prefill(0, toks, start, nb,
                                         pow2_bucket(nb))), key


def phase_prefill_steps(model, card, runs=20):
    """One prefill at each of the serves' shapes, through the engine's
    step (``steps.prefill``: staging, one upload, then the bucket's
    graph replayed, or every kernel launched eagerly): the host wall of
    one call until its logits are on the device (call, then synchronize;
    median of ``runs``), its device busy time (``torch.profiler`` over
    5 calls, behind two kernels of a few microseconds that open the
    window), the idle share. With graphs, the flash launches counted
    over the profiled calls must equal the trace's flash kernels, 5 x
    layers. Returns the rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ContinuousBatchingEngine
    rows = {}
    for graphs in (True, False):
        engine = ContinuousBatchingEngine(
            model, serve_config(cuda_graphs=graphs))
        prompt = prefill_pool(engine)
        for what, n, start in PREFILL_SHAPES:
            call, key = prefill_call(engine, prompt, n, start)
            call()
            call()
            torch.cuda.synchronize()
            walls = []
            for _ in range(runs):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            before = read_launches()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                # a kernel of a few microseconds opens the window: a
                # trace may miss the first kernel after it starts
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
            ops = [e for e in prof.events()
                   if is_device_work(e)]
            busy = sum(e.time_range.end - e.time_range.start
                       for e in ops) / 1e3 / 5
            after = read_launches()
            counted = sum(after[k] - before[k] for k in (
                "flash_attention", "flash_prefix_attention"))
            traced = sum("flash" in e.name for e in ops)
            want = 5 * model.cfg.n_layers
            if not counted == traced == want:
                raise AssertionError(f"prefill {key}: flash launches counted "
                                     f"{counted}, traced {traced}, != {want}")
            wall = statistics.median(walls)
            way = "replayed" if graphs else "eager"
            rows[(what, way)] = dict(key=key, wall_ms=wall, busy_ms=busy,
                                     idle=1 - busy / wall,
                                     ops=len(ops) / 5)
            print(f"[prefill] on {card}: {what}, bucket {key}, {way}: host "
                  f"wall {wall:.3f} ms a call (median of {runs}), device "
                  f"busy {busy:.3f} ms, idle {(1 - busy / wall) * 100:.1f}%, "
                  f"{len(ops) / 5:.0f} device ops a call; flash launches "
                  f"counted {counted}, traced {traced} over 5 calls")
        del engine
        release()
    return rows


SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=0)


def phase_sampled_serve(model, card, greedy):
    """The paged serve's 32 requests sampled (temperature 0.8, top-k 50,
    top-p 0.95, seed = request id) with CUDA graphs, sync, and their
    agreement with ``greedy`` (the same requests served greedily); the
    serves of :func:`phase_graph_modes` must give the same tokens.
    Returns the serve (its requests and metrics) and the launch counts."""
    from repro_torch.serving.workload import SamplingParams
    reqs = serve_workload(SamplingParams(**SAMPLED))
    engine, m, launches = serve(model, reqs, "paged", card, tag="sampled")
    del engine
    release()
    print(f"[serve sampled] sampled vs the greedy paged serve: "
          f"{agreement(reqs, greedy)}")
    return dict(reqs=reqs, metrics=m), launches


WAYS = {"eager, sync": dict(cuda_graphs=False),
        "graphs, sync": {},
        "graphs, overlap": dict(overlap=True)}


def first_difference(a_reqs, b_reqs):
    """The first request and output position where two serves differ."""
    for a, b in zip(a_reqs, b_reqs):
        for i, (x, y) in enumerate(zip(a.output_tokens, b.output_tokens)):
            if x != y:
                return f"request {a.req_id}, output token {i}: {x} vs {y}"
        if len(a.output_tokens) != len(b.output_tokens):
            return f"request {a.req_id}: lengths differ"
    return None


EAGER_CAP = 48    # new tokens a request in phase_graph_modes' eager serves


def cut_workload(reqs):
    """``reqs`` afresh, each cut to ``EAGER_CAP`` new tokens (its sampling
    kept)."""
    from repro_torch.serving.workload import Request
    return [Request(r.req_id, r.prompt, sampling=dataclasses.replace(
        r.sampling, max_new_tokens=min(r.sampling.max_new_tokens,
                                       EAGER_CAP)))
        for r in reqs]


def cut_eager_serve(model, card, reqs, mode, tag):
    """``reqs`` cut to ``EAGER_CAP`` new tokens, served with CUDA graphs,
    sync, then with every step eager; the eager serve's tokens must equal
    the graphs serve's. Returns the eager serve's requests and metrics."""
    want = cut_workload(reqs)
    engine, _, _ = serve(model, want, mode, card, tag=f"{tag}, graphs, cut")
    del engine
    release()
    got = cut_workload(reqs)
    engine, m, _ = serve(model, got, mode, card, tag=f"{tag}, eager, sync",
                         **WAYS["eager, sync"])
    del engine
    release()
    diff = first_difference(want, got)
    if diff:
        raise AssertionError(f"{tag}, eager: tokens differ from a graphs "
                             f"serve of the same requests at {diff}")
    print(f"[graphs] {tag}, eager, sync: tokens equal to a graphs-sync "
          f"serve of the {len(want)} requests cut to {EAGER_CAP} new tokens "
          f"on all {sum(r.generated for r in got)} tokens")
    return got, m


def phase_graph_modes(model, card, runs):
    """The paged serve and the sampled serve three ways: eager decode
    steps, CUDA graphs, CUDA graphs with overlap. The graphs way is
    ``runs[kind]``, the earlier phases' graphs-sync serve (its requests
    and metrics), not served again; the others are served afresh here,
    and the overlapped serve's tokens must equal its. The eager way, whose
    steps are host-bound, serves the same 32 requests cut to
    ``EAGER_CAP`` new tokens (at batch 16, so the last 16 take the blocks
    of finished ones), and its tokens must equal a graphs-sync serve of
    that cut workload. Each way's serve metrics and profile window (16
    uncut requests at batch 16) are printed, then a table of them.
    Returns each ``(kind, way)``'s requests, metrics and profile."""
    from repro_torch.serving.workload import SamplingParams
    table = []
    served = {}
    for kind, sampling in (("greedy", None), ("sampled", SAMPLED)):
        sp = SamplingParams(**sampling) if sampling else None
        for way, kw in WAYS.items():
            cut = way == "eager, sync"
            if cut:
                reqs, m = cut_eager_serve(model, card, serve_workload(sp),
                                          "paged", kind)
            elif way == "graphs, sync":
                reqs, m = runs[kind]["reqs"], runs[kind]["metrics"]
            else:
                reqs = serve_workload(sp)
                engine, m, _ = serve(model, reqs, "paged", card,
                                     tag=f"{kind}, {way}", **kw)
                del engine
                release()
                diff = first_difference(runs[kind]["reqs"], reqs)
                if diff:
                    raise AssertionError(f"{kind} serve, {way}: tokens differ"
                                         f" from the graphs-sync serve at "
                                         f"{diff}")
            prof = profile_decode(model, "paged", card, sampling=sp,
                                  tag=f"paged, {kind}, {way}", **kw)
            served[kind, way] = dict(reqs=reqs, metrics=m, prof=prof)
            table.append(f"{kind}, {way}" + (f" (cut to {EAGER_CAP})"
                                              if cut else "") + ": output "
                         f"{m.output_throughput:.1f} tok/s, ITL p50 "
                         f"{m.itl.p50 * 1e3:.2f} p95 {m.itl.p95 * 1e3:.2f} "
                         f"ms, TTFT p50 {m.ttft.p50 * 1e3:.1f} p95 "
                         f"{m.ttft.p95 * 1e3:.1f} ms; steady step busy "
                         f"{prof['busy']:.3f} ms, wall {prof['wall']:.3f} "
                         f"ms, idle {prof['idle'] * 100:.1f}%")
        print(f"[graphs] {kind} paged serve: graphs with overlap equal to "
              f"the earlier graphs serve on all "
              f"{sum(r.generated for r in runs[kind]['reqs'])} tokens, eager "
              f"equal to graphs on the cut serve")
    for row in table:
        print(f"[graphs] on {card}: {row}")
    return served


SPEC_SERVE = dict(max_batch=4, speculate=True, spec_k=8)
SPEC_WAYS = {"off, graphs": dict(speculate=False),
             "on, graphs": {},
             "on, graphs + overlap": dict(overlap=True)}


def phase_spec_serve(model, card):
    """The speculative serve: 16 repetitive requests (prompt 96, 128 new
    tokens, the shape of ``benchmarks/speculative.py``), batch 4,
    ``spec_k`` 8, greedy and sampled, speculation off (graphs), on with
    graphs (cold, then warm: the same engine serves the workload at
    another seed), on with graphs and overlap (an eager verify step is
    held against the replayed one in phase 5, and eager speculation runs
    in phase 3).
    Each serve checks launches, finite logits and the pool
    (:func:`run_served`); a profile window of verify steps follows the
    warm serve; token agreement with speculation off is reported. Returns
    the greedy graphs serve's launch counts."""
    from repro_torch.serving.workload import SamplingParams
    vocab = model.cfg.vocab_size
    table, launches = [], None
    for kind, sampling in (("greedy", None), ("sampled", SAMPLED)):
        sp = SamplingParams(**sampling) if sampling else None
        runs = {}
        for way, kw in SPEC_WAYS.items():
            reqs = spec_workload(vocab, sampling=sp)
            tag = f"spec {kind}, {way}"
            engine, m, got = serve(model, reqs, "paged", card, tag=tag,
                                   **{**SPEC_SERVE, **kw})
            runs[way] = reqs
            table.append(spec_table_row(tag, engine, m))
            if way == "on, graphs":
                launches = launches or got
                rewarm(engine)
                wtag = f"spec {kind}, on, graphs, warm"
                wm, _ = run_served(engine, spec_workload(vocab, seed=1,
                                                         sampling=sp),
                                   card, f"[serve {wtag}]")
                table.append(spec_table_row(wtag, engine, wm))
                spec_profile(engine, sp, card, kind)
            del engine
            release()
        for way, reqs in runs.items():
            if way != "off, graphs":
                print(f"[spec] {kind}, bf16, {way} against off, graphs: "
                      f"{agreement(runs['off, graphs'], reqs)}")
    for row in table:
        print(f"[spec] on {card}: {row}")
    return launches


def spec_table_row(tag, engine, m):
    """One line of the speculative serves' table."""
    st = engine.steps
    verify = sum(1 for k in st.graphs if k[0] == "verify")
    pool = getattr(engine, "graph_pool_bytes", None)
    return (f"{tag}: output {m.output_throughput:.1f} tok/s, ITL p50 "
            f"{m.itl.p50 * 1e3:.2f} p95 {m.itl.p95 * 1e3:.2f} ms, "
            f"{m.spec_steps} verify steps, drafted {m.spec_drafted}, "
            f"accepted {m.spec_accepted} "
            f"({m.spec_acceptance_rate * 100:.1f}%), "
            f"{m.decode_tokens_per_step:.2f} tokens a step; {verify} verify "
            f"graphs of {len(st.graphs)}, capture {st.capture_s:.2f} s, "
            + (f"graph pools and step buffers {pool / 1e9:.3f} GB"
               if pool is not None else "graph pools as the cold serve's"))


def spec_window(engine, steps, wrap=contextlib.nullcontext):
    """``steps`` engine steps ending in a sync inside ``wrap()``, done again
    (up to three times) while a window met a new bucket. Returns the
    context, the host wall ms a step, the counters before the last window
    (plain steps, verify steps, verify iterations, committed tokens, paged
    launches) and whether it met no new bucket."""
    import torch
    for _ in range(3):
        n = len(engine.steps.graphs)
        c0 = (engine.decode_steps, engine.spec_steps,
              engine.verify_iterations, sum(engine.decode_token_samples),
              read_launches()["paged_decode_attention"])
        with wrap() as ctx:
            # a kernel of a few microseconds opens the window: a trace may
            # miss the first kernel after it starts (as phase_prefill_steps)
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.step(0.0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
        if len(engine.steps.graphs) == n:
            return ctx, ms, c0, True
    return ctx, ms, c0, False


def spec_profile(engine, sp, card, kind, steps=10):
    """``torch.profiler`` over ``steps`` engine steps of 4 repetitive
    requests (150 new tokens, so that their tables stay in the buckets the
    serves captured) on a warm graphs engine after 8 warm steps: device
    busy against the host wall of an unprofiled window, the verify steps
    and decode iterations in it, and the paged kernel's replayed launches
    against the counters' (plain steps + verify iterations) x layers and
    the trace's count of its split kernel (a trace short of it, and only
    short, is taken again, up to three windows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rewarm(engine)
    for r in spec_workload(engine.model.cfg.vocab_size, n=4,
                           max_new_tokens=150, seed=2, sampling=sp):
        engine.add_request(r)
    for _ in range(8):
        engine.step(0.0)
    torch.cuda.synchronize()
    _, plain_wall_ms, c0, _ = spec_window(engine, steps)     # unprofiled
    # a verify step's work scales with its iterations: the two windows
    # are compared a decode iteration (a plain step is one)
    plain_iters = (engine.decode_steps - c0[0]) + (engine.verify_iterations
                                                   - c0[2])
    wall_iter = plain_wall_ms * steps / max(plain_iters, 1)
    tag = f"[profile spec {kind}]"
    # the counter must equal the steps' launches in every window; a trace
    # may hold fewer kernel records than launches (one short of 120 and
    # one short of 1824 have been seen on the card), never more, so a
    # short trace is measured again
    for attempt in range(3):
        prof, _, c0, steady = spec_window(engine, steps, lambda: profile(
            activities=[ProfilerActivity.CUDA]))
        plain_steps, verify_steps, iters, toks, counted = (
            a - b for a, b in zip((engine.decode_steps, engine.spec_steps,
                                   engine.verify_iterations,
                                   sum(engine.decode_token_samples),
                                   read_launches()["paged_decode_attention"]),
                                  c0))
        kernels = [e for e in prof.events()
                   if is_device_work(e)]
        if not kernels:
            raise AssertionError("profiler recorded no device activity")
        traced = sum("paged_decode_split_kernel" in e.name for e in kernels)
        want = (plain_steps + iters) * engine.model.cfg.n_layers
        print(f"{tag} paged_decode_attention over the profiled steps: "
              f"launch counter +{counted}, trace {traced} split kernels "
              f"((plain steps + verify iterations) x layers = {want})")
        if counted != want or traced > want:
            raise AssertionError(f"{tag}: replayed launches {counted} and "
                                 f"traced kernels {traced} != {want}")
        if traced == want:
            break
    else:
        raise AssertionError(f"{tag}: three traces short of {want} split "
                             f"kernels")
    busy = sum(e.time_range.end - e.time_range.start
               for e in kernels) / 1e3 / steps
    busy_iter = busy * steps / max(plain_steps + iters, 1)
    print(f"{tag} on {card}, {step_mode(engine)}: {steps} steps at batch "
          f"{len(engine.running)}: {verify_steps} verify steps of {iters} "
          f"decode iterations and {plain_steps} plain steps, {toks} tokens "
          f"committed; torch.profiler: device busy {busy:.3f} ms/step, "
          f"{busy_iter:.3f} ms a decode iteration; an unprofiled window of "
          f"{plain_iters} iterations: host wall {plain_wall_ms:.3f} ms/step, "
          f"{wall_iter:.3f} ms a decode iteration, so the device idles "
          f"{(1 - busy_iter / wall_iter) * 100:.1f}%"
          + ("" if steady else "; a window met a new bucket"))
    for r in list(engine.running) + list(engine.waiting):
        engine.abort(r.req_id)


# ------------------------------------------------------- observability ----
def obs_roofline(ob, tag, card):
    """Print each step variant's live roofline summary (steps, mean
    bandwidth and compute shares of the card's peaks, arithmetic
    intensity, device time, the verdicts); fail if any sample's share of
    either peak is above 1 (a census that undercounts). Returns the
    decode summary."""
    from repro_torch.core.census import VARIANTS
    hw = ob.roofline.hw
    for variant in VARIANTS:
        samples = ob.roofline.variant_samples(variant)
        if not samples:
            continue
        s = ob.roofline.summary(variant)
        verdicts = {}
        for x in samples:
            verdicts[x.bound(hw)] = verdicts.get(x.bound(hw), 0) + 1
        print(f"[obs] {tag} on {card}: {variant}: {s['steps']} steps, "
              f"bw_util mean {s['bw_util_mean'] * 100:.2f}%, mfu mean "
              f"{s['mfu_mean'] * 100:.3f}%, ai mean {s['ai_mean']:.2f} "
              f"flop/B, device_s mean {s['device_s_mean'] * 1e3:.3f} ms, "
              f"bound {verdicts}")
    over = [x for x in ob.roofline.samples
            if x.bw_util(hw) > 1.0 or x.compute_util(hw) > 1.0]
    if over:
        x = over[0]
        raise AssertionError(
            f"{tag}: {len(over)} samples above a peak, e.g. {x.variant} "
            f"step {x.step}: {x.bytes:.4g} B and {x.flops:.4g} FLOP in "
            f"{x.device_s * 1e3:.3f} ms (bw {x.bw_util(hw):.3f}, compute "
            f"{x.compute_util(hw):.3f}): the census undercounts")
    rep = ob.roofline.report("decode", arch=MODEL)
    if rep is not None:
        print(f"[obs] {tag} roofline_report('decode') of the last decode "
              f"step (arch | shape | mesh | compute ms | memory ms | "
              f"collective ms | dominant | useful | GB): {rep.row()}")
    return ob.roofline.summary("decode")


def obs_memory_gap(ob, tag, card):
    """Print the memory-gap report; every audited step's partition must
    be exact."""
    aud = ob.auditor
    if aud.audits != len(aud.steps) or not aud.audits:
        raise AssertionError(f"{tag}: {aud.audits} audits, "
                             f"{len(aud.steps)} kept")
    for wb in aud.steps:
        if wb.physical_bytes != wb.pool_bytes:
            raise AssertionError(f"{tag}: step {wb.step}: partition "
                                 f"{wb.physical_bytes} != {wb.pool_bytes}")
    rep = aud.report()
    mean = rep["mean_bytes"]
    print(f"[obs] {tag} memory gap on {card}: {aud.audits} steps, the "
          f"partition exact on each; pool {rep['pool_bytes'] / 1e9:.3f} GB; "
          f"means: used {mean['used'] / 1e9:.4f} GB, block-pad "
          f"{mean['block_pad'] / 1e9:.4f} GB, prefix-held "
          f"{mean['prefix_held'] / 1e9:.4f} GB, free {mean['free'] / 1e9:.4f}"
          f" GB; overlays: reserved-unused {mean['reserved_unused'] / 1e9:.4f}"
          f" GB, bucket-pad {mean['bucket_pad'] / 1e9:.4f} GB; peak used "
          f"{rep['peak_used_bytes'] / 1e9:.4f} GB at step "
          f"{rep['peak_used_step']} ({rep['peak_used_tokens_per_req']:.1f} "
          f"tokens a request); gap {rep['gap_fraction_mean'] * 100:.1f}% "
          f"of the pool, worst term {rep['worst_term']}")


def obs_steady(model, card, prof):
    """The event-timed device time of 10 steady decode steps at batch 16
    (profile_decode's setup: the serve's first 16 requests, 21 warm
    steps, an untimed window, then the window read), held between 0.95 x
    the torch.profiler busy time of phase 4's graphs-sync window and the
    host wall time of a step there. Returns (device ms, wall ms)."""
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.obs import Observability
    engine = ContinuousBatchingEngine(model, serve_config("paged"))
    obs = Observability()
    ob = obs.attach(engine)
    for r in serve_workload()[:16]:
        engine.add_request(r)
    for _ in range(21):
        engine.step(0.0)
    torch.cuda.synchronize()
    steady_steps(engine, 10)
    _, wall_ms, _ = steady_steps(engine, 10)
    samples = ob.roofline.variant_samples("decode")[-10:]
    if len(samples) != 10 or any(s.batch != 16 for s in samples):
        raise AssertionError(f"steady window: {[s.batch for s in samples]}")
    dev_ms = statistics.mean(s.device_s for s in samples) * 1e3
    hw = ob.roofline.hw
    print(f"[obs] steady decode on {card}: 10 steps at batch 16 "
          f"({sum(engine._pos.values())} context tokens at the end): "
          f"CUDA-event device time {dev_ms:.3f} ms/step (min "
          f"{min(s.device_s for s in samples) * 1e3:.3f}, max "
          f"{max(s.device_s for s in samples) * 1e3:.3f}); phase 4's "
          f"torch.profiler busy {prof['busy']:.3f} ms, host wall "
          f"{prof['wall']:.3f} ms a step (observer off); this window's host "
          f"wall {wall_ms:.3f} ms with the observer on; bw_util "
          f"{statistics.mean(s.bw_util(hw) for s in samples) * 100:.2f}%, "
          f"mfu {statistics.mean(s.compute_util(hw) for s in samples) * 100:.3f}"
          f"%, {samples[-1].bytes / 1e9:.4f} GB and "
          f"{samples[-1].flops / 1e9:.2f} GFLOP a step")
    if not 0.95 * prof["busy"] <= dev_ms <= prof["wall"]:
        raise AssertionError(
            f"event-timed device time {dev_ms:.3f} ms outside [0.95 x busy "
            f"{prof['busy']:.3f}, wall {prof['wall']:.3f}]")
    del engine, obs, ob
    release()
    return dev_ms, wall_ms


def obs_deadlines(model, card):
    """A deadline and shedding serve (graphs, overlap, an observer): 48
    requests of the ShareGPT prompts submitted 4 a step through
    ``try_add_request`` at the serving clock, with ``max_waiting=8``;
    every fourth carries a 0.4 s end-to-end deadline and 400 new tokens
    (admitted first, it expires mid-decode), every fourth after it a
    50 ms TTFT deadline and 32 tokens, the rest 48 tokens. Every request
    must finish (length or stop), be shed or expire; the counters must add
    up; an expired request keeps its partial output; every block must be
    back."""
    import torch
    from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                     SamplingParams)
    from repro_torch.serving.metrics import collect_from_engine
    from repro_torch.serving.obs import Observability
    from repro_torch.serving.obs.windows import STREAM_DEADLINE
    engine = ContinuousBatchingEngine(
        model, serve_config(overlap=True, max_waiting=8))
    obs = Observability(windows=True)
    obs.attach(engine)
    prompts = [r.prompt for r in serve_workload()]
    kinds = (dict(deadline_s=0.4, max_new_tokens=400),
             dict(ttft_deadline_s=0.05, max_new_tokens=32),
             dict(max_new_tokens=48), dict(max_new_tokens=48))
    reqs, verdicts = [], {}
    t0 = time.perf_counter()
    while len(reqs) < 48 or engine.busy:
        now = time.perf_counter() - t0
        for _ in range(4 if len(reqs) < 48 else 0):
            i = len(reqs)
            req = Request(i, prompts[i % 32], arrival_s=now,
                          sampling=SamplingParams(**kinds[i % 4]))
            reqs.append(req)
            reason = engine.try_add_request(req, now)
            verdicts[reason] = verdicts.get(reason, 0) + 1
        engine.step(now)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finish = {}
    for r in reqs:
        finish[r.finish_reason] = finish.get(r.finish_reason, 0) + 1
    m = collect_from_engine(engine, reqs, wall)
    expired = [r for r in reqs if r.finish_reason == "deadline"]
    partial = [r for r in expired if 0 < r.generated < r.max_new_tokens]
    misses = sum(v for _, v in obs.windows.samples(STREAM_DEADLINE))
    mgr = engine.pool.manager
    print(f"[obs] deadlines and shedding on {card}: {len(reqs)} requests in "
          f"{wall:.2f} s; try_add_request verdicts {verdicts}; finish "
          f"{finish}; shed {engine.shed} {engine.shed_reasons}, deadline "
          f"expired {engine.deadline_expired} ({len(partial)} mid-decode, "
          f"partial outputs of {[r.generated for r in partial]} tokens kept)"
          f"; windows deadline misses {misses:.0f}; output "
          f"{m.output_throughput:.1f} tok/s")
    if set(finish) - {"length", "stop", "shed", "deadline"} \
            or any(r.t_done is None for r in reqs):
        raise AssertionError(f"unexpected finishes {finish}")
    if not (engine.shed == finish.get("shed", 0) == m.shed
            == sum(engine.shed_reasons.values())
            == len(reqs) - verdicts.get(None, 0) > 0):
        raise AssertionError(f"shed counters disagree: {engine.shed}, "
                             f"{finish}, {engine.shed_reasons}, {verdicts}")
    if not (engine.deadline_expired == finish.get("deadline", 0)
            == m.deadline_expired == misses > 0):
        raise AssertionError(f"deadline counters disagree: "
                             f"{engine.deadline_expired}, {finish}, {misses}")
    if not partial or any(len(r.output_tokens) != r.generated
                          for r in expired):
        raise AssertionError("no expired request kept a partial output")
    if sum(finish.values()) != len(reqs) or m.n_completed != len(reqs) \
            or mgr.free_blocks != mgr.num_blocks:
        raise AssertionError(f"{mgr.free_blocks} of {mgr.num_blocks} "
                             f"blocks free at the end")
    del engine, obs
    release()


def phase_obs(model, card, modes):
    """Observability on the card: the paged serve's 32 requests with
    ``Observability(audit_memory=True, windows=True)`` attached, graphs
    and overlap, then graphs and sync; each serve's tokens equal to
    phase 4's with the observer off, each variant's live roofline
    printed (no share above 1), the memory-gap partition exact on every
    step, the trace written under ``chiprun_out/`` and valid. Then the
    event-timed device time of 10 steady steps against phase 4's
    profiler window, the observer's cost under overlap on a warm engine
    (off, on, on, off, off, on), and the deadline and shedding serve."""
    import torch
    from repro_torch.serving.obs import Observability, validate_chrome_trace
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    engines = {}
    for way, kw in (("graphs, overlap", dict(overlap=True)),
                    ("graphs, sync", {})):
        obs = Observability(audit_memory=True, windows=True)
        reqs = serve_workload()
        engine, m, _ = serve(model, reqs, "paged", card,
                             tag=f"obs on, {way}", obs=obs, **kw)
        off = modes["greedy", way]
        diff = first_difference(off["reqs"], reqs)
        if diff:
            raise AssertionError(f"{way}: observer on differs from off at "
                                 f"{diff}")
        ob = obs.observer(0)
        tag = f"obs on, {way}"
        print(f"[obs] {tag}: tokens equal to the observer-off serve on all "
              f"{sum(r.generated for r in reqs)} tokens; hardware "
              f"{obs.hw.name} ({obs.hw.device_name}, {obs.hw.power_w:.0f} W "
              f"entry), census of {obs.census.compiles} buckets, "
              f"{ob.captures} first uses (warm-up + capture), errors "
              f"{len(obs.census.errors)}")
        obs_roofline(ob, tag, card)
        obs_memory_gap(ob, tag, card)
        ph = ob.phase_summary()
        print(f"[obs] {tag} phases on {card}: {ph['steps']} steps, means: "
              f"schedule {ph['schedule_s'] * 1e3:.3f} ms, dispatch "
              f"{ph['dispatch_s'] * 1e3:.3f} ms, device "
              f"{ph['device_s'] * 1e3:.3f} ms, host {ph['host_s'] * 1e3:.3f}"
              f" ms, gap {ph['gap_s'] * 1e3:.3f} ms, dispatch ahead "
              f"{ph['dispatch_ahead_s'] * 1e3:.3f} ms, total "
              f"{ph['total_s'] * 1e3:.3f} ms; host-gap fraction "
              f"{ph['host_gap_fraction'] * 100:.1f}%; output "
              f"{m.output_throughput:.1f} tok/s (observer off, phase 4: "
              f"{off['metrics'].output_throughput:.1f})")
        if way == "graphs, overlap":
            path = str(out_dir / "obs_trace.json")
            obs.export_chrome_trace(path)
            errs = validate_chrome_trace(path)
            if errs:
                raise AssertionError(f"trace: {errs[:5]}")
            print(f"[obs] trace: {obs.trace.n_events} events "
                  f"({obs.trace.dropped} dropped) in {path}, "
                  f"validate_chrome_trace: []")
        engines[way] = (engine, obs, ob)
    dev_ms, _ = obs_steady(model, card, modes["greedy", "graphs, sync"]
                           ["prof"])
    # the observer's cost: the warm overlapped engine, off / on in turns
    engine, obs, ob = engines["graphs, overlap"]
    del engines
    want = modes["greedy", "graphs, overlap"]["reqs"]
    tps = {False: [], True: []}
    for on in (False, True, True, False, False, True):
        engine.obs = ob if on else None
        engine.reset_stats()
        reqs = serve_workload()
        m = engine.run(reqs)
        torch.cuda.synchronize()
        if first_difference(want, reqs):
            raise AssertionError("a warm serve's tokens differ")
        tps[on].append(m.output_throughput)
    off, on = statistics.median(tps[False]), statistics.median(tps[True])
    print(f"[obs] observer cost on {card}, warm graphs + overlap, the "
          f"32-request serve off, on, on, off, off, on: output tok/s off "
          f"{tps[False]}, on {tps[True]}; medians {off:.1f} / {on:.1f} "
          f"({(on / off - 1) * 100:+.2f}%)")
    del engine, obs, ob
    release()
    obs_deadlines(model, card)
    return dev_ms


CLUSTER_BUDGET = 32768       # KV tokens split across a cluster's replicas
KILL_AFTER = 150             # a fault run kills replica 1 this many steps in
FAULT_REQUESTS = 16          # a fault run serves the workload's first 16
CLUSTER_WAYS = (("MAX", 1, 32), ("R=2", 2, 16), ("R=4", 4, 8))


def cluster_workload(seed=0, n=64):
    """The ``[cluster]`` phase's requests: the paged serve's generator
    (ShareGPT lengths, mean 161 in / 338 out, capped at 1024), all at
    t=0."""
    from repro_torch.configs import get_config
    from repro_torch.serving.workload import sharegpt_like
    return sharegpt_like(n, get_config(MODEL).vocab_size, seed=seed,
                         mean_in=161, mean_out=338, max_len=1024)


def cluster_config(n, batch):
    """A replica of an ``n``-way split of the KV budget: graphs and
    overlap, ``max_batch=batch``."""
    return serve_config(max_batch=batch, overlap=True,
                        kv_pool_tokens=CLUSTER_BUDGET // n // 16 * 16)


def graph_pool_bytes(steps):
    """Device bytes held by one engine's two graph memory pools, from the
    caching allocator's snapshot (None where it does not say)."""
    import torch
    if not steps.graphs_on:
        return 0
    ids = {tuple(steps._decode_pool), tuple(steps._prefill_pool)}
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) in ids)


def replica_memory(engine):
    """(KV pool, graph pools, step buffers on the device, pinned staging)
    bytes one replica holds."""
    st = engine.steps
    stagings = (st._staging, st._prefill_staging)
    return (sum(t.numel() * t.element_size()
                for t in engine.pool.pool.values()),
            graph_pool_bytes(st),
            sum(s.device_buf.numel() * 4 for s in stagings),
            sum(b.numel() * 4 for s in stagings for b in s.bufs))


def gb(n):
    return "not measured" if n is None else f"{n / 1e9:.3f} GB"


def cluster_way(model, card, tag, n, batch):
    """``n`` co-located replicas (threaded, round-robin, graphs +
    overlap, ``max_batch=batch``, the KV budget split ``n`` ways): a cold
    serve of the workload's seed-1 twin (every graph captured inside it,
    on the replicas' threads), then the measured serve of the 64
    requests with an observer attached (each replica's CUDA-event device
    time). Prints the aggregate and each replica's steps, device idle
    share and memory. Returns the cluster, the metrics, the requests and
    the launch counts."""
    import torch
    from repro_torch.serving import ReplicatedCluster
    from repro_torch.serving.obs.observer import Observability
    release()
    cluster = ReplicatedCluster.colocated(model, cluster_config(n, batch), n,
                                          policy="round-robin", mode="thread")
    t0 = time.perf_counter()
    serve_cluster(cluster, cluster_workload(seed=1), f"[cluster {tag}] cold")
    cold = time.perf_counter() - t0
    capture = sum(rep.engine.steps.capture_s for rep in cluster.replicas)
    graphs = sum(len(rep.engine.steps.graphs) for rep in cluster.replicas)
    cluster.reset_stats()
    obs = Observability()
    obs.attach_cluster(cluster)
    reqs = cluster_workload()
    m, launches = serve_cluster(cluster, reqs, f"[cluster {tag}]")
    print(f"[cluster {tag}] on {card}: {n} replica(s) x max_batch={batch}, "
          f"{CLUSTER_BUDGET // n // 16 * 16} KV tokens each, threaded, "
          f"round-robin, graphs + overlap: {len(reqs)} requests, output "
          f"{m.output_throughput:.1f} tok/s, total {m.throughput:.1f} tok/s,"
          f" wall {m.wall_s:.3f} s; ITL p50 {m.itl.p50 * 1e3:.3f} ms, p95 "
          f"{m.itl.p95 * 1e3:.3f} ms; TTFT p50 {m.ttft.p50 * 1e3:.1f} ms, "
          f"p95 {m.ttft.p95 * 1e3:.1f} ms; {m.preemptions} preemptions; "
          f"cold serve {cold:.2f} s with {graphs} graphs captured in "
          f"{capture:.2f} s")
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    for rep, rs in zip(cluster.replicas, m.per_replica):
        eng = rep.engine
        samples = obs.observer(rep.idx).roofline.samples
        busy = sum(s.device_s for s in samples) * (
            samples.appended / max(len(samples), 1))
        pool, graph, dev_buf, pinned = replica_memory(eng)
        print(f"[cluster {tag}] replica {rep.idx}: {rs.n_requests} requests, "
              f"{eng.decode_steps} decode steps, {eng.prefills} prefills, "
              f"mean batch {rs.metrics.avg_batch:.2f}; its stream busy "
              f"{busy:.3f} s of the {m.wall_s:.3f} s wall (CUDA events), "
              f"device idle share {(1 - busy / m.wall_s) * 100:.1f}%; "
              f"memory: KV pool {gb(pool)}, graph pools {gb(graph)}, step "
              f"buffers {dev_buf / 1e6:.2f} MB on the card and "
              f"{pinned / 1e6:.2f} MB pinned")
    print(f"[cluster {tag}] weights held once for all {n} replica(s): "
          f"{gb(weights)}")
    return cluster, m, reqs, launches


def stream_intervals(prof, path):
    """Each device kernel of a profile as ``(stream, start_us, end_us,
    name)``: the stream from the event's device resource id, or, where
    the events do not carry it, from the Chrome trace's ``tid``."""
    import torch
    ks = [e for e in prof.events()
          if is_device_work(e)]
    out = [(getattr(e, "device_resource_id", None), e.time_range.start,
            e.time_range.end, e.name) for e in ks]
    if len({s for s, _, _, n in out if "paged_decode_split" in n}) > 1:
        return out
    prof.export_chrome_trace(str(path))
    doc = json.loads(Path(path).read_text())
    return [(e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0), e["name"])
            for e in doc["traceEvents"] if e.get("cat") == "kernel"]


def union_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def cluster_window(cluster, card, steps=10):
    """``torch.profiler`` over ``steps`` steps of each replica, stepped on
    its own thread (as the cluster steps them), at 16 requests a replica
    of the paged serve: each replica stream's kernel busy time, their sum
    against the union of busy time on the device (above 1.0: the replicas'
    kernels ran at the same time), and the paged kernel's launches against
    the counters and the trace (a window that met a new bucket, or whose
    trace lost a record, is taken again)."""
    import threading
    import torch
    from torch.profiler import ProfilerActivity, profile
    engines = [rep.engine for rep in cluster.replicas]
    for i, r in enumerate(serve_workload()[:16 * len(engines)]):
        engines[i % len(engines)].add_request(r)
    for _ in range(21):                  # admits all, then warm steps
        for e in engines:
            e.step(0.0)
    torch.cuda.synchronize()
    layers = engines[0].model.cfg.n_layers
    for attempt in range(3):
        graphs = [len(e.steps.graphs) for e in engines]
        d0 = [e.decode_steps for e in engines]
        reset_launches()
        barrier = threading.Barrier(len(engines))
        errors = []

        def run(e):
            try:
                barrier.wait()
                for _ in range(steps):
                    e.step(0.0)
            except BaseException as exc:   # raised again below
                errors.append(exc)

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=run, args=(e,))
                       for e in engines]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        stepped = sum(e.decode_steps - d for e, d in zip(engines, d0))
        counted = read_launches()["paged_decode_attention"]
        ks = stream_intervals(prof, ROOT / "chiprun_out" /
                              "cluster_window_trace.json")
        traced = sum("paged_decode_split_kernel" in n for _, _, _, n in ks)
        if graphs == [len(e.steps.graphs) for e in engines] \
                and traced == counted:
            break
    if counted != stepped * layers or traced != counted:
        raise AssertionError(f"[cluster window] paged launches: counter "
                             f"+{counted}, trace {traced}, steps x layers "
                             f"{stepped * layers}")
    streams = {}
    for s, a, b, n in ks:
        streams.setdefault(s, []).append((a, b))
    replica_streams = {s for s, _, _, n in ks
                       if "paged_decode_split_kernel" in n}
    per_stream = {s: union_us(streams[s]) / 1e3 for s in replica_streams}
    union = union_us([(a, b) for _, a, b, _ in ks]) / 1e3
    ratio = sum(per_stream.values()) / union
    print(f"[cluster window] on {card}: {len(engines)} replicas x {steps} "
          f"steps on their own threads, {stepped} decode steps at batch "
          f"{[len(e.running) for e in engines]}, host wall {wall * 1e3:.1f}"
          f" ms; kernel busy a replica stream "
          f"{', '.join(f'{v:.3f}' for v in per_stream.values())} ms, sum "
          f"{sum(per_stream.values()):.3f} ms against the device's busy "
          f"union {union:.3f} ms: {ratio:.3f} (above 1.0: the replicas' "
          f"kernels overlapped); paged kernel launches: counter +{counted}"
          f" = trace {traced} = steps x layers {stepped * layers}"
          f"{f' (window taken {attempt + 1} times)' if attempt else ''}")
    if len(replica_streams) != len(engines) or ratio <= 1.0:
        raise AssertionError(f"[cluster window] {len(replica_streams)} "
                             f"replica streams, busy sum / union {ratio:.3f}")
    for e in engines:
        for r in list(e.running) + list(e.prefilling) + list(e.waiting):
            e.abort(r.req_id)
    torch.cuda.synchronize()
    return ratio


def cluster_faults(cluster, card, two):
    """The R=2 cluster (threaded, overlapped, warm) with replica 1 killed
    mid-serve, observed, serving the workload's first ``FAULT_REQUESTS``
    requests: every request must finish by length, requests
    must be redriven, the trace must hold the quarantine and the
    redrives; first with ``respawn=True`` (replica 1 must serve again over
    its own pool and graphs), then without. Each run's tokens are held
    against the same requests of the fault-free threaded serve ``two``
    (agreement printed: the survivor's batches differ from the fault-free
    run's)."""
    from repro_torch.serving import FaultInjector, FaultSpec
    from repro_torch.serving.obs.observer import Observability
    for respawn in (True, False):
        dead = cluster.replicas[1].engine
        at = dead.step_count + KILL_AFTER
        inj = FaultInjector([FaultSpec("kill", replica=1, step=at)])
        cluster.faults, cluster.respawn = inj, respawn
        for rep in cluster.replicas:
            rep.engine.faults = inj
        cluster.reset_stats()
        obs = Observability()
        obs.attach_cluster(cluster)
        reqs = cluster_workload()[:FAULT_REQUESTS]
        tag = f"[cluster faults{', respawn' if respawn else ''}]"
        # a replica's fault count survives reset_stats, as its health does
        m, _ = serve_cluster(cluster, reqs, tag, faults=1 + sum(
            rep.faults for rep in cluster.replicas))
        rep = cluster.replicas[1]
        names = {e["name"] for e in obs.trace.to_dict()["traceEvents"]}
        want = {"quarantine", "redrive"} | ({"respawn"} if respawn else set())
        if not m.redriven or not want <= names:
            raise AssertionError(f"{tag}: {m.redriven} redriven, trace "
                                 f"events {sorted(want - names)} missing")
        if respawn and not (rep.healthy and rep.engine is not dead
                            and rep.engine.steps is dead.steps
                            and rep.engine.decode_steps > 0):
            raise AssertionError(f"{tag}: replica 1 did not serve again")
        print(f"{tag} on {card}: replica 1 killed at its step {at}; "
              f"{m.completed} of {len(reqs)} requests finished, "
              f"{m.redriven} redriven, {m.lost} lost; trace events "
              f"{sorted(want)} present; "
              + (f"replica 1 respawned over its pool and graphs served "
                 f"{len(rep.requests)} requests, {rep.engine.decode_steps}"
                 f" decode steps after it; " if respawn else
                 f"replica 1 down, availability "
                 f"{m.per_replica[1].availability * 100:.1f}%; ")
              + f"output {m.output_throughput:.1f} tok/s; against the "
              f"fault-free serve: {agreement(two[:len(reqs)], reqs)}")


def phase_cluster(model, card):
    """``[cluster]``: the paper's replication (Sec. VI-B) on its own card.
    The 64-request workload on one MAX engine (``max_batch=32``, the
    32768-token budget) and on 2 and 4 co-located replicas splitting the
    budget (batch 16 and 8), each threaded, round-robin, graphs +
    overlap, cold then measured (:func:`cluster_way`); the R=2 cluster's
    profile window (:func:`cluster_window`), its serve again in sync mode
    (token agreement with the threaded one) and its fault runs
    (:func:`cluster_faults`); then the BCA loop: ``measure_curves`` at
    batch 4, 8, 16 and 32 (short serves), ``decide`` on the card's peaks
    with at most 4 replicas, and the decided configuration served.
    Returns the R=2 measured serve's launch counts."""
    from repro_torch.core.hardware import H100_SXM5_80GB
    from repro_torch.core.replication import ReplicationPlanner
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.cluster import decide, measure_curves
    from repro_torch.serving.workload import sharegpt_like
    out = {}
    for tag, n, batch in CLUSTER_WAYS:
        cluster, m, reqs, launches = cluster_way(model, card, tag, n, batch)
        out[tag] = m
        if tag != "R=2":
            del cluster
            continue
        r2_launches, r2_reqs = launches, reqs
        cluster_window(cluster, card)
        cluster.mode = "sync"
        cluster.reset_stats()
        sync_reqs = cluster_workload()
        serve_cluster(cluster, sync_reqs, "[cluster R=2 sync]")
        diff = first_difference(r2_reqs, sync_reqs)
        print(f"[cluster R=2] sync against threaded, the same 64 requests: "
              f"{agreement(r2_reqs, sync_reqs)}"
              f"{'' if diff is None else '; first difference: ' + diff}")
        cluster.mode = "thread"
        cluster_faults(cluster, card, r2_reqs)
        del cluster
    base = out["MAX"]
    for tag in ("R=2", "R=4"):
        m = out[tag]
        print(f"[cluster] {tag} against MAX on {card}: output tok/s "
              f"{m.output_throughput / base.output_throughput:.3f}x, ITL p50 "
              f"{m.itl.p50 / base.itl.p50:.3f}x, ITL p95 "
              f"{m.itl.p95 / base.itl.p95:.3f}x, TTFT p50 "
              f"{m.ttft.p50 / base.ttft.p50:.3f}x")
    cfg = model.cfg
    plan = ReplicationPlanner(H100_SXM5_80GB, cfg, ctx=331).plan(16)
    print(f"[cluster] the planner's accounting at B=16: {plan.summary()} "
          f"(weights {plan.model_bytes / 1e9:.3f} GB counted once a replica,"
          f" as MPS processes hold them; co-located in one process they are"
          f" held once)")

    def make_engine(b):
        release()
        return ContinuousBatchingEngine(model, cluster_config(1, b))

    def curve_workload():
        return sharegpt_like(32, cfg.vocab_size, seed=2, mean_in=161,
                             mean_out=64, max_len=512)

    t0 = time.perf_counter()
    curves = measure_curves(make_engine, curve_workload, [4, 8, 16, 32])
    print(f"[cluster bca] measured curves on {card} "
          f"({time.perf_counter() - t0:.1f} s, 32 requests of mean 161 in /"
          f" 64 out a point, each engine "
          f"warmed by one serve first): " + "; ".join(
              f"B={int(b)}: {t:.1f} tok/s, ITL {l * 1e3:.3f} ms, KV "
              f"{k * 100:.1f}%" for b, t, l, k in zip(
                  curves.batches, curves.throughput, curves.itl_s,
                  curves.kv_fraction)))
    d = decide(curves, hw=H100_SXM5_80GB, cfg=cfg, ctx=331, max_replicas=4)
    print(f"[cluster bca] decide on {H100_SXM5_80GB.name} (ctx 331, SLO 2x "
          f"the ITL at B=4 = {d.slo_s * 1e3:.3f} ms, at most 4 replicas): "
          f"B_opt={d.bca.b_opt}, R={d.n_replicas}; "
          + d.summary().replace("\n", "; "))
    _, m, _, _ = cluster_way(model, card, f"BCA R={d.n_replicas}",
                             d.n_replicas, d.bca.b_opt)
    print(f"[cluster] BCA's choice against MAX on {card}: output tok/s "
          f"{m.output_throughput / base.output_throughput:.3f}x, ITL p50 "
          f"{m.itl.p50 / base.itl.p50:.3f}x")
    release()
    return r2_launches


# ------------------------------------------------ serving API, launcher ----
API_KILL_AT = 40             # the facade's cluster kills replica 1 here
API_ABORT_AFTER = 8          # the async facade aborts one stream here


def api_stream_drain(backend, reqs, strict=True):
    """Submit ``reqs`` through a ``ServingAPI``, stream the first, drain
    the rest: the first stream's deltas must reassemble to its drained
    output, and every drained output must be its request's tokens (with
    ``strict``; otherwise the requests whose emitted history differs from
    the tokens a redrive regenerated in another batch are counted).
    Returns the session's metrics."""
    from repro_torch.serving import ServingAPI
    api = ServingAPI(backend)
    handles = [api.submit(r) for r in reqs]
    events = list(api.stream(handles[0]))
    outs = api.drain()
    first = outs[handles[0].req_id]
    if tuple(t for e in events for t in e.new_token_ids) != first.token_ids \
            or not events[-1].finished:
        raise AssertionError("streamed deltas do not reassemble to the "
                             "drained output")
    differ = [h.req_id for h in handles
              if list(outs[h.req_id].token_ids) != h.request.output_tokens]
    if differ and strict:
        raise AssertionError(f"requests {differ}: drained output is not "
                             f"the request's tokens")
    print(f"[api] stream: request {handles[0].req_id} in {len(events)} "
          f"events, {len(first.token_ids)} tokens; {len(differ)} drained "
          f"outputs differ from their request's final tokens")
    return api.metrics()


def api_async(model, card, a_reqs):
    """``AsyncServingAPI`` over a new overlapped engine: the first 16
    requests of the paged serve streamed concurrently (16 ``async for``
    consumers), the longest aborted after :data:`API_ABORT_AFTER` tokens.
    Every
    stream's deltas must reassemble to its drained output, the aborted
    one end ``abort`` and the rest ``length``, every block come home
    after ``aclose`` (which joins the pump thread and waits for the
    engine's stream), and the launches (graphs captured on the pump
    thread) match the steps. Returns the launch counts."""
    import asyncio
    import torch
    from repro_torch.serving import AsyncServingAPI, ContinuousBatchingEngine
    release()
    engine = ContinuousBatchingEngine(model, serve_config(overlap=True))
    reqs = serve_workload()[:16]
    victim = max(reqs, key=lambda r: r.max_new_tokens).req_id

    async def serve_async():
        api = AsyncServingAPI(engine)
        handles = [await api.submit(r) for r in reqs]

        async def consume(h):
            toks, aborted = [], False
            async for ev in api.stream(h):
                toks.extend(ev.new_token_ids)
                if ev.finished:
                    return toks, ev.finish_reason
                if h.req_id == victim and not aborted \
                        and len(toks) >= API_ABORT_AFTER:
                    aborted = await api.abort(h)
            return toks, None
        streamed = await asyncio.gather(*(consume(h) for h in handles))
        outs = await api.drain()
        await api.aclose()
        return streamed, outs

    t0 = time.perf_counter()
    reset_launches()
    streamed, outs = asyncio.run(serve_async())
    torch.cuda.synchronize()
    launches = read_launches()
    wall = time.perf_counter() - t0
    for r, (toks, reason) in zip(reqs, streamed):
        out = outs[r.req_id]
        want = "abort" if r.req_id == victim else "length"
        if tuple(toks) != out.token_ids or reason != out.finish_reason \
                or reason != want:
            raise AssertionError(f"[api async] request {r.req_id}: streamed "
                                 f"{len(toks)} tokens ({reason}), drained "
                                 f"{len(out.token_ids)} ({out.finish_reason})"
                                 f", want {want}")
    mgr = engine.pool.manager
    want = expected_launches([engine])
    if mgr.free_blocks != mgr.num_blocks or engine.busy:
        raise AssertionError(f"[api async] {mgr.num_blocks - mgr.free_blocks}"
                             f" blocks held after the drain")
    if launches != want or not bool(engine.steps.finite):
        raise AssertionError(f"[api async] launch counts {launches} != "
                             f"{want}, or NaN or inf logits")
    kept = [r for r in reqs if r.req_id != victim]
    by_id = {r.req_id: r for r in a_reqs}
    print(f"[api async] on {card}: 16 concurrent streams over "
          f"{step_mode(engine)}; request {victim} aborted after "
          f"{len(outs[victim].token_ids)} tokens, blocks all home; "
          f"{sum(len(o.token_ids) for o in outs.values())} tokens in "
          f"{wall:.2f} s; launches {launches}; against (a): "
          f"{agreement([by_id[r.req_id] for r in kept], kept)}")
    del engine
    release()
    return launches


def api_cluster(model, card, a_reqs):
    """``ServingAPI`` over an R=2 co-located cluster (sync, 16384 KV tokens
    a replica) with replica 1 killed at its step :data:`API_KILL_AT`, as
    ``--inject-fault replica=1,step=40`` does: the facade's pump redrives
    its requests onto replica 0; every request must finish by length,
    none be lost. Returns the launch counts."""
    from repro_torch.serving import FaultInjector, ReplicatedCluster
    release()
    cluster = ReplicatedCluster.colocated(
        model, serve_config(kv_pool_tokens=16384), 2, mode="sync",
        faults=FaultInjector.parse(f"replica=1,step={API_KILL_AT}"))
    reqs = serve_workload()[:16]
    m, launches = serve_cluster(
        cluster, reqs, "[api cluster]", faults=1,
        drive=lambda c, r: api_stream_drain(c, r, strict=False))
    if not m.redriven:
        raise AssertionError("[api cluster]: nothing was redriven")
    by_id = {r.req_id: r for r in a_reqs}
    print(f"[api cluster] on {card}: R=2 through the facade, replica 1 "
          f"killed at its step {API_KILL_AT}: {m.completed} of {len(reqs)} "
          f"finished, {m.redriven} redriven, {m.lost} lost; launches "
          f"{launches}; against (a): "
          f"{agreement([by_id[r.req_id] for r in reqs], reqs)}")
    del cluster
    release()
    return launches


LAUNCHER_RUNS = (
    ("launcher_overlap", ["--requests", "64", "--overlap"]),
    ("launcher_bca", ["--bca", "--replicas", "auto", "--stream",
                      "--trace", "{out}/launcher_trace.json",
                      "--metrics-out", "{out}/launcher_metrics.prom",
                      "--audit-memory"]),
    ("launcher_prefix", ["--replicas", "2", "--policy", "prefix-affinity",
                         "--prefix-cache", "--shared-prefix-tenants", "4"]),
)


@contextlib.contextmanager
def recorded_engines():
    """Every ``ContinuousBatchingEngine`` built inside, in the list it
    yields (an entry point that builds its own engines)."""
    from repro_torch.serving import ContinuousBatchingEngine
    made = []
    init = ContinuousBatchingEngine.__init__

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)
    ContinuousBatchingEngine.__init__ = recorded
    try:
        yield made
    finally:
        ContinuousBatchingEngine.__init__ = init


def launcher_run(card, tag, flags):
    """``repro_torch.launch.serve.main`` in this process at full width,
    its output printed under ``[tag]``, with the launch counters set to 0
    just before and read just after: every engine it built must keep its
    logits finite and launch each kernel once a layer of each step of its
    kind, and every request finish by length or stop. Returns the launch
    counts."""
    import io
    import torch
    from repro_torch.launch import serve as launcher
    argv = ["--arch", MODEL] + [f.format(out=ROOT / "chiprun_out")
                                for f in flags]
    release()
    t0 = time.perf_counter()
    out = io.StringIO()
    try:
        with recorded_engines() as made:
            reset_launches()
            with contextlib.redirect_stdout(out):
                metrics = launcher.main(argv)
            torch.cuda.synchronize()
            launches = read_launches()
    finally:
        for line in out.getvalue().splitlines():
            print(f"[{tag}] {line}")
    wall = time.perf_counter() - t0
    want = expected_launches(made)
    reasons = {k: v for k, v in metrics.finish_reasons.items() if v}
    if set(reasons) - {"length", "stop"}:
        raise AssertionError(f"[{tag}] finish reasons {reasons}")
    if launches != want or not all(bool(e.steps.finite) for e in made):
        raise AssertionError(f"[{tag}] launch counts {launches} != {want}, "
                             f"or NaN or inf logits")
    need = ["paged_decode_attention", "flash_attention"] + (
        ["flash_prefix_attention"] if "--prefix-cache" in flags else [])
    if not all(launches[k] for k in need):
        raise AssertionError(f"[{tag}] a kernel of {need} never launched: "
                             f"{launches}")
    print(f"[{tag}] on {card}: python -m repro_torch.launch.serve "
          f"{' '.join(argv)}: {len(made)} engine(s), {wall:.1f} s; "
          f"paged {launches['paged_decode_attention']}, flash "
          f"{launches['flash_attention']}, flash prefix "
          f"{launches['flash_prefix_attention']} launches (= each engine's "
          f"steps x layers)")
    made.clear()
    release()
    return launches


def phase_api(model, card, modes):
    """The serving API and the launcher on the card: (a) ``ServingAPI``
    over one overlapped engine with the paged serve's 32 requests, the
    first streamed and the rest drained, token for token the graphs +
    overlap serve of ``engine.run`` (the first differing step printed
    and fatal); (b) ``AsyncServingAPI`` (:func:`api_async`); (c) the
    facade over an R=2 cluster with a kill (:func:`api_cluster`); (d) the
    launcher's three runs (:data:`LAUNCHER_RUNS`), the trace validated
    and the Prometheus file linted. Returns each path's launch counts."""
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.obs import lint_prometheus, validate_chrome_trace
    release()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    reqs = serve_workload()
    engine = ContinuousBatchingEngine(model, serve_config(overlap=True))
    _, got = run_served(engine, reqs, card, "[serve api, graphs, overlap]",
                        drive=api_stream_drain)
    del engine
    release()
    diff = first_difference(modes["greedy", "graphs, overlap"]["reqs"], reqs)
    if diff:
        raise AssertionError(f"[api] the facade's tokens differ from "
                             f"engine.run's at {diff}")
    print(f"[api] ServingAPI stream + drain equals engine.run (graphs, "
          f"overlap) on all {sum(r.generated for r in reqs)} tokens")
    paths = {"api_serve": got,
             "api_async": api_async(model, card, reqs),
             "api_cluster": api_cluster(model, card, reqs)}
    for tag, flags in LAUNCHER_RUNS:
        paths[tag] = launcher_run(card, tag, flags)
    out = ROOT / "chiprun_out"
    errs = validate_chrome_trace(str(out / "launcher_trace.json"))
    lint = lint_prometheus((out / "launcher_metrics.prom").read_text())
    if errs or lint:
        raise AssertionError(f"[launcher_bca] trace {errs[:3]}, "
                             f"Prometheus {lint[:3]}")
    print("[launcher_bca] the trace passes validate_chrome_trace and the "
          "metrics file lint_prometheus")
    return paths


def phase_gather_serve(model, card, paged_all):
    """The gather-fallback serve of the first 16 requests three ways (CUDA
    graphs, sync, whose launch counts it returns; every step eager, the
    requests cut to ``EAGER_CAP`` new tokens and held to a graphs serve
    of the same cut requests; CUDA graphs with overlap), equal on every
    token, each followed by its decode profile (16 uncut requests) and
    then a table of them; the paged serve of the same
    16 for token agreement (beside, as a control, the same 16 in the
    32-request paged serve, where other batches surround them), and the
    same agreement with the model in float32."""
    table, runs = [], {}
    for way in ("graphs, sync", "eager, sync", "graphs, overlap"):
        kw = WAYS[way]
        if way == "eager, sync":
            _, m = cut_eager_serve(model, card, serve_workload()[:16],
                                   "gather", "gather")
        else:
            reqs = serve_workload()[:16]
            engine, m, launches = serve(model, reqs, "gather", card,
                                        tag=f"gather, {way}", **kw)
            del engine
            release()
            runs[way] = (reqs, launches)
            diff = first_difference(runs["graphs, sync"][0], reqs)
            if diff:
                raise AssertionError(f"gather serve, {way}: tokens differ "
                                     f"from the graphs-sync serve at {diff}")
        prof = profile_decode(model, "gather", card, tag=f"gather, {way}",
                              **kw)
        table.append(f"gather, {way}"
                     + (f" (cut to {EAGER_CAP})" if way == "eager, sync"
                        else "") + f": output {m.output_throughput:.1f} "
                     f"tok/s, ITL p50 {m.itl.p50 * 1e3:.2f} p95 "
                     f"{m.itl.p95 * 1e3:.2f} ms, TTFT p50 "
                     f"{m.ttft.p50 * 1e3:.1f} p95 {m.ttft.p95 * 1e3:.1f} ms; "
                     f"steady step busy {prof['busy']:.3f} ms, wall "
                     f"{prof['wall']:.3f} ms, idle {prof['idle'] * 100:.1f}%")
    reqs, launches = runs["graphs, sync"]
    print(f"[serve gather] overlapped equal to graphs, sync on all "
          f"{sum(r.generated for r in reqs)} tokens, eager equal to graphs "
          f"on the cut serve")
    for row in table:
        print(f"[graphs] on {card}: {row}")
    paged_reqs = serve_workload()[:16]
    engine, _, _ = serve(model, paged_reqs, "paged", card)
    del engine
    release()
    print(f"[serve gather] {model.cfg.dtype} token agreement, gather vs the "
          f"paged serve of the same 16 requests: "
          f"{agreement(reqs, paged_reqs)}")
    print(f"[serve gather] control, paged vs paged (the same 16 requests "
          f"served alone and among 32): "
          f"{agreement(paged_all[:16], paged_reqs)}")
    # the same pair in float32 at full depth: rounding, not the data path,
    # is what may still tell the two modes apart
    f32 = full_model(dtype="float32")
    f32_runs = {}
    for mode in ("gather", "paged"):
        f32_runs[mode] = serve_workload()[:16]
        engine, _, _ = serve(f32, f32_runs[mode], mode, card)
        del engine
        release()
    print(f"[serve gather] float32 token agreement, gather vs paged on the "
          f"same 16 requests: "
          f"{agreement(f32_runs['gather'], f32_runs['paged'])}")
    prefill_symbol(f32, card)
    del f32
    release()
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
            "flash_prefix_attention": 0,
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
    release()
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


def steady_steps(engine, steps, wrap=contextlib.nullcontext):
    """``steps`` engine steps ending in a sync, inside ``wrap()``, done
    again (up to three times) while a window met a new bucket: a bucket's
    first use and capture are set-up, not a steady step. Returns the
    context ``wrap()`` gave, the host wall ms a step and the kernel
    launches counted, of the last window."""
    import torch
    for _ in range(3):
        n = len(engine.steps.graphs)
        before = read_launches()
        with wrap() as ctx:
            # a kernel of a few microseconds opens the window: a trace may
            # miss the first kernels after it starts (as spec_window)
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.step(0.0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
        if len(engine.steps.graphs) == n:
            after = read_launches()
            return ctx, ms, {k: after[k] - before[k] for k in after}
    raise AssertionError("three windows in a row met a new bucket")


# each decode mode's kernel: its launch counter and its split kernel's
# symbol in a trace (the paged symbols hold the contiguous ones' names)
DECODE_KERNEL = {"paged": ("paged_decode_attention",
                           lambda name: "paged_decode_split_kernel" in name),
                 "gather": ("decode_attention",
                            lambda name: "decode_split_kernel" in name
                            and "paged_decode_" not in name)}


def profile_decode(model, decode_mode, card, steps=10, sampling=None,
                   tag=None, **ecfg_kw):
    """Where a steady decode step's time goes: ``torch.profiler`` over
    ``steps`` engine steps at batch 16 (after 20 warm steps and as many
    unprofiled, timed ones; a window that met a new bucket is run again),
    device busy time by kernel kind against the host's wall time of an
    unprofiled step. With CUDA graphs and no overlap, the decode kernel's
    launch counter over the profiled steps and the trace's count of its
    split kernel must both be steps x layers. Returns ``{"busy", "wall",
    "idle"}`` (ms, ms, share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(model,
                                      serve_config(decode_mode, **ecfg_kw))
    for r in serve_workload(sampling)[:16]:
        engine.add_request(r)
    for _ in range(21):                  # admits all 16, then warm steps
        engine.step(0.0)
    torch.cuda.synchronize()
    _, plain_wall_ms, _ = steady_steps(engine, steps)   # unprofiled
    counter, is_split = DECODE_KERNEL[decode_mode]
    want = steps * model.cfg.n_layers
    exact = engine.steps.graphs_on and not engine.ecfg.overlap
    for attempt in range(3):
        prof, wall_ms, launched = steady_steps(engine, steps, lambda: profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        counted = launched[counter]
        kernels = [e for e in prof.events()
                   if is_device_work(e)]
        traced = sum(is_split(e.name) for e in kernels)
        # a trace can drop kernel records: a short one is taken again
        if not exact or traced >= want:
            break
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
    tag = f"[profile {tag or decode_mode}]"
    idle = 1 - busy / plain_wall_ms
    print(f"{tag} on {card}, {step_mode(engine)}: {steps} decode steps at "
          f"batch {len(engine.running)} ({ctx} context tokens at the end), "
          f"torch.profiler: device busy {busy:.3f} ms/step, "
          f"{len(kernels) / steps:.0f} device ops/step; host wall "
          f"{plain_wall_ms:.3f} ms/step unprofiled ({wall_ms:.3f} profiled),"
          f" so the device idles {idle * 100:.1f}% of an unprofiled step")
    print(f"{tag} device time per step: {parts}")
    # under overlap the trace also holds steps dispatched before the
    # window, so the counts are held equal in sync mode only
    again = f"; window taken {attempt + 1} times" if attempt else ""
    print(f"{tag} {counter} over the profiled steps: launch counter "
          f"+{counted}, trace {traced} split kernels (steps x layers = "
          f"{want}){again}")
    if exact and not counted == traced == want:
        raise AssertionError(f"{tag}: replayed launches {counted} and "
                             f"traced kernels {traced} != {want}")
    del engine
    release()
    return {"busy": busy, "wall": plain_wall_ms, "idle": idle}


def phase_times(card, prefill_sizes, serve_reqs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    times = {}
    heads = {name: family_heads(name) for name in FAMILIES}
    heads = {name: h for name, h in heads.items() if h}
    long_request = paged_inputs(1, 32, 1, 64, 16, 512, torch.bfloat16,
                                [8000], seed=11)
    paged = [time_paged(card, what, *args) for what, args in (
        ("the paged serve's shape", serve_decode_inputs()),
        ("one long request through a wide table", long_request),
        *((f"{name}'s paged serve", serve_decode_inputs(*h))
          for name, h in heads.items()))]
    times["paged_decode_attention"] = dict(paged[0], other_shapes=paged[1:])

    shapes = [("the gather serve's shape", gather_decode_inputs()),
              *((f"{name}'s gather serve", gather_decode_inputs(8, *h))
                for name, h in heads.items()),
              ("one long request", decode_inputs(
                  1, 8192, 32, 1, 64, torch.bfloat16, [8192], seed=9)),
              ("the static batch at its middle step", decode_inputs(
                  32, 192, 32, 1, 64, torch.bfloat16, [160] * 32, seed=10)),
              ("the VLM's cross-attention decode, every length 1601",
               decode_inputs(16, 1601, 8, 8, 128, torch.bfloat16,
                             [1601] * 16, seed=12)),
              ("the windowed static loop's ring decode",
               decode_inputs(4, 8192, 8, 2, 128, torch.bfloat16,
                             [8192] * 4, seed=13)),
              *((f"{name}'s long_500k decode (the dry-run's case)",
                 decode_inputs(1, LONG_SLOTS, K, G, hd, torch.bfloat16,
                               [LONG_SLOTS], seed=80 + G))
                for name, K, G, hd, _ in LONG_DECODE)]
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

    main_len = statistics.median_low(
        [r.prompt_len for r in serve_reqs
         if -(-r.prompt_len // 64) * 64 == main_s])
    serial = time_masked(card, f"a serial prefill in the paged serve's most "
                               f"frequent bucket (prompt {main_len})",
                         main_s, 0, 0, main_len)
    wide = [time_flash(card, what, inputs, **kw) for what, inputs, kw in (
        ("the VLM's cross-attention prefill",
         flash_inputs(1, 128, 1601, 8, 8, 128, torch.bfloat16, seed=61),
         dict(causal=False)),
        ("hubert's bidirectional forward",
         flash_inputs(8, 1024, 1024, 16, 1, 80, torch.bfloat16, seed=62),
         dict(causal=False, lengths=[1024 - 28 * i for i in range(8)])),
        ("the windowed prefill",
         flash_inputs(1, 10240, 10240, 8, 2, 128, torch.bfloat16, seed=63),
         dict(window=8192)))]
    times["flash_attention"] = dict(serial, by_bucket=by_bucket,
                                    other_shapes=wide)
    prefix = [time_masked(card, what, *args) for what, args in (
        ("the prefix serve's suffix prefill", (64, 256, 256, 32)),
        ("the chunked serve's middle chunk", (192, 512, 384, 192)))]
    times["flash_prefix_attention"] = dict(prefix[0],
                                           other_shapes=prefix[1:])
    return times


def time_masked(card, what, S, P, pl, n):
    """The flash kernel at one shape of the engine's prefills (B=1,
    H=K=32, hd 64, bf16: a suffix of ``S`` rows, ``n`` valid, over ``P``
    prefix slots of which ``pl`` are valid; the prefix-masked entry, or
    where ``P`` is 0 the plain entry with the request's length), its
    plain version and SDPA with the same boolean mask, beside the bound;
    the bytes counted are q, the output and the K/V rows that hold a
    valid id, the operations the mask's valid (query, key) pairs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    q, k, v, lens = prefix_inputs(1, S, 32, 1, 64, P, pl, (n,),
                                  torch.bfloat16, seed=S + P)
    if P:
        kernel, plain = fa.flash_prefix_attention, \
            fa.flash_prefix_attention_torch
        kw = dict(prefix_pad=P, prefix_len=device_int(pl), lengths=lens)
        entry = "flash prefix entry"
    else:
        kernel, plain = fa.flash_attention, fa.flash_attention_torch
        kw = dict(lengths=lens)
        entry = "flash plain entry with lengths"
    ids = fa.prefix_kv_ids(P, pl, S, "cuda")
    q_ids = pl + torch.arange(S, device="cuda")[:, None]
    mask = (ids >= 0) & (q_ids >= ids) & (ids < lens[0])
    pairs = int(mask.sum())
    H, K, hd = q.shape[2], k.shape[2], q.shape[3]
    # q and out in full; of K and V only the rows holding a valid id: the
    # valid prefix and the suffix up to the length
    kv_rows = min(pl, P) + min(n, S)
    nbytes = (2 * q.numel() + 2 * kv_rows * K * hd) * q.element_size() + 4
    b_ms, b_by = bound(nbytes, 4 * hd * H * pairs)
    k_ms, k_call = timed(lambda: kernel(q, k, v, **kw))
    p_ms = time_ms(lambda: plain(q, k, v, **kw), runs=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    l_ms, l_call = timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[None, None], enable_gqa=True))
    e = close(kernel(q, k, v, **kw), plain(q, k, v, **kw),
              f"{entry} at {what}")
    row = dict(
        ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
        call_ms=k_call, library_call_ms=l_call, max_abs_err=e,
        tflop_s=4 * hd * H * pairs / (k_ms * 1e-3) / 1e12,
        gb_s=nbytes / (k_ms * 1e-3) / 1e9,
        shape=f"B=1 S={S} ({n} valid)"
              + (f" over P_pad={P} (prefix_len {pl})" if P else "")
              + f" H=K=32 hd=64 bf16, {pairs} valid (query, key) pairs "
                f"({what})",
        library_call="scaled_dot_product_attention(attn_mask=the same "
                     "boolean mask, enable_gqa=True)")
    print(f"[times] on {card}: {entry} at {row['shape']}: device "
          f"time: kernel {k_ms * 1e3:.1f} us, SDPA with the mask "
          f"{l_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}); kernel "
          f"{row['tflop_s']:.2f} TFLOP/s, {row['gb_s']:.0f} GB/s; one call "
          f"end to end: kernel {k_call * 1e3:.1f} us, SDPA "
          f"{l_call * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us")
    return row


def time_flash(card, what, inputs, causal=True, window=None, lengths=None):
    """The flash kernel's plain entry at one of slice 13's shapes (not
    causal, with a length a request, or windowed), its plain version
    (one call) and SDPA with the same boolean mask, beside the bound:
    bytes q, out and the K/V rows some query reads, operations ``4·hd``
    a valid (query, key) pair a head."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    q, k, v = inputs
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    lens = None if lengths is None else torch.tensor(
        lengths, dtype=torch.int32, device="cuda")
    q_ids = torch.arange(Sq, device="cuda")[:, None]
    kv_ids = torch.arange(Skv, device="cuda")[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device="cuda")
    if causal:
        mask &= q_ids >= kv_ids
    if window is not None:
        mask &= q_ids - kv_ids < window
    mask = mask[None].expand(B, Sq, Skv)
    if lens is not None:
        mask = mask & (kv_ids[None] < lens[:, None, None])
    pairs = int(mask.sum())
    kv_rows = sum(min(n, Skv) for n in lengths) if lengths else B * Skv
    nbytes = (2 * q.numel() + 2 * kv_rows * K * hd) * q.element_size()
    flops = 4 * hd * H * pairs
    b_ms, b_by = bound(nbytes, flops)
    kw = dict(causal=causal, window=window, lengths=lens)
    k_ms, k_call = timed(lambda: flash_attention(q, k, v, **kw))
    p_ms = time_ms(lambda: flash_attention_torch(q, k, v, **kw), runs=3,
                   warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bmask = mask[:, None]
    l_ms, l_call = timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bmask, enable_gqa=True), runs=10)
    e = close(flash_attention(q, k, v, **kw),
              flash_attention_torch(q, k, v, **kw), f"flash at {what}")
    del qt, kt, vt, bmask, mask
    release()
    row = dict(
        ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
        call_ms=k_call, library_call_ms=l_call, max_abs_err=e,
        tflop_s=flops / (k_ms * 1e-3) / 1e12,
        gb_s=nbytes / (k_ms * 1e-3) / 1e9,
        shape=f"B={B} Sq={Sq} Skv={Skv} H={H} K={K} hd={hd} "
              f"{str(q.dtype).replace('torch.', '')}"
              + ("" if causal else ", not causal")
              + (f", window {window}" if window else "")
              + (f", lengths {lengths[0]}..{lengths[-1]}" if lengths else "")
              + f", {pairs} valid (query, key) pairs ({what})",
        library_call="scaled_dot_product_attention(attn_mask=the same "
                     "boolean mask, enable_gqa=True)")
    print(f"[times] on {card}: flash plain entry at {row['shape']}: device "
          f"time: kernel {k_ms * 1e3:.1f} us, SDPA with the mask "
          f"{l_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}); kernel "
          f"{row['tflop_s']:.2f} TFLOP/s, {row['gb_s']:.0f} GB/s; one call "
          f"end to end: kernel {k_call * 1e3:.1f} us, SDPA "
          f"{l_call * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us; max abs err "
          f"{e:.3e}")
    return row


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
    release()
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
    release()
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


def replay_check(kind, what, key, replayed, want_logits, got, want, card):
    """A replayed step's logits and tokens against the same step eager:
    tokens equal and logits within 3e-2, reported bit for bit."""
    import torch
    err = (replayed - want_logits).abs().max().item()
    same = bool(torch.equal(replayed, want_logits))
    if err > TOL["bfloat16"] or got.tolist() != want.tolist():
        raise AssertionError(f"replayed {kind} {what}: logits differ by "
                             f"{err:.3e} or tokens differ from eager")
    print(f"[step] on {card}: the {kind} {what} replayed from its CUDA "
          f"graph (bucket {key}) against the same step eager: tokens equal, "
          f"logits " + ("equal bit for bit" if same else
                        f"max abs err {err:.3e} (tolerance "
                        f"{TOL['bfloat16']})"))
    return same


def phase_step_compare(model, card):
    """One whole engine decode step at batch 16 on one pool holding the
    16 requests at half their output budget: the paged step and the
    gather step, each replayed from its CUDA graph, greedy and sampled,
    against the same step eager (the same tokens, logits within 3e-2 and
    reported bit for bit); then the replayed and eager paged and gather
    steps (the port's counterpart of ``benchmarks/decode_datapath.py``),
    timed in turns (paged, paged eager, gather, gather eager, gather
    eager, gather, paged eager, paged); then the gather copy and the
    scatter alone."""
    import torch
    from repro_torch.models.sampler import (positions_array, sample_tokens,
                                            stack_sampling)
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.scheduler import StepPlan
    from repro_torch.serving.steps import StepFunctions
    from repro_torch.serving.workload import SamplingParams
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
    eager = StepFunctions(model, engine.pool, max_batch=16,
                          max_model_len=2048, cuda_graphs=False)
    tokens = [engine._tokens[r] for r in rids]
    for kind, sp in (("greedy", None), ("sampled", SamplingParams(**SAMPLED))):
        sreqs = serve_workload(sp)[:16]
        for _ in range(2):        # the first call captures, the second replays
            got = engine.steps.paged(sreqs, rids, positions, tokens)
        key = engine.steps.paged_bucket(rids) + (sp is not None,)
        replayed = engine.steps.graphs[key].logits[:16].clone()
        view = engine.pool.view(rids, positions, key[1], key[0])
        inp = torch.zeros((key[0],), dtype=torch.long, device="cuda")
        inp[:16] = torch.tensor(tokens)
        want_logits = model.decode_step(inp, view)[:16]
        want = sample_tokens(
            want_logits, *stack_sampling([r.sampling for r in sreqs]),
            positions_array([p + 1 for p in positions]))
        replay_check(kind, "paged step at batch 16", key, replayed,
                     want_logits, got[:16], want, card)
        pad = engine.steps.gather_bucket(positions)
        for _ in range(2):        # the first call captures, the second replays
            got = engine.steps.gather(sreqs, rids, positions, tokens)
        key = ("gather", 16, pad, sp is not None)
        replayed = engine.steps.graphs[key].logits.clone()
        cache = engine.pool.gather(rids, pad)
        pos = torch.tensor(positions, device="cuda")
        want_logits = model.decode_step(torch.tensor(tokens, device="cuda"),
                                        cache, pos, lengths=pos + 1)
        engine.pool.scatter_new_token(rids, positions, cache)
        del cache
        want = sample_tokens(
            want_logits, *stack_sampling([r.sampling for r in sreqs]),
            positions_array([p + 1 for p in positions]))
        replay_check(kind, "gather step at batch 16", key, replayed,
                     want_logits, got, want, card)
    steps = {"paged": engine._decode_paged,
             "paged eager": lambda p: eager.paged(
                 p.reqs, p.rids, p.positions, tokens)[:16].cpu(),
             "gather": engine._decode_gather,
             "gather eager": lambda p: eager.gather(
                 p.reqs, p.rids, p.positions, tokens).cpu()}
    ms = {mode: [] for mode in steps}
    for mode in ("paged", "paged eager", "gather", "gather eager",
                 "gather eager", "gather", "paged eager", "paged"):
        ms[mode].append(time_ms(lambda: steps[mode](plan), runs=20))
    busy = {mode: busy_ms(lambda: fn(plan)) for mode, fn in steps.items()}
    pad_blocks = engine.steps.gather_bucket(positions)
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
    mean = {mode: statistics.mean(v) for mode, v in ms.items()}
    print(f"[step] on {card}: one decode step at batch 16, "
          f"{sum(positions)} context tokens, full-width {cfg.name} "
          f"{cfg.dtype}, {cfg.n_layers} layers, end to end (CUDA events; "
          f"turns paged, paged eager, gather, gather eager and back): paged "
          f"replayed {ms['paged'][0]:.3f} / {ms['paged'][1]:.3f} ms, paged "
          f"eager {ms['paged eager'][0]:.3f} / {ms['paged eager'][1]:.3f} "
          f"ms, gather replayed {ms['gather'][0]:.3f} / "
          f"{ms['gather'][1]:.3f} ms, gather eager "
          f"{ms['gather eager'][0]:.3f} / {ms['gather eager'][1]:.3f} ms; "
          f"gather / paged replayed {mean['gather'] / mean['paged']:.2f}x, "
          f"eager {mean['gather eager'] / mean['paged eager']:.2f}x; device "
          f"busy a step (torch.profiler): paged replayed "
          f"{busy['paged']:.3f} ms, eager {busy['paged eager']:.3f} ms, "
          f"gather replayed {busy['gather']:.3f} ms, eager "
          f"{busy['gather eager']:.3f} ms")
    print(f"[step] on {card}: the gather copy ([{cfg.n_layers}, 16, "
          f"{pad_blocks * 16}, {cfg.n_kv_heads}, {cfg.hd}] K and V, "
          f"{view_bytes / 1e9:.2f} GB written, as many read): device "
          f"{g_dev:.3f} ms ({2 * view_bytes / (g_dev * 1e-3) / 1e9:.0f} GB/s),"
          f" end to end {g_ms:.3f} ms; the scatter back: end to end "
          f"{s_ms:.3f} ms; copy and scatter are "
          f"{(g_ms + s_ms) / mean['gather'] * 100:.1f}% of the gather step's "
          f"time; the copy is {g_dev / busy['gather'] * 100:.1f}% of its "
          f"device busy time")
    del engine, eager, cache
    release()


def phase_prefill_compare(model, card):
    """Each prefill body replayed from its CUDA graph against the same
    prefill eager (the dense prefix gathered with a host table, the model
    with an int prefix length): logits and first token, and the rows the
    replay wrote into the pool against the eager call's K/V, at every
    shape of :data:`PREFILL_SHAPES`; then each suffix bucket replayed at
    two prefix lengths it was not captured at (the prefix length is read
    from the device at every replay). Returns how many compared bit for
    bit, of how many."""
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.steps import bucket, pow2_bucket
    engine = ContinuousBatchingEngine(model, serve_config())
    prompt = prefill_pool(engine, seed=5)
    table = engine.pool.manager.tables[0]
    cases = [(n, start) for _, n, start in PREFILL_SHAPES]
    cases += [(32, 250), (32, 200), (192, 400), (192, 500)]
    n_same = 0
    for n, start in cases:
        call, key = prefill_call(engine, prompt, n, start)
        first = key not in engine.steps.graphs
        for _ in range(2 if first else 1):
            call()
        replayed = engine.steps.graphs[key].logits.clone()
        S = bucket(n, engine.ecfg.prefill_bucket)
        toks = torch.zeros((1, S), dtype=torch.long)
        toks[0, :n] = torch.from_numpy(prompt[start:start + n])
        nb = -(-start // 16)
        prefix = (engine.pool.gather_prefix(table[:nb], pow2_bucket(nb))
                  if start else None)
        want, cache = model.prefill(toks.cuda(), torch.tensor(
            [n], device="cuda"), cache_len=S, prefix=prefix, prefix_len=start)
        rows = torch.arange(start, start + n, device="cuda")
        phys = torch.tensor(table, device="cuda")[rows // 16]
        same = replay_check(
            "prefill", f"of {n} tokens from position {start}" + (
                "" if first else " (a bucket captured at another prefix "
                "length)"), key, replayed, want, replayed.argmax(-1),
            want.argmax(-1), card)
        for name, leaf in engine.pool.pool.items():
            written = leaf[:, phys, rows % 16]
            close(written, cache[name][:, 0, :n],
                  f"prefill {key} from {start}: the replay's pool rows "
                  f"({name}) against the eager call's K/V")
            same = same and bool(torch.equal(written, cache[name][:, 0, :n]))
        n_same += same
    print(f"[step] on {card}: {len(cases)} prefills replayed, {n_same} equal "
          f"to eager bit for bit in logits and in the pool rows they wrote; "
          f"{step_mode(engine)}")
    del engine
    release()
    return n_same, len(cases)


def phase_verify_compare(model, card, K=8):
    """One verify step at ``(batch 4, nb_pad, K_pad 8)`` on three requests
    of the serve workload at half their output budget and a padding row,
    over random pool rows: a full draft, a draft wrong at its fourth
    token and none, the drafts taken from 9 plain paged steps of the same
    bucket (eager, on a copy of the pool). The verify step replayed from
    its CUDA graph against the same step eager (on another copy): tokens,
    acceptance and logits bit for bit, and the pool rows written; its
    iteration 0 against the plain paged step on the same inputs, bit for
    bit in logits; the accepted prefixes must be the drafted 8, 3 and 0.
    Then its device busy time and end-to-end time, replayed, against
    ``K + 1`` replayed paged steps of the same bucket, and eager."""
    import torch
    from repro_torch.kvcache.paged import PagedKVCache
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.steps import StepFunctions, split_verify
    engine = ContinuousBatchingEngine(model, serve_config(
        max_batch=4, kv_pool_tokens=8192, speculate=True, spec_k=K))
    pool = engine.pool
    gen = torch.Generator("cuda").manual_seed(4)
    for leaf in pool.pool.values():
        leaf.normal_(generator=gen)
    twins = [PagedKVCache(model.cfg, num_blocks=pool.num_blocks,
                          block_size=pool.block_size, device="cuda")
             for _ in range(2)]
    for twin in twins:
        for name, leaf in pool.pool.items():
            twin.pool[name].copy_(leaf)
    reqs = serve_workload()[:3]
    rids = [r.req_id for r in reqs]
    positions = decode_lengths()[:3]
    tokens = [r.req_id + 1 for r in reqs]
    for p in (pool, *twins):
        for rid, pos in zip(rids, positions):
            p.manager.allocate(rid, pos + K + 2)
    serial = StepFunctions(model, twins[1], max_batch=4, max_model_len=2048,
                           cuda_graphs=False)
    batch_pad, nb_pad = serial.paged_bucket(rids)
    dev, hot = serial._stage(reqs, positions, tokens, None, batch_pad,
                             nb_pad, rids)
    out, plain_logits = serial._paged_body(dev, hot)
    s = [out[:3].tolist()]
    for j in range(1, K + 1):
        s.append(serial.paged(reqs, rids, [p + j for p in positions],
                              s[-1])[:3].tolist())
    s = np.asarray(s, np.int64).T
    wrong = (s + 1) % model.cfg.vocab_size
    drafts = [np.asarray(d, np.int32) for d in (
        s[0, :K], np.r_[s[1, :3], wrong[1, 3], s[1, 4:K]], s[2, :0])]
    eager = StepFunctions(model, twins[0], max_batch=4, max_model_len=2048,
                          cuda_graphs=False, spec_k=K)
    key = ("verify",) + eager.verify_bucket(rids, drafts) + (False,)
    if key != ("verify", batch_pad, nb_pad, K, False):
        raise AssertionError(f"verify bucket {key}")
    dev, hot = eager._stage(reqs, positions, tokens, None, batch_pad, nb_pad,
                            rids, drafts, K)
    packed_e, logits_e = eager._verify_body(dev, K, hot)
    for _ in range(2):        # the first call captures, the second replays
        engine.steps.verify(reqs, rids, positions, tokens, drafts)
    step = engine.steps.graphs[key]
    packed_r, logits_r = step.tokens.clone(), step.logits.clone()
    torch.cuda.synchronize()
    ys, oks = split_verify(packed_r.cpu().numpy())
    accepted = [int(oks[i].sum()) for i in range(3)]
    checks = {
        "tokens and acceptance, replayed = eager": torch.equal(packed_r,
                                                               packed_e),
        "logits, replayed = eager": torch.equal(logits_r, logits_e),
        "iteration 0's logits = the plain paged step's": torch.equal(
            logits_e, plain_logits),
        "pool rows, replayed = eager": all(
            torch.equal(leaf[:, :pool.num_blocks],
                        twins[0].pool[name][:, :pool.num_blocks])
            for name, leaf in pool.pool.items()),
        "accepted prefixes 8, 3, 0": accepted == [K, 3, 0],
        "the committed tokens are the plain steps'": all(
            ys[i, :n + 1].tolist() == s[i, :n + 1].tolist()
            for i, n in enumerate(accepted)),
        "logits finite": bool(engine.steps.finite) and bool(eager.finite)}
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"verify step {key}: {what} fails")
    print(f"[verify] on {card}: one verify step, bucket {key}, 3 requests "
          f"({sum(positions)} context tokens) and a padding row: "
          + "; ".join(f"{what}: yes" for what in checks))
    vcall = lambda: engine.steps.verify(  # noqa: E731
        reqs, rids, positions, tokens, drafts)
    pcall = lambda: engine.steps.paged(  # noqa: E731
        reqs, rids, positions, tokens)
    for _ in range(2):
        pcall()
    busy = {"verify": busy_ms(vcall), "paged": busy_ms(pcall)}
    wall = {"verify": time_ms(vcall, runs=20),
            "paged": time_ms(pcall, runs=20),
            "verify eager": time_ms(lambda: eager.verify(
                reqs, rids, positions, tokens, drafts), runs=5, warmup=1)}
    print(f"[verify] on {card}: device busy (torch.profiler) a verify step "
          f"{busy['verify']:.3f} ms against a paged step's "
          f"{busy['paged']:.3f} ms x (K_pad + 1 = {K + 1}) = "
          f"{busy['paged'] * (K + 1):.3f} ms (ratio "
          f"{busy['verify'] / (busy['paged'] * (K + 1)):.3f}); end to end "
          f"(CUDA events): verify replayed {wall['verify']:.3f} ms, paged "
          f"replayed {wall['paged']:.3f} ms (x {K + 1} = "
          f"{wall['paged'] * (K + 1):.3f}), verify eager "
          f"{wall['verify eager']:.3f} ms")
    del engine, eager, serial, twins
    release()
    return busy, wall


# ------------------------------------------------- non-dense families ----


# run B's steady window (PERF.md section 5): the first 16 requests of the
# serve workload this many positions past their prompts (3151 tokens)
CENSUS_POSITION = 41
CENSUS_STEPS = 3             # eager steps in the census's profile window


def classes_of(d):
    """A dispatch census by class: (FLOPs, bytes, launches)."""
    return {k: (v.flops, v.bytes, d.launches.per_class.get(k, 0))
            for k, v in sorted(d.census.per_class.items())}


def scoped_kernels(prof):
    """Each kernel of a trace with the model scopes it ran under, as
    ``(scope path, ms)``: the path joins, outermost first, the
    device-side spans of the ``record_function`` ranges (the scopes)
    whose span holds the kernel, so a kernel launched through ``ctypes``
    (no PyTorch operation) is filed too. Returns (those pairs, kernels
    under no scope)."""
    import torch
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and getattr(e, "is_user_annotation", False))
    pairs, bare = [], 0
    for e in events:
        if not is_device_work(e):
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        names = [n for s0, s1, n in spans if s0 <= t0 and t1 <= s1]
        bare += not names
        pairs.append(("/".join(names), (t1 - t0) / 1e3))
    return pairs, bare


def busy_by_class(prof, steps):
    """Device busy ms a step by kernel class in an eager window's trace
    (:func:`scoped_kernels` filed by ``classify``; a kernel under no
    scope is ``other``). Returns (ms by class, kernels by class a step,
    the kernels in the trace, those under no scope)."""
    from repro_torch.core.analysis import classify
    pairs, bare = scoped_kernels(prof)
    if not pairs:
        raise AssertionError("profiler recorded no device activity")
    ms, n = {}, {}
    for path, t in pairs:
        cls = classify(path)
        ms[cls] = ms.get(cls, 0.0) + t / steps
        n[cls] = n.get(cls, 0) + 1 / steps
    return ms, n, len(pairs), bare


def phase_census(model, card):
    """(a) The dispatch census of OPT-1.3B's paged greedy step at full
    width, bf16, at run B's shape (B=16, 3151 context tokens): taken by
    an observed engine at the bucket's first use (the eager warm-up
    before its capture); the same step's census on the steps' meta twin,
    which must equal it exactly (FLOPs, bytes and launches by class, the
    temporaries); busy by class from ``CENSUS_STEPS`` eager steps under
    ``torch.profiler`` (each kernel under the model scopes whose device
    spans hold it); each class's achieved GB/s and share of the card's
    memory rate (attention from the live terms); the census's launches
    beside the trace's kernels, and the share of kernels under no scope.
    Returns the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import census as C
    from repro_torch.core.analysis import census_of
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.obs.observer import Observability
    from repro_torch.serving.scheduler import StepPlan
    cfg = model.cfg
    engine = ContinuousBatchingEngine(model, serve_config())
    obs = Observability()
    obs.attach(engine)
    reqs = serve_workload()[:16]
    rids = [r.req_id for r in reqs]
    positions = [r.prompt_len + CENSUS_POSITION for r in reqs]
    gen = torch.Generator("cuda").manual_seed(3)
    for leaf in engine.pool.pool.values():
        leaf.normal_(generator=gen)
    for r, pos in zip(reqs, positions):
        engine.pool.manager.allocate(r.req_id, pos + 1)
        engine._tokens[r.req_id] = r.req_id + 1
        engine._pos[r.req_id] = pos
    plan = StepPlan(reqs=reqs, rids=rids, positions=positions, n_prefill=0,
                    t0=0.0)
    t0 = time.perf_counter()
    engine._decode_paged(plan)       # the bucket's first use, censused
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    bucket = engine.steps.paged_bucket(rids)
    sc = obs.census._cache[("decode", bucket)]
    d = sc.dispatched
    if d is None:
        raise AssertionError("census: the first use took no census")
    key = bucket + (False,)
    t0 = time.perf_counter()
    twin = engine.steps.meta_twin()
    m = census_of(twin.body(key))
    meta_s = time.perf_counter() - t0
    if classes_of(m) != classes_of(d) or m.temp_bytes != d.temp_bytes:
        raise AssertionError(f"census: meta {classes_of(m)}, "
                             f"{m.temp_bytes} B of temporaries; card "
                             f"{classes_of(d)}, {d.temp_bytes} B")
    body = engine.steps.body(key)
    body()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        for _ in range(CENSUS_STEPS):
            body()
        torch.cuda.synchronize()
    ms, kernels, n_dev, bare = busy_by_class(prof, CENSUS_STEPS)
    busy = sum(ms.values())
    live = C.LiveWork(rows=16, context=sum(positions) + 16, entries=sum(
        len(engine.pool.manager.tables[r]) for r in rids))
    attn = C.attention_cost(cfg, "decode", bucket, live,
                            engine.ecfg.block_size)
    by_bytes = {k: v.bytes for k, v in d.census.per_class.items()}
    by_bytes["attention"] = attn.bytes
    hw = card_peaks()
    parts = []
    for cls in sorted(set(ms) | set(by_bytes), key=lambda c: -ms.get(c, 0)):
        t = ms.get(cls, 0.0)
        gbs = by_bytes.get(cls, 0.0) / (t * 1e-3) / 1e9 if t else 0.0
        parts.append(f"{cls} {by_bytes.get(cls, 0.0) / 1e9:.4f} GB, "
                     f"{d.launches.per_class.get(cls, 0)} launches, "
                     f"busy {t:.3f} ms ({kernels.get(cls, 0):.0f} kernels):"
                     f" {gbs:.1f} GB/s, {gbs * 1e9 / hw.hbm_bw * 100:.1f}%"
                     f" of {hw.hbm_bw / 1e12:.2f} TB/s")
    total = sum(by_bytes.values())
    shown = "; ".join(f"{k} {f:.4g} FLOPs, {b:.4g} B, {n}"
                      for k, (f, b, n) in classes_of(d).items())
    print(f"[census] on {card}: {cfg.name} {cfg.dtype}, {cfg.n_layers} "
          f"layers, the paged greedy step at batch 16, "
          f"{sum(positions)} context tokens, bucket {bucket}: dispatched "
          f"by class (FLOPs, bytes, launches) {shown}, "
          f"{d.launches.total} launches "
          f"({dict(d.launches.kernels)} of the kernels), temporaries "
          f"{d.temp_bytes / 1e6:.1f} MB; the first use with the census "
          f"{first_s:.2f} s")
    print(f"[census] on {card}: the same step on meta tensors equals it "
          f"class by class (FLOPs, bytes, launches, temporaries), "
          f"{meta_s:.2f} s on the host")
    print(f"[census] on {card}: {CENSUS_STEPS} eager steps under "
          f"torch.profiler, busy {busy:.3f} ms a step by class (bytes "
          f"dispatched, attention the live terms' "
          f"{attn.bytes / 1e9:.4f} GB): {'; '.join(parts)}")
    print(f"[census] on {card}: {total / 1e9:.4f} GB a step (the "
          f"analytic census {(sc.census.bytes + attn.bytes) / 1e9:.4f} GB),"
          f" {total / hw.hbm_bw * 1e3:.3f} ms at the memory rate against "
          f"{busy:.3f} ms busy; census launches {d.launches.total} against "
          f"{sum(kernels.values()):.0f} kernels a step in the trace; "
          f"{bare} of {n_dev} kernels ({bare / n_dev * 100:.2f}%, filed as "
          f"other) ran under no scope")
    if bare == n_dev:
        raise AssertionError("census: no kernel of the trace ran under a "
                             "scope")
    del engine, twin, body
    release()
    return dict(ms=ms, kernels=kernels, bytes=by_bytes,
                launches=d.launches.total, busy=busy, bare=bare / n_dev)


FAMILY_CAP = 128   # new tokens a request in a family's paged and gather serve


def family_workload(cfg, n=16, cap=None):
    """16 ShareGPT-length requests in the model's vocabulary, each cut to
    ``cap`` new tokens if given."""
    from repro_torch.serving.workload import Request, sharegpt_like
    reqs = sharegpt_like(n, cfg.vocab_size, seed=0, mean_in=161,
                         mean_out=338, max_len=1024)
    if cap is None:
        return reqs
    return [Request(r.req_id, r.prompt, min(r.max_new_tokens, cap))
            for r in reqs]


def family_model(name):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(name)
    t0 = time.perf_counter()
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def slots_home(engine, tag):
    """Every state slot of a state-keeping model's pool is free again."""
    pool = engine.pool
    if pool.free_slots != (engine.ecfg.max_batch if pool.state_names
                           else 0):
        raise AssertionError(f"{tag}: {pool.free_slots} state slots free "
                             f"of {engine.ecfg.max_batch} after the serve")


def family_graph_check(model, card, n=24, cap=24):
    """The state staged through ``slots`` and read and written inside
    captured graphs under overlap, held to eager steps: ``n`` requests of
    the family workload, each cut to ``cap`` new tokens, at batch 16 (so
    the last eight take the slots and blocks of finished ones), served
    with CUDA graphs and overlap, then with eager synchronous steps;
    every output token must be equal."""
    name = model.cfg.name
    served = {}
    for way in ("graphs, overlap", "eager, sync"):
        reqs = family_workload(model.cfg, n, cap)
        tag = f"families {name} {way}"
        engine, _, _ = serve(model, reqs, "paged", card, tag=tag,
                             **WAYS[way])
        slots_home(engine, tag)
        del engine
        release()
        served[way] = reqs
    diff = first_difference(*served.values())
    if diff:
        raise AssertionError(f"{name}: the graphs + overlap serve differs "
                             f"from the eager sync serve at {diff}")
    print(f"[families {name}] graphs + overlap against eager sync, {n} "
          f"requests cut to {cap} new tokens at batch 16 (slots reused): "
          f"all {sum(r.generated for r in served['eager, sync'])} output "
          f"tokens equal")


def family_memory(engine):
    """The device memory an engine's serve held: weights, the K/V pool,
    the dense-state slots and the graph pools with the step buffers."""
    pool = engine.pool
    weights = sum(p.numel() * p.element_size()
                  for p in engine.model.parameters())
    kv = sum(pool.pool[n].numel() * pool.pool[n].element_size()
             for n in pool.kv_names)
    return (f"weights {gb(weights)}, K/V pool {gb(kv)}, dense state "
            f"{gb(pool.dense_state_bytes)}, graph pools and step buffers "
            f"{gb(engine.graph_pool_bytes)}")


def step_bound(engine):
    """The least time of the engine's next decode step: the bytes its
    census counts (``step_census`` at its bucket plus the live attention
    terms) over the card's memory rate; with that, the census's GB and
    the perfmodel's step time (``decode_step_terms``, which prices an
    MoE step from its active parameters), both at the same rows and
    mean context."""
    from repro_torch.core import census as C
    from repro_torch.core.perfmodel import decode_step_terms
    rids = [r.req_id for r in engine.running]
    positions = [engine._pos[r] for r in rids]
    bucket = engine.steps.paged_bucket(rids)
    tables = engine.pool.manager.tables
    live = C.LiveWork(rows=len(rids), context=sum(positions) + len(rids),
                      entries=sum(min(len(tables[r]), bucket[1])
                                  for r in rids))
    cfg, bs = engine.cfg, engine.ecfg.block_size
    nbytes = C.step_census(cfg, "decode", bucket, bs).bytes + \
        C.attention_cost(cfg, "decode", bucket, live, bs).bytes
    model_s = decode_step_terms(cfg, len(rids), live.context // len(rids),
                                card_peaks()).gpu_s
    return bound(nbytes, 0.0)[0], nbytes / 1e9, model_s * 1e3


def is_device_work(e):
    """A trace event that is device work (a kernel, a copy or a fill):
    not the device-side mirror of a ``record_function`` range, which the
    models' scopes open while a profiler runs."""
    import torch
    return e.device_type == torch.autograd.DeviceType.CUDA and \
        not getattr(e, "is_user_annotation", False)


def busy_by_kind(prof, calls):
    """Device busy ms a call by kernel kind in a ``torch.profiler`` trace
    of ``calls`` calls (raises on a trace with no device activity)."""
    import torch
    kernels = [e for e in prof.events()
               if is_device_work(e)]
    if not kernels:
        raise AssertionError("profiler recorded no device activity")
    by_kind = {}
    for e in kernels:
        kind = kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / calls
    return by_kind


def kind_parts(by_kind):
    """``busy_by_kind``'s kinds, largest first, each with its share."""
    busy = sum(by_kind.values())
    return ", ".join(f"{k} {v:.3f} ms ({v / busy * 100:.1f}%)"
                     for k, v in sorted(by_kind.items(),
                                        key=lambda kv: -kv[1]))


def profile_calls(fn, calls=1):
    """Device busy ms a call of ``fn`` by kernel kind: ``torch.profiler``
    over ``calls`` calls after one unprofiled warm-up, the window opened
    by a short kernel and a sync (a trace may miss the first kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return busy_by_kind(prof, calls)


def steady_profile(model, card, tag, steps=10, engine=None):
    """A steady window at batch 16 on a graphs + overlap engine serving
    the family workload (``engine``, a served one whose buckets are
    captured, emptied first; else a new one): ``torch.profiler`` device
    busy by kernel kind against the host wall of an unprofiled window,
    and the census bound of a step. Returns the engine (mid-serve) and
    the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ContinuousBatchingEngine
    if engine is None:
        engine = ContinuousBatchingEngine(model, serve_config(overlap=True))
    else:
        rewarm(engine)
    for r in family_workload(model.cfg):
        engine.add_request(r)
    for _ in range(21):                  # admits all 16, then warm steps
        engine.step(0.0)
    torch.cuda.synchronize()
    _, wall_ms, _ = steady_steps(engine, steps)
    prof, _, _ = steady_steps(engine, steps, lambda: profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    by_kind = busy_by_kind(prof, steps)
    busy = sum(by_kind.values())
    idle = 1 - busy / wall_ms
    print(f"[{tag} profile] on {card}, {step_mode(engine)}: "
          f"{steps} decode steps at batch {len(engine.running)}: device busy "
          f"{busy:.3f} ms/step, host wall {wall_ms:.3f} ms/step unprofiled, "
          f"so the device idles {idle * 100:.1f}%; by kind: "
          f"{kind_parts(by_kind)}")
    bound_ms, census_gb, model_ms = step_bound(engine)
    print(f"[{tag} profile] on {card}: the step's census moves "
          f"{census_gb:.3f} GB (every weight the step reads, any state read "
          f"and written, the live K/V), a bound of {bound_ms:.3f} ms at "
          f"the card's {card_peaks().hbm_bw / 1e12:.2f} TB/s: busy is "
          f"{busy / bound_ms:.2f} x it; the perfmodel (active parameters) "
          f"prices the step at {model_ms:.3f} ms")
    return engine, dict(busy_ms=busy, wall_ms=wall_ms, idle=idle,
                        by_kind=by_kind, bound_ms=bound_ms)


def family_profile(model, card, engine, steps=10):
    """:func:`steady_profile` on ``engine`` (the family's paged serve's);
    then the same engine's steps run eagerly for three more steps under
    named scopes, which give the expert GEMMs' and the SSM state update's
    share of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    name = model.cfg.name
    engine, numbers = steady_profile(model, card, f"families {name}", steps,
                                     engine)
    st = engine.steps
    saved = st.graphs, st.graphs_on
    st.graphs, st.graphs_on = {}, False
    try:
        # the model's own scopes label the expert GEMMs and the state
        # update (repro_torch.core.analysis.scope)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as ep:
            for _ in range(3):
                engine.step(0.0)
            torch.cuda.synchronize()
    finally:
        st.graphs, st.graphs_on = saved
    eager_busy = sum((e.time_range.end - e.time_range.start)
                     for e in ep.events()
                     if is_device_work(e))
    pairs, _ = scoped_kernels(ep)
    shares = {k: sum(t for path, t in pairs if k in path.split("/"))
              * 1e3 / max(eager_busy, 1e-9)
              for k in ("expert_ffn", "ssm_state_update")}
    print(f"[families {name} profile] on {card}: 3 eager steps under named "
          f"scopes: device {eager_busy / 3e3:.3f} ms/step, the expert "
          f"GEMMs (expert_ffn) {shares['expert_ffn'] * 100:.1f}% and the "
          f"SSM state update (ssm_state_update) "
          f"{shares['ssm_state_update'] * 100:.1f}% of it")
    del engine
    release()
    return dict(numbers, shares=shares)


def phase_families(card):
    """Each non-dense family at full width and depth in bfloat16, random
    weights from seed 0, built, served and released before the next: a
    paged serve of 16 ShareGPT-length requests cut to ``FAMILY_CAP`` new
    tokens (CUDA graphs, overlapped, batch 16) and a gather serve of the
    first 8, each with exact launch counts (the paged or contiguous
    decode kernel once an attention layer a step: 16 for olmoe, none for
    mamba2, 13 for zamba2; the flash kernel once an attention layer a
    prefill), finite logits and every block and state slot home; then
    :func:`family_graph_check` and a profile window on the paged serve's
    engine. Returns each serve's launch counts by path and the profile
    numbers."""
    import torch
    by_path, profiles = {}, {}
    for name in FAMILIES:
        model, init_s = family_model(name)
        cfg = model.cfg
        n_params = sum(p.numel() for p in model.parameters())
        print(f"[families {name}] {cfg.arch_type}: {cfg.n_layers} layers "
              f"({attention_layers(cfg)} with attention), d_model "
              f"{cfg.d_model}, head dim {cfg.hd}, {cfg.dtype}, "
              f"{n_params / 1e9:.3f} B parameters, random init in "
              f"{init_s:.1f} s")
        outs, kept = {}, {}
        for mode, n in (("paged", 16), ("gather", 8)):
            part = family_workload(cfg, cap=FAMILY_CAP)[:n]
            engine, m, launches = serve(model, part, mode, card,
                                        tag=f"families {name} {mode}",
                                        overlap=True)
            slots_home(engine, f"{name} {mode}")
            print(f"[families {name} {mode}] on {card}: output "
                  f"{m.output_throughput:.1f} tok/s, ITL p50 "
                  f"{m.itl.p50 * 1e3:.2f} ms; {family_memory(engine)}")
            by_path[f"{name} {mode}_serve"] = launches
            outs[mode] = part
            if mode == "paged":      # its captured buckets serve the profile
                kept["paged"] = engine
            del engine
            release()
        print(f"[families {name}] paged vs gather, the first 8 requests: "
              f"{agreement(outs['paged'][:8], outs['gather'])}")
        family_graph_check(model, card)
        profiles[name] = family_profile(model, card, kept.pop("paged"))
        del model
        release()
        torch.cuda.synchronize()
    return by_path, profiles


# ------------------------------------------------------------ slice 13 ----
VLM = "llama-3.2-vision-90b"
VLM_LAYERS = 10              # two periods of cross_every 5: 8 ATTN, 2 CROSS
VLM_CHECK_LAYERS = 5         # one period, float32
ENCODER = "hubert-xlarge"
WINDOW_MODEL = "internlm2-1.8b"
WINDOW = 8192                # the reference's long-context window
WINDOW_PROMPT = 10240        # longer than the window: the ring wraps


def slice13_model(name, dtype=None, seed=0, **changes):
    """A registry config at full width (``changes`` applied, float32 if
    ``dtype`` says so), random weights from ``seed`` on the card; prints
    its size."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(name), **changes,
                              **({"dtype": dtype} if dtype else {}))
    t0 = time.perf_counter()
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"[slice13 {name}] {cfg.arch_type}: {cfg.n_layers} layers "
          f"({attention_layers(cfg)} self-attention, {cross_layers(cfg)} "
          f"cross), d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} KV heads, head dim {cfg.hd}, {cfg.dtype}, "
          f"{n / 1e9:.3f} B parameters "
          f"({n * model.cfg.activation_dtype.itemsize / 1e9:.2f} GB), "
          f"random init in {time.perf_counter() - t0:.1f} s")
    return model


def slice13_vlm(card):
    """The VLM at full width, cut to two periods (10 layers, bf16): a
    paged serve of 16 ShareGPT-length requests (graphs + overlap, batch
    16) and a gather serve of the first 8, launches exact (8 paged and 2
    contiguous a paged step, 10 contiguous a gather step, 10 flash a
    prefill), logits finite, every block and slot home; then
    :func:`family_graph_check` (graphs + overlap against eager sync, slots
    reused) and a profile window, whose census bound the paged serve's
    ITL is set against. The engine stubs the vision frontend with zero
    image embeddings, as the reference's does."""
    model = slice13_model(VLM, n_layers=VLM_LAYERS)
    cfg = model.cfg
    slot_mb = 2 * cross_layers(cfg) * cfg.n_img_tokens * cfg.n_kv_heads \
        * cfg.hd * cfg.activation_dtype.itemsize / 1e6
    print(f"[slice13 {VLM}] each dense-state slot holds {slot_mb:.1f} MB "
          f"of image K/V ({cross_layers(cfg)} layers x {cfg.n_img_tokens} "
          f"rows x K and V)")
    by_path, outs, itl = {}, {}, {}
    for mode, n in (("paged", 16), ("gather", 8)):
        part = family_workload(cfg)[:n]
        engine, m, launches = serve(model, part, mode, card,
                                    tag=f"slice13 vlm {mode}", overlap=True)
        slots_home(engine, f"vlm {mode}")
        steps = engine.decode_steps
        print(f"[slice13 vlm {mode}] on {card}: output "
              f"{m.output_throughput:.1f} tok/s, ITL p50 "
              f"{m.itl.p50 * 1e3:.2f} ms, {steps} steps, {engine.prefills} "
              f"prefills; launches {launches}; {family_memory(engine)}")
        itl[mode] = m.itl.p50 * 1e3
        by_path[f"vlm_{mode}_serve"] = launches
        outs[mode] = part
        del engine
        release()
    print(f"[slice13 vlm] paged vs gather, the first 8 requests: "
          f"{agreement(outs['paged'][:8], outs['gather'])}")
    family_graph_check(model, card)
    engine, prof = steady_profile(model, card, "slice13 vlm")
    print(f"[slice13 vlm paged] on {card}: the paged serve's ITL p50 "
          f"{itl['paged']:.2f} ms is {itl['paged'] / prof['bound_ms']:.2f} x "
          f"the census bound of its batch-16 step ({prof['bound_ms']:.3f} ms)")
    del engine, model
    release()
    return by_path


def encoder_inputs(cfg, B, S):
    """``B`` sequences of seeded embeddings (the model's dtype) and
    lengths from ``S`` down by 28 a row."""
    import torch
    gen = torch.Generator("cuda").manual_seed(6)
    emb = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda",
                      dtype=cfg.activation_dtype)
    lengths = torch.tensor([S - 28 * i for i in range(B)], device="cuda",
                           dtype=torch.int32)
    return emb, lengths


def encoder_forward(model, emb, lengths, tag):
    """``Model.forward`` through the kernels (one flash launch a layer,
    counted) and through their plain versions; returns both outputs and
    the launches."""
    import torch
    reset_launches()
    out = model.forward(embeds=emb, lengths=lengths)
    torch.cuda.synchronize()
    launches = read_launches()
    want = {"paged_decode_attention": 0, "flash_prefix_attention": 0,
            "decode_attention": 0, "flash_attention": model.cfg.n_layers}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")
    with plain_attention():
        plain = model.forward(embeds=emb, lengths=lengths)
    torch.cuda.synchronize()
    if read_launches() != want:
        raise AssertionError(f"the plain {tag} launched a kernel")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{tag}: non-finite output")
    return out, plain, launches


def slice13_encoder(card, B=8, S=1024):
    """hubert at full width and depth (48 layers): ``Model.forward`` on
    ``B`` sequences of seeded embeddings, lengths 1024 down to 828, one
    flash launch a layer. In bfloat16: finite, its relative (Frobenius)
    error against the plain versions' run within 3e-2 (the max abs
    error, which 48 layers of bf16 rounding spread, printed beside it),
    ms a call beside the operations' bound. In float32, the same forward
    within ``MODEL_TOL`` of its plain run."""
    import torch
    model = slice13_model(ENCODER)
    cfg = model.cfg
    emb, lengths = encoder_inputs(cfg, B, S)
    out, plain, launches = encoder_forward(model, emb, lengths,
                                           "encoder forward, bf16")
    diff = out.float() - plain.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / plain.float().norm()).item()
    if rel > TOL["bfloat16"]:
        raise AssertionError(f"encoder forward, bf16: relative error "
                             f"{rel:.3e} against the plain run")
    ms = time_ms(lambda: model.forward(embeds=emb, lengths=lengths),
                 runs=10, warmup=2)
    by_kind = profile_calls(lambda: model.forward(embeds=emb,
                                                  lengths=lengths))
    d, f, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    per_layer = d * (H + 2 * K) * hd + H * hd * d + 2 * d * f
    tokens = B * S
    flops = (2 * per_layer * cfg.n_layers * tokens
             + 4 * H * hd * S * int(lengths.sum()) * cfg.n_layers
             + 2 * d * V * tokens)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    b_ms, b_by = bound(weights + emb.numel() * emb.element_size()
                       + out.numel() * 4, flops)
    print(f"[slice13 encoder] {ENCODER} on {card}: forward of {B} x {S} "
          f"embeddings (lengths {lengths.tolist()[0]}..{lengths.tolist()[-1]}"
          f"), bf16: {ms:.3f} ms a call, {flops / 1e12:.2f} TFLOP, bound "
          f"{b_ms:.3f} ms ({b_by}, {card_peaks().peak_flops / 1e12:.0f} "
          f"TFLOP/s), {flops / ms / 1e9:.1f} TFLOP/s achieved; kernels vs "
          f"plain: relative error {rel:.3e} (within {TOL['bfloat16']}), max "
          f"abs err {err:.3e} (logits up to "
          f"{plain.float().abs().max().item():.2f}); launches {launches}")
    busy = sum(by_kind.values())
    print(f"[slice13 encoder profile] on {card}: one forward, device busy "
          f"{busy:.3f} ms of the {ms:.3f} ms a call (idle "
          f"{(1 - busy / ms) * 100:.1f}%); by kind: {kind_parts(by_kind)}")
    del model, out, plain, diff, emb
    release()
    model = slice13_model(ENCODER, dtype="float32", seed=1)
    emb, lengths = encoder_inputs(model.cfg, B, S)
    out, plain, _ = encoder_forward(model, emb, lengths,
                                    "encoder forward, float32")
    err32 = (out - plain).abs().max().item()
    if err32 > MODEL_TOL:
        raise AssertionError(f"encoder forward, float32: logits differ by "
                             f"{err32:.3e} (tolerance {MODEL_TOL})")
    print(f"[slice13 encoder check] {ENCODER} width and depth, float32: "
          f"forward of {B} x {S}, kernels vs plain versions: logits max abs "
          f"err {err32:.3e} (tolerance {MODEL_TOL})")
    del model, out, plain, emb
    release()
    return launches


def slice13_window(card, B=4, steps=256):
    """internlm2-1.8b at full width and depth (24 layers, bf16) with a
    sliding window of 8192: the static-batch loop on ``B`` prompts of
    10240 tokens (the ring wraps at prefill: it keeps the last 8192
    rows, row t at slot t % 8192), then ``steps`` greedy decode steps at
    one position for the batch on the ring; one flash launch a layer a
    prefill and one contiguous launch a layer a step."""
    import torch
    model = slice13_model(WINDOW_MODEL, sliding_window=WINDOW)
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, WINDOW_PROMPT))).cuda()
    torch.cuda.synchronize()
    with finite_logits(model) as finite:
        reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(toks, cache_len=WINDOW_PROMPT + steps)
        nxt = logits.argmax(-1)
        out = [nxt]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(steps):
            nxt = model.decode_step(nxt, cache, WINDOW_PROMPT + i).argmax(-1)
            out.append(nxt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read_launches()
        if not bool(finite):
            raise AssertionError("window static batch: NaN or inf logits")
    at = WINDOW_PROMPT + steps

    def step():
        nonlocal nxt, at
        nxt = model.decode_step(nxt, cache, at).argmax(-1)
        at += 1
    by_kind = profile_calls(step, calls=4)
    busy = sum(by_kind.values())
    step_ms = (t2 - t1) * 1e3 / steps
    out = torch.stack(out)
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError("window static batch: token out of range")
    if tuple(cache["k"].shape) != (cfg.n_layers, B, WINDOW, cfg.n_kv_heads,
                                   cfg.hd):
        raise AssertionError(f"window ring shape {tuple(cache['k'].shape)}")
    want = {"paged_decode_attention": 0, "flash_attention": cfg.n_layers,
            "flash_prefix_attention": 0,
            "decode_attention": steps * cfg.n_layers}
    if launches != want:
        raise AssertionError(f"window static batch: launches {launches} != "
                             f"{want}")
    print(f"[slice13 window] {WINDOW_MODEL}, window {WINDOW}, on {card}: "
          f"{B} prompts x {WINDOW_PROMPT} tokens, one prefill "
          f"({(t1 - t0) * 1e3:.1f} ms) into a ring of {WINDOW} slots, then "
          f"{steps} greedy decode steps at one position across the wrap "
          f"(slots {WINDOW_PROMPT % WINDOW}..{(WINDOW_PROMPT + steps) % WINDOW}"
          f"): {(t2 - t1) * 1e3 / steps:.3f} ms a step, "
          f"{B * steps / (t2 - t1):.1f} output tok/s; launches {launches}")
    print(f"[slice13 window profile] on {card}: 4 more ring decode steps, "
          f"eager: device busy {busy:.3f} ms a step of the loop's "
          f"{step_ms:.3f} ms (idle {(1 - busy / step_ms) * 100:.1f}%); by "
          f"kind: {kind_parts(by_kind)}")
    del model, cache
    release()
    return launches


def slice13_window_check(errs, B=2, S=8200, steps=16):
    """internlm2-1.8b at full width in float32, 2 layers, window 8192:
    a prefill of ``B`` prompts of ``S`` > 8192 tokens (a ring that has
    wrapped) and ``steps`` decode steps on it, kernels against plain
    versions: tokens identical, logits within ``MODEL_TOL``."""
    import torch
    model = slice13_model(WINDOW_MODEL, dtype="float32", seed=8, n_layers=2,
                          sliding_window=WINDOW)
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, S))).cuda()

    def run():
        logits, cache = model.prefill(toks)
        out, nxt = [logits], logits.argmax(-1)
        history = [nxt]
        for i in range(steps):
            logits = model.decode_step(nxt, cache, S + i)
            nxt = logits.argmax(-1)
            out.append(logits)
            history.append(nxt)
        torch.cuda.synchronize()
        return out, torch.stack(history).tolist()

    reset_launches()
    kern, kern_tok = run()
    want = {"paged_decode_attention": 0, "flash_prefix_attention": 0,
            "flash_attention": cfg.n_layers,
            "decode_attention": steps * cfg.n_layers}
    if read_launches() != want:
        raise AssertionError(f"window check: launches {read_launches()}")
    with plain_attention():
        plain, plain_tok = run()
    err = max((a - b).abs().max().item() for a, b in zip(kern, plain))
    if err > MODEL_TOL or kern_tok != plain_tok:
        raise AssertionError(f"window check: logits differ by {err:.3e} or "
                             f"tokens differ: {kern_tok} vs {plain_tok}")
    errs["decode"]["window_model_check"] = err
    errs["flash"]["window_model_check"] = err
    print(f"[slice13 window check] {WINDOW_MODEL} width, 2 layers, float32, "
          f"window {WINDOW}: a prefill of {B} x {S} tokens (the ring "
          f"wrapped) and {steps} decode steps, kernels vs plain versions: "
          f"logits max abs err {err:.3e} (tolerance {MODEL_TOL}), greedy "
          f"tokens identical ({kern_tok[-1]})")
    del model
    release()


def phase_slice13(card, errs):
    """Slice 13's paths on the card, each model built, run and released
    before the next: the VLM's serves and its float32 check, the
    encoder's forward, the windowed static loop and its float32 check.
    Returns each path's launch counts."""
    by_path = slice13_vlm(card)
    phase_model(errs, VLM, VLM_CHECK_LAYERS, steps=16)
    by_path["encoder_forward"] = slice13_encoder(card)
    by_path["window_static"] = slice13_window(card)
    slice13_window_check(errs)
    return by_path


TRAIN_ARGV = ["--arch", MODEL, "--batch", "8", "--seq", "1024", "--steps",
              "10", "--lr", "3e-4", "--log-every", "1"]   # warmup 2
TRAIN_CHECK_LAYERS = {MODEL: 2, "olmoe-1b-7b": 2}   # float32, full width
TRAIN_CHECK = dict(batch=2, seq=256, steps=3)


def train_fn_check(card, errs):
    """``FlashAttentionFn`` at the training shape (OPT-1.3B's: B=8, S=1024,
    H=K=32, hd 64, causal), bf16 and float32: its output equal to the
    kernel called directly, bit for bit, its node the output's
    ``grad_fn``, and dq/dk/dv within ``TOL`` of autograd of the plain
    version. Then, in bf16, the device time of its backward (the dense
    float32 recompute and its gradient) beside the kernel's forward, the
    plain version and SDPA (:func:`time_flash`). Returns the times."""
    import torch
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     flash_attention,
                                                     flash_attention_torch)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, k, v = (t.requires_grad_() for t in flash_inputs(
            8, 1024, 1024, 32, 1, 64, dtype, seed=11))
        out = FlashAttentionFn.apply(q, k, v, True, None, None, 128, 128)
        if not torch.equal(out, flash_attention(q.detach(), k.detach(),
                                                v.detach(), causal=True)):
            raise AssertionError(f"FlashAttentionFn ({name}): output differs "
                                 f"from the kernel's")
        if not isinstance(out.grad_fn, FlashAttentionFn._backward_cls):
            raise AssertionError(f"FlashAttentionFn ({name}): grad_fn is "
                                 f"{type(out.grad_fn).__name__}")
        w = torch.randn(out.shape, generator=torch.Generator(
            "cuda").manual_seed(12), device="cuda").to(dtype)
        got = torch.autograd.grad(out, (q, k, v), w, retain_graph=True)
        want = torch.autograd.grad(
            flash_attention_torch(q, k, v, causal=True), (q, k, v), w)
        errs["flash"][f"train_fn_out_{name}"] = 0.0
        for n, a, b in zip("qkv", got, want):
            errs["flash_train"][f"d{n}_{name}"] = close(
                a, b, f"FlashAttentionFn d{n} ({name})")
        del got, want
        if dtype == torch.bfloat16:
            bwd_ms = time_ms(lambda: torch.autograd.grad(
                out, (q, k, v), w, retain_graph=True), runs=5, warmup=1)
            inputs = [t.detach() for t in (q, k, v)]
        del out, q, k, v, w
        release()
    print(f"[train] on {card}: FlashAttentionFn at B=8 S=1024 H=K=32 hd 64, "
          f"causal: output = the kernel's bit for bit, grad_fn its node "
          f"(bf16 and float32); gradients against autograd of the plain "
          f"version: max abs err " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs["flash_train"].items()))
    row = time_flash(card, "the training shape", inputs)
    print(f"[train] on {card}: FlashAttentionFn backward (dense float32 "
          f"recompute, autograd's gradient) {bwd_ms:.3f} ms a call in bf16, "
          f"against the kernel's forward {row['ms']:.3f} ms")
    return dict(row, backward_ms=bwd_ms)


def train_run(name, n_layers, batches, plain):
    """A float32 model at full width cut to ``n_layers`` (seed 1): the
    gradients of the first batch, then a train step on each batch (AdamW,
    lr 3e-4, warmup 2), through the kernels or (``plain``) their plain
    versions. Returns the gradients and parameters by path, the losses
    and the launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training import (AdamWConfig, TrainState, adamw_init,
                                      make_train_step)
    cfg = dataclasses.replace(get_config(name), n_layers=n_layers,
                              dtype="float32")
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(1))
    state = TrainState(model=model, opt_state=adamw_init(model.params))
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=2,
                                            total_steps=len(batches)))
    with plain_attention() if plain else contextlib.nullcontext():
        reset_launches()
        model.requires_grad_(True)
        leaves = tree_leaves(model.params)
        loss = model.loss(batches[0])
        grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(t) if g is None else g
                 for (k, t), g in zip(leaves, grads)}
        losses = [float(loss.detach())] + [float(step(state, b)["loss"])
                                  for b in batches]
        launches = read_launches()
    params = {k: t.detach() for k, t in tree_leaves(model.params)}
    return grads, params, losses, launches


def train_check(errs, name, n_layers, card):
    """The train path with the kernels against their plain versions, in
    float32 at full width cut to ``n_layers``: the first batch's loss and
    every gradient leaf (within 1e-4 of the leaf's largest magnitude),
    then three AdamW steps (each step's loss within 1e-5, the parameters
    within ``MODEL_TOL``); the kernel run launches the flash kernel twice
    an attention layer a pass (the forward and the block's recompute),
    the plain run none; the attention weights' gradients non-zero."""
    from repro_torch.configs import get_config
    from repro_torch.training import synthetic_batches
    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    data = synthetic_batches(cfg, batch=TRAIN_CHECK["batch"],
                             seq=TRAIN_CHECK["seq"], seed=0)
    batches = [next(data) for _ in range(TRAIN_CHECK["steps"])]
    kg, kp, kl, kn = train_run(name, n_layers, batches, plain=False)
    release()
    pg, pp, pl, pn = train_run(name, n_layers, batches, plain=True)
    release()
    passes = 1 + len(batches)
    want = {"paged_decode_attention": 0, "decode_attention": 0,
            "flash_prefix_attention": 0,
            "flash_attention": 2 * attention_layers(cfg) * passes}
    if kn != want or any(pn.values()):
        raise AssertionError(f"train check {name}: launches {kn} (kernels, "
                             f"want {want}) and {pn} (plain, want none)")
    loss_err = max(abs(a - b) for a, b in zip(kl, pl))
    grad_err = max((kg[k] - pg[k]).abs().max().item()
                   / max(pg[k].abs().max().item(), 1e-30) for k in kg)
    param_err = max((kp[k] - pp[k]).abs().max().item() for k in kp)
    dead = [k for k in kg if k.endswith(("/wq", "/wk", "/wv"))
            and not bool(kg[k].abs().max() > 0)]
    if loss_err > 1e-5 or grad_err > 1e-4 or param_err > MODEL_TOL or dead:
        raise AssertionError(
            f"train check {name}: losses {kl} vs {pl} ({loss_err:.3e}), "
            f"gradients {grad_err:.3e} of a leaf's largest, parameters "
            f"{param_err:.3e}; attention weights without a gradient: "
            f"{dead}")
    errs["flash_train"].update({f"{name}_loss": loss_err,
                                f"{name}_grad_rel": grad_err,
                                f"{name}_params": param_err})
    print(f"[train] {name} full width, {n_layers} layers, float32, "
          f"batch {TRAIN_CHECK['batch']} x {TRAIN_CHECK['seq']}: kernels "
          f"against plain versions: losses {', '.join(f'{x:.6f}' for x in kl)}"
          f" (max diff {loss_err:.3e}, tolerance 1e-5), gradients within "
          f"{grad_err:.3e} of each leaf's largest (1e-4), parameters after "
          f"{len(batches)} AdamW steps within {param_err:.3e} ({MODEL_TOL}); "
          f"launches {kn} (plain run none); wq/wk/wv gradients non-zero")
    del kg, kp, pg, pp
    release()


def train_microbatch_check(card):
    """``microbatches=2`` against 1 on two equal float32 states (OPT at
    full width, 2 layers, batch 4 x 256): the loss within 1e-4 (the
    reference's bound)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.training import (AdamWConfig, TrainState, adamw_init,
                                      make_train_step, synthetic_batches)
    cfg = dataclasses.replace(get_config(MODEL), n_layers=2,
                              dtype="float32")
    batch = next(synthetic_batches(cfg, batch=4, seq=256, seed=0))
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    losses = []
    for mb in (1, 2):
        model = Model(cfg, generator=torch.Generator("cuda").manual_seed(1))
        state = TrainState(model=model, opt_state=adamw_init(model.params))
        losses.append(float(make_train_step(cfg, opt, mb)(state,
                                                          batch)["loss"]))
        del model, state
        release()
    if abs(losses[0] - losses[1]) > 1e-4:
        raise AssertionError(f"microbatches 2 against 1: losses {losses}")
    print(f"[train] on {card}: microbatches 2 against 1 (float32, 2 layers, "
          f"batch 4 x 256): loss {losses[1]:.6f} against {losses[0]:.6f} "
          f"(within 1e-4)")


def train_checkpoint_check(card):
    """A bf16 state (OPT's family at ``reduced`` size: the format, not the
    bytes, is checked; after one step) saved and loaded on the card:
    every parameter (bf16 as 2-byte words) and optimizer leaf equal bit
    for bit, the step kept."""
    import tempfile
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.params import tree_leaves
    from repro_torch.training import (AdamWConfig, TrainState,
                                      load_checkpoint, make_train_step,
                                      save_checkpoint, synthetic_batches)
    cfg = dataclasses.replace(reduced(get_config(MODEL)), dtype="bfloat16")
    state = TrainState.create(cfg, seed=2)
    make_train_step(cfg, AdamWConfig())(state, next(synthetic_batches(
        cfg, batch=2, seq=256, seed=0)))
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "state.npz")
        t0 = time.perf_counter()
        save_checkpoint(path, state.params, state.opt_state, step=1)
        p, o, step = load_checkpoint(path, state.params, state.opt_state)
        secs = time.perf_counter() - t0
    pairs = list(zip(tree_leaves((state.params, state.opt_state)),
                     tree_leaves((p, o))))
    bad = [k for (k, a), (_, b) in pairs
           if a.dtype != b.dtype or a.device != b.device
           or not torch.equal(a, b)]
    if bad or step != 1 or state.params["embed"]["tok"].dtype != \
            torch.bfloat16:
        raise AssertionError(f"checkpoint round trip: {bad}, step {step}")
    nbytes = sum(t.numel() * t.element_size() for _, t in tree_leaves((p, o)))
    print(f"[train] on {card}: checkpoint of a bf16 state ({cfg.name} "
          f"reduced, "
          f"{len(pairs)} leaves, {nbytes / 1e9:.2f} GB) saved and loaded "
          f"in {secs:.1f} s: every leaf equal bit for bit, on the card")
    del state, p, o
    release()


def train_full(card):
    """The main path: ``repro_torch.launch.train.main`` in process at
    OPT-1.3B's full width and depth (bf16 weights, float32 moments,
    ``synthetic_batches`` batch 8 x 1024 from seed 0, 10 steps, lr 3e-4,
    warmup 2), its launch counts read around it: the flash kernel
    exactly 2 x 24 a step (each block's forward and its recompute), no
    other kernel; every loss finite and the last below the first. Then a
    step of a fresh state of the same run, profiled: device busy by
    kernel kind against the host wall of an unprofiled step. Returns the
    launch counts and the numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.training import (AdamWConfig, TrainState, adamw_init,
                                      make_train_step, synthetic_batches)
    cfg = get_config(MODEL)
    steps = int(TRAIN_ARGV[TRAIN_ARGV.index("--steps") + 1])
    release()
    reset_launches()
    t0 = time.perf_counter()
    records = launch_train.main(TRAIN_ARGV)
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {"paged_decode_attention": 0, "decode_attention": 0,
            "flash_prefix_attention": 0,
            "flash_attention": 2 * cfg.n_layers * steps}
    losses = [r["loss"] for r in records]
    if launches != want:
        raise AssertionError(f"train: launches {launches} != {want}")
    if len(records) != steps or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses} not finite or not "
                             f"falling")
    release()
    # a fresh state of the same run for the profile (the launcher's is gone)
    model = launch_train.make_model(cfg, torch.device("cuda"))
    state = TrainState(model=model, opt_state=adamw_init(model.params))
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=2,
                                            total_steps=steps))
    data = synthetic_batches(cfg, batch=8, seq=1024, seed=0)
    batch = next(data)
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) * 1e3
    reset_launches()
    by_kind = profile_calls(lambda: step(state, batch))   # warm + profiled
    two = read_launches()["flash_attention"]
    if two != 2 * 2 * cfg.n_layers:
        raise AssertionError(f"train: {two} flash launches in two steps")
    busy = sum(by_kind.values())
    last = records[-1]
    print(f"[train] on {card}: {MODEL} full width and depth, bf16, batch 8 x "
          f"1024, {steps} steps through the launcher in {wall:.1f} s: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches {launches} "
          f"({2 * cfg.n_layers} flash a step); last step device "
          f"{last['device_ms']:.2f} ms, {last['tokens_per_s']:.0f} tok/s, "
          f"MFU {last['mfu'] * 100:.1f}%, peak {last['peak_gb']:.2f} GB")
    print(f"[train profile] on {card}: one step: device busy {busy:.3f} ms, "
          f"host wall {step_wall:.3f} ms unprofiled, so the device idles "
          f"{(1 - busy / step_wall) * 100:.1f}%; by kind: "
          f"{kind_parts(by_kind)}")
    del model, state, step
    release()
    return launches, dict(records=records, busy_ms=busy, wall_ms=step_wall,
                          by_kind=by_kind)


def phase_train(card, errs):
    """Training on the card: the Function alone, the float32 train checks,
    microbatching, a checkpoint, then the full-width launcher run.
    Returns the launcher run's launch counts and the numbers."""
    fn_times = train_fn_check(card, errs)
    for name, n_layers in TRAIN_CHECK_LAYERS.items():
        train_check(errs, name, n_layers, card)
    train_microbatch_check(card)
    train_checkpoint_check(card)
    launches, numbers = train_full(card)
    share = fn_times["backward_ms"] * LAYERS / \
        numbers["records"][-1]["device_ms"]
    print(f"[train] on {card}: the Function's backward, "
          f"{fn_times['backward_ms']:.3f} ms a layer x {LAYERS} layers, is "
          f"{share * 100:.1f}% of the last step's device time")
    predicted = train_prediction(card, numbers["records"])
    return launches, dict(numbers, fn=fn_times, backward_share=share,
                          dryrun=predicted)


def train_prediction(card, records):
    """The dry-run's case for the launcher's run (OPT-1.3B, a train step
    of 8 x 1024 on a 1 x 1 mesh): its predicted peak memory and step
    terms beside what the launcher measured."""
    from repro_torch.configs import get_config
    from repro_torch.core.census import dryrun_census
    from repro_torch.core.roofline import roofline_report
    from repro_torch.launch.dryrun import case_memory, case_step
    from repro_torch.launch.input_specs import ShapeSpec, case_for
    from repro_torch.launch.mesh import make_mesh
    case = case_for(get_config(MODEL), ShapeSpec("train_8x1024", "train",
                                                 1024, 8),
                    make_mesh((1, 1), ("data", "model")))
    mem = case_memory(case)
    rep = roofline_report(dryrun_census(case.cfg, case_step(case)),
                          card_peaks())
    peak = max(r["peak_gb"] for r in records)
    step_ms = records[-1]["device_ms"]
    print(f"[train dryrun] on {card}: {MODEL}, 8 x 1024, 1 x 1 mesh, "
          f"{case.microbatches} microbatch: predicted peak "
          f"{mem['peak_bytes'] / 1e9:.2f} GB (arguments "
          f"{mem['argument_bytes'] / 1e9:.2f}, working set "
          f"{mem['temp_bytes'] / 1e9:.2f}) against {peak:.2f} GB measured "
          f"({peak / (mem['peak_bytes'] / 1e9):.3f} x); predicted step "
          f"max(compute {rep.compute_s * 1e3:.1f}, memory "
          f"{rep.memory_s * 1e3:.1f}) ms against {step_ms:.1f} ms measured")
    return dict(peak_gb=mem["peak_bytes"] / 1e9, measured_peak_gb=peak,
                compute_ms=rep.compute_s * 1e3, memory_ms=rep.memory_s * 1e3)


# the one-device cases the dry-run says fit the card (its 1 x 1 records;
# the phase fails if the dry-run finds another set)
DRYRUN_FIT = (("phi3-mini-3.8b", "long_500k"),
              ("internlm2-1.8b", "long_500k"),
              ("deepseek-coder-33b", "long_500k"),
              ("qwen2.5-3b", "long_500k"),
              ("mamba2-1.3b", "long_500k"),
              ("mamba2-1.3b", "decode_32k"))
DRYRUN_STEPS = 4
ARG_TOL = 1e-3               # allocated arguments against the prediction
PEAK_TOL = 0.10              # measured peak against the predicted peak
# kernels vs plain at the logits after DRYRUN_STEPS full-depth bf16 steps,
# of the largest logit: above the spread of two other correct versions of
# the contiguous attention (the plain one in 256-row tiles, SDPA; up to
# 7.0e-2 on the card) and below each planted fault (from 0.67), all read
# in every run (PERF.md §6)
DEEP_TOL = 1e-1
# a greedy token may differ from the plain run's only where the plain
# run's token is within this many bf16 ulps of the kernel run's top logit
TIE_ULPS = 4


def dryrun_meta(card):
    """(a) The dry-run of every arch x shape x {pod16x16, pod2x16x16,
    1x1}, meta tensors only, priced on the H100: one line a case, no
    error, and exactly hubert's decode shapes skipped. Writes every
    record to ``chiprun_out/dryrun.json``; returns the 1 x 1 records."""
    from repro_torch.configs import ASSIGNED
    from repro_torch.launch.dryrun import MESHES, run_case
    from repro_torch.launch.input_specs import SHAPES
    t0 = time.perf_counter()
    # the one-device cases' dispatch census is taken where they run
    # (dryrun_case): a train case's takes tens of seconds on the host
    recs = [run_case(arch, shape, mesh, None, verbose=False,
                     dispatched=False)
            for arch in ASSIGNED for shape in SHAPES for mesh in MESHES]
    seconds = time.perf_counter() - t0
    for r in recs:
        if r["status"] != "ok":
            print(f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']}: "
                  f"{r['status']} ({r.get('reason') or r.get('error')})")
            continue
        print(f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']}: C "
              f"{r['compute_s'] * 1e3:.3f} M {r['memory_s'] * 1e3:.3f} X "
              f"{r['collective_s'] * 1e3:.3f} ms -> {r['dominant']}, "
              f"{r['memory']['peak_bytes'] / 1e9:.2f} GB a device "
              f"(arguments {r['memory']['argument_bytes'] / 1e9:.2f}), "
              f"fits: {r['fits_hbm']}")
    errors = [r for r in recs if r["status"] == "error"]
    skips = {(r["arch"], r["shape"], r["mesh"]) for r in recs
             if r["status"] == "skip"}
    want = {("hubert-xlarge", s, m) for s in ("decode_32k", "long_500k")
            for m in MESHES}
    print(f"[dryrun] on {card}: {len(recs)} cases priced in {seconds:.2f} s "
          f"(no device touched): {len(recs) - len(skips) - len(errors)} ok, "
          f"{len(skips)} skipped, {len(errors)} errors")
    if errors or skips != want:
        bad = [(r["arch"], r["shape"], r["mesh"], r["error"])
               for r in errors]
        raise AssertionError(f"dry-run: errors {bad}, skips "
                             f"{sorted(skips)} (want {sorted(want)})")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "dryrun.json").write_text(json.dumps(recs, default=float))
    one = {(r["arch"], r["shape"]): r for r in recs
           if r["mesh"] == "1x1" and r["status"] == "ok"}
    fit = sorted(k for k, r in one.items()
                 if r["fits_hbm"] and SHAPES[k[1]].kind == "decode")
    if fit != sorted(DRYRUN_FIT):
        raise AssertionError(f"dry-run: the one-device decode cases that "
                             f"fit are {fit}, not {sorted(DRYRUN_FIT)}")
    return one


def dryrun_steps(model, cache, tokens, pos, steps, feed=None):
    """``steps`` greedy decode steps from ``tokens`` at ``pos``; each next
    input is ``feed[i]`` where given (the kernel run's tokens), else the
    step's own argmax. Returns (logits, tokens), stacked."""
    import torch
    logits, toks = [], []
    tok = tokens
    for i in range(steps):
        out = model.decode_step(tok, cache, pos + i)
        logits.append(out)
        toks.append(out.argmax(-1).to(torch.int32))
        tok = toks[-1] if feed is None else feed[i]
    return torch.stack(logits), torch.stack(toks)


def one_tile_plain(q, k, v, lengths):
    """The contiguous kernel's plain version in one tile of the whole
    cache: the same function for rows of length > 0 (every row of the
    dry-run's cases), in a 32nd of the launches of 256-row tiles."""
    from repro_torch.kernels.decode_attention import \
        gqa_decode_attention_torch
    return gqa_decode_attention_torch(q, k, v, lengths, block_s=k.shape[1])


def sdpa_decode(q, k, v, lengths):
    """The contiguous decode attention through SDPA with a length mask:
    a library's version, a witness of the noise floor."""
    import torch
    import torch.nn.functional as F
    S = k.shape[1]
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)[:, :, 0, :]


def fault_split_dropped(q, k, v, lengths):
    """The kernel with its first 256-row split dropped: a planted fault."""
    from repro_torch.kernels.decode_attention import gqa_decode_attention
    return gqa_decode_attention(q, k[:, 256:].contiguous(),
                                v[:, 256:].contiguous(), lengths - 256)


def fault_head_mixed(q, k, v, lengths):
    """The kernel with the last query head's row taken from its
    neighbour: a planted fault."""
    from repro_torch.kernels.decode_attention import gqa_decode_attention
    out = gqa_decode_attention(q, k, v, lengths)
    out[:, -1] = out[:, -2]
    return out


# the witnesses of the logits check, each run from the same cache and fed
# the kernel run's tokens: (name, the model's contiguous attention, noise
# or fault)
DEEP_WITNESSES = (("plain, 256-row tiles", None, "noise"),
                  ("SDPA", sdpa_decode, "noise"),
                  ("a split dropped", fault_split_dropped, "fault"),
                  ("a head's row mixed up", fault_head_mixed, "fault"))


@contextlib.contextmanager
def checked_decode_attention():
    """The model's contiguous decode attention through the kernel, each
    call also held to the plain version on the same inputs
    (:func:`row_close`); yields the worst error, the largest |plain| and
    the calls."""
    from repro_torch.kernels import ops
    saved = ops.decode_attention
    worst = {"err": 0.0, "top": 0.0, "calls": 0}

    def call(q, k, v, lengths, **kw):
        out = saved(q, k, v, lengths, **kw)
        e, top = row_close(out, one_tile_plain(q, k, v, lengths),
                           "contiguous decode in the model")
        worst["err"] = max(worst["err"], e)
        worst["top"] = max(worst["top"], top)
        worst["calls"] += 1
        return out
    ops.decode_attention = call
    try:
        yield worst
    finally:
        ops.decode_attention = saved


def deep_gap(logits, ref):
    """Max abs difference of two runs' logits, of ``ref``'s largest."""
    return ((logits - ref).abs().max() / ref.abs().max()).item()


def untied(k_logits, k_toks, toks):
    """Steps and rows where ``toks`` differ from the kernel run's greedy
    tokens by more than a tie: ``toks``' logit in the kernel run more
    than ``TIE_ULPS`` bf16 ulps under the kernel run's top logit.
    Returns (differing, past a tie, the largest gap in ulps)."""
    import torch
    differ = k_toks != toks
    top = k_logits.max(-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30)))
                     - 7)
    gap = (top - k_logits.gather(-1, toks.long()[..., None])[..., 0]) / ulp
    gap = gap[differ]
    return (int(differ.sum()), int((gap > TIE_ULPS).sum()),
            gap.max().item() if gap.numel() else 0.0)


TEMP_TOL = 0.02              # dispatched temporaries against the measured


def dryrun_census_check(card, case, args, measured_temp, resident):
    """(b, c) The census of a one-device case's step: taken on the card
    with the materialized arguments and on the case's meta arguments,
    equal class by class (FLOPs, bytes, launches) and in temporaries;
    the meta census's temporaries against the allocator's measured peak
    less the arguments (``TEMP_TOL`` printed as met or not), the gap
    split into what the allocator holds between steps (``resident``),
    the census run's own allocator peak and its allocations at operation
    boundaries; an SSM model's ``ssm`` bytes in passes over its layers'
    float32 state. Returns the numbers."""
    import torch
    from repro_torch.core.analysis import DispatchCensus, census_of
    from repro_torch.launch.dryrun import dispatched_record
    from repro_torch.models.params import ssm_dims

    class Watched(DispatchCensus):
        """The census, reading the allocator after each operation."""
        def __init__(self):
            super().__init__()
            self.base = torch.cuda.memory_allocated()
            self.seen = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            self.seen = max(self.seen,
                            torch.cuda.memory_allocated() - self.base)
            return out

    cfg = case.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Watched() as cen:
        case.fn(*args)
    torch.cuda.synchronize()
    run_peak = torch.cuda.max_memory_allocated() - cen.base
    on_card = dispatched_record(cen.result())
    t0 = time.perf_counter()
    meta = dispatched_record(census_of(case.fn, *case.args))
    meta_s = time.perf_counter() - t0
    if on_card != meta:
        raise AssertionError(f"census of {case.arch} x {case.shape.name}: "
                             f"card {on_card} != meta {meta}")
    gap = meta["temp_bytes"] / measured_temp - 1
    per = "; ".join(f"{k} {v['bytes'] / 1e9:.4f} GB, {v['launches']}"
                    for k, v in sorted(meta["per_class"].items()))
    passes = None
    if cfg.ssm is not None:
        _, nh, _ = ssm_dims(cfg)
        state = case.shape.batch * nh * cfg.ssm.head_dim \
            * cfg.ssm.d_state * 4
        layers = cfg.block_plan().count("ssm")
        passes = meta["per_class"]["ssm"]["bytes"] / (layers * state)
    print(f"[census dryrun] {case.arch} x {case.shape.name} on {card}: the "
          f"step's census on the card equals its census on meta tensors "
          f"({meta_s:.2f} s on the host): {meta['bytes'] / 1e9:.4f} GB, "
          f"{meta['launches']} launches ({meta['kernel_launches']} of the "
          f"kernels); by class (GB, launches): {per}; temporaries "
          f"{meta['temp_bytes']:.0f} B against the measured peak less the "
          f"arguments {measured_temp} B ({gap:+.2%}, within "
          f"{TEMP_TOL:.0%}: {'yes' if abs(gap) <= TEMP_TOL else 'no'}): "
          f"held between steps {resident} B, the census run's allocator "
          f"peak {run_peak} B, at operation boundaries {cen.seen} B"
          + ("" if passes is None else
             f"; the ssm class moves {passes:.2f} x its {layers} layers' "
             f"float32 state ({state / 1e6:.1f} MB a layer)"))
    return dict(census=meta, temp_gap=gap, ssm_passes=passes,
                resident=resident, run_peak=run_peak, boundary=cen.seen)


def dryrun_case(card, arch, shape, rec):
    """(b) One case the dry-run says fits, at full width and depth:
    materialized on the card (arguments held within ``ARG_TOL`` of the
    predicted ``argument_bytes``, the model on those leaves without a
    copy); ``DRYRUN_STEPS`` greedy decode steps through the kernels, each
    attention call also held to its plain version on the same inputs
    (contiguous launches exactly attention layers x steps); the same
    steps through the plain versions (the contiguous one in one tile,
    :func:`one_tile_plain`) from the same cache, fed the kernel run's
    tokens (no launch; the same greedy tokens but at a tie of
    ``TIE_ULPS``, logits within ``DEEP_TOL`` of the largest); with
    attention layers, each of ``DEEP_WITNESSES`` the same way, the noise
    within ``DEEP_TOL`` and each fault past it; then the step alone: its
    device ms (eager, CUDA events, median) against the dry-run's
    ``max(compute_s, memory_s)``, its peak memory within ``PEAK_TOL`` of
    the predicted ``peak_bytes``, and a profile of its device time by
    kernel kind."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.input_specs import build_case, materialize
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import Model
    release()
    mesh = make_test_mesh()
    case = build_case(arch, shape, mesh)
    cfg = case.cfg
    base = torch.cuda.memory_allocated()
    params, cache, tokens, pos = materialize(
        case, mesh, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    want = rec["memory"]["argument_bytes"]
    if abs(held - want) > ARG_TOL * want:
        raise AssertionError(f"{arch} {shape}: {held} bytes held, "
                             f"{want:.0f} predicted")
    model = Model(cfg, params, device=mesh.devices.flat[0])
    if torch.cuda.memory_allocated() - base != held:
        raise AssertionError(f"{arch} {shape}: the model copied its weights")
    snapshot = {n: t.clone() for n, t in cache.items()}
    n_attn = attention_layers(cfg)
    reset_launches()
    with checked_decode_attention() as in_situ:
        k_logits, k_toks = dryrun_steps(model, cache, tokens, pos,
                                        DRYRUN_STEPS)
    torch.cuda.synchronize()
    launches = read_launches()
    want_launches = {"paged_decode_attention": 0, "flash_attention": 0,
                     "flash_prefix_attention": 0,
                     "decode_attention": n_attn * DRYRUN_STEPS}
    if launches != want_launches or in_situ["calls"] != n_attn * DRYRUN_STEPS:
        raise AssertionError(f"{arch} {shape}: launches {launches} != "
                             f"{want_launches}")

    def fed_run(attention):
        for name in cache:
            cache[name].copy_(snapshot[name])
        with plain_attention():
            if attention is not None:
                ops.decode_attention = attention
            logits, toks = dryrun_steps(model, cache, tokens, pos,
                                        DRYRUN_STEPS, feed=k_toks)
        torch.cuda.synchronize()
        return logits, toks

    reset_launches()
    p_logits, p_toks = fed_run(one_tile_plain)
    if any(read_launches().values()):
        raise AssertionError(f"{arch} {shape}: the plain run launched "
                             f"{read_launches()}")
    if not bool(torch.isfinite(k_logits).all() and
                torch.isfinite(p_logits).all()):
        raise AssertionError(f"{arch} {shape}: non-finite logits")
    rel = deep_gap(k_logits, p_logits)
    ties, past, worst_ulps = untied(k_logits, k_toks, p_toks)
    witnesses = {}
    for name, attention, role in (DEEP_WITNESSES if n_attn else ()):
        w_logits, w_toks = fed_run(attention)
        witnesses[name] = (role, deep_gap(w_logits, p_logits),
                           untied(k_logits, k_toks, w_toks)[0])
        del w_logits
    del snapshot
    wit = "; ".join(f"{n} ({r}) {g:.2e}, {d} tokens differ"
                    for n, (r, g, d) in witnesses.items())
    print(f"[dryrun deep] {arch} x {shape}: logits against the plain run "
          f"(one tile), of the largest ({p_logits.abs().max().item():.3f})"
          f": kernels {rel:.2e}, {ties} of {k_toks.numel()} tokens differ "
          f"(largest gap {worst_ulps:.1f} bf16 ulps of the top logit)"
          f"{'; ' + wit if wit else ''}; DEEP_TOL {DEEP_TOL}")
    if rel > DEEP_TOL:
        raise AssertionError(f"{arch} {shape}: logits differ by {rel:.3e} "
                             f"of the largest")
    if past:
        raise AssertionError(f"{arch} {shape}: {past} greedy tokens differ "
                             f"past a tie of {TIE_ULPS} ulps: kernels "
                             f"{k_toks.flatten().tolist()[:16]} vs plain "
                             f"{p_toks.flatten().tolist()[:16]}")
    for name, (role, gap, _) in witnesses.items():
        if (gap > DEEP_TOL) != (role == "fault"):
            raise AssertionError(f"{arch} {shape}: DEEP_TOL {DEEP_TOL} does "
                                 f"not part noise from faults: {name} "
                                 f"({role}) at {gap:.3e}")
    # the runs' logits go before the step's peak is read: it is the
    # step's working set, not the checks' (4 steps x B x vocab in f32)
    del k_logits, p_logits
    step = lambda: model.decode_step(tokens, cache, pos)  # noqa: E731
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(step, runs=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() - base
    pred_peak = rec["memory"]["peak_bytes"]
    if abs(peak - pred_peak) > PEAK_TOL * pred_peak:
        raise AssertionError(f"{arch} {shape}: peak {peak / 1e9:.3f} GB, "
                             f"{pred_peak / 1e9:.3f} GB predicted")
    by_kind = profile_calls(step)
    busy = sum(by_kind.values())
    bound_ms = max(rec["compute_s"], rec["memory_s"]) * 1e3
    # what the allocator holds between steps beyond the arguments, part
    # of the peak but of no step's temporaries
    resident = torch.cuda.memory_allocated() - base - held
    census = dryrun_census_check(card, case, (params, cache, tokens, pos),
                                 peak - held, resident)
    print(f"[dryrun run] {arch} x {shape} on {card}: B={case.shape.batch}, "
          f"{cfg.n_layers} layers, position {int(pos)} "
          f"({case.kv_len} cache slots), {cfg.dtype}: arguments "
          f"{held / 1e9:.3f} GB held, {want / 1e9:.3f} predicted "
          f"({held / want - 1:+.2e}); {DRYRUN_STEPS} steps: each "
          f"attention call against its plain version max abs err "
          f"{in_situ['err']:.2e}, largest |plain| {in_situ['top']:.2e} "
          f"({in_situ['calls']} calls), contiguous "
          f"launches {launches['decode_attention']} = {n_attn} x "
          f"{DRYRUN_STEPS}; kernels vs plain at the logits: max abs err "
          f"{rel:.2e} of the largest, {DRYRUN_STEPS * case.shape.batch - ties}"
          f" of {DRYRUN_STEPS * case.shape.batch} greedy tokens equal"
          f"{f' ({ties} at a tie)' if ties else ''}; a step {step_ms:.3f} ms "
          f"(eager, CUDA events, median of 10), peak {peak / 1e9:.3f} GB "
          f"({pred_peak / 1e9:.3f} predicted, {peak / pred_peak - 1:+.3f}), "
          f"against the dry-run's max(compute, memory) {bound_ms:.3f} ms "
          f"({step_ms / bound_ms:.2f} x); device busy {busy:.3f} ms "
          f"(idle {(1 - busy / step_ms) * 100:.1f}%): {kind_parts(by_kind)}")
    del model, params, cache, tokens
    release()
    return dict(launches=launches, step_ms=step_ms, bound_ms=bound_ms,
                busy_ms=busy, by_kind=by_kind, held=held,
                argument_bytes=want, peak=peak, peak_bytes=pred_peak,
                rel_err=rel, in_situ_err=in_situ["err"], ties=ties,
                witnesses=witnesses, census=census)


def phase_dryrun(card, errs):
    """The dry-run (a) and its one-device cases on the card (b). Returns
    the cases' launches, summed, and each case's numbers."""
    one = dryrun_meta(card)
    runs = {f"{a} x {s}": dryrun_case(card, a, s, one[(a, s)])
            for a, s in DRYRUN_FIT}
    errs["decode"]["dryrun_model_calls"] = max(
        r["in_situ_err"] for r in runs.values())
    launches = {}
    for r in runs.values():
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches, runs


# ------------------------------------------------------------ examples ----
EXAMPLE_ARCH = "qwen2.5-3b"  # quickstart's default architecture
EXAMPLE_TRAIN = dict(steps=50, batch=8, seq=128)   # train_tiny on the card


def example_run(card, name, fn, want=None, need=()):
    """Run one example (``fn``, its ``run``) with every launch counter set
    to 0 just before and read just after, recording the engines it
    builds: each kernel must have launched exactly once a layer of each
    of their steps of its kind, plus ``want`` (an example's work outside
    an engine), every kernel of ``need`` at least once, and every engine
    kept its logits finite. Returns the example's result and the launch
    counts."""
    import torch
    release()
    print(f"[examples {name}] on {card}: "
          f"python -m repro_torch.examples.{name}'s run, full width")
    t0 = time.perf_counter()
    with recorded_engines() as made:
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = read_launches()
    wall = time.perf_counter() - t0
    expected = expected_launches(made)
    for k, v in (want or {}).items():
        expected[k] += v
    if launches != expected:
        raise AssertionError(f"[examples {name}] launch counts {launches} "
                             f"!= {expected}")
    if not all(bool(e.steps.finite) for e in made):
        raise AssertionError(f"[examples {name}] NaN or inf logits")
    missing = [k for k in need if not launches[k]]
    if missing:
        raise AssertionError(f"[examples {name}] {missing} never launched: "
                             f"{launches}")
    print(f"[examples {name}] on {card}: {wall:.1f} s, {len(made)} "
          f"engine(s); launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items() if v) +
          (" (= each engine's steps x layers"
           + (" + the work outside an engine" if want else "") + ")"
           if any(launches.values()) else "none"))
    made.clear()
    return out, launches


def example_kernels(errs):
    """Each kernel against its plain version at a shape an example gives
    it that phase 2 does not reach: the paged kernel at block size 8
    (``speculative_decode``), the contiguous one at qwen2.5-3b's K 2, G 8,
    hd 128 over ``quickstart``'s 24-slot cache, the flash kernel in
    float32 at ``train_tiny``'s G 3 (B=8, S=128, 12 heads, hd 64)."""
    import torch
    from repro_torch.kernels.decode_attention import (
        gqa_decode_attention, gqa_decode_attention_torch)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    from repro_torch.kernels.paged_decode_attention import (
        paged_gqa_decode_attention, paged_gqa_decode_attention_torch)
    args = paged_inputs(4, 32, 1, 64, 8, 32, torch.bfloat16,
                        [96, 65, 1, 256], seed=27)
    errs["paged"]["examples"] = close(
        paged_gqa_decode_attention(*args),
        paged_gqa_decode_attention_torch(*args), "paged BS=8")
    args = decode_inputs(2, 24, 2, 8, 128, torch.bfloat16, [17, 22],
                         seed=28)
    errs["decode"]["examples"] = close(gqa_decode_attention(*args),
                                       gqa_decode_attention_torch(*args),
                                       "contiguous K=2 G=8 hd=128")
    q, k, v = flash_inputs(8, 128, 128, 4, 3, 64, torch.float32, seed=29)
    errs["flash"]["examples"] = close(flash_attention(q, k, v),
                                      flash_attention_torch(q, k, v),
                                      "flash f32 G=3")
    print(f"[examples] kernels at the examples' shapes against their plain "
          f"versions: paged at block size 8 (B=4, K=32, hd 64, bf16) max "
          f"abs err {errs['paged']['examples']:.3e}; contiguous at K 2, "
          f"G 8, hd 128 (B=2, S=24, bf16) {errs['decode']['examples']:.3e}; "
          f"flash at G 3 (B=8, S=128, K=4, hd 64, float32) "
          f"{errs['flash']['examples']:.3e}; within tolerance")


def phase_examples(model, card, errs):
    """The port's seven examples (``repro_torch.examples``), each ``run``
    at full width on the card: the analytic BCA loop; the quickstart at
    ``EXAMPLE_ARCH`` in bf16 (the forward and prefill through the flash
    kernel, six dense-cache decode steps through the contiguous kernel;
    the forward's logits held within ``DEEP_TOL`` of the plain versions'
    run); ``serve_engine``, ``stream_generate``, ``speculative_decode``
    and ``serve_cluster`` (R=2 co-located on this card) on the loaded
    OPT-1.3B; ``train_tiny``'s configuration for ``EXAMPLE_TRAIN`` steps
    (the flash kernel twice a layer a step), the loss falling and the
    checkpoint written. Every example's own assertions hold; each
    kernel is held against its plain version at the examples' shapes
    phase 2 does not reach (:func:`example_kernels`). Returns each
    example's launch counts."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.examples import (bca_replication, card_hardware,
                                      quickstart, serve_cluster,
                                      serve_engine, speculative_decode,
                                      stream_generate, train_tiny)
    from repro_torch.models.model import Model
    example_kernels(errs)
    hw, label = card_hardware(torch.device("cuda"))
    paths = {}
    paged = ("paged_decode_attention", "flash_attention")

    _, paths["examples_bca_replication"] = example_run(
        card, "bca_replication", bca_replication.run)

    full = get_config(EXAMPLE_ARCH)
    qs = Model(full)
    tokens = quickstart.prompt(full)
    n = attention_layers(full)
    got, paths["examples_quickstart"] = example_run(
        card, "quickstart",
        lambda: quickstart.run(qs, full, tokens, hw, label),
        want={"flash_attention": 2 * n,
              "decode_attention": quickstart.DECODE_STEPS * n},
        need=("flash_attention", "decode_attention"))
    logits = got["logits"]
    if tuple(logits.shape) != (quickstart.B, quickstart.S, full.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[examples quickstart] logits "
                             f"{tuple(logits.shape)}, or not finite")
    with plain_attention():
        plain = quickstart.run(qs, full, tokens, hw, label, echo=False)
    gap = ((logits - plain["logits"]).abs().max()
           / plain["logits"].abs().max()).item()
    if gap > DEEP_TOL:
        raise AssertionError(f"[examples quickstart] the forward's logits "
                             f"{gap:.3e} of the largest from the plain "
                             f"versions' run")
    same = sum(a == b for a, b in zip(got["tokens"], plain["tokens"]))
    print(f"[examples quickstart] on {card}: the forward's logits within "
          f"{gap:.3e} of the largest of the plain versions' run "
          f"(DEEP_TOL {DEEP_TOL}); decoded tokens {same}/"
          f"{len(got['tokens'])} equal to it")
    del qs, got, plain
    release()

    vocab = model.cfg.vocab_size
    got, paths["examples_serve_engine"] = example_run(
        card, "serve_engine", lambda: serve_engine.run(model), need=paged)
    want = [r.max_new_tokens for r in serve_engine.workload(vocab)]
    for mb, outs in got["outputs"].items():
        if [len(o) for o in outs] != want or \
                not all(0 <= t < vocab for o in outs for t in o):
            raise AssertionError(f"[examples serve_engine] max_batch {mb}: "
                                 f"lengths or tokens out of range")

    _, paths["examples_stream_generate"] = example_run(
        card, "stream_generate", lambda: stream_generate.run(model),
        need=paged)

    _, paths["examples_speculative_decode"] = example_run(
        card, "speculative_decode",
        lambda: speculative_decode.run(model, model.cfg), need=paged)

    got, paths["examples_serve_cluster"] = example_run(
        card, "serve_cluster", lambda: serve_cluster.run(
            model.cfg, model.params,
            serve_cluster.devices_for(torch.device("cuda")), hw),
        need=paged)
    if got["branch"] != ("colocated" if torch.cuda.device_count() < 2
                         else "sliced"):
        raise AssertionError(f"[examples serve_cluster] {got['branch']}")
    del got

    tiny = Model(train_tiny.tiny_config())
    steps = EXAMPLE_TRAIN["steps"]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "tiny_ckpt.npz")
        got, paths["examples_train_tiny"] = example_run(
            card, "train_tiny",
            lambda: train_tiny.run(tiny, checkpoint=ckpt, **EXAMPLE_TRAIN),
            want={"flash_attention": steps * 2 * tiny.cfg.n_layers},
            need=("flash_attention",))
        saved = int(np.load(ckpt)["__step__"])
    losses = got["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            saved != steps:
        raise AssertionError(f"[examples train_tiny] losses {losses[0]} -> "
                             f"{losses[-1]}, checkpoint step {saved}")
    ms = [r["device_ms"] for r in got["records"]]
    print(f"[examples train_tiny] on {card}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over {steps} steps; device ms a printed step "
          f"{', '.join(f'{m:.2f}' for m in ms)} (the first includes the "
          f"kernels' first calls); checkpoint of step {saved} written")
    del tiny, got
    release()
    return paths


def phase(name, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


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
    phase("0, build", phase_build)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    errs = {"paged": {"sweep": 0.0}, "decode": {},
            "flash": {"reference_cases": 0.0, "serving_shape": 0.0},
            "flash_prefix": {}, "flash_train": {}}
    phase("2, kernels", phase_kernels, errs)
    for name, n_layers in MODEL_CHECK_LAYERS.items():
        phase(f"3, model {name}", phase_model, errs, name, n_layers)
    phase("3, prefill modes", phase_model_prefill_modes, errs)
    phase("3, speculation", phase_model_speculative, errs)
    phase("3, cluster", phase_model_cluster)
    model = full_model()
    by_path = {"paged_serve": None, "gather_serve": None,
               "static_batch": None, "prefix_serve": None,
               "chunked_serve": None, "sampled_serve": None,
               "spec_serve": None, "cluster_serve": None}
    by_path["paged_serve"], prefill_sizes, paged = phase(
        "4, paged serve", phase_serve, model, card)
    by_path["prefix_serve"] = phase("4, prefix serve", phase_prefix_serve,
                                    model, card)
    by_path["chunked_serve"] = phase("4, chunked serve", phase_chunked_serve,
                                     model, card)
    paged_all = paged["reqs"]
    sampled, by_path["sampled_serve"] = phase(
        "4, sampled serve", phase_sampled_serve, model, card, paged_all)
    modes = phase("4, graph modes", phase_graph_modes, model, card,
                  {"greedy": paged, "sampled": sampled})
    by_path["gather_serve"] = phase("4, gather serve", phase_gather_serve,
                                    model, card, paged_all)
    by_path["static_batch"] = phase("4, static batch", phase_static, model,
                                    card)
    phase("4, serve profiles", phase_serve_profiles, model, card)
    phase("4, prefill steps", phase_prefill_steps, model, card)
    by_path["spec_serve"] = phase("4, speculative serve", phase_spec_serve,
                                  model, card)
    phase("4, observability", phase_obs, model, card, modes)
    by_path["cluster_serve"] = phase("4, cluster", phase_cluster, model,
                                     card)
    by_path.update(phase("4, serving API and launcher", phase_api, model,
                         card, modes))
    phase("5, step compare", phase_step_compare, model, card)
    phase("5, prefill compare", phase_prefill_compare, model, card)
    phase("5, verify compare", phase_verify_compare, model, card)
    phase("4, census", phase_census, model, card)
    by_path.update(phase("4, examples", phase_examples, model, card, errs))
    del model
    release()
    family_paths, _ = phase("4, non-dense families", phase_families, card)
    by_path.update(family_paths)
    by_path.update(phase("4, slice 13", phase_slice13, card, errs))
    by_path["train"], _ = phase("4, train", phase_train, card, errs)
    by_path["dryrun_decode"], _ = phase("4, dry-run", phase_dryrun, card,
                                        errs)
    times = phase("5, kernel times", phase_times, card, prefill_sizes,
                  serve_workload())
    kernels = []
    meta = {   # source, the TPU kernel's entry, the path whose run counts
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_decode_attention.py:78", "paged_serve"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:76", "paged_serve"),
        "flash_prefix_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:76", "prefix_serve"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:67", "gather_serve"),
    }
    for name, key in (("paged_decode_attention", "paged"),
                      ("flash_attention", "flash"),
                      ("flash_prefix_attention", "flash_prefix"),
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
            **({"train_errors": errs["flash_train"]}
               if name == "flash_attention" else {}),
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
