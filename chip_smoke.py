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
   entries past each allocation, length-0 rows, full tables), the flash
   cases of the reference's tests, and both at the serving shapes;
3. a model check at OPT-1.3B's full width in float32, cut to 2 layers:
   one prefill per prompt and 4 paged decode steps through the kernels,
   then through the plain versions; logits and greedy tokens must agree;
4. serve 32 ShareGPT-length requests through full-width, 24-layer
   OPT-1.3B in bfloat16 (random weights from a seed) to completion, with
   the kernels' launch counters reset just before and read just after;
   then profile 10 steady decode steps at batch 16 (device busy time by
   kernel kind against host wall time);
5. time each kernel, its plain version and one PyTorch library call at
   the serving shapes, beside the least time the card could take;
6. print the card, a ``{"kernels": [...]}`` line and, last, the ``ok``
   line. Any failure raises: the script then exits non-zero and prints
   no ``ok`` line. Without a CUDA device it exits 1 at once.
"""
import contextlib
import dataclasses
import json
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
MODEL_TOL = 1e-3             # float32 logits, kernels vs plain, full width
MODEL = "opt-1.3b"           # the served configuration, full width


def close(a, b, what):
    """Max abs error of ``a`` against ``b``; raises past atol + rtol*|b|
    (the reference tests' assert_allclose rule, atol by dtype)."""
    import torch
    atol = TOL[str(b.dtype).replace("torch.", "")]
    af, bf = a.float(), b.float()
    err = (af - bf).abs()
    if not bool(torch.isfinite(af).all()):
        raise AssertionError(f"{what}: non-finite output")
    if bool((err > atol + RTOL * bf.abs()).any()):
        raise AssertionError(f"{what}: max abs err {err.max().item():.3e} "
                             f"over atol {atol}")
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
    need = [max(0, -(-int(n) // BS)) for n in lengths]
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
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.kernels.paged_decode_attention import \
        paged_gqa_decode_attention_torch
    saved = ops.paged_decode_attention, ops.prefill_attention
    ops.paged_decode_attention = paged_gqa_decode_attention_torch
    ops.prefill_attention = flash_attention_torch
    try:
        yield
    finally:
        ops.paged_decode_attention, ops.prefill_attention = saved


# ------------------------------------------------------------- phases ----
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"[build] {len(paths)} libraries in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in paths:
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(errs):
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    from repro_torch.kernels.paged_decode_attention import (
        paged_gqa_decode_attention, paged_gqa_decode_attention_torch)
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
    args = serve_decode_inputs()
    e = close(paged_gqa_decode_attention(*args),
              paged_gqa_decode_attention_torch(*args), "paged serving shape")
    errs["paged"]["serving_shape"] = e
    print(f"[kernels] paged decode at the serving shape (B=16, K=32, G=1, "
          f"hd=64, BS=16, bf16): max abs err {e:.3e}")

    cases = [(2, 64, 64, 2, 2, 64, True, None, torch.float32),
             (1, 96, 96, 1, 4, 32, True, 40, torch.float32),
             (2, 64, 64, 4, 1, 64, False, None, torch.bfloat16),
             (1, 128, 128, 2, 4, 128, True, None, torch.bfloat16),
             (3, 32, 96, 1, 2, 64, True, None, torch.float32),
             (1, 100, 100, 2, 1, 64, True, None, torch.float32)]
    for i, (B, Sq, Skv, K, G, hd, causal, window, dtype) in enumerate(cases):
        q, k, v = flash_inputs(B, Sq, Skv, K, G, hd, dtype, seed=100 + i)
        e = close(flash_attention(q, k, v, causal=causal, window=window),
                  flash_attention_torch(q, k, v, causal=causal,
                                        window=window),
                  f"flash case {i}")
        errs["flash"]["reference_cases"] = max(
            errs["flash"]["reference_cases"], e)
    for S in (64, 128, 256, 512, 1024):
        q, k, v = flash_inputs(1, S, S, 32, 1, 64, torch.bfloat16, seed=S)
        e = close(flash_attention(q, k, v), flash_attention_torch(q, k, v),
                  f"flash serving shape S={S}")
        errs["flash"]["serving_shape"] = max(errs["flash"]["serving_shape"],
                                             e)
    print(f"[kernels] flash prefill: {len(cases)} reference cases (max abs "
          f"err {errs['flash']['reference_cases']:.3e}) and S in 64..1024 "
          f"at H=K=32, hd=64, bf16 (max abs err "
          f"{errs['flash']['serving_shape']:.3e}) within tolerance")


def run_model(model, prompts, steps):
    """Prefill each prompt at batch 1 into a paged pool, then ``steps``
    greedy paged decode steps in a batch bucket with a padding row.
    Returns the logits of every call and the greedy tokens."""
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
        nb_pad = _pow2_bucket(max(len(pool.manager.tables[r]) for r in rids),
                              lo=4)
        view = pool.view(rids, positions, nb_pad, batch_pad)
        inp = torch.zeros((batch_pad,), dtype=torch.long)
        inp[:len(rids)] = torch.tensor(tokens)
        logits = model.decode_step(inp.cuda(), view)[:len(rids)]
        logits_all.append(logits)
        tokens = logits.argmax(-1).tolist()
        history.append(tokens)
        positions = [p + 1 for p in positions]
    return logits_all, history


def phase_model(errs):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_gqa_decode_attention
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("opt-1.3b"), n_layers=2,
                              dtype="float32")
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(1))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (161, 97)]
    p0, f0 = paged_gqa_decode_attention.launches, flash_attention.launches
    kern, kern_tok = run_model(model, prompts, steps=4)
    if (paged_gqa_decode_attention.launches - p0,
            flash_attention.launches - f0) != (4 * 2, 2 * 2):
        raise AssertionError("the model check did not run the kernels")
    with plain_attention():
        plain, plain_tok = run_model(model, prompts, steps=4)
    if paged_gqa_decode_attention.launches - p0 != 4 * 2:
        raise AssertionError("the plain run launched a kernel")
    err = max((a - b).abs().max().item() for a, b in zip(kern, plain))
    if not all(bool(torch.isfinite(a).all()) for a in kern):
        raise AssertionError("model check: non-finite logits")
    if err > MODEL_TOL or kern_tok != plain_tok:
        raise AssertionError(f"model check: logits differ by {err:.3e} "
                             f"(tolerance {MODEL_TOL}) or tokens differ: "
                             f"{kern_tok} vs {plain_tok}")
    errs["paged"]["model_check"] = errs["flash"]["model_check"] = err
    print(f"[model] OPT-1.3B width, 2 layers, float32: 2 prefills + 4 paged "
          f"decode steps, kernels vs plain versions: logits max abs err "
          f"{err:.3e} (tolerance {MODEL_TOL}), greedy tokens equal "
          f"{kern_tok[-1]}")
    del model
    torch.cuda.empty_cache()


def serve_workload():
    from repro_torch.configs import get_config
    from repro_torch.serving.workload import sharegpt_like
    return sharegpt_like(32, get_config(MODEL).vocab_size, seed=0,
                         mean_in=161, mean_out=338, max_len=1024)


def serve_decode_inputs():
    """The paged kernel's serving shape: 16 requests of the serve
    workload at half their output budget, blocks at permuted ids."""
    import torch
    reqs = serve_workload()[:16]
    lengths = [r.prompt_len + r.max_new_tokens // 2 for r in reqs]
    nb = 4
    while nb * 16 < max(lengths):
        nb *= 2
    return paged_inputs(16, 32, 1, 64, 16, nb, torch.bfloat16, lengths,
                        seed=7)


def phase_serve(card):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_gqa_decode_attention
    from repro_torch.models.model import Model
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    cfg = get_config(MODEL)
    t0 = time.perf_counter()
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}, {sum(p.numel() for p in model.parameters()) / 1e9:.3f}"
          f" B parameters, random init in {time.perf_counter() - t0:.1f} s")
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
    ecfg = EngineConfig(max_batch=16, block_size=16, kv_pool_tokens=32768,
                        max_model_len=2048, prefill_bucket=64)
    engine = ContinuousBatchingEngine(model, ecfg)
    reqs = serve_workload()
    torch.cuda.synchronize()
    paged_gqa_decode_attention.launches = 0
    flash_attention.launches = 0
    metrics = engine.run(reqs)
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": paged_gqa_decode_attention.launches,
                "flash_attention": flash_attention.launches}
    if not bool(finite):
        raise AssertionError("serve: NaN or inf logits")
    for r in reqs:
        if r.finish_reason != "length" or r.generated != r.max_new_tokens:
            raise AssertionError(f"request {r.req_id}: {r.finish_reason}, "
                                 f"{r.generated}/{r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"request {r.req_id}: token out of range")
    want = {"paged_decode_attention": engine.decode_steps * cfg.n_layers,
            "flash_attention": engine.prefills * cfg.n_layers}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    print(f"[serve] on {card}: {len(reqs)} requests, "
          f"{metrics.output_tokens} output tokens, {engine.decode_steps} "
          f"decode steps, {engine.prefills} prefills, {metrics.preemptions} "
          f"preemptions; launches {launches} = steps x {cfg.n_layers} layers")
    print(f"[serve] eager PyTorch, no CUDA graphs, on {card}: "
          f"throughput {metrics.throughput:.1f} tok/s, output "
          f"{metrics.output_throughput:.1f} tok/s, wall {metrics.wall_s:.2f} s,"
          f" mean batch {metrics.avg_batch:.2f}, KV peak "
          f"{metrics.max_kv_fraction * 100:.1f}%")
    print(f"[serve] on {card}: TTFT {metrics.ttft.row()}; ITL "
          f"{metrics.itl.row()}; E2E {metrics.e2e.row(scale=1.0, unit='s')}")
    prefill_sizes = sorted({-(-r.prompt_len // 64) * 64 for r in reqs})
    del engine, model.prefill, model.decode_step     # drop the checks
    torch.cuda.empty_cache()
    profile_decode(model, ecfg, card)
    del model
    torch.cuda.empty_cache()
    return launches, prefill_sizes


def kernel_kind(name):
    if "paged_decode_kernel" in name:
        return "paged attention kernel"
    if "flash_kernel" in name:
        return "flash kernel"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90")):
        return "GEMMs"
    return "other (norms, elementwise, indexing, copies)"


def profile_decode(model, ecfg, card, steps=10):
    """Where a steady decode step's time goes: ``torch.profiler`` over
    ``steps`` engine steps at batch 16 (after 20 warm steps and as many
    unprofiled, timed ones), device busy time by kernel kind against the
    host's wall time of an unprofiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(model, ecfg)
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
    print(f"[profile] on {card}: {steps} decode steps at batch "
          f"{len(engine.running)} ({ctx} context tokens at the end), "
          f"torch.profiler: device busy {busy:.3f} ms/step, "
          f"{len(kernels) / steps:.0f} device ops/step; host wall "
          f"{plain_wall_ms:.3f} ms/step unprofiled ({wall_ms:.3f} profiled),"
          f" so the device idles {(1 - busy / plain_wall_ms) * 100:.1f}% of "
          f"an unprofiled step")
    print(f"[profile] device time per step: {parts}")


def phase_times(card, prefill_sizes, serve_reqs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    from repro_torch.kernels.paged_decode_attention import (
        paged_gqa_decode_attention, paged_gqa_decode_attention_torch)
    times = {}
    q, kp, vp, table, lens = serve_decode_inputs()
    B, H, hd = q.shape
    K = kp.shape[2]
    tokens = int(lens.sum())
    isz = q.element_size()
    nbytes = (2 * tokens * K * hd * isz + 2 * q.numel() * isz
              + table.numel() * 4 + lens.numel() * 4)
    b_ms, b_by = bound(nbytes, 4 * tokens * H * hd)
    k_ms = time_ms(lambda: paged_gqa_decode_attention(q, kp, vp, table, lens))
    p_ms = time_ms(lambda: paged_gqa_decode_attention_torch(
        q, kp, vp, table, lens), runs=20)
    # yardstick: SDPA on the gathered contiguous cache (gather excluded)
    S = table.shape[1] * kp.shape[1]
    kc = kp[table.long()].reshape(B, S, K, hd).transpose(1, 2).contiguous()
    vc = vp[table.long()].reshape(B, S, K, hd).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, kc, vc,
                                                          attn_mask=mask))
    times["paged_decode_attention"] = dict(
        ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
        shape=f"B={B} H=K={K} hd={hd} BS=16 bf16, {tokens} context tokens, "
              f"table width {table.shape[1]}",
        library_call="scaled_dot_product_attention on the gathered "
                     "contiguous cache with a length mask (gather excluded)")
    print(f"[times] on {card}: paged decode at {times['paged_decode_attention']['shape']}: "
          f"kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, SDPA "
          f"yardstick {l_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us "
          f"({b_by}); {nbytes / (k_ms * 1e-3) / 1e9:.0f} GB/s achieved")

    counts = {}
    for r in serve_reqs:
        s = -(-r.prompt_len // 64) * 64
        counts[s] = counts.get(s, 0) + 1
    main_s = max(counts, key=lambda s: (counts[s], s))
    for S in sorted(set(prefill_sizes) | {1024}):
        q, k, v = flash_inputs(1, S, S, 32, 1, 64, torch.bfloat16, seed=S)
        nbytes = 4 * q.numel() * q.element_size()
        b_ms, b_by = bound(nbytes, 4 * 64 * 32 * S * (S + 1) / 2)
        k_ms = time_ms(lambda: flash_attention(q, k, v))
        p_ms = time_ms(lambda: flash_attention_torch(q, k, v), runs=20)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        print(f"[times] on {card}: flash prefill B=1 S={S} H=K=32 hd=64 "
              f"bf16 ({counts.get(S, 0)} serve prefills): kernel "
              f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, SDPA "
              f"{l_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by})")
        if S == main_s:
            times["flash_attention"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by,
                shape=f"B=1 S={S} H=K=32 hd=64 bf16 (the most frequent "
                      f"serve prefill bucket)",
                library_call="scaled_dot_product_attention(is_causal=True)")
    return times


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

    errs = {"paged": {"sweep": 0.0}, "flash": {"reference_cases": 0.0,
                                               "serving_shape": 0.0}}
    phase_kernels(errs)
    phase_model(errs)
    launches, prefill_sizes = phase_serve(card)
    times = phase_times(card, prefill_sizes, serve_workload())
    kernels = []
    meta = {
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_decode_attention.py:78"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:76"),
    }
    for name, key in (("paged_decode_attention", "paged"),
                      ("flash_attention", "flash")):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": max(errs[key].values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library_call": t["library_call"],
            "shape": t["shape"], "max_abs_err_by_phase": errs[key]})
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
