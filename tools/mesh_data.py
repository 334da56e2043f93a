"""Data parallelism inside one engine across four cards: the phases
``tools/mesh_smoke.py --data`` runs, each serve in one call so that the
noise between calls does not enter a comparison.

* (a) OPT-1.3B bf16 at full width and depth over ``4 x 1``: one engine at
  ``max_batch`` 512 (128 a card, each card's share of the pool 65,536
  tokens), 512 requests at t=0 at the paper's offline lengths (161 in,
  338 out), served sync and overlapped; interleaved with it (before and
  after), ``ReplicatedCluster.sliced`` as R=4 replicas of ``1 x 1`` at
  ``max_batch`` 128 on the same pool a card, stepped on threads, sync
  then overlapped; every engine first serves the same requests at 100
  new tokens each (a warm-up that meets every bucket), so the measured
  serves replay graphs their process has built. The port's counterpart of
  ``benchmarks/replication_throughput.py``'s one MAX replica over the
  mesh against R replicas.
* (b) deepseek-coder-33b bf16 at full width and depth over ``4 x 1``
  under FSDP (the reference's own choice at 66.7 GB of weights: more
  than half a card), 128 ShareGPT-length requests at ``max_batch`` 128;
  beside it the ``1 x 4`` ``act_replicated`` paged serve of the same
  requests. Each rank's bytes held against the count read off its
  blocks, its peak, a steady step's busy split (NCCL, GEMMs, the paged
  kernel, the rest).
* (c) deepseek-coder-33b over ``2 x 2`` (no FSDP at model 2), the same
  requests; every mesh's check prompts' logits within ``DEEP_TOL`` of
  the ``1 x 4`` serve's.

Every rank's paged and flash launches are held to what its engine's
counters say (the paged kernel once a layer a decode step, the flash
kernel once a layer a prefill step) and equal across ranks; every logit
finite. The weights are drawn from seed 0 as one card draws them
(``init_shard``), cut to each rank's blocks. Rank functions live here
(they pickle by this module's name: ``tools/`` is on the path of a
process ``tools/mesh_smoke.py`` starts)."""
import time

import chip_smoke as cs

CARDS = 4
OPT_REQUESTS = 512
OPT_SHARE = 65536            # KV tokens of a card's share of the pool
OPT_ENGINE = dict(max_batch=512, block_size=16,
                  kv_pool_tokens=CARDS * OPT_SHARE, max_model_len=512,
                  prefill_bucket=64)
OPT_REPLICA = dict(OPT_ENGINE, max_batch=128, kv_pool_tokens=OPT_SHARE)
DEEP_ENGINE = dict(cs.MESH_DEEP_ENGINE)     # 131,072 tokens: 8.32 GB a card
FSDP = {"act_replicated": True, "fsdp": True}
PROFILE_AT = 120             # the decode step a profile window starts at
PROFILE_STEPS = 10
GATHER_REPS = 20             # row gathers captured in a graph, timed alone
GATHER_REPLAYS = 5
TEMP_BYTES = 1 << 30         # a step's temporaries beside its weights


WARM_TOKENS = 100            # a warm-up serve's new tokens a request


def opt_workload(vocab, n=OPT_REQUESTS, new=None):
    """``n`` requests at the paper's offline lengths, all at t=0 (``new``
    new tokens each if given: a warm-up serve, which meets every bucket
    of the measured one)."""
    import dataclasses
    from repro_torch.serving.workload import Request, sharegpt_like
    reqs = sharegpt_like(n, vocab, seed=0, fixed=True, max_len=1024)
    if new is None:
        return reqs
    return [Request(r.req_id, r.prompt, sampling=dataclasses.replace(
        r.sampling, max_new_tokens=new)) for r in reqs]


def block_bytes(cfg, rules, rank):
    """Bytes of device ``rank``'s blocks of every weight under ``rules``,
    read off the specs (``rank_ranges``)."""
    import math
    import torch
    from repro_torch.models.params import (param_specs, rank_ranges,
                                           spec_dtype, tree_leaves)
    ranges = rank_ranges(cfg, rules, rank)
    return sum(math.prod(b - a for a, b in ranges(s))
               * torch.empty((), dtype=spec_dtype(cfg, s)).element_size()
               for _, s in tree_leaves(param_specs(cfg)))


def layer_gathered_bytes(model):
    """One layer's weights as FSDP gathers them whole over the data axis
    (each ``w_in`` leaf's block times the data ranks); 0 without FSDP."""
    lay = model.layout
    if not lay.w_in:
        return 0
    blk = model.layers[0]
    leaves = {**blk.attn.tree(), **blk.ffn.tree()}
    return sum(lay.data * leaves[n].numel() * leaves[n].element_size()
               for n, _ in lay.w_in if n in leaves)


def gather_us(group, rows):
    """The data group's gather of a decode step's ``rows + 1`` int32
    words (its tokens and finiteness), ``GATHER_REPS`` captured in a
    graph and replayed: µs a gather."""
    import torch
    x = torch.zeros((rows + 1,), dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        group.gather_rows(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        for _ in range(GATHER_REPS):
            group.gather_rows(x)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GATHER_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) * 1e3 / (GATHER_REPS * GATHER_REPLAYS)


def data_serve_rank(group, cfg, serves, rules=None, slice_bytes=None,
                    check=None, warm=None):
    """A rank's model under the flags ``rules`` (drawn from seed 0 as one
    card draws it), ``deep_logits`` of ``check`` if given, then each of
    ``serves`` (``(tag, engine settings, requests)``) in turn over the
    mesh: bytes held after the engine is built against the count read
    off the blocks, the peak, the launches counted from 0 around the
    serve, every logit finite, a steady step's device ms and idle share
    on every rank (outside the profile window), and rank 0's profile window of ``PROFILE_STEPS``
    decode steps from ``PROFILE_AT`` (busy by kernel kind); the row gather
    timed alone at the widest decode bucket; on rank 0 the serve's metrics and
    the engine's counters. With ``warm`` (``(fn, args)`` making
    requests), each engine first serves ``fn(*args)`` and resets its
    counters: the measured serve then replays graphs its process and its
    engine have already built."""
    import torch
    from repro_torch.launch.tensor_parallel import (engine_counters,
                                                    rank_model)
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    cs.release()
    if group.rank == 0:
        cs.mesh_profiler_warmup(group)
    t0 = time.perf_counter()
    model = rank_model(group, cfg, seed=0, slice_bytes=slice_bytes,
                       rules=rules)
    torch.cuda.synchronize()
    out = {"rank": group.rank, "init_s": time.perf_counter() - t0,
           "weights": torch.cuda.memory_allocated(),
           "weights_counted": block_bytes(cfg, model.rules, group.rank),
           "layer_gathered": layer_gathered_bytes(model)}
    if check is not None:
        t0 = time.perf_counter()
        out["logits"] = cs.deep_logits(model, check)
        out["check_s"] = time.perf_counter() - t0
        cs.release()
    for tag, kw, reqs in serves:
        engine = ContinuousBatchingEngine(model, EngineConfig(**kw))
        torch.cuda.synchronize()
        pool = sum(t.numel() * t.element_size()
                   for t in engine.pool.pool.values())
        res = {"held": torch.cuda.memory_allocated(), "pool": pool}
        if warm is not None:
            t0 = time.perf_counter()
            engine.serve_mesh(warm[0](*warm[1]))
            engine.reset_stats()
            res["warm_s"] = time.perf_counter() - t0
        engine.steps.timing = True
        run = engine.steps._run
        marks, window, decodes = [], {}, [0]

        def marked(key, body, kind, run=run, marks=marks, window=window,
                   decodes=decodes, engine=engine, group=group):
            decode = key[0] not in ("prefill", "suffix")
            decodes[0] += decode
            if decode and decodes[0] == PROFILE_AT:
                window["at"] = len(marks)
            if decode and decodes[0] == PROFILE_AT and group.rank == 0:
                torch.cuda.synchronize()
                window["bucket"] = key
                window["prof"] = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                window["prof"].start()
            out_ = run(key, body, kind)
            marks.append((key, engine.steps.last))
            if "prof" in window and \
                    decodes[0] == PROFILE_AT + PROFILE_STEPS - 1:
                torch.cuda.synchronize()
                window["prof"].stop()
                window["by_kind"] = cs.busy_by_kind(window.pop("prof"),
                                                    PROFILE_STEPS)
            return out_
        engine.steps._run = marked
        torch.cuda.reset_peak_memory_stats()
        with cs.finite_logits(model) as finite:
            cs.reset_launches()
            t0 = time.perf_counter()
            metrics = engine.serve_mesh(reqs)
            torch.cuda.synchronize()
            res.update(serve_s=time.perf_counter() - t0,
                       launches=cs.read_launches(),
                       peak=torch.cuda.max_memory_allocated(),
                       after=torch.cuda.memory_allocated(),
                       graphs=len(engine.steps.graphs))
            if not bool(finite) or not bool(engine.steps.finite):
                raise AssertionError(f"rank {group.rank}, {tag}: NaN or "
                                     f"inf logits")
        if "prof" in window:            # a serve shorter than its window
            window.pop("prof").stop()
        # the steady run before or after the profile window, whichever is
        # longer (the window's syncs idle the card)
        at = window.get("at", len(marks))
        runs = [cs.steady_idle(m) for m in (
            marks[:at], marks[at + PROFILE_STEPS:])]
        runs = [r for r in runs if r is not None]
        res["steady"] = max(runs, key=lambda r: r["steps"]) if runs \
            else None
        res["window"] = {k: v for k, v in window.items()
                         if k not in ("prof", "at")}
        decode_rows = [k[0] for k, _ in marks if not isinstance(k[0], str)]
        if model.data > 1 and decode_rows:
            res["gather_us"] = gather_us(group,
                                         max(decode_rows) // model.data)
        if metrics is not None:
            res.update(
                counters=engine_counters(engine),
                finish=sorted({r.finish_reason for r in reqs}),
                output_tokens=metrics.output_tokens,
                tok_s=metrics.output_throughput,
                itl=(metrics.itl.p50, metrics.itl.p95),
                ttft=(metrics.ttft.p50, metrics.ttft.p95),
                wall_s=metrics.wall_s, preemptions=metrics.preemptions)
        out[tag] = res
        del engine, marks
        cs.release()
    del model
    cs.release()
    return out


def launches_check(ranks, tag, n_layers):
    """Every rank launched the paged kernel once a layer a decode step and
    the flash kernel once a layer a prefill step (rank 0's counters), and
    nothing else."""
    c = ranks[0][tag]["counters"]
    want = dict.fromkeys(ranks[0][tag]["launches"], 0)
    want["paged_decode_attention"] = c["decode_steps"] * n_layers
    want["flash_attention"] = c["prefill_steps"] * n_layers
    for r in ranks:
        if r[tag]["launches"] != want:
            raise AssertionError(f"[mesh data {tag}] rank {r['rank']} "
                                 f"launched {r[tag]['launches']}, not "
                                 f"{want}")
    return want


def serve_line(x):
    st = x["steady"]
    steady = (f"steady step {st['ms']:.2f} ms busy at bucket {st['bucket']}"
              f" over {st['steps']} steps, idle {st['idle'] * 100:.1f}%"
              if st else "no steady window")
    return (f"{x['output_tokens']} output tokens, {x['preemptions']} "
            f"preemptions; output {x['tok_s']:.1f} tok/s, ITL p50 "
            f"{x['itl'][0] * 1e3:.2f} ms p95 {x['itl'][1] * 1e3:.2f} ms, "
            f"TTFT p50 {x['ttft'][0] * 1e3:.1f} ms p95 "
            f"{x['ttft'][1] * 1e3:.1f} ms, wall {x['wall_s']:.1f} s; "
            f"{steady}")


def rank_lines(ranks, tag, label):
    """Each rank's bytes, steady step, idle share and row gather."""
    for r in ranks:
        x = r[tag]
        st = x["steady"]
        gather = f", row gather {x['gather_us']:.1f} µs alone" \
            if "gather_us" in x else ""
        print(f"[{label} rank {r['rank']}] held {cs.gb(x['held'])} (pool "
              f"{cs.gb(x['pool'])}), peak {cs.gb(x['peak'])}; "
              + (f"steady step {st['ms']:.2f} ms busy, idle "
                 f"{st['idle'] * 100:.1f}%" if st else "no steady window")
              + gather)


def opt_cluster_child(cfg, ecfg, n, requests, warm=None):
    """R=``n`` replicas of ``1 x 1`` over ``cuda:0..n-1``
    (``ReplicatedCluster.sliced``, threaded), each drawn from seed 0,
    serving ``requests`` (after the requests ``warm`` makes, if given,
    as :func:`data_serve_rank` takes them, and a reset of the counters):
    the cluster's metrics, each card's bytes held and peak, the
    launches."""
    import torch
    from repro_torch.serving import ReplicatedCluster
    cluster = ReplicatedCluster.sliced(
        cfg, None, ecfg, [f"cuda:{i}" for i in range(n)], n, seed=0,
        mode="thread")
    if warm is not None:
        cluster.run(warm[0](*warm[1]))
        cluster.reset_stats()
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
    cs.reset_launches()
    metrics = cluster.run(requests)
    for i in range(n):
        torch.cuda.synchronize(i)
    return {"tok_s": metrics.output_throughput,
            "itl": (metrics.itl.p50, metrics.itl.p95),
            "ttft": (metrics.ttft.p50, metrics.ttft.p95),
            "wall_s": metrics.wall_s, "output_tokens": metrics.output_tokens,
            "lost": metrics.lost,
            "finish": sorted({r.finish_reason for r in requests}),
            "routed": [len(rep.requests) for rep in cluster.replicas],
            "held": [torch.cuda.memory_allocated(i) for i in range(n)],
            "peak": [torch.cuda.max_memory_allocated(i) for i in range(n)],
            "launches": cs.read_launches(),
            "counters": [dict(decode_steps=rep.engine.decode_steps,
                              prefill_steps=rep.engine.prefill_steps)
                         for rep in cluster.replicas]}


def opt_cluster(card, cfg, tag, n_requests, **kw):
    from repro_torch.distributed import run_child
    from repro_torch.serving import EngineConfig
    t0 = time.perf_counter()
    out = run_child(opt_cluster_child, cfg, EngineConfig(**OPT_REPLICA, **kw),
                    CARDS, opt_workload(cfg.vocab_size, n_requests),
                    (opt_workload, (cfg.vocab_size, n_requests,
                                    WARM_TOKENS)))
    if out["finish"] != ["length"] or out["lost"]:
        raise AssertionError(f"[mesh data {tag}] finish {out['finish']}, "
                             f"lost {out['lost']}")
    want = dict.fromkeys(out["launches"], 0)
    for c in out["counters"]:
        want["paged_decode_attention"] += c["decode_steps"] * cfg.n_layers
        want["flash_attention"] += c["prefill_steps"] * cfg.n_layers
    if out["launches"] != want:
        raise AssertionError(f"[mesh data {tag}] launched "
                             f"{out['launches']}, not {want}")
    print(f"[mesh data {tag}] {cs.MODEL} bf16, {cfg.n_layers} layers: R="
          f"{CARDS} replicas of 1 x 1 ({OPT_REPLICA['max_batch']} seats and"
          f" {OPT_SHARE} tokens of KV each{', overlapped' if kw else ''}) on"
          f" {card}, threaded, in {time.perf_counter() - t0:.1f} s: routed "
          f"{out['routed']}, {out['output_tokens']} output tokens; output "
          f"{out['tok_s']:.1f} tok/s, ITL p50 {out['itl'][0] * 1e3:.2f} ms "
          f"p95 {out['itl'][1] * 1e3:.2f} ms, TTFT p50 "
          f"{out['ttft'][0] * 1e3:.1f} ms, wall {out['wall_s']:.1f} s; held "
          f"{[cs.gb(b) for b in out['held']]}, peak "
          f"{[cs.gb(b) for b in out['peak']]}; launches {out['launches']}"
          f" (after a warm-up serve of {WARM_TOKENS} new tokens a request)")
    return out


def phase_opt(card, n_layers, n_requests):
    """(a): R=4 sync, the 4 x 1 engine sync then overlapped, R=4
    overlapped; each MAX serve against the R=4 serve of its mode."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed import devices_mesh, spawn
    cfg = get_config(cs.MODEL)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    r4 = {"sync": opt_cluster(card, cfg, "R=4 sync", n_requests)}
    serves = [(tag, dict(OPT_ENGINE, **kw),
               opt_workload(cfg.vocab_size, n_requests))
              for tag, kw in (("sync", {}), ("overlap", dict(overlap=True)))]
    t0 = time.perf_counter()
    ranks = spawn(data_serve_rank, devices_mesh(CARDS, data=CARDS), cfg,
                  serves, None, None, None,
                  (opt_workload, (cfg.vocab_size, n_requests, WARM_TOKENS)))
    print(f"[mesh data opt] two serves over {CARDS} x 1 in "
          f"{time.perf_counter() - t0:.1f} s")
    r4["overlap"] = opt_cluster(card, cfg, "R=4 overlap", n_requests,
                                overlap=True)
    for tag, _, _ in serves:
        x = ranks[0][tag]
        if x["finish"] != ["length"]:
            raise AssertionError(f"[mesh data opt {tag}] finish "
                                 f"{x['finish']}")
        launches = launches_check(ranks, tag, cfg.n_layers)
        c = x["counters"]
        print(f"[mesh data opt {tag}] {cs.MODEL} bf16, {cfg.n_layers} "
              f"layers, one engine over {CARDS} x 1 ({card}; "
              f"{OPT_ENGINE['max_batch']} seats, {OPT_SHARE} tokens of KV a "
              f"card; after a warm-up serve of {WARM_TOKENS} new tokens a "
              f"request): {n_requests} requests at 161 in / 338 out, "
              f"{c['prefills']} admissions in {c['prefill_steps']} prefill "
              f"steps, {c['decode_steps']} decode steps; {serve_line(x)}; "
              f"launches {launches} on every rank")
        rank_lines(ranks, tag, f"mesh data opt {tag}")
        y = r4[tag]
        print(f"[mesh data opt {tag} vs R=4] on {card}: MAX {CARDS} x 1 "
              f"{x['tok_s']:.1f} tok/s, ITL p50 {x['itl'][0] * 1e3:.2f} ms, "
              f"TTFT p50 {x['ttft'][0] * 1e3:.1f} ms; R=4 x (1 x 1) "
              f"{y['tok_s']:.1f} tok/s, ITL p50 {y['itl'][0] * 1e3:.2f} ms, "
              f"TTFT p50 {y['ttft'][0] * 1e3:.1f} ms; R=4 / MAX "
              f"{y['tok_s'] / x['tok_s']:.3f}")
    return {"max": ranks[0], "r4": r4}


def deep_report(ranks, tag, label, cfg, one=None):
    """A deepseek serve: finished, launches exact and equal, the check's
    logits equal on every rank of a data row... (and within DEEP_TOL of
    ``one``'s), each rank's bytes against its blocks' count."""
    x = ranks[0][tag]
    if x["finish"] != ["length"]:
        raise AssertionError(f"[{label}] finish {x['finish']}")
    launches = launches_check(ranks, tag, cfg.n_layers)
    gaps = None
    if one is not None:
        gaps = [cs.deep_gap_of(g, w) for g, w in zip(ranks[0]["logits"],
                                                     one)]
        if max(gaps) > cs.DEEP_TOL:
            raise AssertionError(f"[{label}] check logits {gaps} of the "
                                 f"largest from 1 x 4's, above "
                                 f"{cs.DEEP_TOL}")
        toks = [int((a.float().argmax(-1) == b.float().argmax(-1)).sum())
                for a, b in zip(ranks[0]["logits"], one)]
    c = x["counters"]
    print(f"[{label}] {cs.MESH_DEEP} bf16, {cfg.n_layers} layers: "
          f"{c['prefills']} admissions in {c['prefill_steps']} prefill steps,"
          f" {c['decode_steps']} decode steps; {serve_line(x)}; launches "
          f"{launches} on every rank"
          + (f"; the {len(ranks[0]['logits'][0])} check prompts' prefill and"
             f" decode logits within {gaps[0]:.2e} and {gaps[1]:.2e} of the "
             f"largest of 1 x 4's (DEEP_TOL {cs.DEEP_TOL}), greedy tokens "
             f"equal {toks[0]} and {toks[1]} of "
             f"{len(ranks[0]['logits'][0])}" if gaps else ""))
    w = x["window"]
    if "by_kind" in w:
        print(f"[{label} window] rank 0, {PROFILE_STEPS} decode steps from "
              f"step {PROFILE_AT} at bucket {w['bucket']}: busy "
              f"{sum(w['by_kind'].values()):.3f} ms a step: "
              f"{cs.kind_parts(w['by_kind'])}")
    for r in ranks:
        y = r[tag]
        counted = r["weights_counted"] + y["pool"]
        off = y["held"] / counted - 1
        limit = counted + 2 * r["layer_gathered"] + TEMP_BYTES
        st = y["steady"]
        print(f"[{label} rank {r['rank']}] weights {cs.gb(r['weights'])} "
              f"held against {cs.gb(r['weights_counted'])} read off its "
              f"blocks; with the pool {cs.gb(y['held'])} against "
              f"{cs.gb(counted)} ({off * 100:+.3f}%); peak "
              f"{cs.gb(y['peak'])} (the shard, the pool, two layers' "
              f"gathered weights {cs.gb(2 * r['layer_gathered'])} and "
              f"{cs.gb(TEMP_BYTES)} of temporaries: {cs.gb(limit)}); "
              + (f"steady step {st['ms']:.2f} ms busy, idle "
                 f"{st['idle'] * 100:.1f}%" if st else "no steady window")
              + (f", row gather {y['gather_us']:.1f} µs alone"
                 if "gather_us" in y else ""))
        if abs(off) > 0.02:
            raise AssertionError(f"[{label}] rank {r['rank']} holds "
                                 f"{y['held']} bytes, not within 2% of "
                                 f"{counted}")
        if y["peak"] > limit:
            raise AssertionError(f"[{label}] rank {r['rank']} peaked at "
                                 f"{y['peak']} bytes, over {limit}")


def phase_deep(card, n_layers, n_requests):
    """(b) and (c): deepseek-coder-33b over 1 x 4 (act_replicated, the
    check's reference), 4 x 1 under FSDP and 2 x 2."""
    from repro_torch.distributed import devices_mesh, spawn
    from repro_torch.models.params import DRAW_SLICE_BYTES
    cfg = cs.mesh_deep_cfg(n_layers)
    reqs = cs.mesh_workload(cfg.vocab_size, n_requests)
    check = reqs[:cs.MESH_DEEP_CHECK]
    serve = [("paged", DEEP_ENGINE, reqs)]
    out = {}
    for label, data, rules in (("1 x 4", 1, None), ("4 x 1 fsdp", 4, FSDP),
                               ("2 x 2", 2, None)):
        t0 = time.perf_counter()
        ranks = spawn(data_serve_rank, devices_mesh(CARDS, data=data), cfg,
                      serve, rules, DRAW_SLICE_BYTES, check)
        print(f"[mesh data deep {label}] built, checked and served in "
              f"{time.perf_counter() - t0:.1f} s; ranks drew their blocks in "
              f"{max(r['init_s'] for r in ranks):.1f} s, the check in "
              f"{max(r['check_s'] for r in ranks):.1f} s")
        one = out["1 x 4"][0]["logits"] if out else None
        deep_report(ranks, "paged", f"mesh data deep {label}", cfg, one)
        out[label] = ranks
    a, b, c = (out[k][0]["paged"] for k in ("1 x 4", "4 x 1 fsdp", "2 x 2"))
    print(f"[mesh data deep] on {card}: 1 x 4 act_replicated "
          f"{a['tok_s']:.1f} tok/s, 4 x 1 FSDP {b['tok_s']:.1f} tok/s "
          f"({b['tok_s'] / a['tok_s']:.3f} x), 2 x 2 {c['tok_s']:.1f} tok/s "
          f"({c['tok_s'] / a['tok_s']:.3f} x)")
    return out


def phase_mesh_data(card, n_layers=None, n_requests=None, which="all"):
    """(a)-(c) on four cards (module docstring), or ``which`` of them
    (``"opt"``: (a), ``"deep"``: (b) and (c)); ``n_layers`` cuts the
    models' depth and ``n_requests`` each workload for a short first
    call."""
    import torch
    if torch.cuda.device_count() < CARDS:
        print(f"[mesh data] needs {CARDS} cards, this machine has "
              f"{torch.cuda.device_count()}")
        return None
    out = {}
    if which in ("all", "opt"):
        out["opt"] = phase_opt(card, n_layers, n_requests or OPT_REQUESTS)
    if which in ("all", "deep"):
        out["deep"] = phase_deep(card, n_layers,
                                 n_requests or cs.MESH_DEEP_REQUESTS)
    return out
