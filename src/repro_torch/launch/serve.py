"""Serving launcher for the card: wires the whole paper loop,

    profile T(B)/L(B) -> BCA (Eq. 2) -> replication plan -> serve

(the port of ``repro.launch.serve``, with the same flags and defaults).
With ``--replicas`` > 1 (or ``auto``) it runs the replicated cluster
(:mod:`repro_torch.serving.cluster`, replicas co-located on the card)
instead of a single engine, routing requests with ``--policy``.

It serves on the card unless given ``--device cpu``; without a CUDA device
and without that flag it raises. The analytics run on the paper's H100
(``H100_PAPER``) for the paper's models (``opt-*``, ``llama-2*``) and on
the card's own entry otherwise (``H100_SXM5_80GB`` under ``--device
cpu``); the observer reads the card's own entry. Weights are random,
drawn from seed 0 by :func:`make_model`.

Examples::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-1.3b \
      --requests 64 --bca --replicas auto
  PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-1.3b \
      --reduced --device cpu --requests 8 --stream
"""
from __future__ import annotations

import argparse
import io
from typing import List, Optional

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import (H100_PAPER, H100_SXM5_80GB,
                              BatchingConfigurationAdvisor,
                              ReplicationPlanner, audit_sizing,
                              decode_curves, for_device_name, max_batch_for,
                              prefill_step_terms, replication_sweep,
                              slo_from_reference, speculation_advisor)
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                 FaultInjector, ReplicatedCluster,
                                 SamplingParams, ServingAPI,
                                 repetitive_workload, shared_prefix_workload,
                                 sharegpt_like)

KV_BUDGET_TOKENS = 1 << 16     # stands in for device memory; R ways split it
MAX_REPLICAS = 8


def make_model(cfg, device: torch.device) -> Model:
    """The served model: random weights drawn from seed 0 on ``device``."""
    return Model(cfg, device=device,
                 generator=torch.Generator(device).manual_seed(0))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a model on the card through the paper's loop: "
                    "BCA, replication plan, serve.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--bca", action="store_true",
                    help="pick max_batch via the Batching Configuration "
                         "Advisor over modeled curves")
    ap.add_argument("--slo-factor", type=float, default=2.0)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--replicas", default="1",
                    help="'auto' = ReplicationPlanner decides")
    ap.add_argument("--policy", default="round-robin",
                    choices=("round-robin", "jsq", "least-kv",
                             "prefix-affinity"))
    ap.add_argument("--cluster-mode", default="thread",
                    choices=("thread", "sync"))
    ap.add_argument("--ctx", type=int, default=331)
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="N",
                    help="chunked prefill token budget per mixed step "
                         "(0 = serial admission-time prefill; -1 = size "
                         "the budget from the BCA curves' ITL headroom)")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="double-buffered overlapped stepping: dispatch "
                         "decode step N+1 while step N's tokens are in "
                         "flight (scheduler/executor split; outputs are "
                         "bit-identical to --no-overlap)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share KV blocks across prompts with a common "
                         "prefix (radix prefix cache; skips redundant "
                         "prefill and pool footprint)")
    ap.add_argument("--workload", default="sharegpt",
                    choices=("sharegpt", "repetitive"),
                    help="request mix: 'sharegpt' = independent "
                         "ShareGPT-like prompts; 'repetitive' = highly "
                         "self-repetitive template prompts (the "
                         "speculative-decoding target shape — pair with "
                         "--speculate)")
    ap.add_argument("--shared-prefix-tenants", type=int, default=0,
                    metavar="N",
                    help="serve a shared-system-prompt workload (N "
                         "tenants splitting --requests, 128-token shared "
                         "prefix + 24-token suffix each) instead of "
                         "independent ShareGPT-like prompts — the shape "
                         "where --prefix-cache and the prefix-affinity "
                         "policy actually pay off")
    ap.add_argument("--speculate", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="speculative decoding: draft-free prompt-lookup "
                         "drafter + multi-token verify over the paged pool "
                         "(outputs bit-identical to plain decode). Default "
                         "lets the BCA speculation advisor decide from the "
                         "break-even batch; --no-speculate forces it off")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="max draft tokens per request per verify step "
                         "(0 = advisor's K, or the engine default when "
                         "--speculate was forced on)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax, "
                         "bit-identical to the pre-sampler engine)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus truncation (1.0 = disabled)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base RNG seed; request i samples from stream "
                         "seed+i (bit-reproducible across batch "
                         "composition and replicas)")
    ap.add_argument("--stream", action="store_true",
                    help="serve through the online facade (submit/"
                         "stream/drain) and print per-event token deltas "
                         "for the first request instead of a batch run")
    ap.add_argument("--deadline", type=float, default=0.0, metavar="S",
                    help="per-request end-to-end deadline in seconds "
                         "(0 = none); expired requests finish with "
                         "reason='deadline' and release KV immediately")
    ap.add_argument("--ttft-deadline", type=float, default=0.0,
                    metavar="S",
                    help="per-request time-to-first-token deadline in "
                         "seconds (0 = none); stops binding once the "
                         "first token is out")
    ap.add_argument("--inject-fault", action="append", default=[],
                    metavar="SPEC",
                    help="deterministic fault injection, e.g. "
                         "'replica=1,step=50' (kind defaults to kill; "
                         "also kind=delay,seconds=0.1 or "
                         "kind=alloc-fail); repeatable")
    ap.add_argument("--max-waiting", type=int, default=0, metavar="N",
                    help="bound each replica's arrival queue at N "
                         "requests (0 = unbounded); overflow is shed "
                         "with reason='shed', never an engine crash")
    ap.add_argument("--shed-kv", type=float, default=0.0, metavar="F",
                    help="shed new arrivals while free KV fraction is "
                         "below F and a backlog exists (0 = disabled)")
    ap.add_argument("--watchdog", type=float, default=0.0, metavar="S",
                    help="mark a replica wedged (and route around it) "
                         "when a step exceeds S seconds (0 = disabled; "
                         "cluster mode only)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record request-lifecycle + step-phase spans and "
                         "write Chrome-trace/Perfetto JSON to PATH (open "
                         "in ui.perfetto.dev or chrome://tracing)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the final metrics snapshot to PATH — "
                         "Prometheus text exposition if PATH ends in "
                         ".prom, versioned JSON otherwise ('-' = stdout)")
    ap.add_argument("--obs-interval", type=float, default=10.0,
                    metavar="S",
                    help="periodic metrics-emit interval for --metrics-out "
                         "during --stream serving (the batch path emits "
                         "once at the end)")
    ap.add_argument("--audit-memory", action="store_true",
                    help="attribute every KV pool byte per step (used / "
                         "block pad / prefix-held / free, plus the "
                         "reserved-unused and bucket-pad overlays) and "
                         "print the end-of-run memory gap report with the "
                         "BCA sizing cross-check")
    ap.add_argument("--slo-ttft", type=float, default=0.0, metavar="S",
                    help="TTFT objective in seconds: 95%% of first tokens "
                         "within S, breach/recovery via multi-window burn "
                         "rates (0 = no TTFT SLO)")
    ap.add_argument("--slo-itl", type=float, default=0.0, metavar="S",
                    help="ITL objective in seconds: 95%% of decode steps "
                         "within S (0 = no ITL SLO)")
    ap.add_argument("--dashboard", action="store_true",
                    help="live ANSI terminal dashboard (windowed "
                         "latencies, memory-gap bars, SLO burn rates); "
                         "renders a final frame on batch runs")
    ap.add_argument("--dashboard-html", default=None, metavar="PATH",
                    help="write the dashboard as a self-contained HTML "
                         "report (inline SVG charts) at end of run")
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on: the card (the default) "
                         "or 'cpu'; without a CUDA device only an explicit "
                         "'cpu' runs")
    return ap


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    full_cfg = get_config(args.arch)
    card_hw = (H100_SXM5_80GB if device.type == "cpu"
               else for_device_name(torch.cuda.get_device_name(device)))
    hw = H100_PAPER if args.arch.startswith(("opt-", "llama-2")) else card_hw

    max_batch = args.max_batch
    prefill_chunk = args.prefill_chunk if args.prefill_chunk > 0 else None
    if args.bca:
        mb = max_batch_for(full_cfg, hw, ctx=args.ctx)
        curves = decode_curves(full_cfg, hw, ctx=args.ctx, max_batch=mb)
        slo = slo_from_reference(curves, 32, args.slo_factor)
        # modeled per-prompt-token prefill cost: lets BCA sweep the
        # chunked-prefill budget alongside max_batch (the ITL headroom
        # above the pure-decode step is the prefill time a mixed step
        # may spend)
        pf_tok_s = prefill_step_terms(full_cfg, 1, args.ctx,
                                      hw).step_s / args.ctx
        res = BatchingConfigurationAdvisor(
            curves, slo_s=slo, eps=args.eps,
            prefill_token_s=pf_tok_s).solve()
        print(f"[BCA] {res.summary()}")
        max_batch = min(res.b_opt, 64) if args.reduced else res.b_opt
        if args.prefill_chunk < 0:
            prefill_chunk = res.chunk_tokens
            print(f"[BCA] prefill chunk budget: {prefill_chunk} tok/step")
    elif args.prefill_chunk < 0:
        raise SystemExit("--prefill-chunk -1 (auto) requires --bca")

    if args.replicas == "auto":
        plan = ReplicationPlanner(hw, full_cfg, ctx=args.ctx).plan(max_batch)
        n_rep = plan.n_replicas
        print(f"[replication] {plan.summary()}")
        for r in replication_sweep(full_cfg, hw, batch=max_batch,
                                   ctx=args.ctx, max_replicas=n_rep):
            print(f"[sim] {r.summary()}")
    else:
        n_rep = int(args.replicas)
    n_rep = max(1, min(n_rep, MAX_REPLICAS))

    # speculative decoding: default is advisor-decided — speculate iff the
    # break-even math says the verify compute rides the memory gap at this
    # batch (small B), forced on/off by --speculate/--no-speculate
    speculate, spec_k = args.speculate, args.spec_k
    if speculate is None or (speculate and spec_k <= 0):
        sp = speculation_advisor(full_cfg, hw, batch=max(max_batch, 1))
        print(f"[spec] advisor: {sp.summary()}")
        if speculate is None:
            speculate = sp.enabled
        if spec_k <= 0:
            spec_k = sp.k            # 0 = keep the engine default

    cfg = reduced(full_cfg) if args.reduced else full_cfg
    model = make_model(cfg, device)
    ecfg = EngineConfig(max_batch=min(max_batch, 64),
                        kv_pool_tokens=(KV_BUDGET_TOKENS // n_rep) // 64 * 64,
                        max_model_len=512, prefill_bucket=64,
                        prefix_cache=args.prefix_cache,
                        overlap=args.overlap,
                        prefill_chunk_tokens=prefill_chunk,
                        max_waiting=args.max_waiting or None,
                        shed_kv_fraction=args.shed_kv or None,
                        speculate=bool(speculate),
                        **({"spec_k": spec_k} if spec_k > 0 else {}))
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed,
                              deadline_s=args.deadline or None,
                              ttft_deadline_s=args.ttft_deadline or None)
    faults = None
    if args.inject_fault:
        faults = FaultInjector.parse(*args.inject_fault)
        print(f"[faults] injecting {len(faults.specs)} fault(s): "
              + "; ".join(str(s) for s in faults.specs))
    if args.shared_prefix_tenants > 0:
        # round per-tenant count up, then trim so exactly --requests are
        # served (the interleaved tail drops evenly across tenants)
        per = -(-args.requests // args.shared_prefix_tenants)
        reqs = shared_prefix_workload(
            args.shared_prefix_tenants, per, cfg.vocab_size,
            prefix_len=128, suffix_len=24, max_new_tokens=16,
            seed=0, sampling=sampling)[:args.requests]
    elif args.workload == "repetitive":
        reqs = repetitive_workload(
            args.requests, cfg.vocab_size, prompt_len=64,
            max_new_tokens=32, repeat_rate=1.0, phrase_len=8,
            pool_size=1, seed=0, sampling=sampling)
    else:
        reqs = sharegpt_like(args.requests, cfg.vocab_size, seed=0,
                             mean_in=24, mean_out=32, max_len=256,
                             sampling=sampling)
    if n_rep > 1:
        backend = ReplicatedCluster.colocated(
            model, ecfg, n_rep, policy=args.policy,
            mode=args.cluster_mode, faults=faults,
            watchdog_s=args.watchdog or None)
    else:
        backend = ContinuousBatchingEngine(model, ecfg, device=device)
        if faults is not None:
            # single engine = replica 0; kills surface as InjectedFault
            # (no peer to redrive onto)
            backend.faults = faults
    # runtime observability: roofline attribution + lifecycle tracing
    # attach to the backend; metrics snapshots go through the emitter;
    # SLOs + the dashboard ride the windows layer
    obs = emitter = dash = None
    slos = []
    if args.slo_ttft or args.slo_itl:
        from repro_torch.serving import default_slos
        slos = default_slos(ttft_s=args.slo_ttft or None,
                            itl_s=args.slo_itl or None)
    want_dash = args.dashboard or args.dashboard_html
    if args.trace or args.metrics_out or args.audit_memory \
            or want_dash or slos:
        from repro_torch.serving import MetricsEmitter, Observability
        obs = Observability(hw=card_hw, audit_memory=args.audit_memory,
                            windows=bool(want_dash or slos
                                         or args.audit_memory),
                            slos=slos or None)
        # crash-safe: everything recorded so far survives a replica
        # failure or ^C as a valid trace file
        obs.trace.autosave_path = args.trace
        obs.attach_backend(backend)
        if args.metrics_out:
            path = None if args.metrics_out == "-" else args.metrics_out
            fmt = "prom" if args.metrics_out.endswith(".prom") else "json"
            emitter = MetricsEmitter(path, fmt=fmt,
                                     interval_s=args.obs_interval)
        if want_dash:
            from repro_torch.serving import Dashboard
            dash = Dashboard(obs, out=None if args.dashboard
                             else io.StringIO())
    try:
        if args.stream:
            # online path: submit everything through the facade, stream
            # the first request's token deltas, drain the rest
            if n_rep > 1 and args.cluster_mode == "thread":
                print("[stream] note: streaming steps replicas "
                      "cooperatively from the calling thread; "
                      "--cluster-mode thread applies only to the batch "
                      "run() path")
            api = ServingAPI(backend, obs=obs, emitter=emitter,
                             dashboard=dash)
            handles = [api.submit(r) for r in reqs]
            for ev in api.stream(handles[0]):
                print(f"[stream] req {ev.req_id} "
                      f"+{len(ev.new_token_ids)} "
                      f"tok {list(ev.new_token_ids)} "
                      f"finished={ev.finished} "
                      f"reason={ev.finish_reason}")
            api.drain()
            metrics = api.metrics()
        elif n_rep == 1 and obs is not None:
            # batch path through the facade so the SLO monitor, emitter
            # and dashboard tick during the run
            metrics = ServingAPI(backend, obs=obs, emitter=emitter,
                                 dashboard=dash).run(reqs)
        else:
            metrics = backend.run(reqs)
    except BaseException:
        # crash path: flush the partial trace and the last-known metrics
        # before propagating, so the evidence survives the failure
        if obs is not None:
            obs.trace.flush()
        if emitter is not None:
            try:
                emitter.close()
            except Exception:
                pass
        raise
    if dash is not None:
        dash.close()
    if emitter is not None:
        emitter.emit(metrics)       # final end-of-run snapshot
        if args.metrics_out != "-":
            print(f"[obs] metrics -> {args.metrics_out} "
                  f"({emitter.emits} snapshot(s))")
    if obs is not None:
        if args.trace:
            obs.export_chrome_trace(args.trace)
            print(f"[obs] trace -> {args.trace} "
                  f"({obs.trace.n_events} events; open in "
                  f"ui.perfetto.dev)")
        for row in obs.roofline_rows():
            print(f"[obs] {row}")
        ob0 = obs.observer(0)
        if ob0 is not None:
            p = ob0.phase_summary()
            print(f"[obs] step phases: sched={p['schedule_s']*1e3:.2f}ms "
                  f"dispatch={p['dispatch_s']*1e3:.2f}ms "
                  f"device={p['device_s']*1e3:.2f}ms "
                  f"host={p['host_s']*1e3:.2f}ms "
                  f"host_gap={p['host_gap_fraction']*100:.0f}%")
        if args.dashboard_html:
            from repro_torch.serving.obs.dashboard import write_html_report
            write_html_report(obs, obs.trace.now(), args.dashboard_html,
                              title=f"{args.arch} serving run")
            print(f"[obs] dashboard -> {args.dashboard_html}")
        if obs.slo is not None:
            s = obs.slo.summary()
            print(f"[slo] breaches={s['breaches']} "
                  f"recoveries={s['recoveries']} "
                  f"active={s['active'] or 'none'}")
            for e in obs.slo.events:
                print(f"[slo] {e.row()}")
        for pid, rep in obs.memory_gap_report().items():
            mb = rep["mean_bytes"]
            pool = max(rep["pool_bytes"], 1)
            print(f"[memgap] replica {pid}: "
                  f"pool={pool / 2**20:.1f}MiB "
                  f"used={100 * mb['used'] / pool:.1f}% "
                  f"blk_pad={100 * mb['block_pad'] / pool:.1f}% "
                  f"pfx_held={100 * mb['prefix_held'] / pool:.1f}% "
                  f"free={100 * mb['free'] / pool:.1f}% | "
                  f"resv_unused={100 * mb['reserved_unused'] / pool:.1f}% "
                  f"worst={rep['worst_term']}")
            sa = audit_sizing(
                full_cfg, hw, args.ctx,
                observed_tokens_per_req=max(
                    rep["peak_used_tokens_per_req"], 1.0))
            print(f"[memgap] replica {pid}: {sa.summary()}")
    if n_rep > 1:
        print(metrics.summary())
        return metrics
    print(f"[engine] {metrics.row()}")
    print(f"[engine] {metrics.latency_row()}")
    print(f"[engine] {metrics.stall_row()}")
    print(f"[engine] {metrics.finish_row()}")
    if speculate:
        why = getattr(backend, "spec_disabled_reason", None)
        if why is not None:
            print(f"[spec] disabled: {why}")
        else:
            print(f"[spec] {metrics.spec_row()}")
    return metrics


if __name__ == "__main__":
    main()
