"""The port's observability layer (``repro_torch.serving.obs`` and
``repro_torch.core``) on the CPU, against the JAX reference: the analytic
census against the reference's HLO census (``matmul`` and ``head``
FLOPs within 0.1% for every variant and bucket the reference's
``StepCensusCache`` meets on the shared workloads, the same variant and
bucket set), the live attention terms against the stated formula (the
13.0 µs bound at ``chip_smoke.py`` phase 5's shape), the observer on and
off giving bit-identical outputs (sync, overlapped, gather, chunked with
the prefix cache, speculative), the trace's event-name set equal to the
reference's on the same run, the phases, the census cache, the hardware
lookup, the export surface against the reference's registry, and the
bounded series, the tracer and the emitter ported one to one."""
import dataclasses
import json
import types

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import init_params as j_init_params  # noqa: E402
from repro.serving import BoundedSeries as JBoundedSeries  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Observability as JObservability  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import repetitive_workload as j_repetitive  # noqa: E402
from repro.serving import \
    shared_prefix_workload as j_shared_prefix  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro.serving.obs import export as j_export  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import census as C  # noqa: E402
from repro_torch.core.hardware import (H100_PAPER,  # noqa: E402
                                       H100_SXM5_80GB, HARDWARE,
                                       for_device_name)
from repro_torch.core.roofline import (model_flops_for,  # noqa: E402
                                       roofline_report)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, repetitive_workload,
                                 shared_prefix_workload, sharegpt_like)
from repro_torch.serving.metrics import ServingMetrics  # noqa: E402
from repro_torch.serving.obs import export  # noqa: E402
from repro_torch.serving.obs.observer import Observability  # noqa: E402
from repro_torch.serving.obs.roofline import StepCensusCache  # noqa: E402
from repro_torch.serving.obs.series import BoundedSeries  # noqa: E402
from repro_torch.serving.obs.trace import (Tracer,  # noqa: E402
                                           validate_chrome_trace)

BS = 8
BASE = dict(max_batch=4, block_size=BS, kv_pool_tokens=4096,
            max_model_len=128, prefill_bucket=16)
HW = H100_SXM5_80GB


@pytest.fixture(scope="module")
def models(rules):
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    tcfg = reduced(get_config("opt-1.3b"))
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jmodel = JModel(jcfg, rules)
    return (jmodel, jp, JStepFunctions.build(jmodel, BS),
            Model(tcfg, tp, device="cpu"))


def _sharegpt(ref, n=4, seed=3, mean_out=8):
    make = j_sharegpt_like if ref else sharegpt_like
    return make(n, 512, seed=seed, mean_in=12, mean_out=mean_out,
                max_len=48, sigma=0.4)


def _prefix(ref):
    make = j_shared_prefix if ref else shared_prefix_workload
    return make(2, 2, 512, prefix_len=32, suffix_len=8, max_new_tokens=6,
                seed=5)


def _repetitive(ref):
    make = j_repetitive if ref else repetitive_workload
    return make(3, 512, prompt_len=24, max_new_tokens=16, seed=0)


# the shared workloads: (requests, engine settings); between them every
# step variant of the reference runs
WORKLOADS = {
    "paged": (_sharegpt, {}),
    "chunked_prefix": (_prefix, dict(prefix_cache=True,
                                     prefill_chunk_tokens=16)),
    "prefix": (_prefix, dict(prefix_cache=True)),
    "gather": (lambda ref: _sharegpt(ref, n=3), dict(decode_mode="gather")),
    "speculative": (_repetitive, dict(speculate=True)),
}
_REF = {}


def _reference(models, name):
    """The reference engine's run of a shared workload with its
    observability attached (memoised: its census compiles dominate)."""
    if name not in _REF:
        jmodel, jp, steps, _ = models
        make, kw = WORKLOADS[name]
        obs = JObservability()
        eng = JEngine(jmodel, jp, JEngineConfig(**BASE, **kw), steps=steps)
        obs.attach(eng)
        reqs = make(True)
        eng.run(reqs)
        _REF[name] = (obs, reqs, eng)
    return _REF[name]


def _serve(models, make, observe=False, **kw):
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**{**BASE, **kw}),
                                   device="cpu")
    obs = None
    if observe:
        obs = Observability(hw=HW, audit_memory=True, windows=True,
                            strict_census=True)
        obs.attach(eng)
    reqs = make(False)
    eng.run(reqs)
    return reqs, eng, obs


def _tokens(reqs):
    return [(list(map(int, r.output_tokens)), r.finish_reason)
            for r in reqs]


def _port_key(variant, key):
    """A reference census key as the port buckets it: a chunk is keyed
    by its prefill bucket and the prefix blocks it gathers."""
    if variant == "chunk_prefill":
        return (key[0], key[2])
    return tuple(key)


# ----------------------------------------------------------------- census --
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_census_matches_reference_hlo_census(models, name):
    """Every (variant, bucket) the reference's census cache met on the
    workload, the port's run met too, and the port's analytic matmul and
    head FLOPs are the reference's HLO census's within 0.1%."""
    jobs, jreqs, _ = _reference(models, name)
    make, kw = WORKLOADS[name]
    reqs, eng, obs = _serve(models, make, observe=True, **kw)
    assert _tokens(reqs) == _tokens(jreqs)
    want = {(v, _port_key(v, key)): sc
            for (v, _, key), sc in jobs.census._cache.items()}
    assert not jobs.census.errors and all(want.values())
    got = set(obs.census._cache)
    assert got == set(want)
    assert obs.census.compiles == len(got) and not obs.census.errors
    cfg = eng.cfg
    for (variant, key), jsc in want.items():
        port = C.step_census(cfg, variant, key, BS)
        for cls in ("matmul", "head"):
            ref = jsc.census.per_class[cls].flops
            assert port.per_class[cls].flops == pytest.approx(
                ref, rel=1e-3), (variant, key, cls)


def test_census_rows_and_iterations():
    """The bucket fixes the padded rows, the logit rows and the
    iterations: a verify step is K_pad + 1 decode steps, a prefill's
    head is one row, and the gather step's dense copy is read and
    written once."""
    cfg = reduced(get_config("opt-1.3b"))
    dec = C.step_census(cfg, "decode", (4, 8), BS)
    ver = C.step_census(cfg, "spec_verify", (4, 8, 4), BS)
    for cls in ("matmul", "head", "other"):
        assert ver.per_class[cls].flops == 5 * dec.per_class[cls].flops
        assert ver.per_class[cls].bytes == 5 * dec.per_class[cls].bytes
    pf = C.step_census(cfg, "prefill", (16,), BS)
    assert pf.per_class["matmul"].flops == 4 * dec.per_class["matmul"].flops
    isz, L = 4, cfg.n_layers
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * isz
    g = C.step_census(cfg, "decode_gather", (3, 4), BS)
    assert g.per_class["attention"].bytes == 2 * 3 * 4 * BS * L * kv_row
    assert dec.per_class["attention"].bytes == 0
    sfx = C.step_census(cfg, "chunk_prefill", (16, 2), BS)
    assert sfx.per_class["attention"].bytes == 2 * 2 * BS * L * kv_row
    assert dec.flops == sum(c.flops for c in dec.per_class.values())
    assert dec.bytes == sum(c.bytes for c in dec.per_class.values())
    with pytest.raises(ValueError, match="variant"):
        C.step_census(cfg, "encode", (4,), BS)


def test_live_attention_terms_follow_the_formula():
    """A sample's attention terms come from its live work, not the
    bucket: the same bucket at a longer context reads more; the formula
    by hand for a decode and a prefill step."""
    cfg = reduced(get_config("opt-1.3b"))
    H, K, hd, L, isz = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers, 4
    kv_row = 2 * K * hd * isz
    live = C.LiveWork(rows=3, context=50, entries=8)
    a = C.attention_cost(cfg, "decode", (4, 8), live, BS)
    assert a.bytes == L * (50 * kv_row + 3 * kv_row + 2 * 3 * H * hd * isz
                           + 4 * (8 + 3))
    assert a.flops == L * 4 * 50 * H * hd
    longer = C.attention_cost(cfg, "decode", (4, 8),
                              dataclasses.replace(live, context=90), BS)
    assert longer.bytes > a.bytes and longer.flops > a.flops
    v = C.attention_cost(cfg, "spec_verify", (4, 8, 2), live, BS)
    assert v.bytes == 3 * a.bytes and v.flops == 3 * a.flops
    p = C.attention_cost(cfg, "chunk_prefill", (16, 2),
                         C.LiveWork(rows=10, context=12, entries=2), BS)
    assert p.bytes == L * (22 * kv_row + 10 * kv_row
                           + 2 * 10 * H * hd * isz + 4 * 12)
    assert p.flops == L * 4 * H * hd * (10 * 11 / 2 + 10 * 12)


def test_kernel_bytes_give_the_paged_bound_at_phase_5():
    """At chip_smoke.py phase 5's shape (16 requests of the paged serve
    at half their output budget, 5318 context tokens, full-width
    OPT-1.3B in bf16) the kernel's bytes over the card's rate are the
    13.0 µs bound PERF.md states."""
    cfg = get_config("opt-1.3b")
    reqs = sharegpt_like(32, cfg.vocab_size, seed=0, mean_in=161,
                         mean_out=338, max_len=1024)
    lens = [r.prompt_len + r.max_new_tokens // 2 for r in reqs[:16]]
    assert sum(lens) == 5318
    live = C.LiveWork(rows=16, context=sum(lens),
                      entries=sum(-(-n // 16) for n in lens))
    us = C.kernel_bytes(cfg, live) / HW.hbm_bw * 1e6
    assert round(us, 1) == 13.0
    # the step's attention class is the kernel's bytes, a layer each,
    # plus the new rows' pool writes
    a = C.attention_cost(cfg, "decode", (16, 64), live, 16)
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * 2
    assert a.bytes == pytest.approx(
        cfg.n_layers * (C.kernel_bytes(cfg, live) + 16 * kv_row))


def test_full_width_decode_prediction_inputs():
    """The bytes a batch-16 decode step of full-width OPT-1.3B must move
    (PERF.md's prediction): every weight once (about 2.62 GB in bf16)
    and the live K/V (about 1.05 GB)."""
    cfg = get_config("opt-1.3b")
    c = C.step_census(cfg, "decode", (16, 64), 16)
    weights = c.per_class["matmul"].bytes + c.per_class["head"].bytes
    assert 2.55e9 < weights < 2.7e9
    a = C.attention_cost(cfg, "decode", (16, 64),
                         C.LiveWork(16, 5318, 340), 16)
    assert 1.0e9 < a.bytes < 1.1e9
    # the reference's count, up to the vocabulary's padding
    assert C.param_count(cfg) == pytest.approx(
        j_get_config("opt-1.3b").num_params(), rel=1e-3)
    assert model_flops_for(cfg, "decode", 16, 1, False) == \
        2.0 * C.param_count(cfg) * 16


# ------------------------------------------------------ census cache ----
def test_census_cache_keys_compiles_and_errors():
    cfg = reduced(get_config("opt-1.3b"))
    cache = StepCensusCache()
    a = cache.get("decode", (4, 8), cfg=cfg, block_size=BS)
    assert cache.get("decode", (4, 8), cfg=cfg, block_size=BS) is a
    cache.get("decode", (4, 16), cfg=cfg, block_size=BS)
    assert cache.compiles == 2 and set(cache._cache) == {
        ("decode", (4, 8)), ("decode", (4, 16))}
    assert cache.get("mystery", (1,), cfg=cfg, block_size=BS) is None
    assert ("mystery", (1,)) in cache.errors and cache.compiles == 2
    with pytest.raises(ValueError, match="variant"):
        StepCensusCache(strict=True).get("mystery", (1,), cfg=cfg,
                                         block_size=BS)
    strict = StepCensusCache(strict=True)
    strict.get("decode", (4, 8), cfg=cfg, block_size=BS)
    with pytest.raises(ValueError, match="one model config"):
        strict.get("decode", (4, 8), cfg=dataclasses.replace(cfg, n_layers=3),
                   block_size=BS)
    with pytest.raises(ValueError, match="one model config"):
        strict.get("decode", (4, 16), cfg=cfg, block_size=2 * BS)


# ------------------------------------------------------------- hardware --
def test_hardware_entries_and_lookup():
    assert HW.peak_flops == 989e12 and HW.hbm_bw == 3.35e12
    assert HW.device_name == "NVIDIA H100 80GB HBM3" and HW.power_w == 700
    assert for_device_name("NVIDIA H100 80GB HBM3") is HW
    with pytest.raises(ValueError, match="no Hardware entry"):
        for_device_name("NVIDIA A100-SXM4-40GB")
    from repro.core.hardware import H100_PAPER as J_H100_PAPER
    assert dataclasses.asdict(J_H100_PAPER).items() <= \
        dataclasses.asdict(H100_PAPER).items()
    assert set(HARDWARE) == {"h100-sxm5-80gb", "h100-paper"}
    assert not any("tpu" in n for n in HARDWARE)


def test_observability_needs_hw_on_the_cpu(models):
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**BASE),
                                   device="cpu")
    with pytest.raises(ValueError, match="hw="):
        Observability().attach(eng)
    assert eng.obs is None and not eng.steps.timing
    obs = Observability(hw=HW)
    obs.attach(eng)
    assert eng.obs is obs.observer(0) and eng.steps.timing
    eng.obs = None
    assert not eng.steps.timing
    # the cluster half (ported since): attaching a cluster points every
    # replica at its own observer; an event on an attached replica lands
    # on the trace, one on an unknown replica is dropped
    cluster = types.SimpleNamespace(
        obs=None, replicas=[types.SimpleNamespace(idx=1, engine=eng)])
    assert obs.attach_cluster(cluster) is obs and cluster.obs is obs
    assert eng.obs is obs.observer(1)
    n = obs.trace.n_events
    obs.replica_event(1, "redrive", {"req": 0, "from": 0})
    obs.replica_event(5, "redrive")
    assert obs.trace.n_events == n + 1


# --------------------------------------------------- observer on / off --
@pytest.mark.parametrize("kw", [
    {}, dict(overlap=True), dict(decode_mode="gather"),
    dict(decode_mode="gather", overlap=True),
    dict(prefix_cache=True, prefill_chunk_tokens=16),
    dict(speculate=True, overlap=True)],
    ids=["sync", "overlap", "gather", "gather_overlap", "chunked_prefix",
         "speculative_overlap"])
def test_observer_on_equals_off_bit_for_bit(models, kw):
    make = _repetitive if kw.get("speculate") else (
        _prefix if kw.get("prefix_cache") else _sharegpt)
    off, e_off, _ = _serve(models, make, **kw)
    on, e_on, obs = _serve(models, make, observe=True, **kw)
    assert _tokens(on) == _tokens(off)
    assert list(e_on.batch_samples) == list(e_off.batch_samples)
    ob = obs.observer(0)
    n_steps = ob.phases.appended
    assert n_steps == len(e_on.stall_samples) > 0
    assert all(s.device_s >= 0 for s in ob.roofline.samples)
    assert all(s.flops > 0 and s.bytes > 0 for s in ob.roofline.samples)
    assert not ob._prefills               # every prefill resolved
    decoded = sum(ob.roofline.summary(v)["steps"] for v in
                  ("decode", "decode_gather", "spec_verify"))
    assert decoded == e_on.decode_steps + e_on.spec_steps
    assert validate_chrome_trace(obs.trace.to_dict()) == []


def test_trace_event_names_equal_the_reference(models, tmp_path):
    """The same workload through both engines with their observers: the
    Chrome traces carry the same event-name set (steps, phases, request
    lifecycles, counters), and the same roofline variants."""
    jobs, jreqs, _ = _reference(models, "paged")
    reqs, eng, obs = _serve(models, _sharegpt, observe=True)
    assert _tokens(reqs) == _tokens(jreqs)
    path = str(tmp_path / "t.json")
    obs.export_chrome_trace(path)
    assert validate_chrome_trace(path) == []
    names = {e["name"] for e in json.load(open(path))["traceEvents"]}
    jnames = {e["name"] for e in jobs.trace.to_dict()["traceEvents"]}
    # the port's observer audits memory too (one counter more)
    assert names - {"kv_waste_bytes"} == jnames
    assert {"queued", "decode", "first_token", "schedule", "dispatch",
            "device", "host", "prefill"} <= names
    jvar = {s.variant for s in jobs.observer(0).roofline.samples}
    assert {s.variant for s in obs.observer(0).roofline.samples} == jvar


def test_sync_phases_partition_the_step(models):
    _, eng, obs = _serve(models, _sharegpt, observe=True)
    ob = obs.observer(0)
    for p in ob.phases:
        assert not p.overlapped
        total = p.schedule_s + p.dispatch_s + p.device_s + p.host_s
        assert total == pytest.approx(p.total_s, rel=0.05, abs=1e-4)
    s = ob.roofline.summary("decode")
    assert 0 < s["bw_util_mean"] and s["bound"] in ("memory", "compute")
    assert s["attributed_steps"] == s["steps"] == eng.decode_steps
    rep = ob.roofline.report("decode")
    sc = ob.roofline.latest["decode"]
    assert rep == roofline_report(sc.census, HW, shape="decode",
                                  mesh="live")
    # the latest census holds the last sample's live attention terms
    last = ob.roofline.variant_samples("decode")[-1]
    assert sc.census.bytes == pytest.approx(last.bytes)
    summ = obs.summary()
    assert summ["hardware"] == HW.name and summ["census"]["errors"] == 0
    assert "memory_gap" in summ and summ["replicas"][0]["captures"] == 0
    assert len(obs.roofline_rows()) == 1


def test_overlap_phases_are_attributions(models):
    _, eng, obs = _serve(models, _sharegpt, observe=True, overlap=True)
    ob = obs.observer(0)
    over = [p for p in ob.phases if p.overlapped]
    assert len(over) == eng.decode_steps
    assert all(p.gap_s >= 0 and p.device_s > 0 for p in over)
    assert ob.phase_summary()["host_gap_fraction"] >= 0
    names = {e["name"] for e in obs.trace.to_dict()["traceEvents"]}
    assert {"dispatch", "device", "schedule"} <= names


# -------------------------------------------------------------- export --
def test_serving_registry_equals_the_reference():
    """One scraper reads both packages: the same schema, prefix and
    serving metric specs."""
    assert export.SCHEMA == j_export.SCHEMA
    assert export.PREFIX == j_export.PREFIX
    assert [dataclasses.astuple(s) for s in export.SERVING_SPECS] == \
        [dataclasses.astuple(s) for s in j_export.SERVING_SPECS]
    paths = {s.path for s in export.SERVING_SPECS}
    for field in ("spec_steps", "spec_drafted", "spec_accepted",
                  "spec_rejected", "spec_acceptance_rate", "shed",
                  "shed_reasons", "deadline_expired", "preemptions",
                  "queued_aborts"):
        assert field in paths
    from repro.serving.metrics import ServingMetrics as JServingMetrics
    assert [f.name for f in dataclasses.fields(ServingMetrics)] == \
        [f.name for f in dataclasses.fields(JServingMetrics)]


def test_prometheus_and_json_roundtrip(models, tmp_path):
    reqs, eng, obs = _serve(models, _repetitive, observe=True,
                            speculate=True, prefix_cache=True)
    from repro_torch.serving.metrics import collect_from_engine
    m = collect_from_engine(eng, reqs, 1.0)
    assert m.spec_steps > 0 and m.memgap is not None and m.prefix
    text = export.prometheus_text(m)
    assert export.lint_prometheus(text) == []
    assert "repro_spec_steps_total" in text
    assert "repro_memgap_pool_bytes" in text
    for spec in export.SERVING_SPECS:
        export._resolve(m, spec.path)
    doc = export.metrics_to_json(m)
    got = export.metrics_from_json(json.dumps(doc))
    assert dataclasses.asdict(got) == dataclasses.asdict(m)
    assert got.memgap == m.memgap and got.prefix == m.prefix
    path = tmp_path / "m.json"
    path.write_text(json.dumps(doc))
    assert dataclasses.asdict(export.metrics_from_json(str(path))) == \
        dataclasses.asdict(m)
    # the reference reads the port's document back into its own class
    jm = j_export.metrics_from_json(doc)
    assert dataclasses.asdict(jm) == dataclasses.asdict(m)


def test_export_fails_loudly():
    with pytest.raises(ValueError, match="schema"):
        export.metrics_from_json({"schema": "bogus/v9",
                                  "type": "ServingMetrics", "data": {}})
    with pytest.raises(ValueError, match="type"):
        export.metrics_from_json({"schema": export.SCHEMA,
                                  "type": "Mystery", "data": {}})
    # a cluster document without its fields fails as the reference's does
    # (the cluster half is ported since)
    for mod in (export, j_export):
        with pytest.raises(KeyError):
            mod.metrics_from_json({"schema": export.SCHEMA,
                                   "type": "ClusterMetrics", "data": {}})
    with pytest.raises(TypeError):
        export.metrics_to_json({"not": "metrics"})
    with pytest.raises(TypeError):
        export.prometheus_text({"not": "metrics"})
    for text in ("va lue{ 1.0\n", "# TYPE x flavor\nx 1\n",
                 'm{a=unquoted} 1\n', "m nope\n"):
        assert export.lint_prometheus(text) == \
            j_export.lint_prometheus(text) != []


def test_metrics_emitter_tick_gating_and_crash_snapshot(models, tmp_path):
    reqs, eng, _ = _serve(models, _sharegpt)
    from repro_torch.serving.metrics import collect_from_engine
    m = collect_from_engine(eng, reqs, 1.0)
    path = str(tmp_path / "m.json")
    em = export.MetricsEmitter(path, interval_s=10.0)
    calls = []

    def provider():
        calls.append(1)
        return m

    assert em.tick(0.0, provider) is True
    assert em.tick(5.0, provider) is False
    assert em.tick(10.0, provider) is True
    assert len(calls) == 2 and em.emits == 2
    assert export.metrics_from_json(path).total_tokens == m.total_tokens
    with pytest.raises(ValueError):
        export.MetricsEmitter(fmt="xml")
    with pytest.raises(ValueError):
        export.MetricsEmitter(interval_s=0.0)
    em2 = export.MetricsEmitter(str(tmp_path / "c.json"), interval_s=1e9,
                                provider=lambda: m)
    with pytest.raises(RuntimeError):
        with em2:
            raise RuntimeError("mid-run death")
    assert em2.emits == 1
    assert export.metrics_from_json(str(tmp_path / "c.json")).n_completed \
        == len(reqs)


# ------------------------------------------------------- bounded series --
def _series_ops(S, maxlen, n):
    s = S(maxlen)
    trace = []
    for i in range(n):
        s.append(i)
        trace.append((list(s), s.stride, s.appended))
    return trace, s


@pytest.mark.parametrize("maxlen,n", [(16, 16), (8, 1000), (1, 100),
                                      (5, 100), (4, 9)])
def test_bounded_series_equals_the_reference(maxlen, n):
    """Every append's kept samples, stride and count, as the
    reference's."""
    got, s = _series_ops(BoundedSeries, maxlen, n)
    want, _ = _series_ops(JBoundedSeries, maxlen, n)
    assert got == want
    assert len(s) <= maxlen and s[0] == 0 and s.appended == n
    f = s.fresh()
    assert f.maxlen == maxlen and len(f) == 0 and f.stride == 1
    with pytest.raises(ValueError):
        BoundedSeries(0)


def test_engine_series_are_bounded(models):
    reqs, eng, _ = _serve(models, lambda ref: _sharegpt(ref, n=6,
                                                        mean_out=12),
                          series_maxlen=4)
    for name in ("itl_samples", "batch_samples", "kv_fraction_samples",
                 "stall_samples", "prefill_token_samples",
                 "decode_token_samples", "preemption_samples",
                 "spec_acceptance_samples"):
        series = getattr(eng, name)
        assert isinstance(series, BoundedSeries) and len(series) <= 4
    assert eng.itl_samples.appended > 4
    with pytest.raises(ValueError, match="series_maxlen"):
        EngineConfig(series_maxlen=1)


# ----------------------------------------------------------------- tracer --
def test_tracer_structure_bound_and_validator(tmp_path):
    tr = Tracer()
    tr.name_process(0, "replica0")
    tr.name_thread(0, 0, "engine steps")
    t = tr.now()
    tr.span("step 1", t, t + 1e-3, pid=0, cat="step")
    tr.instant("first_token", t + 5e-4, pid=0, tid=3)
    tr.counter("kv", t + 1e-3, {"used": 0.5}, pid=0)
    path = str(tmp_path / "trace.json")
    tr.export_chrome_trace(path)
    assert validate_chrome_trace(path) == []
    assert {e["ph"] for e in json.load(open(path))["traceEvents"]} >= {
        "X", "i", "C", "M"}
    small = Tracer(max_events=4)
    for i in range(10):
        small.instant(f"e{i}", float(i))
    assert small.n_events <= 4 and small.dropped == 6
    from repro.serving.obs.trace import \
        validate_chrome_trace as j_validate
    bad = {"traceEvents": [{"ph": "X", "name": "no-dur", "ts": 1.0,
                            "pid": 0, "tid": 0}]}
    assert validate_chrome_trace(bad) == j_validate(bad) != []


def test_tracer_flushes_on_crash_and_never_masks_it(tmp_path):
    path = str(tmp_path / "t.json")
    with pytest.raises(RuntimeError, match="boom"):
        with Tracer(autosave_path=path) as tr:
            tr.instant("before_crash", 0.5)
            raise RuntimeError("boom")
    assert validate_chrome_trace(path) == []
    bad = str(tmp_path / "no" / "such" / "dir" / "t.json")
    with pytest.raises(RuntimeError, match="original"):
        with Tracer(autosave_path=bad):
            raise RuntimeError("original")
    with pytest.raises(OSError):
        with Tracer(autosave_path=bad):
            pass


# ------------------------------------------------------- device timing --
def test_step_timing_marks():
    """On the CPU the marks are host stamps around the body; a first use
    has none, reads no device time and no gap."""
    from repro_torch.serving.steps import StepTiming
    a = StepTiming(1.0, 1.25)
    b = StepTiming(1.5, 1.75)
    assert a.ready() and a.device_s == 0.25
    assert b.gap_after(a) == 0.25 and b.gap_after(None) == 0.0
    assert StepTiming(1.0, 1.5).gap_after(b) == 0.0     # never negative
    cap = StepTiming(None, None, first_use=(2.0, 3.0))
    assert cap.ready() and cap.device_s == 0.0
    assert cap.gap_after(b) == 0.0 and b.gap_after(cap) == 0.0


def test_first_use_is_a_capture_span_not_a_sample(models):
    """A bucket's first use (warm-up and capture) is a capture span on the
    step track, not a roofline sample; the replays after it are."""
    from repro_torch.serving.steps import StepTiming
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**BASE),
                                   device="cpu")
    obs = Observability(hw=HW)
    ob = obs.attach(eng)
    real = eng.steps._run
    seen = set()

    def run(key, body, pool):
        out = real(key, body, pool)
        if key not in seen:               # as a CUDA device's first use
            seen.add(key)
            eng.steps.last = StepTiming(None, None, first_use=(0.0, 1e-3))
        return out
    eng.steps._run = run
    eng.run(_sharegpt(False))
    captures = len(seen)
    assert ob.captures == captures > 0
    # every decode step and prefill is a sample but the first uses
    assert len(ob.roofline.samples) == \
        eng.decode_steps + eng.prefills - captures
    spans = [e for e in obs.trace.to_dict()["traceEvents"]
             if e["name"] == "capture"]
    assert len(spans) == captures
