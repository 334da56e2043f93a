"""The port's memory-gap auditor, windows, SLOs and dashboard
(``repro_torch.serving.obs``) on the CPU, against the JAX reference:
every field of every step's ``WasteBreakdown`` integer-equal to the
reference auditor's on the same workload (prefix cache, chunked prefill,
a generous output budget, preemption, the gather mode, speculation), the
exact partition invariant, the reserved-unused overlay, the pure read,
the report and the metrics' memory-gap rider; the window aggregates, the
SLO burn-rate events, the sparkline, the waste bar and the decimated
series folded into windows equal to the reference's on the same inputs;
the dashboard's frames and HTML report; and a crash mid-run still
leaving a valid trace and a final metrics snapshot."""
import dataclasses
import io
import json

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
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import repetitive_workload as j_repetitive  # noqa: E402
from repro.serving import \
    shared_prefix_workload as j_shared_prefix  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro.serving.obs import auditor as j_auditor  # noqa: E402
from repro.serving.obs import dashboard as j_dashboard  # noqa: E402
from repro.serving.obs import series as j_series  # noqa: E402
from repro.serving.obs import windows as j_windows  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.hardware import H100_SXM5_80GB  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, Request, RequestTooLarge,
                                 repetitive_workload,
                                 shared_prefix_workload, sharegpt_like)
from repro_torch.serving.metrics import collect_from_engine  # noqa: E402
from repro_torch.serving.obs import auditor, dashboard  # noqa: E402
from repro_torch.serving.obs import windows as W  # noqa: E402
from repro_torch.serving.obs.export import (MetricsEmitter,  # noqa: E402
                                            metrics_from_json,
                                            metrics_to_json)
from repro_torch.serving.obs.observer import Observability  # noqa: E402
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


class _NoCensus:
    def get(self, *a, **kw):
        return None


class _AuditOnly:
    """A reference observer that only audits memory at each step's end
    (the reference's own ``audit_engine``, at the reference observer's
    call sites), without the census compiles of a full observer."""

    def __init__(self):
        self.census = _NoCensus()
        self.steps = []

    def __getattr__(self, name):        # every other hook: nothing
        if name.startswith("on_"):
            return lambda *a, **kw: None
        raise AttributeError(name)

    def end_step(self, eng, *, n_decode, **kw):
        self.steps.append(j_auditor.audit_engine(eng, n_decode=n_decode))

    def end_step_overlap(self, eng, *, n_decode, **kw):
        self.end_step(eng, n_decode=n_decode)


def _generous(ref):
    rng = np.random.default_rng(5)
    R = JRequest if ref else Request
    return [R(i, rng.integers(0, 512, size=10), max_new_tokens=90)
            for i in range(4)]


def _sharegpt(ref, n=5, seed=3, mean_out=10, **kw):
    make = j_sharegpt_like if ref else sharegpt_like
    return make(n, 512, seed=seed, mean_in=12, mean_out=mean_out,
                max_len=48, sigma=0.4, **kw)


# workload: (requests, engine settings, steps to run: None = to the end)
AUDITS = {
    "prefix_cache": (_sharegpt, dict(prefix_cache=True), None),
    "chunked_prefix": (
        lambda ref: (j_shared_prefix if ref else shared_prefix_workload)(
            2, 3, 512, prefix_len=24, suffix_len=8, max_new_tokens=6,
            seed=3),
        dict(prefix_cache=True, prefill_chunk_tokens=16), None),
    "generous_budget": (_generous, {}, 8),
    "preemption": (
        lambda ref: (j_sharegpt_like if ref else sharegpt_like)(
            6, 512, seed=11, mean_in=20, mean_out=36, max_len=60,
            sigma=0.1),
        dict(max_batch=3, kv_pool_tokens=128, max_model_len=96), None),
    "gather": (_sharegpt, dict(decode_mode="gather"), None),
    "speculative": (
        lambda ref: (j_repetitive if ref else repetitive_workload)(
            3, 512, prompt_len=24, max_new_tokens=16, seed=0),
        dict(speculate=True), None),
}


def _drive(eng, reqs, steps):
    for r in reqs:
        eng.add_request(r)
    i = 0
    while eng.busy and (steps is None or i < steps):
        eng.step(float(i))
        i += 1


def _audits(models, name):
    make, kw, steps = AUDITS[name]
    jmodel, jp, jsteps, tmodel = models
    jeng = JEngine(jmodel, jp, JEngineConfig(**BASE | kw), steps=jsteps)
    stub = _AuditOnly()
    jeng.obs = stub
    jreqs = make(True)
    _drive(jeng, jreqs, steps)
    eng = ContinuousBatchingEngine(tmodel, EngineConfig(**BASE | kw),
                                   device="cpu")
    obs = Observability(hw=HW, audit_memory=True)
    obs.attach(eng)
    reqs = make(False)
    _drive(eng, reqs, steps)
    return stub.steps, obs.observer(0).auditor, eng, reqs, jreqs


@pytest.mark.parametrize("name", list(AUDITS))
def test_waste_breakdown_equals_the_reference_every_step(models, name):
    """Every field of every step's breakdown, integer-exact, and the
    partition exact on each."""
    want, aud, eng, reqs, jreqs = _audits(models, name)
    assert [list(r.output_tokens) for r in reqs] == \
        [list(r.output_tokens) for r in jreqs]
    got = list(aud.steps)
    assert len(got) == len(want) == aud.audits > 0
    assert [dataclasses.astuple(w) for w in got] == \
        [dataclasses.astuple(w) for w in want]
    assert [f.name for f in dataclasses.fields(auditor.WasteBreakdown)] == \
        [f.name for f in dataclasses.fields(j_auditor.WasteBreakdown)]
    assert aud.pool_bytes == eng.pool.pool_bytes
    for wb in got:
        assert wb.physical_bytes == wb.pool_bytes      # exact
        for t in auditor.PHYSICAL_TERMS + auditor.OVERLAY_TERMS:
            assert wb.value(t) >= 0
        if name != "preemption":      # a starved pool dips into it
            assert wb.watermark_bytes <= wb.free_bytes
        assert wb.gap_bytes == wb.pool_bytes - wb.used_bytes
    if name == "generous_budget":
        st = aud.stats()
        assert st.worst_term == "reserved_unused"
        assert st.reserved_unused_bytes_mean > st.used_bytes_mean
        assert 0.0 < st.used_fraction_mean < 1.0
        assert st.gap_fraction_mean == pytest.approx(
            1 - st.used_fraction_mean)
    if name == "prefix_cache":
        assert any(wb.prefix_held_bytes for wb in got)
    if name in ("gather", "prefix_cache"):
        assert any(wb.bucket_pad_bytes for wb in got)


def test_audit_engine_is_pure_read(models):
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**BASE),
                                   device="cpu")
    _drive(eng, _sharegpt(False, n=3, mean_out=20), 4)
    free_before = eng.pool.manager.free_blocks
    wb1 = auditor.audit_engine(eng)
    wb2 = auditor.audit_engine(eng)
    assert wb1 == wb2
    assert eng.pool.manager.free_blocks == free_before
    assert wb1.n_running == len(eng.running)


@pytest.mark.parametrize("prompt_len,limit", [(10, 5), (10, 1), (10, 0),
                                              (1, 90), (96, 32)])
def test_committed_tokens_equals_the_reference(prompt_len, limit):
    assert auditor.committed_tokens(prompt_len, limit) == \
        j_auditor.committed_tokens(prompt_len, limit)


def test_auditor_report_means_and_metrics_rider(models, tmp_path):
    reqs = _sharegpt(False, n=4, mean_out=8)
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**BASE),
                                   device="cpu")
    obs = Observability(hw=HW, audit_memory=True)
    obs.attach(eng)
    eng.run(reqs)
    aud = obs.observer(0).auditor
    rep = aud.report()
    assert set(rep["mean_bytes"]) == set(auditor.PHYSICAL_TERMS
                                         + auditor.OVERLAY_TERMS)
    assert rep["mean_bytes"]["used"] == pytest.approx(
        aud._sums["used"] / aud.audits)
    assert 0.0 <= rep["gap_fraction_mean"] <= 1.0
    assert rep["peak_used_bytes"] >= max(wb.used_bytes for wb in aud.steps)
    assert obs.memory_gap_report() == {0: rep}
    m = collect_from_engine(eng, reqs, 1.0)
    assert m.memgap == aud.stats() and m.memgap.steps_audited > 0
    assert "pool=" in m.memgap.row()
    path = str(tmp_path / "m.json")
    with open(path, "w") as f:
        json.dump(metrics_to_json(m), f)
    got = metrics_from_json(path)
    assert got.memgap == m.memgap and got.slo_breaches == m.slo_breaches


# -------------------------------------------------------------- windows ----
def _both(fn):
    """``fn`` over the port's windows module and the reference's."""
    return fn(W), fn(j_windows)


def test_window_aggregates_equal_the_reference():
    def run(mod):
        win = mod.WindowAggregator()
        for i in range(100):
            win.push(mod.STREAM_ITL, 0.1 * (i + 1), float(i))
        return (dataclasses.astuple(win.window(mod.STREAM_ITL, t_now=10.0,
                                               span_s=10.0)),
                dataclasses.astuple(win.window(mod.STREAM_ITL, t_now=10.0,
                                               span_s=1.0)))
    got, want = _both(run)
    assert got == want
    full = got[0]
    assert full[3] == 100 and full[4] == pytest.approx(49.5)
    assert full[6] == pytest.approx(np.percentile(np.arange(100.0), 50))


def test_window_pruning_empty_and_tumbling_equal_the_reference():
    def run(mod):
        win = mod.WindowAggregator(horizon_s=5.0)
        for i in range(100):
            win.push("x", float(i))
        tiles = mod.WindowAggregator()
        for i in range(40):
            tiles.push("y", 0.25 * i, 1.0)
        return (win.samples("x"), win.latest("x"),
                dataclasses.astuple(win.window("nope", t_now=1.0,
                                               span_s=1.0)),
                win.violation_fraction("nope", t_now=1.0, span_s=1.0,
                                       threshold=0.5),
                [dataclasses.astuple(w) for w in tiles.tumbling(
                    "y", span_s=2.0)])
    got, want = _both(run)
    assert got == want
    assert len(got[0]) <= 7 and got[1] == (99.0, 1.0) and got[3] is None
    assert [w[1] for w in got[4]] == [0.0, 2.0, 4.0, 6.0, 8.0]
    assert sum(w[3] for w in got[4]) == 39


def test_decimated_series_into_windows_equals_the_reference():
    def run(series_mod, win_mod):
        s = series_mod.BoundedSeries(256)
        for v in range(2048):
            s.append(float(v))
        win = win_mod.WindowAggregator(horizon_s=1e9)
        win.push_series(win_mod.STREAM_KV, s, t0=0.0, dt=1.0)
        return (dataclasses.astuple(win.window(
            win_mod.STREAM_KV, t_now=2048.0 * s.stride, span_s=1e9)),
            win.latest(win_mod.STREAM_KV))
    got = run(__import__("repro_torch.serving.obs.series",
                         fromlist=["x"]), W)
    assert got == run(j_series, j_windows)
    assert got[0][3] < 2048
    assert abs(got[0][4] - 1023.5) / 1023.5 < 0.05


def test_slo_validation():
    with pytest.raises(ValueError, match="target"):
        W.SLO("a", W.STREAM_ITL, 0.1, target=1.0)
    with pytest.raises(ValueError, match="fast window"):
        W.SLO("a", W.STREAM_ITL, 0.1, fast_window_s=60.0, slow_window_s=2.0)
    with pytest.raises(ValueError, match="duplicate"):
        W.SLOMonitor([W.SLO("a", W.STREAM_ITL, 0.1),
                      W.SLO("a", W.STREAM_TTFT, 1.0)], W.WindowAggregator())


def _burn(mod, tracer):
    """A healthy stretch, a blip, sustained degradation, then recovery
    (the reference tests' two scenarios end to end)."""
    slo = mod.SLO("itl", mod.STREAM_ITL, threshold=0.01, target=0.5,
                  fast_window_s=1.0, slow_window_s=5.0)
    win = mod.WindowAggregator()
    mon = mod.SLOMonitor([slo], win, tracer=tracer)
    t = 0.0
    trail = []
    for value, n in ((0.001, 60), (1.0, 5), (0.001, 40), (1.0, 100),
                     (0.001, 200)):
        for _ in range(n):
            t = round(t + 0.1, 6)
            win.push(mod.STREAM_ITL, t, value)
            mon.evaluate(t)
        trail.append((mon.burn_rates(slo, t), mon.breached["itl"]))
    return mon, trail


def test_slo_burn_rates_and_events_equal_the_reference():
    from repro.serving.obs.trace import Tracer as JTracer
    tr = Tracer()
    mon, trail = _burn(W, tr)
    jmon, jtrail = _burn(j_windows, JTracer())
    assert trail == jtrail
    assert [dataclasses.astuple(e) for e in mon.events] == \
        [dataclasses.astuple(e) for e in jmon.events]
    assert mon.summary() == jmon.summary()
    assert mon.breaches == 1 and mon.recoveries == 1
    assert not trail[1][1]                     # a blip trips nothing
    names = {e["name"] for e in tr.to_dict()["traceEvents"]}
    assert {"slo_breach:itl", "slo_recover:itl"} <= names


def test_default_slos_equal_the_reference():
    for kw in ({}, dict(ttft_s=1.0, itl_s=0.05, deadline_target=0.99)):
        assert [dataclasses.astuple(s) for s in W.default_slos(**kw)] == \
            [dataclasses.astuple(s) for s in j_windows.default_slos(**kw)]


# ------------------------------------------------------------ dashboard ----
def test_sparkline_and_waste_bar_equal_the_reference():
    for vals in ([], [0.0, 0.5, 1.0], [3.0] * 5, list(range(40))):
        assert dashboard.sparkline(vals) == j_dashboard.sparkline(vals)
    fields = dict(step=1, pool_bytes=1000, used_bytes=500,
                  block_pad_bytes=250, prefix_held_bytes=0,
                  free_bytes=250, watermark_bytes=0,
                  reserved_unused_bytes=0, bucket_pad_bytes=0,
                  used_tokens=10, n_running=1, n_prefilling=0)
    wb = auditor.WasteBreakdown(**fields)
    jwb = j_auditor.WasteBreakdown(**fields)
    for color in (False, True):
        assert dashboard.waste_bar(wb, width=40, color=color) == \
            j_dashboard.waste_bar(jwb, width=40, color=color)
    bar = dashboard.waste_bar(wb, width=40, color=False)
    assert bar.count("█") == 20 and bar.count("▓") == 10


def test_render_frame_html_report_and_dashboard(models, tmp_path):
    obs = Observability(hw=HW, audit_memory=True, windows=True,
                        slos=[W.SLO("itl", W.STREAM_ITL, 0.5)])
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**BASE),
                                   device="cpu")
    obs.attach(eng)
    eng.run(_sharegpt(False, n=4, mean_out=8))
    obs.slo.evaluate(obs.trace.now())
    t = obs.trace.now()
    frame = dashboard.render(obs, t, color=False)
    assert "serving dashboard" in frame and "slo itl" in frame
    assert "replica 0 pool" in frame and "% used" in frame
    html = dashboard.html_report(obs, t, title="t")
    assert html.startswith("<!doctype html>") and "svg" in html
    path = str(tmp_path / "dash.html")
    dashboard.write_html_report(obs, t, path)
    assert open(path).read() == dashboard.html_report(obs, t,
                                                      title="serving run")
    out = io.StringIO()
    dash = dashboard.Dashboard(obs, interval_s=1.0, out=out, color=False)
    assert dash.tick(0.0) is True
    assert dash.tick(0.5) is False
    assert dash.tick(1.0) is True
    dash.close()
    assert dash.frames == 3 and out.getvalue()


# --------------------------------------------------- exception safety ----
def test_crash_mid_run_leaves_a_valid_trace_and_snapshot(models, tmp_path):
    """A request the pool can never hold stops the run mid-serve: the
    context-managed tracer and emitter still leave a loadable trace and
    a final metrics snapshot, memory-gap rider included."""
    eng = ContinuousBatchingEngine(
        models[3], EngineConfig(**BASE | dict(kv_pool_tokens=128,
                                              max_model_len=128)),
        device="cpu")
    obs = Observability(hw=HW, audit_memory=True, windows=True)
    obs.attach(eng)
    tpath = str(tmp_path / "trace.json")
    mpath = str(tmp_path / "metrics.json")
    obs.trace.autosave_path = tpath
    reqs = _sharegpt(False, n=2, mean_out=6)
    rng = np.random.default_rng(0)
    reqs.append(Request(99, rng.integers(0, 512, size=120),
                        max_new_tokens=4))
    em = MetricsEmitter(mpath, interval_s=1e9,
                        provider=lambda: collect_from_engine(eng, reqs, 1.0))
    with pytest.raises(RequestTooLarge):
        with obs.trace, em:
            eng.run(reqs)
    assert validate_chrome_trace(tpath) == []
    names = {e["name"] for e in json.load(open(tpath))["traceEvents"]}
    assert any(n.startswith("step ") for n in names)
    m = metrics_from_json(mpath)
    assert m.memgap is not None and m.memgap.steps_audited > 0
    assert em.emits == 1


def test_bounded_auditor_series(models):
    obs = Observability(hw=HW, audit_memory=True, series_maxlen=4)
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**BASE),
                                   device="cpu")
    obs.attach(eng)
    eng.run(_sharegpt(False, n=4, mean_out=12))
    aud = obs.observer(0).auditor
    assert isinstance(aud.steps, BoundedSeries) and len(aud.steps) <= 4
    assert aud.steps.appended == aud.audits > 4
