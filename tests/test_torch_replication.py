"""The port's replication planner, performance model, BCA and autoscale
decision (``repro_torch.core.replication``, ``core.perfmodel``,
``core.bca``, ``serving.cluster.autoscale``) against the JAX reference's
on the paper's card (``H100_PAPER``), each number equal to 1e-12
relative: the planner's memory accounting, the modeled decode curves,
the BCA's results on them (the paper's Table IV case), the knee, the
chunk budget, prefix reuse, the speculation advisor and the sizing audit;
``decide`` on synthetic curves; ``measure_curves`` on port engines; and
``sliced``/``slice_devices`` refusing a device count that does not
divide, as ``slice_mesh`` does."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import bca as j_bca  # noqa: E402
from repro.core import perfmodel as j_perf  # noqa: E402
from repro.core.hardware import H100_PAPER as J_H100  # noqa: E402
from repro.core.hardware import Hardware as JHardware  # noqa: E402
from repro.core.replication import \
    ReplicationPlanner as JPlanner  # noqa: E402
from repro.serving.cluster import decide as j_decide  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import bca, perfmodel  # noqa: E402
from repro_torch.core.hardware import H100_PAPER, Hardware  # noqa: E402
from repro_torch.core.replication import ReplicationPlanner  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, ReplicatedCluster,
                                 sharegpt_like)
from repro_torch.serving.cluster import (decide, measure_curves,  # noqa: E402
                                         slice_devices)

ARCHS = ["opt-1.3b", "opt-2.7b", "llama-2-7b", "qwen2.5-3b"]
REL = 1e-12


def _eq(a, b):
    """Equal to 1e-12 relative, field by field (arrays elementwise)."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _eq(getattr(a, f.name), getattr(b, f.name))
        return
    if a is None or isinstance(a, (str, bool)):
        assert a == b
        return
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=REL, atol=0)


def _curves_pair(arch, **kw):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    mb = min(perfmodel.max_batch_for(cfg, H100_PAPER, ctx=331), 512)
    assert mb == min(j_perf.max_batch_for(jcfg, J_H100, ctx=331), 512)
    return (perfmodel.decode_curves(cfg, H100_PAPER, ctx=331, max_batch=mb,
                                    **kw),
            j_perf.decode_curves(jcfg, J_H100, ctx=331, max_batch=mb, **kw))


def test_hardware_entry_equals_the_reference():
    for f in dataclasses.fields(JHardware):
        assert getattr(H100_PAPER, f.name) == getattr(J_H100, f.name)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b_opt,max_replicas,reserve",
                         [(32, None, 0.1), (8, 2, 0.1), (96, 4, 0.0),
                          (512, None, 0.5)])
def test_planner_equals_reference(arch, b_opt, max_replicas, reserve):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.kv_bytes_per_token(2) == jcfg.kv_bytes_per_token(2)
    got = ReplicationPlanner(H100_PAPER, cfg, ctx=331,
                             reserve_fraction=reserve).plan(
        b_opt, max_replicas=max_replicas)
    want = JPlanner(J_H100, jcfg, ctx=331, reserve_fraction=reserve).plan(
        b_opt, max_replicas=max_replicas)
    _eq(got, want)
    assert got.summary() == want.summary()


def test_planner_never_below_one_replica():
    cfg = get_config("opt-1.3b")
    tiny = Hardware(name="tiny", peak_flops=1e12, hbm_bw=1e11,
                    link_bw=1e10, hbm_bytes=1e6)
    plan = ReplicationPlanner(tiny, cfg, ctx=331).plan(8)
    assert plan.n_replicas == 1 and plan.total_bytes > plan.capacity_bytes


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("hit", [0.0, 0.4])
def test_decode_curves_equal_reference(arch, hit):
    got, want = _curves_pair(arch, prefix_hit_rate=hit)
    _eq(got, want)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for b in (1, 16, 96):
        g = perfmodel.decode_step_terms(cfg, b, 331, H100_PAPER)
        w = j_perf.decode_step_terms(jcfg, b, 331, J_H100)
        _eq([g.step_s, g.gpu_s, g.mem_bytes, g.flops],
            [w.step_s, w.gpu_s, w.mem_bytes, w.flops])
        g = perfmodel.prefill_step_terms(cfg, 1, 192, H100_PAPER)
        w = j_perf.prefill_step_terms(jcfg, 1, 192, J_H100)
        _eq([g.gpu_s, g.mem_bytes, g.flops], [w.gpu_s, w.mem_bytes, w.flops])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor,eps,prefill_token_s",
                         [(2.0, 0.1, None), (4.0, 0.1, 2e-5),
                          (2.0, 0.3, 1e-6)])
def test_bca_equals_reference(arch, factor, eps, prefill_token_s):
    got_c, want_c = _curves_pair(arch)
    slo = bca.slo_from_reference(got_c, 32, factor)
    assert slo == j_bca.slo_from_reference(want_c, 32, factor)
    got = bca.BatchingConfigurationAdvisor(
        got_c, slo_s=slo, eps=eps, prefill_token_s=prefill_token_s).solve()
    want = j_bca.BatchingConfigurationAdvisor(
        want_c, slo_s=slo, eps=eps, prefill_token_s=prefill_token_s).solve()
    _eq(got, want)
    assert got.summary() == want.summary()
    assert bca.knee_point(got_c, eps) == j_bca.knee_point(want_c, eps)
    _eq(bca.with_prefix_reuse(got_c, 0.3), j_bca.with_prefix_reuse(want_c,
                                                                   0.3))


def test_paper_bca_opt13b_strict():
    """The paper's Table IV case (``tests/test_core.py``): OPT-1.3B, strict
    SLO, B_opt in the neighbourhood of 96 with a small KV share."""
    curves, _ = _curves_pair("opt-1.3b")
    slo = bca.slo_from_reference(curves, 32, 2.0)
    res = bca.BatchingConfigurationAdvisor(curves, slo_s=slo,
                                           eps=0.1).solve()
    assert 48 <= res.b_opt <= 192
    assert res.kv_fraction < 0.35 and res.throughput_retained > 0.5
    plan = ReplicationPlanner(H100_PAPER, get_config("opt-1.3b"),
                              ctx=331).plan(96, max_replicas=4)
    assert plan.n_replicas >= 2 and plan.total_bytes <= plan.capacity_bytes


@pytest.mark.parametrize("arch", ARCHS)
def test_advisors_equal_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for batch in (1, 4, 64, 1024):
        for alpha in (0.0, 0.6, 0.9):
            _eq(bca.speculation_advisor(cfg, H100_PAPER, batch=batch,
                                        alpha=alpha),
                j_bca.speculation_advisor(jcfg, J_H100, batch=batch,
                                          alpha=alpha))
    for observed, hit in ((40.5, 0.0), (300.0, 0.25)):
        _eq(bca.audit_sizing(cfg, H100_PAPER, 1024,
                             observed_tokens_per_req=observed,
                             prefix_hit_rate=hit),
            j_bca.audit_sizing(jcfg, J_H100, 1024,
                               observed_tokens_per_req=observed,
                               prefix_hit_rate=hit))
    got_c, want_c = _curves_pair(arch)
    assert bca.chunk_budget_for(got_c, 64, 0.05, 1e-5) \
        == j_bca.chunk_budget_for(want_c, 64, 0.05, 1e-5)
    with pytest.raises(ValueError, match="alpha"):
        bca.speculation_advisor(cfg, H100_PAPER, batch=4, alpha=1.0)


SYNTHETIC = dict(
    batches=np.array([1., 2, 4, 8, 16, 32]),
    throughput=np.array([10., 19, 35, 60, 70, 71]),
    itl_s=np.array([.010, .011, .012, .013, .020, .040]),
    kv_fraction=np.array([.02, .04, .08, .16, .32, .64]))


@pytest.mark.parametrize("kw", [
    dict(slo_factor=2.0, eps=0.1, mesh_slices=6),
    dict(slo_factor=2.0, eps=0.1, max_replicas=4, mesh_slices=6),
    dict(slo_factor=4.0, eps=0.2, max_replicas=4),
    dict(slo_factor=2.0, eps=0.1, ref_batch=4)])
def test_decide_on_synthetic_curves_equals_reference(kw):
    """``tests/test_cluster.py``'s autoscale case and variations: the
    port's decision is the reference's, field for field."""
    got = decide(perfmodel.ServingCurves(**SYNTHETIC), hw=H100_PAPER,
                 cfg=get_config("opt-1.3b"), ctx=331, **kw)
    want = j_decide(j_perf.ServingCurves(**SYNTHETIC), hw=J_H100,
                    cfg=j_get_config("opt-1.3b"), ctx=331, **kw)
    for name in ("bca", "plan", "curves"):
        _eq(getattr(got, name), getattr(want, name))
    assert (got.n_replicas, got.per_replica_batch, got.slo_s) \
        == (want.n_replicas, want.per_replica_batch, want.slo_s)
    assert got.summary() == want.summary()
    if kw.get("mesh_slices") == 6:
        assert got.bca.b_opt == 16
        assert got.n_replicas == (3 if kw.get("max_replicas") else 6)


def test_measure_curves_on_port_engines():
    """The measured-data path on port engines: one point a ``max_batch``,
    keyed by the knob, each from a warm engine's second serve."""
    cfg = reduced(get_config("opt-1.3b"))
    model = Model(cfg, device="cpu")
    made = []

    def make_engine(b):
        made.append(b)
        return ContinuousBatchingEngine(model, EngineConfig(
            max_batch=b, block_size=8, kv_pool_tokens=1024,
            max_model_len=96, prefill_bucket=16), device="cpu")

    def workload():
        return sharegpt_like(6, cfg.vocab_size, seed=4, mean_in=12,
                             mean_out=6, max_len=40, sigma=0.3)

    curves = measure_curves(make_engine, workload, [1, 2, 4])
    assert made == [1, 2, 4]
    assert list(curves.batches) == [1.0, 2.0, 4.0]
    assert (curves.throughput > 0).all() and (curves.itl_s > 0).all()
    assert ((curves.kv_fraction > 0) & (curves.kv_fraction <= 1)).all()
    d = decide(curves, hw=H100_PAPER, cfg=cfg, ctx=64, max_replicas=4)
    assert d.per_replica_batch in (1, 2, 4) and 1 <= d.n_replicas <= 4


def test_slice_devices_divides_like_slice_mesh():
    subs = slice_devices(["cpu"] * 4, 2)
    assert [len(s) for s in subs] == [2, 2]
    assert slice_devices(["cpu"], 1) == [[torch.device("cpu")]]
    for n, r in ((4, 3), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="not divisible"):
            slice_devices(["cpu"] * n, r)


def test_sliced_cluster_one_device_a_replica():
    """``sliced``: one replica a device, each with its own copy of the
    weights; a count that does not divide raises, and a slice with a
    data axis of more than one device whose engine asks for what a data
    axis does not run (speculation) is refused (a slice of several
    devices is one engine over its mesh: tests/test_torch_mesh_cluster.py
    and tests/test_torch_mesh_data.py)."""
    cfg = reduced(get_config("opt-1.3b"))
    ecfg = EngineConfig(max_batch=2, block_size=8, kv_pool_tokens=512,
                        max_model_len=64, prefill_bucket=16)
    cluster = ReplicatedCluster.sliced(cfg, None, ecfg, ["cpu", "cpu"], 2,
                                       mode="sync")
    e0, e1 = (r.engine for r in cluster.replicas)
    assert e0.model is not e1.model
    assert e0.model.embed.tree()["tok"].data_ptr() \
        != e1.model.embed.tree()["tok"].data_ptr()
    assert [r.devices for r in cluster.replicas] == \
        [[torch.device("cpu")]] * 2
    with pytest.raises(ValueError, match="not divisible"):
        ReplicatedCluster.sliced(cfg, None, ecfg, ["cpu"] * 3, 2)
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(NotImplementedError, match="more than one card"):
        ReplicatedCluster.sliced(cfg, None, dataclasses.replace(
            ecfg, speculate=True), make_mesh((2, 1), ("data", "model"),
                                             ["cpu", "cpu"]), 1)
