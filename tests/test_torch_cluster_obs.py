"""Observability's cluster half in the port (``Observability.attach_cluster``
and ``replica_event``, ``CLUSTER_SPECS``, the cluster JSON document) on
the CPU: the scenarios of ``tests/test_observability.py`` (attach to a
cluster, fault events on the trace under the reference's event names),
``tests/test_memory_gap.py`` (a replica crash leaves a valid trace and
snapshot) and ``tests/test_metrics_export.py`` (the cluster metrics
round-trip, the Prometheus exposition passes ``lint_prometheus``, the
registry resolves and equals the reference's)."""
import ast
import dataclasses
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

from repro.serving.obs import export as j_export  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.hardware import H100_SXM5_80GB  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, FaultInjector, FaultSpec,
                                 InjectedFault, ReplicatedCluster,
                                 ServingMetrics, sharegpt_like)
from repro_torch.serving.cluster import ClusterMetrics  # noqa: E402
from repro_torch.serving.metrics import (Percentiles,  # noqa: E402
                                         collect_from_engine)
from repro_torch.serving.obs.export import (CLUSTER_SPECS,  # noqa: E402
                                            SERVING_SPECS, MetricsEmitter,
                                            _resolve, lint_prometheus,
                                            metrics_from_json,
                                            metrics_to_json,
                                            prometheus_text)
from repro_torch.serving.obs.observer import Observability  # noqa: E402
from repro_torch.serving.obs.trace import validate_chrome_trace  # noqa: E402
from repro_torch.serving.workload import FINISH_FAILED  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ECFG = dict(max_batch=4, block_size=8, kv_pool_tokens=4096,
            max_model_len=128, prefill_bucket=16)


@pytest.fixture(scope="module")
def model():
    return Model(reduced(get_config("opt-1.3b")), device="cpu")


def _cluster(model, n=2, **kw):
    return ReplicatedCluster.colocated(model, EngineConfig(**ECFG), n,
                                       policy="round-robin", **kw)


def _wl(n=6, seed=2, mean_out=8):
    return sharegpt_like(n, 512, seed=seed, mean_in=12, mean_out=mean_out,
                         max_len=48, sigma=0.4)


def _event_names(path):
    """The event names a cluster module passes to ``replica_event``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) \
                and getattr(node.func, "attr", None) == "replica_event":
            names.add(node.args[1].value)
    return names


def test_cluster_event_names_equal_reference():
    rel = "serving/cluster/cluster.py"
    ours = _event_names(ROOT / "src" / "repro_torch" / rel)
    assert ours == _event_names(ROOT / "src" / "repro" / rel)
    assert {"quarantine", "redrive", "respawn", "evict_poison",
            "watchdog_wedged", "watchdog_healed"} == ours


@pytest.mark.parametrize("respawn", [False, True])
def test_cluster_attach_and_fault_events(model, respawn):
    """Attached to a cluster, each replica on its own trace rows; a kill
    puts its quarantine, the redrives (and a respawn) on the trace, which
    stays valid; the respawned engine rejoins the same observer."""
    cluster = _cluster(model, mode="sync", respawn=respawn,
                       faults=FaultInjector.parse("replica=1,step=3"))
    obs = Observability(hw=H100_SXM5_80GB, windows=True)
    assert obs.attach_backend(cluster) is obs
    assert cluster.obs is obs and set(obs.observers) == {0, 1}
    m = cluster.run(_wl())
    assert m.faults == 1 and m.completed == 6
    doc = obs.trace.to_dict()
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"quarantine", "redrive"} <= names
    assert ("respawn" in names) == respawn
    if respawn:
        assert cluster.replicas[1].engine.obs is obs.observer(1)
    assert validate_chrome_trace(doc) == []
    assert obs.summary()["replicas"].keys() == {0, 1}
    # each scheduling round's summed queue depth feeds the windows too
    assert len(obs.windows.samples("cluster_queue_depth")) \
        == len(cluster.queue_samples) > 0


def test_replica_event_for_an_unattached_replica_is_a_noop():
    obs = Observability(hw=H100_SXM5_80GB)
    obs.replica_event(7, "quarantine", {"error": "x"})
    assert obs.trace.n_events == 0


def test_replica_crash_yields_valid_trace_and_snapshot(model, tmp_path):
    """A replica killed with recovery off: the run dies, but the
    context-managed tracer and emitter leave a loadable Chrome trace and
    a final metrics snapshot on disk."""
    cluster = _cluster(model, mode="thread", recover=False,
                       faults=FaultInjector([FaultSpec("kill", replica=1,
                                                       step=2)]))
    obs = Observability(hw=H100_SXM5_80GB, audit_memory=True, windows=True)
    obs.attach_cluster(cluster)
    tpath, mpath = str(tmp_path / "trace.json"), str(tmp_path / "m.json")
    obs.trace.autosave_path = tpath
    reqs = _wl(seed=41, mean_out=30)
    em = MetricsEmitter(mpath, interval_s=1e9, provider=lambda:
                        collect_from_engine(cluster.replicas[0].engine, reqs,
                                            1.0))
    with pytest.raises(InjectedFault):
        with obs.trace, em:
            cluster.run(reqs)
    assert validate_chrome_trace(tpath) == []
    assert json.load(open(tpath))["traceEvents"]
    assert any(r.finish_reason == FINISH_FAILED for r in reqs)
    m = metrics_from_json(mpath)
    assert m is not None and m.memgap is not None


@pytest.fixture(scope="module")
def cluster_metrics(model):
    cluster = ReplicatedCluster.colocated(
        model, EngineConfig(**ECFG, prefix_cache=True), 2, mode="sync",
        faults=FaultInjector.parse("replica=1,step=3"))
    return cluster.run(_wl())


def test_cluster_metrics_roundtrip_with_robustness(cluster_metrics):
    m = cluster_metrics
    assert m.faults == 1 and m.redriven > 0
    got = metrics_from_json(metrics_to_json(m))
    assert isinstance(got, ClusterMetrics)
    assert dataclasses.asdict(got) == dataclasses.asdict(m)
    got2 = metrics_from_json(json.dumps(metrics_to_json(m)))
    assert dataclasses.asdict(got2) == dataclasses.asdict(m)
    assert all(isinstance(rs.metrics, ServingMetrics)
               and isinstance(rs.metrics.ttft, Percentiles)
               for rs in got.per_replica)
    doc = metrics_to_json(m)
    assert (doc["schema"], doc["type"]) == ("repro.serving.metrics/v1",
                                            "ClusterMetrics")
    with pytest.raises(TypeError):
        metrics_to_json({"not": "a metrics object"})


def test_prometheus_cluster_exposition(cluster_metrics):
    text = prometheus_text(cluster_metrics)
    assert lint_prometheus(text) == []
    assert "repro_cluster_faults_total 1" in text
    assert "repro_cluster_redriven_total" in text
    assert 'replica="0"' in text and 'replica="1"' in text
    with pytest.raises(TypeError):
        prometheus_text({"not": "metrics"})


def test_cluster_registry_equals_reference(cluster_metrics):
    """The cluster registry is the reference's, metric for metric, and
    every path resolves on a real ClusterMetrics."""
    def rows(specs):
        return [dataclasses.astuple(s) for s in specs]
    assert rows(CLUSTER_SPECS) == rows(j_export.CLUSTER_SPECS)
    assert rows(SERVING_SPECS) == rows(j_export.SERVING_SPECS)
    for spec in CLUSTER_SPECS:
        _resolve(cluster_metrics, spec.path)
    names = [s.name for s in SERVING_SPECS + CLUSTER_SPECS]
    assert len(names) == len(set(names))
    assert {f.name for f in dataclasses.fields(ClusterMetrics)} \
        == {f.name for f in dataclasses.fields(
            j_export.ClusterMetrics)}


def test_engine_backend_still_attaches(model):
    eng = ContinuousBatchingEngine(model, EngineConfig(**ECFG),
                                   device="cpu")
    obs = Observability(hw=H100_SXM5_80GB)
    obs.attach_backend(eng)
    assert eng.obs is obs.observer(0)
