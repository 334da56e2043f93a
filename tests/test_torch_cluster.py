"""The port's replicated serving (``repro_torch.serving.cluster``) on the
CPU, against the JAX reference: the router policies make the reference's
choices on the same loads; one reference cluster run a module (two
co-located replicas, round-robin, sync, replica 0 on a pool small enough
to preempt) is held against the port's sync, threaded and overlapped
clusters on the same weights and workload (tokens, finish reasons and
``ClusterMetrics`` counts); and the scenarios of ``tests/test_cluster.py``,
``tests/test_overlap.py`` (overlapped cluster, idle cluster),
``tests/test_prefix_cache.py`` (prefix affinity) and
``tests/test_deadlines.py`` (cluster shedding, queued aborts) on the
port. The engine's own stream, the capture lock and ``thread_local``
capture mode, and launch counting that stays exact across threads are
pinned here too, with stand-ins for the CUDA calls (the CPU has none)."""
import contextlib
import dataclasses
import gc
import threading
import time
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
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import ReplicatedCluster as JCluster  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro.serving.cluster import router as j_router  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ops import launch_counters  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, ReplicatedCluster, Request,
                                 SamplingParams, sharegpt_like,
                                 shared_prefix_workload)
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import steps as steps_mod  # noqa: E402
from repro_torch.serving.cluster import router  # noqa: E402
from repro_torch.serving.workload import (FINISH_ABORT,  # noqa: E402
                                          FINISH_LENGTH, FINISH_SHED,
                                          FINISH_STOP)

BS = 8
BASE = dict(max_batch=4, block_size=BS, kv_pool_tokens=4096,
            max_model_len=128, prefill_bucket=16)
SERVED = (FINISH_LENGTH, FINISH_STOP)
# the preemption scenario: replica 0's pool is too small for its three
# requests to finish unpreempted, replica 1's is roomy
TIGHT = dict(max_batch=3, kv_pool_tokens=128, max_model_len=96)
ROOMY = dict(max_batch=3, kv_pool_tokens=2048, max_model_len=96)


@pytest.fixture(scope="module")
def models(rules):
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    tcfg = reduced(get_config("opt-1.3b"))
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jmodel = JModel(jcfg, rules)
    return (jmodel, jp, JStepFunctions.build(jmodel, BS),
            Model(tcfg, tp, device="cpu"))


def _ecfg(**kw):
    return EngineConfig(**{**BASE, **kw})


def _engine(models, **kw):
    return ContinuousBatchingEngine(models[3], _ecfg(**kw), device="cpu")


def _iso_wl(make=sharegpt_like):
    return make(6, 512, seed=11, mean_in=20, mean_out=36, max_len=60,
                sigma=0.1)


def _wl(n=4, seed=2, mean_out=6):
    return sharegpt_like(n, 512, seed=seed, mean_in=12, mean_out=mean_out,
                         max_len=48, sigma=0.4)


def _outcome(reqs):
    return [(r.finish_reason, list(map(int, r.output_tokens)))
            for r in reqs]


def _counts(m):
    """A ClusterMetrics' counts (what must equal the reference's)."""
    return dict(
        completed=m.completed, total_tokens=m.total_tokens,
        output_tokens=m.output_tokens, n_replicas=m.n_replicas,
        policy=m.policy, mode=m.mode, preemptions=m.preemptions,
        finish_reasons={k: v for k, v in m.finish_reasons.items() if v},
        faults=m.faults, redriven=m.redriven, lost=m.lost, shed=m.shed,
        deadline_expired=m.deadline_expired, queued_aborts=m.queued_aborts,
        max_queue_depth=m.max_queue_depth,
        per_replica=[(r.replica, r.n_requests, r.completed, r.preemptions,
                      r.max_queue_depth, r.healthy, r.faults)
                     for r in m.per_replica])


_REF = {}


def _reference(models):
    """The reference's preemption-isolation cluster, run once a module:
    (requests, ClusterMetrics, router assignments)."""
    if not _REF:
        jmodel, jp, steps, _ = models
        engines = [JEngine(jmodel, jp, JEngineConfig(**{**BASE, **kw}),
                           steps=steps) for kw in (TIGHT, ROOMY)]
        cluster = JCluster(engines, policy="round-robin", mode="sync")
        reqs = _iso_wl(j_sharegpt_like)
        m = cluster.run(reqs)
        _REF.update(reqs=reqs, m=m, assigned=list(cluster.router.assigned))
    return _REF


def _port_iso(models, mode="sync", **kw):
    cluster = ReplicatedCluster(
        [_engine(models, **TIGHT, **kw), _engine(models, **ROOMY, **kw)],
        policy="round-robin", mode=mode)
    reqs = _iso_wl()
    return cluster, reqs, cluster.run(reqs)


# --------------------------------------------------------------- router --
@dataclasses.dataclass
class _Stub:
    idx: int
    queue_depth: int = 0
    in_flight: int = 0
    kv_load: float = 0.0

    @property
    def load(self):
        return self.queue_depth + self.in_flight


@pytest.mark.parametrize("policy", sorted(router.POLICIES))
def test_router_choices_equal_reference(policy):
    """Every policy, port and reference, on the same 200 arrivals over
    random loads (ties included) and prompts sharing prefixes, through
    ``Router`` with eligible-only views: the same picks and the same
    per-replica assignment counts."""
    rng = np.random.default_rng(7)
    kw = dict(affinity_tokens=8, max_skew=3) \
        if policy == "prefix-affinity" else {}
    ours = router.Router(router.POLICIES[policy](**kw), 4)
    ref = j_router.Router(j_router.POLICIES[policy](**kw), 4)
    for i in range(200):
        view = [_Stub(j, int(rng.integers(0, 4)), int(rng.integers(0, 3)),
                      float(rng.integers(0, 4)) / 4) for j in range(4)]
        view = [s for s in view if rng.random() > 0.2] or view
        prompt = np.concatenate([np.full(8, rng.integers(0, 5), np.int32),
                                 rng.integers(0, 512, 4, dtype=np.int32)])
        req = types.SimpleNamespace(prompt=prompt, req_id=i)
        assert ours.route(req, view) == ref.route(req, view)
    assert ours.assigned == ref.assigned
    ours.reset()
    assert ours.assigned == [0] * 4


def test_policy_registry():
    assert sorted(router.POLICIES) == sorted(j_router.POLICIES)
    assert router.make_policy("jsq").name == "jsq"
    inst = router.LeastKVLoad()
    assert router.make_policy(inst) is inst
    with pytest.raises(ValueError, match="unknown router policy"):
        router.make_policy("random-telepathy")
    r = router.Router("round-robin", 2)
    r.route(None, [_Stub(0), _Stub(1)])
    assert r.assigned == [1, 0]


# ------------------------------------------------- against the reference --
def test_sync_cluster_equals_reference(models):
    """Round-robin over two co-located replicas, replica 0 preempting:
    tokens, finish reasons, router assignments and ClusterMetrics counts
    equal the reference cluster's; pools drain on both replicas."""
    ref = _reference(models)
    cluster, reqs, m = _port_iso(models)
    assert _outcome(reqs) == _outcome(ref["reqs"])
    assert cluster.router.assigned == ref["assigned"] == [3, 3]
    assert _counts(m) == _counts(ref["m"])
    e0, e1 = (r.engine for r in cluster.replicas)
    assert e0.preemptions > 0 and e1.preemptions == 0
    assert e0.steps is not e1.steps and e0.pool is not e1.pool
    for eng in (e0, e1):
        assert eng.pool.manager.tables == {}
        assert eng.pool.manager.free_blocks == eng.pool.manager.num_blocks
    # the aggregate view adds up (tests/test_cluster.py's round-robin case)
    assert m.total_tokens == sum(r.metrics.total_tokens
                                 for r in m.per_replica)
    assert m.output_tokens == sum(r.generated for r in reqs)
    assert m.goodput_rps > 0 and m.output_throughput > 0
    assert 0 < m.ttft.p50 <= m.ttft.p95 <= m.ttft.p99
    assert 0 < m.itl.p50 <= m.itl.p99
    assert all(0 < r.occupancy <= 1.0 for r in m.per_replica)
    assert m.summary()


@pytest.mark.parametrize("mode,overlap", [("thread", False), ("sync", True),
                                          ("thread", True)])
def test_threaded_and_overlapped_clusters_equal_reference(models, mode,
                                                          overlap):
    """Thread-per-replica stepping and overlapped engines change no
    token and no finish reason (``tests/test_overlap.py``'s overlapped
    cluster, ``tests/test_cluster.py``'s threaded cluster)."""
    ref = _reference(models)
    cluster, reqs, m = _port_iso(models, mode=mode, overlap=overlap)
    assert _outcome(reqs) == _outcome(ref["reqs"])
    assert m.completed == 6 and m.mode == mode
    assert cluster.router.assigned == [3, 3]
    if mode == "thread":
        # an offline workload is routed before the replica loops start:
        # every replica runs the batches the sync cluster runs
        sync, _, _ = _port_iso(models, overlap=overlap)
        for a, b in zip(cluster.replicas, sync.replicas):
            assert list(a.engine.batch_samples) \
                == list(b.engine.batch_samples)
            assert a.engine.preemptions == b.engine.preemptions


def test_replica_isolation_equals_a_bare_engine(models):
    """Replica 1's tokens equal a bare port engine's serve of its share
    (the odd requests), which equal the reference cluster's: replica 0's
    pool exhaustion perturbs nothing of replica 1's."""
    ref = _reference(models)
    odd = [r for i, r in enumerate(_iso_wl()) if i % 2 == 1]
    _engine(models, **ROOMY).run(odd)
    assert _outcome(odd) == [o for i, o in enumerate(_outcome(ref["reqs"]))
                             if i % 2 == 1]


# ------------------------------------------------------ port scenarios --
def test_sync_single_replica_matches_bare_engine(models):
    bare = _wl()
    _engine(models).run(bare)
    cluster = ReplicatedCluster([_engine(models)], mode="sync")
    routed = _wl()
    m = cluster.run(routed)
    assert m.completed == len(routed)
    assert _outcome(routed) == _outcome(bare)


def test_colocated_replicas_share_the_model_not_the_pool(models):
    cluster = ReplicatedCluster.colocated(models[3], _ecfg(), 3,
                                          mode="sync")
    engs = [r.engine for r in cluster.replicas]
    assert all(e.model is models[3] for e in engs)
    assert len({id(e.pool) for e in engs}) == 3
    assert len({id(e.steps) for e in engs}) == 3
    assert [e.replica_id for e in engs] == [0, 1, 2]


def test_timed_arrivals_keep_nonnegative_ttft(models):
    reqs = sharegpt_like(3, 512, seed=6, mean_in=10, mean_out=4, max_len=32,
                         sigma=0.2, arrival_rate=0.5)
    assert reqs[-1].arrival_s > 1.0
    cluster = ReplicatedCluster([_engine(models), _engine(models)],
                                mode="sync")
    m = cluster.run(reqs)
    assert m.completed == 3
    for r in reqs:
        assert r.t_first_token >= r.arrival_s
        assert r.t_done >= r.t_first_token
    assert m.ttft_s >= 0 and m.ttft.p50 >= 0 and m.e2e.p50 >= 0


def test_reused_steps_must_match_engine_config(models):
    eng = _engine(models)
    with pytest.raises(ValueError, match="block_size"):
        ContinuousBatchingEngine(models[3], _ecfg(block_size=16),
                                 device="cpu", steps=eng.steps)
    with pytest.raises(ValueError, match="sized for"):
        ContinuousBatchingEngine(models[3], _ecfg(max_batch=2),
                                 device="cpu", steps=eng.steps)
    other = Model(models[3].cfg, device="cpu")
    with pytest.raises(ValueError, match="different Model"):
        ContinuousBatchingEngine(other, _ecfg(), device="cpu",
                                 steps=eng.steps)


def test_cluster_constructor_validation(models):
    with pytest.raises(ValueError, match="at least one"):
        ReplicatedCluster([])
    with pytest.raises(ValueError, match="mode"):
        ReplicatedCluster([_engine(models)], mode="warp")
    with pytest.raises(ValueError, match="slices"):
        ReplicatedCluster([_engine(models)], slices=[["cpu"], ["cpu"]])
    with pytest.raises(ValueError, match="max_redrives"):
        ReplicatedCluster([_engine(models)], max_redrives=-1)
    with pytest.raises(ValueError, match="watchdog_s"):
        ReplicatedCluster([_engine(models)], watchdog_s=0)


def test_idle_cluster_burns_no_steps(models):
    """Threaded replica loops park on the work condition variable while
    every arrival is still in the future."""
    cluster = ReplicatedCluster([_engine(models), _engine(models)],
                                mode="thread")
    reqs = [Request(req_id=r.req_id, prompt=r.prompt, arrival_s=0.4,
                    sampling=r.sampling, max_new_tokens=r.max_new_tokens)
            for r in _wl(seed=5)]
    samples = []

    def watcher():
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.3:
            samples.append(sum(rep.engine.step_count
                               for rep in cluster.replicas))
            time.sleep(0.02)

    w = threading.Thread(target=watcher)
    w.start()
    m = cluster.run(reqs)
    w.join()
    assert samples and max(samples) == 0, samples
    assert m.completed == len(reqs)


def test_cluster_prefix_affinity_and_aggregation(models):
    """Two replicas with prefix caches behind affinity routing: each
    tenant stays home, tokens equal the cache-off cluster's, and
    ClusterMetrics pools the reuse (``tests/test_prefix_cache.py``)."""
    outs = {}
    for on in (False, True):
        ecfg = EngineConfig(max_batch=4, block_size=16, kv_pool_tokens=8192,
                            max_model_len=256, prefill_bucket=32,
                            prefix_cache=on)
        cluster = ReplicatedCluster.colocated(
            models[3], ecfg, 2,
            policy=router.PrefixAffinity(affinity_tokens=48), mode="sync")
        reqs = shared_prefix_workload(2, 4, 512, prefix_len=48,
                                      suffix_len=16, max_new_tokens=5,
                                      seed=3)
        cm = cluster.run(reqs)
        assert cm.completed == len(reqs)
        outs[on] = _outcome(reqs)
        if on:
            assert cm.prefill_tokens_skipped > 0
            assert 0.0 < cm.prefix_hit_rate < 1.0
            assert cm.prefix_blocks_shared > 0 and cm.peak_kv_fraction > 0
            assert "prefix cache" in cm.summary()
            by_rep = [sorted(r.req_id % 2 for r in rep.requests)
                      for rep in cluster.replicas]
            assert all(len(set(ids)) <= 1 for ids in by_rep if ids)
    assert outs[True] == outs[False]


def _req(rid, seed, **sp):
    prompt = np.random.default_rng(seed + rid).integers(0, 512, 12,
                                                        dtype=np.int32)
    return Request(req_id=rid, prompt=prompt, arrival_s=0.0,
                   sampling=SamplingParams(**sp))


def test_cluster_sheds_only_when_every_replica_full(models):
    engines = [_engine(models, max_waiting=1, max_batch=1)
               for _ in range(2)]
    cluster = ReplicatedCluster(engines, mode="sync")
    reqs = [_req(i, 83, max_new_tokens=4) for i in range(6)]
    m = cluster.run(reqs)
    assert m.shed > 0 and m.completed == 6
    assert all(r.t_done is not None for r in reqs)
    served = [r for r in reqs if r.finish_reason in SERVED]
    shed = [r for r in reqs if r.finish_reason == FINISH_SHED]
    assert len(served) + len(shed) == 6 and served
    assert m.finish_reasons[FINISH_SHED] == len(shed) == m.shed
    assert "queue_full" in cluster.shed_reasons


def test_queued_abort_counter_cluster(models):
    """A request routed to a replica but never admitted, aborted there,
    counts once in ``queued_aborts`` and once as an abort."""
    cluster = ReplicatedCluster([_engine(models), _engine(models)],
                                mode="sync")
    reqs = [_req(i, 85, max_new_tokens=4) for i in range(3)]
    reps = [cluster.route_one(r) for r in reqs]
    assert reps[2].engine.abort(reqs[2].req_id)
    m = cluster.run([])
    assert m.queued_aborts == 1 and m.finish_reasons[FINISH_ABORT] == 1
    assert reqs[2].finish_reason == FINISH_ABORT
    assert all(r.finish_reason in SERVED for r in reqs[:2])


# --------------------------------------- streams, captures and launches --
def test_each_engine_steps_on_its_own_stream(models, monkeypatch):
    """Every step, abort and eviction of an engine enters the engine's
    own stream (each engine owns one; a stand-in object here, the CPU
    having none), on whichever thread steps it."""
    seen = []

    def recording(stream):
        seen.append((stream, threading.get_ident()))
        return contextlib.nullcontext()

    engines = [_engine(models), _engine(models)]
    monkeypatch.setattr(engine_mod, "on_stream", recording)
    for i, e in enumerate(engines):
        e.steps.stream = f"stream-{i}"
    cluster = ReplicatedCluster(engines, mode="thread")
    reqs = _wl(n=4, seed=3)
    m = cluster.run(reqs)
    assert m.completed == 4
    steps = sum(e.step_count for e in engines)
    assert len(seen) == steps
    for e in engines:
        assert e.stream == f"stream-{engines.index(e)}"
    threads = {s: {t for st, t in seen if st == s} for s, _ in seen}
    assert set(threads) == {"stream-0", "stream-1"}
    assert threads["stream-0"].isdisjoint(threads["stream-1"])
    late = _req(9, 86, max_new_tokens=4)
    engines[0].add_request(late)
    assert engines[0].abort(9) and seen[-1][0] == "stream-0"


def test_launch_counts_stay_exact_across_threads():
    """Launches counted on many threads at once all land; a thread
    tallying (a capture) takes none of another thread's."""
    fn = launch_counters()["paged_decode_attention"]
    saved = fn.launches
    try:
        fn.launches = 0
        start = threading.Barrier(5)
        tallied = {}

        def count(n):
            start.wait()
            for _ in range(n):
                launches.count_launch(fn)

        def capture():
            with launches.tally_launches() as tally:
                start.wait()
                for _ in range(3000):
                    launches.count_launch(fn)
                tallied.update(tally)

        threads = [threading.Thread(target=count, args=(5000,))
                   for _ in range(4)] + [threading.Thread(target=capture)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert fn.launches == 20000 and tallied == {fn: 3000}
        launches.add_counts({fn: 7})
        assert fn.launches == 20007
        with launches.tally_launches():
            with pytest.raises(RuntimeError, match="already"):
                with launches.tally_launches():
                    pass
    finally:
        fn.launches = saved


class _FakeStream:
    def wait_stream(self, other):
        pass


def test_capture_takes_the_lock_in_thread_local_mode(models, monkeypatch):
    """A bucket's first use captures under the process-wide capture lock,
    in ``thread_local`` mode, with the collector off; the launches the
    capture records are its own tally (another thread's launches during
    the capture still count), and each replay adds them. The CUDA calls
    are stand-ins: the CPU has no graphs."""
    fn = launch_counters()["paged_decode_attention"]
    saved = fn.launches
    calls = []

    def counted(*a, **k):
        launches.count_launch(fn)
        return ops_paged(*a, **k)

    ops_paged = ops.paged_decode_attention
    monkeypatch.setattr(ops, "paged_decode_attention", counted)

    class FakeGraph:
        def replay(self):
            calls.append("replay")

    @contextlib.contextmanager
    def fake_graph(graph, stream=None, pool=None,
                   capture_error_mode="global"):
        calls.append((capture_error_mode, steps_mod._CAPTURE_LOCK.locked(),
                      gc.isenabled(), pool))
        other = threading.Thread(target=lambda: [
            launches.count_launch(fn) for _ in range(5)])
        other.start()
        other.join()
        yield

    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    eng = _engine(models)
    st = eng.steps
    st.graphs_on = True
    st._side = _FakeStream()
    st._decode_pool, st._prefill_pool = "decode-pool", "prefill-pool"
    try:
        fn.launches = 0
        eng.pool.manager.allocate(0, 20)
        req = types.SimpleNamespace(sampling=SamplingParams())
        layers = models[3].cfg.n_layers
        st.paged([req], [0], [10], [1])
        assert calls == [("thread_local", True, False, "decode-pool")]
        assert not steps_mod._CAPTURE_LOCK.locked() and gc.isenabled()
        (key, captured), = st.graphs.items()
        assert captured.launches["paged_decode_attention"] == layers
        # the eager warm-up's launches and the other thread's count
        assert fn.launches == layers + 5
        st.paged([req], [0], [10], [1])
        assert calls[-1] == "replay" and fn.launches == 2 * layers + 5
    finally:
        fn.launches = saved
