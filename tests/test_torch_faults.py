"""Fault tolerance of the port's cluster (``repro_torch.serving.faults``,
the engine's and the scheduler's hooks, the cluster's recovery ladder)
on the CPU, against the JAX reference: fault specs, their parsing and the
seeded ``random_kill`` equal the reference's; one reference cluster run a
module (two replicas, sync, no fault, greedy and sampled requests) gives
the tokens every port run with a ``kill`` must reproduce — sync,
threaded, overlapped, and the victim chosen among sampled requests; and
the scenarios of ``tests/test_fault_tolerance.py`` (all but the serving
API's, which is not ported): alloc-fail, respawn over the dead engine's
pool and graphs, the poison request, every replica dead, the redrive
budget, ``recover=False`` and the watchdog. A stream that cannot be
drained (a device fault) is not reused."""
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
from repro.serving import FaultInjector as JFaultInjector  # noqa: E402
from repro.serving import FaultSpec as JFaultSpec  # noqa: E402
from repro.serving import ReplicatedCluster as JCluster  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import parse_fault as j_parse_fault  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, FaultInjector, FaultSpec,
                                 InjectedFault, ReplicatedCluster, Request,
                                 RequestTooLarge, SamplingParams,
                                 parse_fault, sharegpt_like)
from repro_torch.serving.workload import (FINISH_FAILED,  # noqa: E402
                                          FINISH_LENGTH, FINISH_STOP)

BS = 8
BASE = dict(max_batch=4, block_size=BS, kv_pool_tokens=4096,
            max_model_len=128, prefill_bucket=16)
SERVED = (FINISH_LENGTH, FINISH_STOP)


@pytest.fixture(scope="module")
def models(rules):
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    tcfg = reduced(get_config("opt-1.3b"))
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jmodel = JModel(jcfg, rules)
    return (jmodel, jp, JStepFunctions.build(jmodel, BS),
            Model(tcfg, tp, device="cpu"))


def _engine(models, **kw):
    return ContinuousBatchingEngine(models[3], EngineConfig(**{**BASE, **kw}),
                                    device="cpu")


def _pair(models, **kw):
    return [_engine(models, **kw), _engine(models, **kw)]


def _wl(n=4, seed=2, mean_out=6, make=sharegpt_like):
    return make(n, 512, seed=seed, mean_in=12, mean_out=mean_out, max_len=48,
                sigma=0.4)


def _mixed(ref=False):
    """Six greedy requests and four sampled ones (temperature 0.8, top-k
    20, a seed each), all at t=0: the workload every kill must leave as
    the fault-free run serves it."""
    R, S = (JRequest, JSamplingParams) if ref else (Request, SamplingParams)
    reqs = _wl(6, 9, 10, make=j_sharegpt_like if ref else sharegpt_like)
    rng = np.random.default_rng(17)
    return reqs + [R(req_id=100 + i,
                     prompt=rng.integers(0, 512, 10, dtype=np.int32),
                     arrival_s=0.0,
                     sampling=S(temperature=0.8, top_k=20, seed=100 + i,
                                max_new_tokens=8))
                   for i in range(4)]


def _outputs(reqs):
    return [(r.req_id, r.finish_reason, list(map(int, r.output_tokens)))
            for r in reqs]


_REF = {}


def _reference(models):
    """The reference's fault-free two-replica sync run of :func:`_mixed`,
    once a module."""
    if not _REF:
        jmodel, jp, steps, _ = models
        reqs = _mixed(ref=True)
        JCluster([JEngine(jmodel, jp, JEngineConfig(**BASE), steps=steps)
                  for _ in range(2)], mode="sync").run(reqs)
        assert all(r.finish_reason in SERVED for r in reqs)
        _REF["outputs"] = _outputs(reqs)
    return _REF["outputs"]


# ---------------------------------------------------------- fault specs --
def test_fault_spec_validation():
    for Spec in (FaultSpec, JFaultSpec):
        with pytest.raises(ValueError, match="kind"):
            Spec(kind="explode", replica=0, step=1)
        with pytest.raises(ValueError, match="replica"):
            Spec(kind="kill", replica=-1, step=1)
        with pytest.raises(ValueError, match="step"):
            Spec(kind="kill", replica=0, step=0)
        with pytest.raises(ValueError, match="seconds"):
            Spec(kind="delay", replica=0, step=1, seconds=-1)


@pytest.mark.parametrize("text", [
    "replica=1,step=50", "replica=0, step=3, kind=delay, seconds=0.25",
    "kind=alloc-fail,replica=2,step=7", "replica=0,step=1,color=red",
    "step=1", "replica=0,step", "replica=0,step=1,kind=explode"])
def test_parse_fault_equals_reference(text):
    def parsed(parse):
        try:
            s = parse(text)
        except ValueError as e:
            return ("error", str(e))
        return (s.kind, s.replica, s.step, s.seconds)
    assert parsed(parse_fault) == parsed(j_parse_fault)


def test_injector_fires_once_at_or_after_step():
    inj = FaultInjector([FaultSpec("kill", replica=0, step=3)])
    inj.on_step(0, 1)
    inj.on_step(1, 5)                     # other replica: never fires
    with pytest.raises(InjectedFault):
        inj.on_step(0, 4)                 # at-or-after semantics
    assert not inj.pending and len(inj.fired) == 1
    inj.on_step(0, 5)                     # fires exactly once
    inj.reset()
    assert inj.pending == (FaultSpec("kill", replica=0, step=3),)
    assert inj.steals_allocation(0, 1) is False


def test_random_kill_equals_reference():
    for seed in range(20):
        for n, steps in ((1, 1), (4, 100), (3, 7)):
            a = FaultInjector.random_kill(n, steps, seed=seed).specs[0]
            b = JFaultInjector.random_kill(n, steps, seed=seed).specs[0]
            assert (a.kind, a.replica, a.step) == (b.kind, b.replica, b.step)
    with pytest.raises(ValueError):
        FaultInjector.random_kill(0, 5)


def test_alloc_fail_fault_skips_one_admission(models):
    eng = _engine(models)
    eng.faults = FaultInjector([FaultSpec("alloc-fail", replica=0, step=1)])
    req = _wl(n=1, seed=5)[0]
    eng.add_request(req)
    eng.step(0.0)
    assert len(eng.waiting) == 1          # admission stolen, request waits
    eng.step(0.0)
    assert not eng.waiting
    while eng.busy:
        eng.step(0.0)
    assert req.finish_reason in SERVED


# ------------------------------------------------------- kill + redrive --
@pytest.mark.parametrize("mode,overlap,victim,step", [
    ("sync", False, 1, 4), ("thread", False, 1, 4), ("sync", True, 1, 4),
    ("thread", True, 1, 4), ("sync", False, 0, 3)])
def test_kill_recovery_equals_reference(models, mode, overlap, victim,
                                        step):
    """A replica killed mid-serve is quarantined and its requests redriven
    onto the survivor, which regenerates the reference's fault-free
    tokens, greedy and sampled (replica 0 serves sampled requests when it
    dies at step 3); under overlap the dead replica's in-flight steps are
    dropped."""
    want = _reference(models)
    inj = FaultInjector([FaultSpec("kill", replica=victim, step=step)])
    cluster = ReplicatedCluster(_pair(models, overlap=overlap), mode=mode,
                                faults=inj)
    reqs = _mixed()
    m = cluster.run(reqs)
    assert len(inj.fired) == 1
    assert m.faults == 1 and m.redriven > 0 and m.lost == 0
    assert m.completed == len(reqs)
    assert _outputs(reqs) == want
    dead = cluster.replicas[victim]
    assert not dead.healthy and isinstance(dead.error, InjectedFault)
    assert not dead.engine._executor._inflight
    stats = m.per_replica[victim]
    assert not stats.healthy and stats.faults == 1
    assert stats.availability < 1.0 and m.availability < 1.0
    if victim == 0:
        assert any(r.sampling.temperature > 0 for r in reqs
                   if r in cluster.replicas[1].requests)
    assert "faults:" in m.summary()


@pytest.mark.parametrize("mode", ["sync", "thread"])
def test_respawn_reuses_the_pool_and_graphs(models, mode):
    """With ``respawn=True`` the dead replica is rebuilt over its
    engine's StepFunctions (pool tensors, graphs, stream) with a fresh
    allocator, and takes requests again."""
    want = _reference(models)
    inj = FaultInjector([FaultSpec("kill", replica=1, step=3)])
    engines = _pair(models)
    steps1, pool1 = engines[1].steps, engines[1].pool
    cluster = ReplicatedCluster(engines, mode=mode, faults=inj, respawn=True)
    reqs = _mixed()
    m = cluster.run(reqs)
    assert m.faults == 1 and m.completed == len(reqs) and m.lost == 0
    assert _outputs(reqs) == want
    rep = cluster.replicas[1]
    assert rep.healthy and rep.downtime >= 0.0
    assert rep.engine is not engines[1] and rep.engine.replica_id == 1
    assert rep.engine.steps is steps1 and rep.engine.pool is pool1
    mgr = rep.engine.pool.manager
    assert mgr.free_blocks == mgr.num_blocks and mgr.tables == {}
    # the respawned replica served again: redriven requests came home
    assert rep.engine.step_count > 0 and rep.requests
    assert all(r.finish_reason in SERVED for r in rep.requests)
    stats = m.per_replica[1]
    assert stats.healthy and stats.faults == 1


def test_undrainable_stream_is_not_reused(models):
    """A stream that raises when drained (a device fault: the CUDA
    context is lost) quarantines the replica without a respawn; its
    requests still go to the survivor. A stand-in stream here."""
    class Faulted:
        def synchronize(self):
            raise RuntimeError("CUDA error: an illegal memory access")

    want = _reference(models)
    inj = FaultInjector([FaultSpec("kill", replica=1, step=3)])
    engines = _pair(models)
    engines[1].steps.stream = Faulted()
    cluster = ReplicatedCluster(engines, mode="sync", faults=inj,
                                respawn=True)
    reqs = _mixed()
    m = cluster.run(reqs)
    assert not cluster.replicas[1].healthy
    assert cluster.replicas[1].engine is engines[1]
    assert m.redriven > 0 and _outputs(reqs) == want


def test_poison_request_evicted_not_fatal(models):
    eng = _engine(models, kv_pool_tokens=128, max_model_len=128,
                  prefill_bucket=128)
    rng = np.random.default_rng(3)
    poison = Request(req_id=99, prompt=rng.integers(0, 512, 120,
                                                    dtype=np.int32),
                     arrival_s=0.0, sampling=SamplingParams(max_new_tokens=4))
    small = [Request(req_id=i, prompt=rng.integers(0, 512, 6,
                                                   dtype=np.int32),
                     arrival_s=0.0, sampling=SamplingParams(max_new_tokens=4))
             for i in range(3)]
    cluster = ReplicatedCluster([eng], mode="sync")
    m = cluster.run([poison] + small)
    assert poison.finish_reason == FINISH_FAILED
    assert all(r.finish_reason in SERVED for r in small)
    assert cluster.replicas[0].healthy
    assert m.lost == 1 and m.faults == 1 and m.completed == 4
    assert m.finish_reasons[FINISH_FAILED] == 1
    assert issubclass(RequestTooLarge, RuntimeError)


def test_all_replicas_dead_requests_fail_without_hang(models):
    inj = FaultInjector([FaultSpec("kill", replica=0, step=2),
                         FaultSpec("kill", replica=1, step=2)])
    cluster = ReplicatedCluster(_pair(models), mode="sync", faults=inj)
    reqs = _wl(n=6, seed=31, mean_out=20)
    m = cluster.run(reqs)
    assert m.faults == 2 and m.completed == 6
    assert all(r.t_done is not None for r in reqs)
    assert any(r.finish_reason == FINISH_FAILED for r in reqs)
    assert not any(rep.healthy for rep in cluster.replicas)
    assert m.availability < 1.0


def test_redrive_budget_caps_retries(models):
    inj = FaultInjector([FaultSpec("kill", replica=1, step=3)])
    cluster = ReplicatedCluster(_pair(models), mode="sync", faults=inj,
                                max_redrives=0)
    reqs = _wl(n=6, seed=9, mean_out=10)
    m = cluster.run(reqs)
    assert m.redriven == 0 and m.lost > 0
    assert all(r.t_done is not None for r in reqs)
    assert any(r.finish_reason in SERVED for r in reqs)


def test_recover_false_threaded_stops_promptly_and_stamps(models):
    inj = FaultInjector([FaultSpec("kill", replica=1, step=2)])
    cluster = ReplicatedCluster(_pair(models), mode="thread", faults=inj,
                                recover=False)
    reqs = _wl(n=6, seed=41, mean_out=30)
    with pytest.raises(InjectedFault):
        cluster.run(reqs)
    assert all(r.t_done is not None for r in reqs)
    assert any(r.finish_reason == FINISH_FAILED for r in reqs)


@pytest.mark.parametrize("mode", ["sync", "thread"])
def test_watchdog_trips_on_delayed_step(models, mode):
    inj = FaultInjector([FaultSpec("delay", replica=0, step=2,
                                   seconds=0.05)])
    cluster = ReplicatedCluster(_pair(models), mode=mode, faults=inj,
                                watchdog_s=0.01)
    reqs = _wl(n=6, seed=51, mean_out=10)
    m = cluster.run(reqs)
    assert m.watchdog_trips >= 1 and m.completed == 6
    assert all(r.finish_reason in SERVED for r in reqs)
    assert all(rep.healthy for rep in cluster.replicas)
