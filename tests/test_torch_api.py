"""The port's online serving facade (``repro_torch.serving.api``) on the
CPU, against the JAX reference: every scenario of ``tests/test_api.py``,
the four ``ServingAPI`` scenarios of ``tests/test_deadlines.py``, the two
``AsyncServingAPI`` scenarios of ``tests/test_overlap.py`` and the facade
fault scenario of ``tests/test_fault_tolerance.py`` run once on each
package, with the same weights (carried across by ``params_from_numpy``)
and the same requests; each checks the reference test's assertions on
both and then holds the port's token ids, finish reasons, freed blocks
and counters to the reference's. Wall-clock values are compared only
through the timeline's invariants.

Also pinned here: ``engine.run`` and ``cluster.run`` go through
``ServingAPI.run``, and ``engine.run`` does not fast-forward the clock
past a prompt still being prefilled (the reference's ``_EngineBackend.run``
condition), which changes a deadline's outcome under chunked prefill."""
import asyncio
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.serving as jserving  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import init_params as j_init_params  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import api as api_mod  # noqa: E402
from repro_torch.serving.workload import (FINISH_ABORT,  # noqa: E402
                                          FINISH_DEADLINE, FINISH_LENGTH,
                                          FINISH_SHED, FINISH_STOP)

BS = 8
BASE = dict(max_batch=4, block_size=BS, kv_pool_tokens=4096,
            max_model_len=256, prefill_bucket=16)
SMALL = dict(BASE, max_model_len=128)     # the deadline/overlap/fault files'
SERVED = (FINISH_LENGTH, FINISH_STOP)
VOCAB = 512


@pytest.fixture(scope="module")
def pkgs(rules):
    """The two packages behind one namespace each: ``engine(**kw)`` and
    ``cluster(n, ecfg_kw, **cluster_kw)`` build on shared weights (the
    reference's engines on one compiled ``StepFunctions``)."""
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    tcfg = reduced(get_config("opt-1.3b"))
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tmodel = Model(tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu"), device="cpu")
    jmodel = JModel(jcfg, rules)
    steps = jserving.StepFunctions.build(jmodel, BS)

    def j_engine(**kw):
        return jserving.ContinuousBatchingEngine(
            jmodel, jp, jserving.EngineConfig(**{**BASE, **kw}), steps=steps)

    def t_engine(**kw):
        return tserving.ContinuousBatchingEngine(
            tmodel, tserving.EngineConfig(**{**BASE, **kw}), device="cpu")

    def ns(mod, engine):
        return types.SimpleNamespace(
            engine=engine,
            cluster=lambda n, ecfg_kw=None, **kw: mod.ReplicatedCluster(
                [engine(**(ecfg_kw or {})) for _ in range(n)], **kw),
            **{name: getattr(mod, name) for name in (
                "Request", "SamplingParams", "ServingAPI", "AsyncServingAPI",
                "FaultInjector", "FaultSpec", "sharegpt_like")})
    return ns(jserving, j_engine), ns(tserving, t_engine)


def _both(pkgs, scenario):
    """Run ``scenario(p)`` on the reference and on the port; the port's
    outcome must equal the reference's."""
    ref, port = (scenario(p) for p in pkgs)
    assert port == ref
    return ref


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _toks(x):
    return [int(t) for t in x]


def _free(eng):
    mgr = eng.pool.manager
    return mgr.free_blocks, mgr.num_blocks


def _timeline(req):
    """The invariant every served request's stamps keep."""
    assert req.arrival_s <= req.t_first_token <= req.t_done


# ------------------------------------------------------- request model ----
def test_request_input_fields_are_frozen(pkgs):
    def scenario(p):
        req = p.Request(req_id=0, prompt=_prompt(8), max_new_tokens=4)
        for field, value in (("req_id", 1), ("prompt", None),
                             ("arrival_s", 2.0),
                             ("sampling", p.SamplingParams())):
            with pytest.raises(AttributeError):
                setattr(req, field, value)
        req.t_first_token = 1.0
        req.generated = 3
        req.output_tokens = [1, 2, 3]
        assert req.max_new_tokens == 4 == req.sampling.max_new_tokens
        return req.state.generated, req.state.output_tokens
    _both(pkgs, scenario)


def test_request_budget_conflict_rejected(pkgs):
    def scenario(p):
        with pytest.raises(TypeError):
            p.Request(req_id=0, prompt=_prompt(8))
        with pytest.raises(ValueError):
            p.Request(req_id=0, prompt=_prompt(8), max_new_tokens=4,
                      sampling=p.SamplingParams(max_new_tokens=5))
        return p.Request(req_id=0, prompt=_prompt(8), max_new_tokens=5,
                         sampling=p.SamplingParams(
                             max_new_tokens=5)).max_new_tokens
    assert _both(pkgs, scenario) == 5


# ------------------------------------------------------------ streaming ----
def test_stream_yields_deltas_and_final_reason(pkgs):
    def scenario(p):
        api = p.ServingAPI(p.engine())
        h = api.submit(_prompt(10), p.SamplingParams(max_new_tokens=6))
        events = list(api.stream(h))
        assert all(not e.finished for e in events[:-1])
        assert events[-1].finished and events[-1].finish_reason == "length"
        cat = [t for e in events for t in e.new_token_ids]
        assert tuple(cat) == events[-1].token_ids
        assert list(events[-1].token_ids) == h.request.output_tokens
        return [(_toks(e.new_token_ids), e.finished, e.finish_reason)
                for e in events]
    assert len(sum((e[0] for e in _both(pkgs, scenario)), [])) == 6


def _sampled_wl(p, n=4):
    sp = p.SamplingParams(temperature=0.7, top_p=0.9, seed=13)
    return p.sharegpt_like(n, VOCAB, seed=5, mean_in=12, mean_out=6,
                           max_len=48, sigma=0.3, sampling=sp)


def test_stream_equals_batch_run(pkgs):
    """The facade is a wrapper, not a fork: the same tokens as run(), and
    the port's equal the reference's (sampled)."""
    def scenario(p):
        reqs = _sampled_wl(p)
        p.engine().run(reqs)
        api = p.ServingAPI(p.engine())
        handles = [api.submit(r) for r in _sampled_wl(p)]
        outs = api.drain()
        got = [_toks(outs[h.req_id].token_ids) for h in handles]
        assert got == [_toks(r.output_tokens) for r in reqs]
        m = api.metrics()
        assert m.n_completed == 4 and m.finish_reasons == {"length": 4}
        return got
    _both(pkgs, scenario)


def test_generate_convenience(pkgs):
    def scenario(p):
        out = p.ServingAPI(p.engine()).generate(
            _prompt(9), p.SamplingParams(max_new_tokens=3))
        assert out.finished and out.finish_reason == "length"
        return _toks(out.token_ids)
    assert len(_both(pkgs, scenario)) == 3


# ---------------------------------------------------------------- abort ----
def test_abort_mid_decode_reclaims_blocks(pkgs):
    def scenario(p):
        eng = p.engine()
        api = p.ServingAPI(eng)
        free0 = _free(eng)
        h = api.submit(_prompt(24), p.SamplingParams(max_new_tokens=100))
        for _ in range(3):
            api._backend.pump(api._clock())
        assert h.request.generated > 1 and not h.done
        at_abort = _toks(h.request.output_tokens)
        assert api.abort(h)
        assert _free(eng) == free0 and not eng.busy
        ev = list(api.stream(h))
        assert ev[-1].finished and ev[-1].finish_reason == "abort"
        assert api.metrics().finish_reasons == {"abort": 1}
        assert not api.abort(h) and not api.abort(12345)
        return at_abort, _toks(ev[-1].token_ids), free0
    _both(pkgs, scenario)


def test_abort_mid_prefill_reclaims_blocks(pkgs):
    """Abort while PREFILLING (chunked): every block of the half-written
    prompt returns to the pool."""
    def scenario(p):
        eng = p.engine(prefill_chunk_tokens=16)
        api = p.ServingAPI(eng)
        free0 = _free(eng)
        h = api.submit(_prompt(100), p.SamplingParams(max_new_tokens=4))
        api._backend.pump(api._clock())          # one 16-token chunk
        done = eng._prefilled.get(h.req_id, 0)
        assert done > 0, "not mid-PREFILLING"
        assert api.abort(h)
        assert _free(eng) == free0
        assert not eng.busy and h.done and h.finish_reason == "abort"
        return done, h.request.generated, free0
    _both(pkgs, scenario)


def test_abort_with_prefix_cache_restores_refcounts(pkgs):
    """Aborting a request that spliced shared prefix blocks drops exactly
    its references: the cached blocks stay at refcount 1."""
    def scenario(p):
        eng = p.engine(prefix_cache=True)
        api = p.ServingAPI(eng)
        base = _prompt(32, seed=3)
        warm = api.generate(base, p.SamplingParams(max_new_tokens=2))
        cached = sorted(n.block for n in eng.prefix._iter_nodes())
        assert cached
        refs = lambda: [eng.pool.manager.ref_count(b)  # noqa: E731
                        for b in cached]
        assert refs() == [1] * len(cached)
        h = api.submit(np.concatenate([base, _prompt(16, seed=4)]),
                       p.SamplingParams(max_new_tokens=50))
        for _ in range(2):
            api._backend.pump(api._clock())
        assert eng.prefix.stats.hits >= 1
        assert api.abort(h)
        assert refs() == [1] * len(cached)
        return (_toks(warm.token_ids), cached, eng.prefix.stats.hits,
                _toks(h.request.output_tokens), _free(eng))
    _both(pkgs, scenario)


def test_abort_future_arrival_never_negative_e2e(pkgs):
    def scenario(p):
        api = p.ServingAPI(p.engine())
        h = api.submit(_prompt(8), p.SamplingParams(max_new_tokens=4),
                       arrival_s=1e6)
        assert api.abort(h)
        assert h.request.t_done >= h.request.arrival_s
        m = api.metrics()
        assert m.e2e.p50 >= 0.0
        return h.finish_reason, h.request.t_done, m.finish_reasons
    _both(pkgs, scenario)


def test_simulated_future_arrivals_keep_timeline_monotonic(pkgs):
    """A fast-forward to a simulated arrival floors every later stamp."""
    def scenario(p):
        api = p.ServingAPI(p.engine())
        near = api.submit(_prompt(8), p.SamplingParams(max_new_tokens=2))
        far = api.submit(_prompt(8, seed=1),
                         p.SamplingParams(max_new_tokens=3), arrival_s=50.0)
        outs = api.drain()
        for h in (near, far):
            assert outs[h.req_id].finished
            _timeline(h.request)
        m = api.metrics()
        assert m.e2e.p50 >= 0.0 and m.wall_s >= 45.0
        return [(_toks(outs[h.req_id].token_ids),
                 outs[h.req_id].finish_reason) for h in (near, far)]
    _both(pkgs, scenario)


def test_release_prunes_finished_handles(pkgs):
    def scenario(p):
        api = p.ServingAPI(p.engine())
        h = api.submit(_prompt(8), p.SamplingParams(max_new_tokens=2))
        assert not api.release(h)
        out = api.drain()[h.req_id]
        assert api.release(h) and not api.release(h)
        assert api.metrics().n_completed == 0
        assert h.req_id not in api.drain()
        return _toks(out.token_ids)
    _both(pkgs, scenario)


def test_submit_prebuilt_request_rejects_overrides(pkgs):
    def scenario(p):
        api = p.ServingAPI(p.engine())
        req = p.Request(req_id=0, prompt=_prompt(8), max_new_tokens=2)
        with pytest.raises(ValueError):
            api.submit(req, arrival_s=5.0)
        with pytest.raises(ValueError):
            api.submit(req, p.SamplingParams())
        return api._submitted == []
    assert _both(pkgs, scenario)


def test_abort_queued_request(pkgs):
    """Abort before admission: nothing was allocated, nothing leaks."""
    def scenario(p):
        eng = p.engine(max_batch=1)
        api = p.ServingAPI(eng)
        h1 = api.submit(_prompt(12), p.SamplingParams(max_new_tokens=30))
        api._backend.pump(api._clock())
        h2 = api.submit(_prompt(12, seed=9),
                        p.SamplingParams(max_new_tokens=5))
        assert len(eng.waiting) == 1
        assert api.abort(h2)
        assert not eng.waiting and h2.finish_reason == "abort"
        first = _toks(h1.request.output_tokens)
        api.abort(h1)
        assert not eng.busy
        return first, h1.finish_reason, h2.request.generated, _free(eng)
    _both(pkgs, scenario)


# ---------------------------------------------------------- stop tokens ----
def _stop_wl(p, sp=None):
    return p.sharegpt_like(1, VOCAB, seed=8, mean_in=12, mean_out=20,
                           max_len=48, sigma=0.1, sampling=sp)


def test_stop_token_finishes_same_step_and_releases_blocks(pkgs):
    """A stop token releases KV the same step and counts like a length
    finish; ``ignore_eos`` decodes straight through it."""
    def scenario(p):
        reqs = _stop_wl(p)
        p.engine().run(reqs)
        full = _toks(reqs[0].output_tokens)
        assert len(full) >= 4
        stop_tok = full[3]
        cut = full.index(stop_tok)
        sp = p.SamplingParams(stop_token_ids=(stop_tok,))
        eng = p.engine()
        reqs2 = _stop_wl(p, sp)
        m = eng.run(reqs2)
        assert _toks(reqs2[0].output_tokens) == full[:cut + 1]
        assert reqs2[0].finish_reason == "stop"
        assert m.finish_reasons == {"stop": 1}
        assert m.output_tokens == cut + 1
        assert _free(eng)[0] == _free(eng)[1]
        reqs3 = _stop_wl(p, dataclasses.replace(sp, ignore_eos=True))
        p.engine().run(reqs3)
        assert _toks(reqs3[0].output_tokens) == full
        assert reqs3[0].finish_reason == "length"
        return full, cut
    _both(pkgs, scenario)


def test_stop_token_on_first_prefill_token(pkgs):
    def scenario(p):
        probe = _stop_wl(p)
        p.engine().run(probe)
        first = int(probe[0].output_tokens[0])
        reqs = _stop_wl(p, p.SamplingParams(stop_token_ids=(first,)))
        eng = p.engine()
        eng.run(reqs)
        assert _toks(reqs[0].output_tokens) == [first]
        assert reqs[0].finish_reason == "stop" and not eng.busy
        return first
    _both(pkgs, scenario)


# ----------------------------------------------------- clock regression ----
def test_run_restores_clock_for_back_to_back_runs(pkgs):
    """run() leaves no epoch installed: a second run, or facade use after
    one, stamps on its own timeline."""
    def scenario(p):
        eng = p.engine()
        assert eng.clock is None
        wl = lambda s: p.sharegpt_like(  # noqa: E731
            3, VOCAB, seed=s, mean_in=10, mean_out=5, max_len=48, sigma=0.3)
        r1, r2 = wl(2), wl(3)
        m1 = eng.run(r1)
        assert eng.clock is None
        m2 = eng.run(r2)
        assert eng.clock is None
        assert m2.n_completed == 3
        assert m2.e2e.p99 <= m2.wall_s + 1e-6
        assert m1.e2e.p99 <= m1.wall_s + 1e-6
        api = p.ServingAPI(eng)
        out = api.generate(_prompt(8), p.SamplingParams(max_new_tokens=2))
        req = api._submitted[0]
        assert out.finished and req.t_done <= api._clock() + 1e-6
        return ([_toks(r.output_tokens) for r in r1 + r2],
                _toks(out.token_ids))
    _both(pkgs, scenario)


CLUSTER_ECFG = dict(max_model_len=128)


def test_cluster_run_restores_clocks(pkgs):
    def scenario(p):
        cluster = p.cluster(2, CLUSTER_ECFG, mode="sync")
        reqs = p.sharegpt_like(4, VOCAB, seed=2, mean_in=10, mean_out=5,
                               max_len=48, sigma=0.3)
        m = cluster.run(reqs)
        assert m.completed == 4
        assert all(rep.engine.clock is None for rep in cluster.replicas)
        return ([_toks(r.output_tokens) for r in reqs],
                list(cluster.router.assigned))
    _both(pkgs, scenario)


# -------------------------------------------------------- cluster facade ----
def test_facade_over_cluster_routes_and_streams(pkgs):
    """Router-aware submit, cross-replica streaming and abort through the
    same facade surface."""
    def scenario(p):
        cluster = p.cluster(2, dict(CLUSTER_ECFG, max_batch=2),
                            policy="round-robin", mode="sync")
        api = p.ServingAPI(cluster)
        h = [api.submit(_prompt(10, seed=i), p.SamplingParams(
            max_new_tokens=4 if i < 2 else 100)) for i in range(3)]
        assert cluster.router.assigned == [2, 1]
        events = list(api.stream(h[1]))          # lives on replica 1
        assert events[-1].finished and len(events[-1].token_ids) == 4
        aborted_at = _toks(h[2].request.output_tokens)
        assert api.abort(h[2])                   # replica 0, mid-flight
        outs = api.drain()
        assert outs[h[0].req_id].finish_reason == "length"
        assert outs[h[2].req_id].finish_reason == "abort"
        m = api.metrics()
        assert m.completed == 3
        assert m.finish_reasons == {"length": 2, "abort": 1}
        for rep in cluster.replicas:
            assert _free(rep.engine)[0] == _free(rep.engine)[1]
        assert api.release(h[0])
        assert sum(len(rep.requests) for rep in cluster.replicas) == 2
        assert api.metrics().completed == 2
        return ([(_toks(e.new_token_ids), e.finished) for e in events],
                aborted_at, {rid: (_toks(o.token_ids), o.finish_reason)
                             for rid, o in outs.items()})
    _both(pkgs, scenario)


def test_cluster_facade_defers_routing_to_arrival(pkgs):
    """Future arrivals are routed when they come, seeing live load."""
    def scenario(p):
        cluster = p.cluster(2, dict(CLUSTER_ECFG, max_batch=2),
                            policy="jsq", mode="sync")
        api = p.ServingAPI(cluster)
        reqs = [p.Request(req_id=i, prompt=_prompt(10, seed=i),
                          arrival_s=5.0 + i, sampling=p.SamplingParams(
                              max_new_tokens=3)) for i in range(3)]
        handles = [api.submit(r) for r in reqs]
        assert cluster.router.assigned == [0, 0]
        assert api._backend.pending == reqs
        assert api.abort(handles[2])
        assert handles[2].done and handles[2].finish_reason == "abort"
        assert handles[2].request.t_done >= reqs[2].arrival_s
        outs = api.drain()
        assert sum(cluster.router.assigned) == 2
        assert not api._backend.pending
        for h in handles[:2]:
            assert outs[h.req_id].finish_reason == "length"
            _timeline(h.request)
        m = api.metrics()
        assert m.completed == 3
        assert m.finish_reasons == {"length": 2, "abort": 1}
        assert api.release(handles[2])
        assert api.metrics().completed == 2
        return ({rid: (_toks(o.token_ids), o.finish_reason)
                 for rid, o in outs.items()}, list(cluster.router.assigned))
    _both(pkgs, scenario)


def test_metrics_wall_anchored_at_first_submit(pkgs):
    """Idle time before the first submit does not deflate throughput."""
    def scenario(p):
        api = p.ServingAPI(p.engine())
        api._t0 -= 100.0
        out = api.generate(_prompt(8), p.SamplingParams(max_new_tokens=3))
        m = api.metrics()
        assert out.finished and m.wall_s < 100.0
        return m.output_tokens, _toks(out.token_ids)
    assert _both(pkgs, scenario)[0] == 3


# ------------------------------------------- deadlines and load shedding ----
def _req(p, rid, n=12, seed=0, **sp):
    rng = np.random.default_rng(seed + rid)
    return p.Request(req_id=rid, prompt=rng.integers(0, VOCAB, n,
                                                     dtype=np.int32),
                     arrival_s=0.0, sampling=p.SamplingParams(**sp))


def test_deadline_streaming_cross_replica(pkgs):
    """A deadline finish streamed over a 2-replica cluster arrives as a
    terminal event, and the expiry aggregates into ClusterMetrics."""
    def scenario(p):
        cluster = p.cluster(2, SMALL, mode="sync")
        api = p.ServingAPI(cluster)
        normal = [api.submit(_req(p, i, seed=70, max_new_tokens=5))
                  for i in range(2)]
        doomed = api.submit(np.random.default_rng(73).integers(
            0, VOCAB, 12, dtype=np.int32), p.SamplingParams(
                max_new_tokens=64, deadline_s=0.03))
        events = list(api.stream(doomed))
        assert events[-1].finished
        api.drain()
        m = api.metrics()
        return (events[-1].finish_reason, m.deadline_expired,
                m.finish_reasons[FINISH_DEADLINE],
                [(h.finish_reason, _toks(h.request.output_tokens))
                 for h in normal])
    reason, expired, n_deadline, normal = _both(pkgs, scenario)
    assert reason == FINISH_DEADLINE and expired == n_deadline == 1
    assert all(r in SERVED for r, _ in normal)


def test_shed_queue_full_is_graceful(pkgs):
    def scenario(p):
        api = p.ServingAPI(p.engine(**{**SMALL, "max_waiting": 1,
                                       "max_batch": 1}))
        h1 = api.submit(_req(p, 0, seed=80, max_new_tokens=4))
        h2 = api.submit(_req(p, 1, seed=80, max_new_tokens=4))
        assert not h1.done and h2.done
        events = list(api.stream(h2))
        assert len(events) == 1 and events[0].finished
        api.drain()
        m = api.metrics()
        return (events[0].finish_reason, h1.finish_reason,
                _toks(h1.request.output_tokens), m.shed,
                dict(m.shed_reasons), m.finish_reasons[FINISH_SHED])
    out = _both(pkgs, scenario)
    assert out[0] == FINISH_SHED and out[1] in SERVED
    assert out[3:] == (1, {"queue_full": 1}, 1)


def test_shed_kv_pressure(pkgs):
    def scenario(p):
        eng = p.engine(**{**SMALL, "shed_kv_fraction": 0.05,
                          "max_batch": 1, "kv_pool_tokens": 256,
                          "max_model_len": 64})
        api = p.ServingAPI(eng)
        h1 = api.submit(_req(p, 0, n=24, seed=81, max_new_tokens=16))
        for _ in range(2):
            api._pump_once()
        assert eng.pool.manager.used_fraction >= 0.05
        h2 = api.submit(_req(p, 1, seed=81, max_new_tokens=4))
        assert not h2.done
        h3 = api.submit(_req(p, 2, seed=81, max_new_tokens=4))
        assert h3.done and h3.finish_reason == FINISH_SHED
        api.drain()
        return ([(h.finish_reason, _toks(h.request.output_tokens))
                 for h in (h1, h2, h3)], api.metrics().shed_reasons,
                _free(eng))
    out = _both(pkgs, scenario)
    assert [r for r, _ in out[0][:2]] == ["length"] * 2
    assert out[1] == {"kv_pressure": 1}


def test_queued_abort_counter_cluster(pkgs):
    def scenario(p):
        cluster = p.cluster(2, SMALL, mode="sync")
        api = p.ServingAPI(cluster)
        handles = [api.submit(_req(p, i, seed=85, max_new_tokens=4))
                   for i in range(3)]
        assert api.abort(handles[2])           # routed, never admitted
        api.drain()
        m = api.metrics()
        return (m.queued_aborts, m.finish_reasons[FINISH_ABORT],
                [(h.finish_reason, _toks(h.request.output_tokens))
                 for h in handles])
    assert _both(pkgs, scenario)[:2] == (1, 1)


# ---------------------------------------------------------- async facade ----
def _async_prompts(p, n, mean_out=8):
    return [_toks(r.prompt) for r in p.sharegpt_like(
        n, VOCAB, seed=3, mean_in=12, mean_out=mean_out, max_len=64,
        sigma=0.4)]


def test_async_api_matches_sync_facade(pkgs):
    """The pump thread and per-handle queues give the cooperative sync
    facade's tokens, on an overlapped engine."""
    def scenario(p):
        prompts = _async_prompts(p, 4)
        sync_api = p.ServingAPI(p.engine(**SMALL, overlap=True))
        for q in prompts:
            sync_api.submit(q)
        sync_outs = sync_api.drain()

        async def main():
            api = p.AsyncServingAPI(p.engine(**SMALL, overlap=True))
            handles = [await api.submit(q) for q in prompts]

            async def consume(h):
                toks = []
                async for ev in api.stream(h):
                    toks.extend(ev.new_token_ids)
                    if ev.finished:
                        return toks, ev.finish_reason
                return toks, None
            streamed = await asyncio.gather(*(consume(h) for h in handles))
            outs = await api.drain()
            await api.aclose()
            return streamed, outs

        streamed, outs = asyncio.run(main())
        assert set(outs) == set(sync_outs)
        for rid in outs:
            assert outs[rid].token_ids == sync_outs[rid].token_ids
            assert outs[rid].finish_reason == sync_outs[rid].finish_reason
        for (toks, reason), rid in zip(streamed, sorted(outs)):
            assert tuple(toks) == outs[rid].token_ids
            assert reason == outs[rid].finish_reason
        return {rid: (_toks(o.token_ids), o.finish_reason)
                for rid, o in outs.items()}
    _both(pkgs, scenario)


def test_async_api_abort_terminates_stream(pkgs):
    """An abort mid-stream ends that stream with ``abort`` and returns
    its blocks; the other request is served."""
    def scenario(p):
        prompts = _async_prompts(p, 2, mean_out=16)
        eng = p.engine(**SMALL, overlap=True)
        free0 = _free(eng)

        async def main():
            async with p.AsyncServingAPI(eng) as api:
                h0 = await api.submit(prompts[0])
                h1 = await api.submit(prompts[1])
                seen = []
                async for ev in api.stream(h0):
                    seen.extend(ev.new_token_ids)
                    if ev.finished:
                        break
                    if len(seen) >= 2:
                        await api.abort(h0)
                outs = await api.drain()
                return (seen, outs[h0.req_id].finish_reason,
                        outs[h1.req_id].finish_reason,
                        _toks(outs[h1.req_id].token_ids))
        seen, reason0, reason1, toks1 = asyncio.run(main())
        assert reason0 == FINISH_ABORT and reason1 in SERVED
        assert _free(eng) == free0 and not eng.busy
        return reason0, reason1, toks1
    _both(pkgs, scenario)


def test_async_close_waits_for_the_pump_and_failure_reaches_callers(pkgs):
    """``close`` joins the pump thread; a backend error on the pump thread
    reaches an open stream and every later call, never swallowed."""
    p = pkgs[1]
    eng = p.engine(**SMALL)

    def boom(now):
        raise RuntimeError("step failed")
    eng.step = boom                  # the pump's first round raises

    async def main():
        api = p.AsyncServingAPI(eng)
        h = await api.submit(_prompt(8))
        with pytest.raises(RuntimeError, match="mid-stream") as err:
            async for _ in api.stream(h):
                pass
        assert "step failed" in str(err.value.__cause__)
        with pytest.raises(RuntimeError, match="failed"):
            await api.submit(_prompt(8))
        await api.aclose()
        assert not api._thread.is_alive()
    asyncio.run(main())


# --------------------------------------------------------- fault tolerance --
def test_facade_pump_recovers_from_kill(pkgs):
    """A replica death under submit/drain redrives onto the survivor and
    every handle finishes served, with the reference's tokens."""
    def scenario(p):
        inj = p.FaultInjector([p.FaultSpec("kill", replica=1, step=3)])
        cluster = p.cluster(2, SMALL, mode="sync", faults=inj)
        api = p.ServingAPI(cluster)
        reqs = p.sharegpt_like(4, VOCAB, seed=61, mean_in=12, mean_out=8,
                               max_len=48, sigma=0.4)
        handles = [api.submit(r) for r in reqs]
        outs = api.drain()
        assert len(outs) == 4 and cluster.redriven > 0
        for h in handles:
            assert h.done and h.finish_reason in SERVED
            assert _toks(outs[h.req_id].token_ids) == \
                _toks(h.request.output_tokens)
        return ([_toks(outs[h.req_id].token_ids) for h in handles],
                cluster.redriven, cluster.lost, api.metrics().faults)
    assert _both(pkgs, scenario)[3] == 1


# ----------------------------------------------- engine.run and cluster.run --
def test_run_goes_through_the_facade(pkgs, monkeypatch):
    p = pkgs[1]
    calls = []
    real = api_mod.ServingAPI.run

    def counted(self, requests):
        calls.append(type(self.backend).__name__)
        return real(self, requests)
    monkeypatch.setattr(api_mod.ServingAPI, "run", counted)
    wl = lambda: p.sharegpt_like(2, VOCAB, seed=2, mean_in=10,  # noqa: E731
                                 mean_out=3, max_len=48, sigma=0.3)
    assert p.engine().run(wl()).n_completed == 2
    assert p.cluster(2, SMALL, mode="sync").run(wl()).completed == 2
    assert calls == ["ContinuousBatchingEngine", "ReplicatedCluster"]


def test_run_does_not_skip_ahead_over_a_half_prefilled_prompt(pkgs):
    """Chunked prefill with a later arrival: the clock may jump to the
    arrival only once no prompt is mid-prefill, so the first request
    (deadline 30 s) finishes ``length`` with 4 tokens well before the
    second arrives at 60 s, in both packages."""
    def scenario(p):
        eng = p.engine(**SMALL, prefill_chunk_tokens=16)
        reqs = [p.Request(req_id=0, prompt=_prompt(100, seed=1),
                          arrival_s=0.0, sampling=p.SamplingParams(
                              max_new_tokens=4, deadline_s=30.0)),
                p.Request(req_id=1, prompt=_prompt(12, seed=2),
                          arrival_s=60.0, sampling=p.SamplingParams(
                              max_new_tokens=4))]
        eng.run(reqs)
        ttft = [r.t_first_token for r in reqs]
        out = [(r.finish_reason, _toks(r.output_tokens)) for r in reqs]
        assert None not in ttft, out
        assert ttft[0] < 30.0 <= 60.0 <= ttft[1]
        for r in reqs:
            _timeline(r)
        return out
    out = _both(pkgs, scenario)
    assert [(reason, len(toks)) for reason, toks in out] == \
        [("length", 4), ("length", 4)]
