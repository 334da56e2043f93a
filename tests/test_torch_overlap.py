"""The port's overlapped engine (``EngineConfig(overlap=True)``: the
executor keeps two decode steps in flight and commits them later) on the
CPU: token for token equal to the port's synchronous loop and to the JAX
reference engine's synchronous tokens (one reference run a family) for
greedy and sampled decoding, chunked prefill, the prefix cache,
preemption in a starved pool and the gather mode (the families of
``tests/test_overlap.py``); a mid-overlap abort reclaims the dispatched
step's blocks and leaves the survivors' tokens as they were; eviction,
queued aborts, a deferred device error's attribution, and speculation
accepted under overlap."""
import dataclasses

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
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro.serving import \
    shared_prefix_workload as j_shared_prefix  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, SamplingParams,
                                 shared_prefix_workload, sharegpt_like)
from repro_torch.serving.executor import InFlightStep  # noqa: E402
from repro_torch.serving.workload import (FINISH_ABORT,  # noqa: E402
                                          FINISH_FAILED)

SAMPLED = dict(temperature=0.9, top_k=40, seed=11)
BASE = dict(max_batch=4, block_size=8, kv_pool_tokens=4096,
            max_model_len=128, prefill_bucket=16)


@pytest.fixture(scope="module")
def models(rules):
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    tcfg = reduced(get_config("opt-1.3b"))
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jmodel = JModel(jcfg, rules)
    return (jmodel, jp, JStepFunctions.build(jmodel, 8),
            Model(tcfg, tp, device="cpu"))


def _sharegpt(reference, n=5, seed=2, mean_in=12, mean_out=8, max_len=64,
              sigma=0.4, sampling=None):
    make, params = ((j_sharegpt_like, JSamplingParams) if reference
                    else (sharegpt_like, SamplingParams))
    return make(n, 512, seed=seed, mean_in=mean_in, mean_out=mean_out,
                max_len=max_len, sigma=sigma,
                sampling=params(**sampling) if sampling else None)


def _shared_prefix(reference):
    make = j_shared_prefix if reference else shared_prefix_workload
    return make(2, 3, 512, prefix_len=24, suffix_len=8, max_new_tokens=6,
                seed=3)


# family: (workload, the port's settings); the reference serves each
# workload once, serially (its own tests hold its chunked, prefix-cache
# and gather tokens to those)
FAMILIES = {
    "greedy": (lambda ref: _sharegpt(ref), {}),
    "sampled": (lambda ref: _sharegpt(ref, seed=7, sampling=SAMPLED), {}),
    "chunked": (lambda ref: _sharegpt(ref, seed=4, mean_out=6),
                dict(prefill_chunk_tokens=16)),
    "prefix_cache": (_shared_prefix, dict(prefix_cache=True)),
    "preemption": (lambda ref: _sharegpt(
        ref, n=6, seed=11, mean_in=20, mean_out=36, max_len=60, sigma=0.1,
        sampling=SAMPLED),
        dict(max_batch=6, kv_pool_tokens=256, max_model_len=96)),
    "gather": (lambda ref: _sharegpt(ref, seed=5, sampling=SAMPLED),
               dict(decode_mode="gather")),
}
# settings the reference run shares with the port's (the pool's size)
_SHARED = ("max_batch", "kv_pool_tokens", "max_model_len")


def _metrics(reqs):
    """What identity is judged on: tokens, finish reason, token count,
    TTFT stamped (wall-clock values differ between the loops)."""
    return [(list(map(int, r.output_tokens)), r.finish_reason,
             len(r.output_tokens), r.t_first_token is not None)
            for r in reqs]


def _engine(models, **kw):
    return ContinuousBatchingEngine(models[3], EngineConfig(**{**BASE, **kw}),
                                    device="cpu")


def _serve(models, make, **kw):
    eng = _engine(models, **kw)
    reqs = make(False)
    eng.run(reqs)
    assert all(r.t_done is not None for r in reqs)
    return _metrics(reqs), eng


def _reference(models, make, **kw):
    jmodel, jp, steps, _ = models
    cfg = JEngineConfig(**{**BASE, **{k: v for k, v in kw.items()
                                      if k in _SHARED}})
    reqs = make(True)
    eng = JEngine(jmodel, jp, cfg, steps=steps)
    eng.run(reqs)
    return _metrics(reqs), eng


@pytest.mark.parametrize("family", list(FAMILIES))
def test_overlap_equals_sync_and_reference(models, family):
    make, kw = FAMILIES[family]
    want, jeng = _reference(models, make, **kw)
    sync, seng = _serve(models, make, **kw)
    over, oeng = _serve(models, make, overlap=True, **kw)
    assert sync == want
    assert over == sync
    assert oeng.ecfg.overlap and oeng.decode_steps
    # no in-flight residue
    assert not oeng._executor._inflight and not oeng._executor._chain
    assert oeng.pool.manager.used_fraction == (
        seng.pool.manager.used_fraction)
    if family in ("greedy", "sampled", "gather"):
        # a request at its budget gives its seat up at dispatch, so the
        # queued admission and every batch are the sync loop's
        assert len(make(False)) > BASE["max_batch"]
        assert oeng.batch_samples == seng.batch_samples
    if family == "chunked":
        assert oeng.chunking and oeng.chunks
    if family == "prefix_cache":
        assert oeng.prefix.stats.hit_tokens > 0
    if family == "preemption":
        assert oeng.preemptions > 0 and seng.preemptions == \
            jeng.preemptions
    if family == "gather":
        assert oeng.decode_mode == "gather"


def test_overlap_stop_tokens_equal_sync_and_reference(models):
    """Stop tokens found at commit, with the request's next steps already
    in flight: those rows are discarded, and the tokens, finish reasons
    and pool equal the synchronous loop's and the reference's."""
    free, _ = _serve(models, lambda ref: _sharegpt(ref, mean_out=16))
    stops = dict(stop_token_ids=(free[0][0][3], free[2][0][2]))
    make = lambda ref: _sharegpt(ref, mean_out=16,        # noqa: E731
                                 sampling=stops)
    want, _ = _reference(models, make)
    sync, seng = _serve(models, make)
    over, oeng = _serve(models, make, overlap=True)
    assert sum(m[1] == "stop" for m in sync) >= 2
    assert sync == want and over == sync
    assert oeng.decode_steps > seng.decode_steps   # discarded rows ran
    assert oeng.pool.manager.used_fraction == 0.0
    assert not oeng._executor._inflight and not oeng._executor._chain


def test_mid_overlap_abort_reclaims_dispatched_step(models):
    """Abort a request while a step holding its next token is in flight:
    that token never lands, its blocks come back, and the others' tokens
    equal the synchronous loop's."""
    make = lambda ref: _sharegpt(ref, mean_out=16)       # noqa: E731
    baseline, _ = _serve(models, make)
    eng = _engine(models, overlap=True)
    reqs = make(False)
    for r in reqs:
        eng.add_request(r)
    victim = reqs[0]
    n_at_abort = None
    now = 0.0
    while eng.busy:
        eng.step(now)
        now += 1e-3
        if n_at_abort is None and len(victim.state.output_tokens) >= 3:
            rows = [e for e in eng._executor._inflight
                    if victim.req_id in e.plan.rids]
            assert rows, "expected a step of the victim in flight"
            assert eng.abort(victim.req_id, now)
            n_at_abort = len(victim.state.output_tokens)
            assert not any(victim.req_id in e.plan.rids and
                           e.valid[e.plan.rids.index(victim.req_id)]
                           for e in eng._executor._inflight)
    assert victim.finish_reason == FINISH_ABORT
    assert len(victim.state.output_tokens) == n_at_abort
    assert _metrics([victim])[0][0] == baseline[0][0][:n_at_abort]
    assert eng.pool.manager.used_fraction == 0.0
    assert not eng._executor._inflight and not eng._executor._chain
    assert _metrics(reqs[1:]) == baseline[1:]
    assert not eng.abort(victim.req_id)          # already finished


def test_queued_abort_and_eviction(models):
    eng = _engine(models, overlap=True, max_batch=2)
    reqs = _sharegpt(False, n=4, mean_out=10)
    for r in reqs:
        eng.add_request(r)
    eng.step(0.0)
    eng.step(0.0)
    assert reqs[3] in eng.waiting
    assert eng.abort(reqs[3].req_id)
    assert eng.queued_aborts == 1
    evicted = eng.evict_request(reqs[0].req_id)
    assert evicted is reqs[0] and reqs[0].finish_reason == FINISH_FAILED
    assert eng.evict_request(reqs[0].req_id) is None
    metrics = eng.run([])
    assert metrics.queued_aborts == 1
    assert all(r.t_done is not None for r in reqs)
    assert eng.pool.manager.used_fraction == 0.0


def test_deferred_device_error_names_its_step(models):
    """An error raised when a step's tokens are fetched carries the engine
    step that dispatched it."""
    eng = _engine(models, overlap=True)
    reqs = _sharegpt(False, n=2)
    for r in reqs:
        eng.add_request(r)
    plan = eng.sched.plan(0.0)
    entry = InFlightStep(dataclasses.replace(plan, step=7),
                         torch.zeros(2, dtype=torch.int32))

    class Faulted:
        def query(self):
            return False

        def synchronize(self):
            raise RuntimeError("CUDA error: an illegal memory access")
    entry.done = Faulted()
    with pytest.raises(RuntimeError, match="illegal") as info:
        eng._executor._commit(entry)
    assert info.value.engine_step == 7
    assert "engine step 7" in "".join(getattr(info.value, "__notes__", []))
    # the plan's step is still chained; a reset drops it uncommitted
    eng._executor._dispatch(plan)
    assert eng._executor._inflight and eng._executor._chain
    eng._executor.reset()
    assert not eng._executor._inflight and not eng._executor._chain


def test_speculation_still_raises(models):
    """Speculation under overlap is ported, so it no longer raises: the
    config is accepted and the overlapped engine builds its drafter
    (``tests/test_torch_speculative.py`` holds its tokens)."""
    eng = _engine(models, overlap=True, speculate=True)
    assert eng.ecfg.overlap and eng.speculator is not None
    assert not eng._executor._spec_pending
