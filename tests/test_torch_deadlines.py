"""The port's request deadlines and admission control
(``repro_torch.serving.scheduler``: ``expire_deadlines``,
``shed_check``, ``shed_request``, ``estimated_queue_delay_s``; the
engine's ``try_add_request``) on the CPU, against the JAX reference: the
scenarios of ``tests/test_deadlines.py`` with the same explicit ``now``
values, through ``try_add_request`` on both engines where the reference's
tests go through ``ServingAPI``, give the same finish reasons, generated
counts, tokens, freed blocks, ``shed_reasons`` and ``deadline_expired``;
the queue-delay estimate on injected samples equals the reference's to
1e-12; queued aborts and the preemption series match; under overlap a
deadline expiry equals the synchronous loop's; and the observer sees the
sheds and expiries. The cluster scenarios wait for the cluster's port
(ROADMAP.md queue 1 item 4)."""
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
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro.serving.metrics import \
    collect_from_engine as j_collect  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.hardware import H100_SXM5_80GB  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, Request, SamplingParams,
                                 sharegpt_like)
from repro_torch.serving.metrics import collect_from_engine  # noqa: E402
from repro_torch.serving.obs.observer import Observability  # noqa: E402
from repro_torch.serving.obs.windows import STREAM_DEADLINE  # noqa: E402
from repro_torch.serving.workload import (FINISH_ABORT,  # noqa: E402
                                          FINISH_DEADLINE, FINISH_LENGTH,
                                          FINISH_SHED, FINISH_STOP)

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


def _pair(models, **kw):
    """(reference engine, port engine) on the same weights and config."""
    jmodel, jp, steps, tmodel = models
    return (JEngine(jmodel, jp, JEngineConfig(**{**BASE, **kw}), steps=steps),
            ContinuousBatchingEngine(tmodel, EngineConfig(**{**BASE, **kw}),
                                     device="cpu"))


def _req(ref, rid, n=12, seed=0, prompt=None, **sp):
    if prompt is None:
        prompt = np.random.default_rng(seed + rid).integers(
            0, 512, n, dtype=np.int32)
    R, S = (JRequest, JSamplingParams) if ref else (Request, SamplingParams)
    return R(req_id=rid, prompt=prompt, arrival_s=0.0, sampling=S(**sp))


def _both(fn):
    """``fn(ref)`` for the reference (True) and the port (False)."""
    return fn(True), fn(False)


def _outcome(reqs):
    """Finish reason, count, tokens, whether a first token came, and the
    finish stamp where no step's wall time is in it (an expiry, a shed,
    an abort: ``max(now, arrival)``)."""
    return [(r.finish_reason, r.generated, list(map(int, r.output_tokens)),
             r.t_done if r.finish_reason not in SERVED else None,
             r.t_first_token is not None) for r in reqs]


def _state(eng):
    return (eng.deadline_expired, eng.shed, dict(eng.shed_reasons),
            eng.queued_aborts, eng.pool.manager.free_blocks, eng.busy,
            len(eng.waiting), len(eng.prefilling), len(eng.running))


def _drain(eng, now):
    while eng.busy:
        eng.step(now)


# --------------------------------------------------------- SamplingParams --
def test_deadline_params_validation():
    for S in (SamplingParams, JSamplingParams):
        with pytest.raises(ValueError, match="deadline_s"):
            S(deadline_s=0)
        with pytest.raises(ValueError, match="ttft_deadline_s"):
            S(ttft_deadline_s=-1)
        sp = S(deadline_s=2.0, ttft_deadline_s=0.5)
        assert sp.has_deadline and not S().has_deadline
        assert not sp.expired(0.0, 2.0, first_token=True)
        assert sp.expired(0.0, 2.01, first_token=True)
        assert sp.expired(0.0, 0.6, first_token=False)
        assert not sp.expired(0.0, 0.6, first_token=True)


# ------------------------------------------------------- expiry by phase --
def test_deadline_expires_pre_admission(models):
    engs = _pair(models)
    reqs = _both(lambda ref: [_req(ref, 0, deadline_s=0.5,
                                   max_new_tokens=8)])
    out = []
    for eng, rs in zip(engs, reqs):
        free0 = eng.pool.manager.free_blocks
        eng.add_request(rs[0])
        eng.step(1.0)                        # past the deadline, queued
        assert eng.pool.manager.free_blocks == free0
        out.append((_outcome(rs), _state(eng)))
    assert out[1] == out[0]
    assert out[1][0][0][:2] == (FINISH_DEADLINE, 0)
    assert out[1][0][0][3] == 1.0 and out[1][1][0] == 1


def test_deadline_expires_mid_prefill_chunked(models):
    engs = _pair(models, prefill_chunk_tokens=16)
    reqs = _both(lambda ref: [_req(ref, 0, n=48, ttft_deadline_s=0.5,
                                   max_new_tokens=8)])
    out = []
    for eng, rs in zip(engs, reqs):
        free0 = eng.pool.manager.free_blocks
        eng.add_request(rs[0])
        eng.step(0.0)                        # the first chunk only
        assert rs[0] in eng.prefilling
        held = eng.pool.manager.free_blocks
        eng.step(1.0)                        # expires mid-prefill
        assert eng.pool.manager.free_blocks == free0
        assert not eng._prefilled and not eng.prefilling
        out.append((_outcome(rs), _state(eng), free0 - held))
    assert out[1] == out[0]
    assert out[1][0][0][0] == FINISH_DEADLINE and out[1][2] > 0


def test_deadline_expires_mid_decode_keeps_partial_output(models):
    engs = _pair(models)
    reqs = _both(lambda ref: [_req(ref, 0, deadline_s=1.0,
                                   max_new_tokens=32)])
    out = []
    for eng, rs in zip(engs, reqs):
        free0 = eng.pool.manager.free_blocks
        eng.add_request(rs[0])
        eng.step(0.0)
        for _ in range(3):
            eng.step(0.5)
        partial = list(rs[0].output_tokens)
        eng.step(2.0)                        # expires mid-decode
        assert list(rs[0].output_tokens) == partial
        assert eng.pool.manager.free_blocks == free0
        out.append((_outcome(rs), _state(eng)))
    assert out[1] == out[0]
    reason, generated = out[1][0][0][:2]
    assert reason == FINISH_DEADLINE and 4 <= generated < 32


def test_ttft_deadline_stops_binding_after_first_token(models):
    engs = _pair(models)
    reqs = _both(lambda ref: [_req(ref, 0, ttft_deadline_s=0.5,
                                   max_new_tokens=6)])
    out = []
    for eng, rs in zip(engs, reqs):
        eng.add_request(rs[0])
        eng.step(0.0)
        _drain(eng, 2.0)                    # past the TTFT bound: moot
        out.append((_outcome(rs), _state(eng)))
    assert out[1] == out[0]
    assert out[1][0][0][0] in SERVED and out[1][0][0][1] == 6


def test_deadline_releases_prefix_pins_same_step(models):
    engs = _pair(models, prefix_cache=True)
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 512, 32, dtype=np.int32)
    tail = rng.integers(0, 512, 16, dtype=np.int32)
    out = []
    for ref, eng in zip((True, False), engs):
        warm = _req(ref, 0, prompt=prefix.copy(), max_new_tokens=2)
        eng.add_request(warm)
        _drain(eng, 0.0)
        cached0 = eng.prefix.cached_blocks
        free0 = eng.pool.manager.free_blocks
        doomed = _req(ref, 1, prompt=np.concatenate([prefix, tail]),
                      max_new_tokens=32, deadline_s=1.0)
        eng.add_request(doomed)
        eng.step(0.0)                        # admitted with a prefix hit
        eng.step(2.0)                        # expires mid-decode
        # no block pinned by the dead request
        assert eng.pool.manager.free_blocks + eng.prefix.cached_blocks \
            == free0 + cached0
        fresh = _req(ref, 2, prompt=prefix.copy(), max_new_tokens=2)
        eng.add_request(fresh)
        _drain(eng, 0.0)
        out.append((_outcome([warm, doomed, fresh]), _state(eng),
                    eng.prefix.cached_blocks, eng.prefix.stats.hit_tokens))
    assert out[1] == out[0]
    assert out[1][0][1][0] == FINISH_DEADLINE
    assert out[1][0][2][0] in SERVED and out[1][3] > 0


# ------------------------------------------------------------- shedding --
def test_shed_queue_full_is_graceful(models):
    engs = _pair(models, max_waiting=1, max_batch=1)
    reqs = _both(lambda ref: [_req(ref, i, seed=80, max_new_tokens=4)
                              for i in range(2)])
    out = []
    for eng, (h1, h2) in zip(engs, reqs):
        assert eng.try_add_request(h1, 0.0) is None
        assert eng.try_add_request(h2, 0.0) == "queue_full"
        assert h2.t_done == 0.0 and h2 not in eng.waiting
        _drain(eng, 0.0)
        out.append((_outcome([h1, h2]), _state(eng)))
    assert out[1] == out[0]
    assert out[1][0][1][0] == FINISH_SHED and out[1][0][0][0] in SERVED
    port = collect_from_engine(engs[1], reqs[1], 1.0)
    ref = j_collect(engs[0], reqs[0], 1.0)
    assert (port.shed, port.shed_reasons, port.finish_reasons) == \
        (ref.shed, ref.shed_reasons, ref.finish_reasons) == \
        (1, {"queue_full": 1}, {FINISH_SHED: 1, out[1][0][0][0]: 1})


def test_shed_kv_pressure(models):
    engs = _pair(models, shed_kv_fraction=0.05, max_batch=1,
                 kv_pool_tokens=256, max_model_len=64)
    reqs = _both(lambda ref: [_req(ref, 0, n=24, seed=81,
                                   max_new_tokens=16)]
                 + [_req(ref, i, seed=81, max_new_tokens=4)
                    for i in (1, 2)])
    out = []
    for eng, (h1, h2, h3) in zip(engs, reqs):
        assert eng.try_add_request(h1, 0.0) is None
        for _ in range(2):
            eng.step(0.0)                    # h1 decoding, pool in use
        assert eng.pool.manager.used_fraction >= 0.05
        assert eng.try_add_request(h2, 0.0) is None   # no queue yet
        assert eng.try_add_request(h3, 0.0) == "kv_pressure"
        _drain(eng, 0.0)
        out.append((_outcome([h1, h2, h3]), _state(eng)))
    assert out[1] == out[0]
    assert [o[0] for o in out[1][0]][2] == FINISH_SHED
    assert out[1][1][2] == {"kv_pressure": 1}


def test_estimated_queue_delay_on_injected_samples(models):
    """The same measured samples and queue give the reference's estimate
    (to 1e-12) and its shed decisions, the policy knob and the
    per-request deadline ones."""
    itl = [0.011, 0.009, 0.0125, 0.0101] * 10
    toks = [3, 4, 4, 2] * 10
    out = []
    for ref, eng in zip((True, False), _pair(models)):
        assert eng.estimated_queue_delay_s() == 0.0    # a cold start
        eng.itl_samples.extend(itl)
        eng.decode_token_samples.extend(toks)
        assert eng.estimated_queue_delay_s() == 0.0    # an empty queue
        eng.add_request(_req(ref, 10, n=24, seed=82, max_new_tokens=64))
        eng.add_request(_req(ref, 11, n=17, seed=82, max_new_tokens=9))
        est = eng.estimated_queue_delay_s()
        hopeless = _req(ref, 12, seed=82, max_new_tokens=4,
                        deadline_s=est / 2)
        fine = _req(ref, 13, seed=82, max_new_tokens=4, deadline_s=est + 60)
        late = _req(ref, 14, seed=82, max_new_tokens=4,
                    ttft_deadline_s=est + 0.5)
        out.append((est, eng.shed_check(hopeless, now=0.0),
                    eng.shed_check(fine, now=0.0),
                    eng.shed_check(late, now=1.0)))
    assert out[1][0] == pytest.approx(out[0][0], abs=1e-12)
    assert out[1][1:] == out[0][1:] == ("deadline_unmeetable", None,
                                        "deadline_unmeetable")
    want = (64 + 24 + 9 + 17) / (sum(toks[-32:]) / sum(itl[-32:]))
    assert out[1][0] == pytest.approx(want, abs=1e-12)
    delays = []
    for ref, eng in zip((True, False),
                        _pair(models, shed_queue_delay_s=1e-6)):
        eng.itl_samples.extend(itl)
        eng.decode_token_samples.extend(toks)
        eng.add_request(_req(ref, 10, n=24, seed=82, max_new_tokens=64))
        delays.append(eng.shed_check(_req(ref, 15, seed=82,
                                          max_new_tokens=4), now=0.0))
    assert delays == ["queue_delay", "queue_delay"]


# ----------------------------------------------- satellite metric series --
def test_queued_abort_counter_engine(models):
    engs = _pair(models, max_batch=1)
    reqs = _both(lambda ref: [_req(ref, i, seed=84, max_new_tokens=4)
                              for i in range(2)])
    out = []
    for eng, (h1, h2) in zip(engs, reqs):
        eng.try_add_request(h1, 0.0)
        eng.try_add_request(h2, 0.0)
        assert eng.abort(h2.req_id)          # still in the arrival queue
        _drain(eng, 0.0)
        out.append((_outcome([h1, h2]), _state(eng)))
    assert out[1] == out[0]
    assert out[1][0][1][0] == FINISH_ABORT and out[1][1][3] == 1


def test_preemptions_are_first_class_series(models):
    engs = _pair(models, max_batch=3, kv_pool_tokens=128, max_model_len=96)
    mk = dict(seed=11, mean_in=20, mean_out=36, max_len=60, sigma=0.1)
    jm = engs[0].run(j_sharegpt_like(6, 512, **mk))
    m = engs[1].run(sharegpt_like(6, 512, **mk))
    assert engs[1].preemptions == engs[0].preemptions > 0
    assert m.preemptions == jm.preemptions
    assert list(m.preemption_series) == list(jm.preemption_series)
    assert sum(m.preemption_series) == m.preemptions
    assert m.robustness_row() == jm.robustness_row()
    assert "preempt=" in m.robustness_row()


# ------------------------------------------------------ overlap, observer --
def _deadline_run(models, ref, **kw):
    eng = _pair(models, **kw)[0 if ref else 1]
    reqs = [_req(ref, i, seed=90, max_new_tokens=24,
                 deadline_s=1.0 if i % 2 else None) for i in range(3)]
    for r in reqs:
        eng.add_request(r)
    for t in (0.0, 0.2, 0.4, 0.6, 0.8):
        eng.step(t)
    _drain(eng, 2.0)
    return reqs, eng


def test_overlap_deadline_equals_the_reference(models):
    """Under overlap a request expiring with rows in flight has them
    discarded: its committed output is a prefix of the synchronous
    loop's, and every output, counter and the pool equal the reference's
    overlapped engine's at the same ``now`` values."""
    sync, seng = _deadline_run(models, False)
    over, oeng = _deadline_run(models, False, overlap=True)
    jover, joeng = _deadline_run(models, True, overlap=True)
    assert _outcome(over) == _outcome(jover)
    assert _state(oeng) == _state(joeng)
    assert sync[1].finish_reason == over[1].finish_reason == FINISH_DEADLINE
    assert sync[1].output_tokens[:over[1].generated] == over[1].output_tokens
    assert [_outcome([r]) for r in over[::2]] == \
        [_outcome([r]) for r in sync[::2]]
    assert oeng.deadline_expired == seng.deadline_expired == 1
    assert oeng.pool.manager.free_blocks == seng.pool.manager.free_blocks
    assert not oeng._executor._inflight and not oeng._executor._chain


def test_observer_sees_sheds_and_expiries(models):
    eng = ContinuousBatchingEngine(
        models[3], EngineConfig(**{**BASE, **dict(max_waiting=1,
                                                  max_batch=1)}),
        device="cpu")
    obs = Observability(hw=H100_SXM5_80GB, windows=True)
    obs.attach(eng)
    h1 = _req(False, 0, seed=80, max_new_tokens=4, deadline_s=0.5)
    h2 = _req(False, 1, seed=80, max_new_tokens=4)
    assert eng.try_add_request(h1, 0.0) is None
    assert eng.try_add_request(h2, 0.0) == "queue_full"
    eng.step(0.0)
    _drain(eng, 1.0)
    assert h1.finish_reason == FINISH_DEADLINE
    names = {e["name"] for e in obs.trace.to_dict()["traceEvents"]}
    assert {"shed", "finish:deadline", "queued", "first_token"} <= names
    misses = [v for _, v in obs.windows.samples(STREAM_DEADLINE)]
    assert misses == [1.0]
