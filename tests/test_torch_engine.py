"""The port's continuous-batching engine against the JAX reference engine
on the CPU: greedy outputs, finish reasons and preemption counts on the
same ShareGPT-shaped requests and the same weights, in both decode modes
(zero-copy paged and the gather fallback), plus the pool's allocator,
byte accounting and dense gather/scatter."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores (about 3x faster there)
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.kvcache.paged import BlockManager as JBlockManager  # noqa: E402
from repro.kvcache.paged import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import init_params as j_init_params  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kvcache.paged import BlockManager, PagedKVCache  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, Request, RequestTooLarge,
                                 SamplingParams, sharegpt_like)
from repro_torch.serving.engine import _bucket, _pow2_bucket  # noqa: E402
from repro_torch.serving.metrics import Percentiles  # noqa: E402
from repro.serving.engine import _bucket as j_bucket  # noqa: E402
from repro.serving.engine import _pow2_bucket as j_pow2_bucket  # noqa: E402
from repro.serving.metrics import Percentiles as JPercentiles  # noqa: E402


@pytest.fixture(scope="module")
def models():
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    tcfg = reduced(get_config("opt-1.3b"))
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, Model(tcfg, tp, device="cpu")


def _serve_both(models, rules, wl, **ecfg_kw):
    jcfg, jp, tcfg, tmodel = models
    jreqs = j_sharegpt_like(*wl[:2], **wl[2])
    treqs = sharegpt_like(*wl[:2], **wl[2])
    jeng = JEngine(JModel(jcfg, rules), jp, JEngineConfig(**ecfg_kw))
    jeng.run(jreqs)
    teng = ContinuousBatchingEngine(tmodel, EngineConfig(**ecfg_kw),
                                    device="cpu")
    metrics = teng.run(treqs)
    return jeng, jreqs, teng, treqs, metrics


def _assert_same_outputs(jreqs, treqs):
    assert [r.prompt.tolist() for r in jreqs] == \
        [r.prompt.tolist() for r in treqs]
    for a, b in zip(jreqs, treqs):
        assert b.output_tokens == a.output_tokens, b.req_id
        assert b.finish_reason == a.finish_reason
        assert b.generated == a.generated


def test_greedy_outputs_match_reference(models, rules):
    wl = (6, 512, dict(seed=7, mean_in=14, mean_out=10, max_len=64,
                       sigma=0.6))
    jeng, jreqs, teng, treqs, m = _serve_both(
        models, rules, wl, max_batch=4, block_size=8, kv_pool_tokens=4096,
        max_model_len=256, prefill_bucket=16)
    _assert_same_outputs(jreqs, treqs)
    assert teng.preemptions == jeng.preemptions == 0
    assert m.n_completed == 6 and m.finish_reasons == {"length": 6}
    assert m.output_tokens == sum(r.generated for r in treqs)
    assert teng.decode_steps == len(teng.itl_samples) > 0
    assert teng.prefills == 6
    assert teng.pool.manager.free_blocks == teng.pool.manager.num_blocks


def test_preempting_pool_matches_reference(models, rules):
    """A pool small enough that admitted requests outgrow it while
    decoding: both engines preempt the same number of times and still
    emit identical tokens."""
    wl = (6, 512, dict(seed=11, mean_in=20, mean_out=36, max_len=60,
                       sigma=0.1))
    jeng, jreqs, teng, treqs, m = _serve_both(
        models, rules, wl, max_batch=6, block_size=8, kv_pool_tokens=256,
        max_model_len=96, prefill_bucket=16)
    assert jeng.preemptions > 0, "workload was meant to force preemption"
    assert teng.preemptions == jeng.preemptions == m.preemptions
    _assert_same_outputs(jreqs, treqs)


MIXED = ((6, 512, dict(seed=7, mean_in=14, mean_out=10, max_len=64,
                      sigma=0.6)),
         dict(max_batch=4, block_size=8, kv_pool_tokens=4096,
              max_model_len=256, prefill_bucket=16))
PREEMPTING = ((6, 512, dict(seed=11, mean_in=20, mean_out=36, max_len=60,
                           sigma=0.1)),
              dict(max_batch=6, block_size=8, kv_pool_tokens=256,
                   max_model_len=96, prefill_bucket=16))


@pytest.mark.parametrize("wl,ecfg", [MIXED, PREEMPTING],
                         ids=["mixed_lengths", "preempting_pool"])
def test_gather_mode_matches_reference_and_paged(models, rules, wl, ecfg):
    """The gather fallback: identical greedy tokens, finish reasons and
    preemptions to the reference engine's gather mode, and to the port's
    own paged mode on the same requests."""
    jeng, jreqs, teng, treqs, m = _serve_both(models, rules, wl,
                                              decode_mode="gather", **ecfg)
    assert teng.decode_mode == jeng.decode_mode == "gather"
    _assert_same_outputs(jreqs, treqs)
    assert teng.preemptions == jeng.preemptions == m.preemptions
    assert teng.decode_steps == len(teng.itl_samples) > 0
    assert teng.pool.manager.free_blocks == teng.pool.manager.num_blocks
    paged = ContinuousBatchingEngine(models[3], EngineConfig(**ecfg),
                                     device="cpu")
    preqs = sharegpt_like(*wl[:2], **wl[2])
    paged.run(preqs)
    _assert_same_outputs(preqs, treqs)
    assert paged.preemptions == teng.preemptions


def test_gather_scatter_round_trip_matches_reference():
    """``gather`` yields the reference pool's dense view of each request's
    written rows, and ``scatter_new_token`` writes a marked row back to
    the same (block, slot) in both pools (``tests/test_substrate.py``'s
    round trip, held against the reference)."""
    jcfg = j_reduced(j_get_config("internlm2-1.8b"))
    tcfg = reduced(get_config("internlm2-1.8b"))
    jpool = JPagedKVCache(jcfg, num_blocks=32, block_size=8, max_batch=4)
    tpool = PagedKVCache(tcfg, num_blocks=32, block_size=8, device="cpu")
    rng = np.random.default_rng(0)
    shape = (tcfg.n_layers, 1, 24, tcfg.n_kv_heads, tcfg.hd)
    for rid, n in ((0, 20), (1, 12)):
        for mgr in (jpool.manager, tpool.manager):
            mgr.allocate(rid, n)
        kv = {k: rng.normal(size=shape).astype(np.float32) for k in "kv"}
        jpool.write_prefill(rid, {"stack": [kv], "rem": []})
        tpool.write_prefill(rid, {k: torch.from_numpy(a)
                                  for k, a in kv.items()})
    jview = jpool.gather([0, 1], pad_blocks=3)["stack"][0]
    tview = tpool.gather([0, 1], pad_blocks=3)
    for k in "kv":
        assert tview[k].shape == jview[k].shape
        np.testing.assert_array_equal(tview[k][:, 0, :20].numpy(),
                                      np.asarray(jview[k])[:, 0, :20])
        np.testing.assert_array_equal(tview[k][:, 1, :12].numpy(),
                                      np.asarray(jview[k])[:, 1, :12])
    for mgr in (jpool.manager, tpool.manager):
        mgr.append_token(0, 21)
        mgr.append_token(1, 13)
    jview = jpool.gather([1, 0], pad_blocks=3)
    tview = tpool.gather([1, 0], pad_blocks=3)
    marks = rng.normal(size=(2,) + shape[:1] + shape[3:]).astype(np.float32)
    for i, pos in enumerate((12, 20)):
        for k in "kv":
            jview["stack"][0][k] = jview["stack"][0][k].at[
                :, i, pos].set(marks[i])
            tview[k][:, i, pos] = torch.from_numpy(marks[i])
    jpool.scatter_new_token([1, 0], [12, 20], jview)
    tpool.scatter_new_token([1, 0], [12, 20], tview)
    for k in "kv":
        np.testing.assert_array_equal(tpool.pool[k].numpy(),
                                      np.asarray(jpool.pool["stack"][0][k]))
    back = tpool.gather([0, 1], pad_blocks=3)
    assert torch.equal(back["k"][:, 0, 20], torch.from_numpy(marks[1]))
    assert torch.equal(back["v"][:, 1, 12], torch.from_numpy(marks[0]))


def test_stop_tokens_budget_one_and_arrivals_match_reference(models, rules):
    """Stop-token finishes, a one-token budget (finished straight out of
    prefill) and timed arrivals (idle fast-forward) end the same way in
    both engines."""
    stops = SamplingParams(stop_token_ids=tuple(range(0, 512, 5)))
    wl = (6, 512, dict(seed=3, mean_in=12, mean_out=6, max_len=48,
                       arrival_rate=200.0, sampling=stops))
    jeng, jreqs, teng, treqs, m = _serve_both(
        models, rules, wl, max_batch=2, block_size=8, kv_pool_tokens=1024,
        max_model_len=128, prefill_bucket=16)
    _assert_same_outputs(jreqs, treqs)
    assert {r.finish_reason for r in treqs} == {"stop", "length"}
    assert min(r.max_new_tokens for r in treqs) == 1
    assert all(r.t_first_token >= r.arrival_s for r in treqs)


def test_request_too_large_raises(models):
    _, _, tcfg, tmodel = models
    eng = ContinuousBatchingEngine(
        tmodel, EngineConfig(max_batch=2, block_size=8, kv_pool_tokens=64,
                             max_model_len=64, prefill_bucket=16),
        device="cpu")
    reqs = sharegpt_like(1, tcfg.vocab_size, seed=1, mean_in=62,
                         mean_out=2, fixed=True, max_len=200)
    with pytest.raises(RequestTooLarge):
        eng.run(reqs)


@pytest.mark.parametrize("name", ["opt-1.3b", "qwen2.5-3b"])
def test_pool_byte_accounting_equal(name):
    jcfg = j_get_config(name)
    tcfg = get_config(name)
    # full-width configs: accounting reads shapes only; a one-layer,
    # two-block pool keeps the allocation small
    jcfg = dataclasses.replace(jcfg, n_layers=1)
    tcfg = dataclasses.replace(tcfg, n_layers=1)
    jp = JPagedKVCache(jcfg, num_blocks=2, block_size=16, max_batch=1)
    tp = PagedKVCache(tcfg, num_blocks=2, block_size=16,
                      device="cpu")
    assert (tp.block_bytes, tp.pool_bytes, tp.token_bytes) == \
        (jp.block_bytes, jp.pool_bytes, jp.token_bytes)
    assert tp.pool["k"].shape == jp.pool["stack"][0]["k"].shape


def test_block_manager_tracks_reference():
    """The same random allocate / append / truncate / release sequence
    leaves both allocators in identical states."""
    rng = np.random.default_rng(0)
    a, b = BlockManager(40, 8), JBlockManager(40, 8)
    live = []
    for step in range(300):
        op = rng.integers(4)
        if op == 0 and a.can_allocate(20):
            n = int(rng.integers(1, 20))
            assert a.allocate(step, n) == b.allocate(step, n)
            live.append(step)
        elif op == 1 and live:
            rid = live[int(rng.integers(len(live)))]
            n = a.covered_tokens(rid) + int(rng.integers(0, 3))
            if a.free_blocks > 1:
                assert a.append_token(rid, n) == b.append_token(rid, n)
        elif op == 2 and live:
            rid = live.pop(int(rng.integers(len(live))))
            a.release(rid)
            b.release(rid)
        elif op == 3 and live:
            rid = live[int(rng.integers(len(live)))]
            keep = int(rng.integers(0, 3))
            assert a.truncate(rid, keep) == b.truncate(rid, keep)
        assert (a.free, a.tables, a.refs, a.version) == \
            (b.free, b.tables, b.refs, b.version)
        assert a.used_fraction == b.used_fraction
        assert all(a.needs_block(r, a.covered_tokens(r) + 1)
                   == b.needs_block(r, b.covered_tokens(r) + 1) for r in live)


def test_view_pads_rows_to_trash_and_zero_length():
    tcfg = reduced(get_config("opt-1.3b"))
    pool = PagedKVCache(tcfg, num_blocks=16, block_size=8,
                        device="cpu")
    pool.manager.allocate(0, 12)
    v = pool.view([0], [12], nb_pad=4, batch_pad=2)
    assert v.tables.dtype == torch.int32 and v.tables.shape == (2, 4)
    assert v.tables[0, :2].tolist() == pool.manager.tables[0]
    assert v.tables[0, 2:].tolist() == [pool.trash_block] * 2
    assert v.tables[1].tolist() == [pool.trash_block] * 4
    assert v.lengths.tolist() == [13, 0] and v.positions.tolist() == [12, 0]


def test_workload_and_helpers_match_reference():
    kw = dict(seed=3, mean_in=161, mean_out=338, max_len=1024)
    a = sharegpt_like(32, 50272, **kw)
    b = j_sharegpt_like(32, 50272, **kw)
    assert [(r.prompt.tolist(), r.max_new_tokens, r.arrival_s) for r in a] \
        == [(r.prompt.tolist(), r.max_new_tokens, r.arrival_s) for r in b]
    a = sharegpt_like(8, 100, seed=2, arrival_rate=4.0,
                      arrival_pattern="burst", burst_size=3)
    b = j_sharegpt_like(8, 100, seed=2, arrival_rate=4.0,
                        arrival_pattern="burst", burst_size=3)
    assert [r.arrival_s for r in a] == [r.arrival_s for r in b]
    for n in (1, 3, 17, 64, 65):
        assert _bucket(n, 16) == j_bucket(n, 16)
        assert _pow2_bucket(n, lo=4) == j_pow2_bucket(n, lo=4)
    xs = [0.3, 0.01, 2.5, 1.0, 0.7]
    a, b = Percentiles.from_samples(xs), JPercentiles.from_samples(xs)
    assert (a.p50, a.p95, a.p99) == (b.p50, b.p95, b.p99)


def test_out_of_slice_requests_raise(models):
    """Sampled requests and requests with deadlines are in the slice and
    are queued; a prompt the model length cannot hold still raises."""
    _, _, tcfg, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, EngineConfig(), device="cpu")
    sampled = sharegpt_like(1, tcfg.vocab_size, seed=0,
                            sampling=SamplingParams(temperature=0.7))
    eng.add_request(sampled[0])
    assert list(eng.waiting) == sampled
    timed = sharegpt_like(1, tcfg.vocab_size, seed=1,
                          sampling=SamplingParams(deadline_s=1.0))
    eng.add_request(timed[0])
    assert list(eng.waiting) == sampled + timed
    assert eng.sched._has_deadlines
    too_long = Request(req_id=9, prompt=np.zeros(
        EngineConfig().max_model_len, np.int32), max_new_tokens=4)
    with pytest.raises(ValueError, match="max_model_len"):
        eng.add_request(too_long)
