"""The port's prefix cache and chunked prefill against the JAX reference on
the CPU: the radix index (the reference's own index tests, run on both
indexes side by side), the pool's prefix gather, token-granular chunk
write and copy-on-write, and the engine's outputs token-identical to the
reference engine with the cache on and off, chunked and serial, both
together, and with half-prefilled requests preempted."""
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
from repro.configs.registry import ALL as J_ALL  # noqa: E402
from repro.kvcache.paged import BlockManager as JBlockManager  # noqa: E402
from repro.kvcache.paged import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.kvcache.prefix import PrefixIndex as JPrefixIndex  # noqa: E402
from repro.kvcache.prefix import \
    prefix_cache_supported as j_supported  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import init_params as j_init_params  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import StepFunctions  # noqa: E402
from repro.serving import long_short_workload as j_long_short  # noqa: E402
from repro.serving import \
    shared_prefix_workload as j_shared_prefix  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro.serving.workload import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.registry import ALL as T_ALL  # noqa: E402
from repro_torch.kvcache.paged import BlockManager, PagedKVCache  # noqa: E402
from repro_torch.kvcache.prefix import (PrefixIndex,  # noqa: E402
                                        prefix_cache_supported)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, long_short_workload,
                                 shared_prefix_workload, sharegpt_like)
from repro_torch.serving.workload import Request  # noqa: E402


# ------------------------------------------------------------ the index --
def _pair(n_blocks, bs, **kw):
    """The port's index and the reference's over allocators of the same
    size, to drive with the same calls."""
    bm, jbm = BlockManager(n_blocks, bs), JBlockManager(n_blocks, bs)
    return (bm, PrefixIndex(bm, **kw)), (jbm, JPrefixIndex(jbm, **kw))


def _same_state(a, b):
    (bm, idx), (jbm, jidx) = a, b
    assert (bm.free, bm.tables, bm.refs) == (jbm.free, jbm.tables, jbm.refs)
    assert idx.cached_blocks == jidx.cached_blocks
    assert dataclasses.asdict(idx.stats) == dataclasses.asdict(jidx.stats)
    assert sorted(idx.indexed_blocks()) == sorted(jidx.indexed_blocks())
    assert sorted(idx.held_blocks()) == sorted(jidx.held_blocks())


def test_index_match_insert_full_blocks_only():
    port, ref = _pair(32, 4)
    for (bm, idx) in (port, ref):
        toks = np.arange(11)                 # 2 full blocks + 3-token tail
        blocks = bm.allocate(0, 11)
        assert idx.insert(toks, blocks) == 2     # tail block never indexed
        assert idx.cached_blocks == 2
        assert idx.match(toks) == blocks[:2]     # capped at prompt_len - 1
        assert idx.match(toks[:4]) == []
        assert idx.match(toks[:9]) == blocks[:2]
        other = np.concatenate([toks[:4], [99, 99, 99, 99, 1]])
        assert idx.match(other) == blocks[:1]
        blocks2 = bm.allocate(1, 11)
        assert idx.insert(toks, blocks2) == 0    # first writer wins
        assert idx.match(toks) == blocks[:2]
    _same_state(port, ref)


def test_index_eviction_lru_and_pinning():
    port, ref = _pair(32, 4)
    for (bm, idx) in (port, ref):
        a = bm.allocate(0, 8)
        idx.insert(np.arange(8), a)
        b = bm.allocate(1, 8)
        idx.insert(np.arange(100, 108), b)
        bm.release(0)
        bm.release(1)
        idx.match(np.arange(9))              # touch both A nodes: B is LRU
        assert idx.evict(1) == 1
        assert idx.match(np.arange(100, 109)) == b[:1]
        assert idx.match(np.arange(9)) == a
        bm.share(2, a)                       # pinned blocks stay
        assert idx.evict(10) == 1
        assert idx.cached_blocks == 2
        bm.release(2)
        assert idx.evict(10) == 2
        assert idx.cached_blocks == 0 and bm.free_blocks == 32
    _same_state(port, ref)


def test_index_max_blocks_cap():
    port, ref = _pair(32, 4, max_blocks=2)
    for (bm, idx) in (port, ref):
        blocks = bm.allocate(0, 16)
        idx.insert(np.arange(16), blocks)
        bm.release(0)
        assert idx.cached_blocks == 2
    _same_state(port, ref)


def test_index_cap_insert_never_evicts_attachment_point():
    port, ref = _pair(32, 4, max_blocks=2)
    for (bm, idx) in (port, ref):
        a = np.arange(8)
        blocks = bm.allocate(0, 8)
        idx.insert(a, blocks)
        bm.release(0)
        longer = np.concatenate([a, np.arange(50, 54)])
        tail = bm.allocate(1, 4)
        n_before = idx.cached_blocks
        idx.insert(longer, list(blocks) + tail)
        bm.release(1)
        assert idx.match(np.concatenate([a, [0]])) == list(blocks)
        assert idx.cached_blocks == n_before
    _same_state(port, ref)
    for (bm, idx) in (port, ref):
        idx.clear()
        assert idx.cached_blocks == 0 and bm.refs == {}
        assert bm.free_blocks == 32


def test_index_random_traffic_tracks_reference():
    """A random mix of admissions (match, share, record, insert),
    releases and evictions leaves both indexes and allocators equal."""
    port, ref = _pair(64, 4, max_blocks=24)
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(0, 50, 12) for _ in range(3)]
    live = []
    for step in range(200):
        op = rng.integers(3)
        if op == 0 and port[0].free_blocks > 12:
            toks = np.concatenate([prefixes[rng.integers(3)],
                                   rng.integers(0, 50, rng.integers(1, 9))])
            for bm, idx in (port, ref):
                hit = idx.match(toks)
                bm.share(step, hit)
                idx.record_admit(len(toks), len(hit) * 4)
                bm.allocate(step, len(toks) + 1 - len(hit) * 4)
                idx.insert(toks, bm.tables[step])
            live.append(step)
        elif op == 1 and live:
            rid = live.pop(int(rng.integers(len(live))))
            for bm, _ in (port, ref):
                bm.release(rid)
        elif op == 2:
            n = int(rng.integers(1, 4))
            assert port[1].evict(n) == ref[1].evict(n)
        _same_state(port, ref)


def test_prefix_cache_gate_equals_reference():
    assert sorted(T_ALL) == sorted(J_ALL)
    for name in sorted(J_ALL):
        assert prefix_cache_supported(reduced(get_config(name))) == \
            j_supported(j_reduced(j_get_config(name))), name


# ------------------------------------------------------------- the pool --
def _pools(n_blocks=24, bs=8):
    jcfg = j_reduced(j_get_config("internlm2-1.8b"))
    tcfg = reduced(get_config("internlm2-1.8b"))
    return (tcfg, PagedKVCache(tcfg, num_blocks=n_blocks, block_size=bs,
                               device="cpu"),
            JPagedKVCache(jcfg, num_blocks=n_blocks, block_size=bs,
                          max_batch=4))


def _rows(tcfg, rng, S):
    return {k: rng.normal(size=(tcfg.n_layers, 1, S, tcfg.n_kv_heads,
                                tcfg.hd)).astype(np.float32) for k in "kv"}


def _assert_pools_equal(tpool, jpool, skip_trash=False):
    n = tpool.num_blocks if skip_trash else tpool.num_blocks + 1
    for k in "kv":
        np.testing.assert_array_equal(
            tpool.pool[k][:, :n].numpy(),
            np.asarray(jpool.pool["stack"][0][k])[:, :n])


def test_chunk_writes_and_prefix_gather_match_reference():
    """Chunks that start and end mid-block, written token by token, fill
    the pool as the reference's do (the port's padding rows go to the
    trash block, which no table holds); a whole-block suffix write leaves
    the prefix alone; the gathered prefix equals the reference's on the
    valid blocks and reads the trash block past them."""
    tcfg, tpool, jpool = _pools()
    rng = np.random.default_rng(1)
    for mgr in (tpool.manager, jpool.manager):
        mgr.allocate(0, 30)
        mgr.allocate(1, 16)
    start = 0
    for chunk, S in ((5, 16), (11, 16), (14, 32)):
        kv = _rows(tcfg, rng, S)
        tpool.write_prefill(0, {k: torch.from_numpy(a)
                                for k, a in kv.items()},
                            start_pos=start, n_tokens=chunk)
        jpool.write_prefill(0, {"stack": [kv], "rem": []}, start_pos=start,
                            n_tokens=chunk)
        start += chunk
    kv = _rows(tcfg, rng, 16)
    tpool.write_prefill(1, {k: torch.from_numpy(a) for k, a in kv.items()},
                        start_pos=8)
    jpool.write_prefill(1, {"stack": [kv], "rem": []}, start_pos=8)
    _assert_pools_equal(tpool, jpool, skip_trash=True)
    for blocks, nb_pad in (([], 1), (tpool.manager.tables[0][:3], 4),
                           (tpool.manager.tables[0][:2], 2)):
        t = tpool.gather_prefix(blocks, nb_pad)
        j = jpool.gather_prefix(blocks, nb_pad)["stack"][0]
        n = len(blocks) * 8
        for k in "kv":
            assert t[k].shape == j[k].shape
            np.testing.assert_array_equal(t[k][:, :, :n].numpy(),
                                          np.asarray(j[k])[:, :, :n])
            trash = tpool.pool[k][:, tpool.trash_block]
            assert torch.equal(t[k][:, 0, n:].reshape(
                trash.shape[0], -1, *trash.shape[1:]),
                trash[:, None].expand(-1, nb_pad - len(blocks),
                                      *trash.shape[1:]))
    with pytest.raises(ValueError, match="over-allocates"):
        tpool.write_prefill(1, {k: torch.from_numpy(a)
                                for k, a in kv.items()},
                            start_pos=10, n_tokens=8)
    with pytest.raises(ValueError, match="block-aligned"):
        tpool.write_prefill(1, {k: torch.from_numpy(a)
                                for k, a in kv.items()}, start_pos=3)


def test_padding_rows_of_a_chunk_go_to_the_trash_block():
    tcfg, tpool, _ = _pools()
    tpool.manager.allocate(0, 6)
    kv = {k: torch.ones(tcfg.n_layers, 1, 16, tcfg.n_kv_heads, tcfg.hd)
          for k in "kv"}
    tpool.write_prefill(0, kv, start_pos=2, n_tokens=4)
    blk = tpool.manager.tables[0][0]
    assert bool((tpool.pool["k"][:, blk, 2:6] == 1).all())
    assert not bool(tpool.pool["k"][:, blk, 6:].any())
    others = [b for b in range(tpool.num_blocks) if b != blk]
    assert not bool(tpool.pool["v"][:, others].any())
    assert bool(tpool.pool["v"][:, tpool.trash_block].any())


def test_copy_on_write_forks_a_shared_block_like_the_reference():
    tcfg, tpool, jpool = _pools()
    rng = np.random.default_rng(2)
    kv = _rows(tcfg, rng, 16)
    for pool, cache in ((tpool, {k: torch.from_numpy(a)
                                 for k, a in kv.items()}),
                        (jpool, {"stack": [kv], "rem": []})):
        pool.manager.allocate(0, 12)
        pool.write_prefill(0, cache)
        pool.manager.share(1, pool.manager.tables[0])
        pool.ensure_writable(1, 9)           # forks block 1
        pool.ensure_writable(1, 10)          # now private: no fork
        pool.ensure_writable(0, 3)           # block 0, still shared: forks
    tables = tpool.manager.tables
    assert tables == jpool.manager.tables
    assert tpool.manager.cow_copies == jpool.manager.cow_copies == 2
    _assert_pools_equal(tpool, jpool)
    for i in (0, 1):
        assert tables[0][i] != tables[1][i]
        assert torch.equal(tpool.pool["k"][:, tables[0][i]],
                           tpool.pool["k"][:, tables[1][i]])
    assert all(tpool.manager.ref_count(b) == 1 for t in tables.values()
               for b in t)


# ------------------------------------------------------------ engines ----
BASE = dict(max_batch=4, block_size=8, kv_pool_tokens=4096,
            max_model_len=256, prefill_bucket=16)


@pytest.fixture(scope="module")
def models(rules):
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    tcfg = reduced(get_config("opt-1.3b"))
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jmodel = JModel(jcfg, rules)
    return (jmodel, jp, StepFunctions.build(jmodel, 8),
            Model(tcfg, tp, device="cpu"))


_REFERENCE_RUNS = {}


def _reference(models, make, **kw):
    """The reference engine's run of ``make``'s requests under ``kw``,
    made once a module (its compiles are the tests' main cost)."""
    key = (make.__name__, tuple(sorted(kw.items())))
    if key not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[key] = _serve(models, make, reference=True, **kw)
    return _REFERENCE_RUNS[key]


def _serve(models, make, *, reference=False, **kw):
    """Serve the requests ``make(reference)`` builds through one engine
    (the port's, or the reference's); returns outputs and the engine."""
    jmodel, jp, steps, tmodel = models
    kw = {**BASE, **kw}
    reqs = make(reference)
    if reference:
        eng = JEngine(jmodel, jp, JEngineConfig(**kw), steps=steps)
    else:
        eng = ContinuousBatchingEngine(tmodel, EngineConfig(**kw),
                                       device="cpu")
    metrics = eng.run(reqs)
    assert all(r.t_done is not None for r in reqs)
    return [list(map(int, r.output_tokens)) for r in reqs], eng, metrics


def _shared_prefix(reference):
    fn = j_shared_prefix if reference else shared_prefix_workload
    return fn(2, 4, 512, prefix_len=32, suffix_len=20, max_new_tokens=5,
              seed=0)


def _mixed(reference):
    """Prompts straddling every chunk regime: shorter than a block, than
    a chunk, several chunks long, not block-aligned."""
    rng = np.random.default_rng(0)
    cls = JRequest if reference else Request
    return [cls(req_id=i, prompt=rng.integers(0, 512, n).astype(np.int32),
                max_new_tokens=6)
            for i, n in enumerate([5, 12, 40, 70, 23])]


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_prefix_cache_outputs_equal_reference(models, prefix_cache):
    """The shared-prefix workload with the cache on and off: the
    reference's tokens, prefill work, hit rate and block traffic."""
    want, jeng, _ = _reference(models, _shared_prefix,
                               prefix_cache=prefix_cache)
    got, teng, m = _serve(models, _shared_prefix, prefix_cache=prefix_cache)
    assert got == want
    assert teng.prefill_tokens_computed == jeng.prefill_tokens_computed
    assert teng.pool.manager.total_allocations == \
        jeng.pool.manager.total_allocations
    if prefix_cache:
        assert dataclasses.asdict(m.prefix) == \
            dataclasses.asdict(jeng.prefix.stats)
        assert m.prefix.hit_rate > 0.3
        assert teng.prefill_tokens_computed < 8 * 52
    else:
        assert m.prefix is None and teng.prefix is None


@pytest.mark.parametrize("chunk", [6, 16, 64])
def test_chunked_outputs_equal_reference_and_serial(models, chunk):
    """chunk 6 < block_size 8 (chunks end mid-block), 16 (several chunks
    a prompt), 64 (mostly whole prompts): the reference engine's tokens
    (its own tests hold its chunked tokens to these serial ones), and
    the port's serial ones."""
    want, jeng, _ = _reference(models, _mixed)
    serial, _, _ = _serve(models, _mixed)
    got, teng, m = _serve(models, _mixed, prefill_chunk_tokens=chunk)
    assert teng.chunking and got == want == serial
    assert teng.prefill_tokens_computed == jeng.prefill_tokens_computed
    assert max(teng.prefill_token_samples) <= chunk
    assert m.stall.p50 > 0.0 and m.prefill_tokens_per_step > 0.0


def test_chunked_with_prefix_cache_equals_reference(models):
    """Chunks of 12 (ending mid-block) over spliced cached prefixes: the
    reference engine's tokens with fewer prefill tokens computed."""
    want, jeng, _ = _reference(models, _shared_prefix, prefix_cache=False)
    got, teng, m = _serve(models, _shared_prefix, prefill_chunk_tokens=12,
                          prefix_cache=True)
    assert got == want
    assert m.prefix.hit_tokens > 0
    assert teng.prefill_tokens_computed < jeng.prefill_tokens_computed


def test_chunked_preempts_half_prefilled_like_reference(models):
    """A tiny pool: the long prompt's chunks exhaust the free blocks
    while decodes need room, so the half-prefilled request is preempted
    and re-admitted; the tokens are the reference engine's, and serial
    prefill preempts as the reference does."""
    def make(reference):
        rng = np.random.default_rng(1)
        cls = JRequest if reference else Request
        return [cls(req_id=i, prompt=rng.integers(0, 512, n).astype(
            np.int32), max_new_tokens=new)
            for i, (n, new) in enumerate(((40, 40), (40, 40), (150, 4)))]
    kw = dict(kv_pool_tokens=256)
    want, jeng, _ = _reference(models, make, **kw)
    got, teng, _ = _serve(models, make, prefill_chunk_tokens=16, **kw)
    serial, seng, _ = _serve(models, make, **kw)
    assert teng.preemptions >= 1, "pool pressure never preempted a prefill"
    assert seng.preemptions == jeng.preemptions
    assert got == want == serial
    assert not teng.prefilling and not teng._prefilled
    assert teng.pool.manager.free_blocks == teng.pool.manager.num_blocks


def test_mixed_steps_stream_a_long_prompt_between_decodes(models):
    """While long prompts stream in, short requests keep decoding: steps
    carry prompt chunks and decode tokens together, within the budget,
    with serial prefill's outputs."""
    def make(reference):
        fn = j_long_short if reference else long_short_workload
        return fn(4, 2, 512, short_len=10, long_len=120, short_new=20,
                  long_new=4, every=2, seed=1)
    kw = dict(max_model_len=512, kv_pool_tokens=8192)
    want, _, _ = _serve(models, make, **kw)
    got, teng, m = _serve(models, make, prefill_chunk_tokens=16, **kw)
    assert got == want
    mixed = [p for p, d in zip(teng.prefill_token_samples,
                               teng.decode_token_samples) if p and d]
    assert mixed and max(teng.prefill_token_samples) <= 16
    assert m.stall_s_mean > 0.0 and m.decode_tokens_per_step > 0.0


def test_preempting_pool_with_prefix_cache_equals_reference(models):
    """Decode preemption with the cache on: cached blocks are evicted
    before running requests are preempted, as in the reference."""
    def make(reference):
        fn = j_sharegpt_like if reference else sharegpt_like
        return fn(6, 512, seed=11, mean_in=20, mean_out=36, max_len=60,
                  sigma=0.1)
    kw = dict(max_batch=6, kv_pool_tokens=256, max_model_len=96,
              prefix_cache=True)
    want, jeng, _ = _reference(models, make, **kw)
    got, teng, _ = _serve(models, make, **kw)
    assert jeng.preemptions > 0
    assert teng.preemptions == jeng.preemptions
    assert got == want


def test_reset_stats_keeps_the_warm_index(models):
    _, _, _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, EngineConfig(
        **BASE, prefix_cache=True, prefix_cache_blocks=64), device="cpu")
    eng.run(_shared_prefix(False))
    cached = eng.prefix.cached_blocks
    assert 0 < cached <= 64
    eng.reset_stats()
    assert eng.prefix.cached_blocks == cached
    assert eng.prefix.stats.lookups == 0 and eng.prefill_tokens_computed == 0
    eng.run(_shared_prefix(False))
    assert eng.prefix.stats.hit_rate > 0.5      # every prefix was warm


@pytest.mark.parametrize("kw", [dict(prefix_cache_blocks=0),
                                dict(prefill_chunk_tokens=0)])
def test_engine_config_refuses_bad_prefill_settings(kw):
    with pytest.raises(ValueError):
        EngineConfig(**kw)
    with pytest.raises(ValueError):
        JEngineConfig(**kw)
