"""Every engine mode over a KV sequence sharded on the model axis
(``shard_kv_seq``): the overlapped executor, chunked prefill, the prefix
cache, speculation and the gather mode, each served by the port's engine
on 2 and 4 gloo ranks on the CPU, every rank holding ``BS / M`` rows of
every block, against the JAX reference engine in the same mode on one
device, on the same weights (the reference's init carried across as
numpy) and the same requests; the static loop's dense decode over the
rank's contiguous share of a cache's slots (a ring under a sliding
window too) against the reference's logits; and, without a spawn, the
pieces those
modes are built of: the prefix's all-gather put back in position order,
the contiguous kernel's partials entry (its plain version) combined, the
dense copy and its write back, copy-on-write and rollback on a
sequence-sharded pool.

The config is qwen-like (8 query heads, 2 KV heads, ``qkv_bias``): its
KV heads do not divide 4 ranks, the case the reference's launcher shards
the KV sequence for. Each rank is a process of its own
(``repro_torch.distributed.spawn``); one spawn a mesh size runs every
mode's serve in turn (``tensor_parallel.run_jobs``), and the reference
serves four times (its engines share one ``StepFunctions``)."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.compat import make_mesh as j_make_mesh  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.kernels.decode_attention import \
    gqa_decode_attention as j_decode  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import repetitive_workload as j_repetitive  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro.serving import \
    shared_prefix_workload as j_shared_prefix  # noqa: E402
from repro.sharding import rules_for as j_rules_for  # noqa: E402
from repro_torch import distributed as D  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import decode_attention as DK  # noqa: E402
from repro_torch.kernels import paged_decode_attention as PK  # noqa: E402
from repro_torch.kvcache.paged import PagedKVCache  # noqa: E402
from repro_torch.launch import tensor_parallel as TP  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.attention import local_lengths  # noqa: E402
from repro_torch.serving import (EngineConfig, SamplingParams,  # noqa: E402
                                 repetitive_workload, sharegpt_like,
                                 shared_prefix_workload)

BS = 8
ENGINE = dict(max_batch=4, block_size=BS, kv_pool_tokens=1024,
              max_model_len=96, prefill_bucket=16)
SEQ = {"shard_kv_seq": True}
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
# speculation's sampled rows: a low temperature and top-k, so that some
# drafts are accepted on random weights
SPEC_SAMPLED = dict(temperature=0.5, top_k=3, top_p=0.9)
# float32, the plain versions' sums in another order than one piece's
PARTIALS_TOL = 3e-5


def _sharegpt(ref):
    """6 ShareGPT-shaped requests with Poisson arrivals; every other one
    sampled (its own seed)."""
    make, params = ((j_sharegpt_like, JSamplingParams) if ref
                    else (sharegpt_like, SamplingParams))
    reqs = make(6, 512, seed=5, mean_in=14, mean_out=10, max_len=40,
                sigma=0.5, arrival_rate=200.0)
    return [type(r)(r.req_id, r.prompt, arrival_s=r.arrival_s,
                    sampling=params(**SAMPLED, seed=100 + i,
                                    max_new_tokens=r.max_new_tokens)
                    if i % 2 else r.sampling)
            for i, r in enumerate(reqs)]


def _sharegpt_at_once(ref):
    """:func:`_sharegpt`'s requests, all arrived at t=0."""
    return [type(r)(r.req_id, r.prompt, arrival_s=0.0, sampling=r.sampling)
            for r in _sharegpt(ref)]


def _shared_prefix(ref):
    """Two tenants of three requests, a 27-token prefix each (it ends
    mid-block: the prefix's last rows lie on some ranks only)."""
    make = j_shared_prefix if ref else shared_prefix_workload
    return make(2, 3, 512, prefix_len=27, suffix_len=10, max_new_tokens=5,
                seed=0)


def _repetitive(ref):
    """Four repetitive prompts, the odd ones sampled."""
    make, params = ((j_repetitive, JSamplingParams) if ref
                    else (repetitive_workload, SamplingParams))
    reqs = make(4, 512, prompt_len=29, max_new_tokens=14, repeat_rate=1.0,
                phrase_len=8, pool_size=1, seed=3)
    return [type(r)(r.req_id, r.prompt, arrival_s=r.arrival_s,
                    sampling=params(**SPEC_SAMPLED, seed=200 + i,
                                    max_new_tokens=r.max_new_tokens)
                    if i % 2 else r.sampling)
            for i, r in enumerate(reqs)]


# the reference's four serves: (workload, engine settings)
REFERENCE = {
    "chunked": (_sharegpt, dict(prefill_chunk_tokens=16, overlap=True)),
    "prefix": (_shared_prefix, dict(prefix_cache=True)),
    "speculate": (_repetitive, dict(speculate=True)),
    "gather": (_sharegpt_at_once, dict(decode_mode="gather")),
}
# each mode under shard_kv_seq: (the reference serve it equals, the
# port's settings). The reference's overlapped loop gives its sync loop's
# tokens (its own tests hold that), so one reference serve answers both
MODES = {
    "overlap": ("chunked", dict(overlap=True, prefill_chunk_tokens=16)),
    "chunked": ("chunked", dict(prefill_chunk_tokens=16)),
    "prefix": ("prefix", dict(prefix_cache=True)),
    "speculate": ("speculate", dict(speculate=True)),
    "gather": ("gather", dict(decode_mode="gather")),
}
CASES = [(name, m) for m in (2, 4) for name in MODES]
# the static loop over a dense cache of STATIC_LEN slots (the rank's
# contiguous share of them): (sliding window, prompt length). The ring
# of 16 slots has wrapped at 20; the decode steps' rows cross from one
# rank's slots to the next's
STATIC = {"dense": (None, 14), "ring": (16, 20)}
STATIC_LEN, STATIC_STEPS = 32, 6
# the tolerance of tests/test_torch_model.py: float32, of the largest logit
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = j_reduced(j_get_config("qwen2.5-3b"), n_heads=8, n_kv_heads=2)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                 jax.random.PRNGKey(3)))
    return jcfg, reduced(get_config("qwen2.5-3b"), n_heads=8,
                         n_kv_heads=2), jp


def _static(name):
    """The reference's config, the port's and the weights, under
    ``name``'s window, and its aligned prompts and decode feed."""
    jcfg, tcfg, jp = _weights()
    window, S = STATIC[name]
    rng = np.random.default_rng(17)
    toks = rng.integers(0, tcfg.vocab_size, (2, S)).astype(np.int32)
    feed = rng.integers(0, tcfg.vocab_size,
                        (STATIC_STEPS, 2)).astype(np.int32)
    return (dataclasses.replace(jcfg, sliding_window=window),
            dataclasses.replace(tcfg, sliding_window=window), jp, toks, feed)


@functools.lru_cache(maxsize=None)
def _reference_static(name):
    """The reference's ``prefill`` and dense ``decode_step`` logits on
    one device (the static loop: one position for the batch)."""
    jcfg, _, jp, toks, feed = _static(name)
    rules = j_rules_for(j_make_mesh((1, 1), ("data", "model")))
    lj, cache, _ = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)},
                              cache_len=STATIC_LEN)
    decode = []
    for i, row in enumerate(feed):
        lj_d, cache = JM.decode_step(jp, jcfg, rules, cache,
                                     jnp.asarray(row),
                                     jnp.int32(toks.shape[1] + i))
        decode.append(np.asarray(lj_d))
    return np.asarray(lj), np.stack(decode)


@functools.lru_cache(maxsize=None)
def _jmodel():
    jcfg, _, _ = _weights()
    return JM.Model(jcfg, j_rules_for(j_make_mesh((1, 1),
                                                   ("data", "model"))))


@functools.lru_cache(maxsize=None)
def _jsteps():
    return JStepFunctions.build(_jmodel(), BS)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference engine's serve ``name`` on one device: each
    request's tokens and finish reason, and its counters."""
    _, _, jp = _weights()
    make, kw = REFERENCE[name]
    reqs = make(True)
    eng = JEngine(_jmodel(), jp, JEngineConfig(**ENGINE, **kw),
                  steps=_jsteps())
    eng.run(reqs)
    counters = dict(spec_steps=eng.spec_steps,
                    spec_drafted=eng.spec_drafted,
                    spec_accepted=eng.spec_accepted)
    if eng.prefix is not None:
        counters["prefix_hit_tokens"] = eng.prefix.stats.hit_tokens
    return ([list(map(int, r.output_tokens)) for r in reqs],
            [r.finish_reason for r in reqs], counters)


@functools.lru_cache(maxsize=None)
def _ranks(m):
    """One spawn of ``m`` gloo ranks under shard_kv_seq serving each mode
    in turn, then the static loop's cases, collectives recorded."""
    _, tcfg, jp = _weights()
    jobs = []
    for name, (ref, kw) in MODES.items():
        jobs.append((TP.serve_rank, (tcfg, EngineConfig(**ENGINE, **kw),
                                     REFERENCE[ref][0](False), jp),
                     dict(record=True, rules=SEQ)))
    for name in STATIC:
        _, scfg, _, toks, feed = _static(name)
        jobs.append((TP.logits_rank, (scfg, jp, toks, None, feed),
                     dict(rules=SEQ, record=True, dense_len=STATIC_LEN)))
    ranks = D.spawn(TP.run_jobs, D.devices_mesh(m, "cpu"), jobs)
    return {name: [r[j] for r in ranks]
            for j, name in enumerate([*MODES, *STATIC])}


# -------------------------------------------------------------- tokens --
@pytest.mark.parametrize("name,m", CASES)
def test_mode_gives_the_reference_engines_tokens(name, m):
    """Rank 0's tokens and finish reasons over M ranks under
    shard_kv_seq equal the reference engine's serve in the same mode on
    one device; the prefix cache hits and speculation drafts and accepts
    as the reference's, chunking chunks, and the gather mode decodes."""
    serve = _ranks(m)[name]
    tokens, finish, counters = _reference(MODES[name][0])
    assert serve[0]["tokens"] == tokens
    assert serve[0]["finish"] == finish
    if name in ("overlap", "chunked"):
        assert serve[0]["suffix_prefills"] > 0 == serve[0]["prefills"]
    if name == "prefix":
        assert serve[0]["prefix_hit_tokens"] == \
            counters["prefix_hit_tokens"] > 0
    if name == "speculate":
        for key in ("spec_steps", "spec_drafted", "spec_accepted"):
            assert serve[0][key] == counters[key], key
        assert serve[0]["spec_accepted"] > 0
    if name == "gather":
        assert serve[0]["decode_steps"] > 0


@pytest.mark.parametrize("name,m", CASES)
def test_every_rank_issues_the_same_collectives(name, m):
    """The lock step: each rank's collectives (op, shape, dtype) through
    the serve, and its kernel launches, equal rank 0's. Every decode
    all-gathers its float32 partials ``[B, H, hd + 2]`` once a layer
    (the gather mode's too, from the contiguous kernel's entry), and a
    prefill over a prefix all-gathers the rank's rows of it, K and V
    together, once a layer."""
    serve = _ranks(m)[name]
    a = serve[0]["record"]
    for r in serve[1:]:
        assert r["record"] == a
        assert r["launches"] == serve[0]["launches"]
    _, tcfg, _ = _weights()
    partials = [s for op, s, dt in a if op == "all_gather" and len(s) == 3
                and s[1:] == (tcfg.n_heads, tcfg.hd + 2)
                and dt == "torch.float32"]
    assert partials and len(partials) % tcfg.n_layers == 0
    prefix = [s for op, s, _ in a if op == "all_gather" and len(s) == 5]
    assert all(s[0] == 2 and s[3:] == (tcfg.n_kv_heads, tcfg.hd)
               and s[2] % (BS // m) == 0 for s in prefix)
    if name == "gather":
        assert not prefix
    elif name != "speculate":
        assert prefix and len(prefix) % tcfg.n_layers == 0


# ------------------------------------------------------ the static loop --
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", STATIC)
def test_static_dense_decode_matches_the_reference(name, m):
    """``prefill`` into the rank's contiguous share of a dense cache, then
    6 dense ``decode_step`` calls (each new row written on the rank that
    holds its slot, the contiguous kernel's partials all-gathered and
    combined) over M ranks under shard_kv_seq, within 1e-5 of the
    reference's largest logit on one device, with and without a sliding
    window's ring; every rank returns the same logits and issues the same
    collectives, the decode's partials once a layer a step."""
    want_prefill, want_decode = _reference_static(name)
    outs = _ranks(m)[name]
    for out in outs:
        np.testing.assert_array_equal(out["prefill"], outs[0]["prefill"])
        np.testing.assert_array_equal(out["decode"], outs[0]["decode"])
        assert out["record"] == outs[0]["record"]
    _, tcfg, _, _, _ = _static(name)
    partials = [s for op, s, _ in outs[0]["record"]
                if op == "all_gather" and s == (2, tcfg.n_heads, tcfg.hd + 2)]
    assert len(partials) == STATIC_STEPS * tcfg.n_layers
    for got, want in ((outs[0]["prefill"], want_prefill),
                      (outs[0]["decode"], want_decode)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * float(np.abs(want).max()))


# ------------------------------------------------------------ the pool --
def _pools(tcfg, m, num_blocks=8):
    """An unsharded pool and each rank's pool of a sharded KV sequence,
    the same allocations and the same rows written into each."""
    whole = PagedKVCache(tcfg, num_blocks=num_blocks, block_size=BS,
                         device="cpu")
    ranks = [PagedKVCache(tcfg, num_blocks=num_blocks, block_size=BS,
                          device="cpu", seq_shard=(r, m)) for r in range(m)]
    rng = np.random.default_rng(m)
    n_kv = whole.pool["k"].shape[0]
    for rid, n in ((0, 21), (1, 13)):
        cache = {name: torch.from_numpy(rng.standard_normal(
            (n_kv, 1, n, tcfg.n_kv_heads, tcfg.hd)).astype(np.float32))
            for name in ("k", "v")}
        for pool in (whole, *ranks):
            pool.manager.allocate(rid, n)
            pool.write_prefill(rid, cache, 0, n_tokens=n)
    return whole, ranks


def _rank_rows(whole, r, m):
    """The rows of every block of the unsharded pool that rank ``r``
    holds."""
    rows = BS // m
    return {name: whole.pool[name][:, :, r * rows:(r + 1) * rows]
            for name in ("k", "v")}


def _assert_rows(whole, ranks, m):
    for r, pool in enumerate(ranks):
        want = _rank_rows(whole, r, m)
        for name in ("k", "v"):
            # the trash block takes other ranks' rows: not compared
            assert torch.equal(pool.pool[name][:, :-1],
                               want[name][:, :-1]), (r, name)
        assert pool.manager.tables == whole.manager.tables


@pytest.mark.parametrize("m", [2, 4])
def test_whole_prefix_equals_gather_prefix_on_an_unsharded_pool(m,
                                                                monkeypatch):
    """Each rank's ``gather_prefix`` (its rows of each block), all-gathered
    and put back in position order (:func:`attention.whole_prefix`, the
    all-gather stood in by stacking the ranks' tensors in rank order),
    equals ``gather_prefix`` on an unsharded pool: every layer, the trash
    block's rows past the prompt's blocks included in shape."""
    _, tcfg, _ = _weights()
    whole, ranks = _pools(tcfg, m)
    blocks = whole.manager.tables[0][:2]
    want = whole.gather_prefix(blocks, nb_pad=4)
    mine = [p.gather_prefix(blocks, nb_pad=4) for p in ranks]
    for l in range(want["k"].shape[0]):
        monkeypatch.setattr(attention, "gather_parts", lambda x: torch.stack(
            [torch.stack([g["k"][l], g["v"][l]]) for g in mine]))
        k, v = attention.whole_prefix(mine[0]["k"][l], mine[0]["v"][l], BS)
        n = len(blocks) * BS
        assert k.shape == want["k"][l].shape
        assert torch.equal(k[:, :n], want["k"][l][:, :n])
        assert torch.equal(v[:, :n], want["v"][l][:, :n])


@pytest.mark.parametrize("m", [2, 4])
def test_dense_copy_and_write_back_hold_the_ranks_rows(m):
    """``gather_tables`` on a rank's pool is the unsharded copy's rows of
    that rank, block by block; ``scatter_rows`` writes a row back on the
    rank that holds its position alone (the trash block elsewhere), and
    ``scatter_new_token`` as well."""
    _, tcfg, _ = _weights()
    whole, ranks = _pools(tcfg, m)
    tables = torch.tensor([whole.manager.tables[0][:3],
                           (whole.manager.tables[1] * 2)[:3]],
                          dtype=torch.int32)
    full = whole.gather_tables(tables)
    rows = BS // m
    for r, pool in enumerate(ranks):
        got = pool.gather_tables(tables)
        want = full["k"].reshape(*full["k"].shape[:2], 3, BS,
                                 *full["k"].shape[3:])[:, :, :, r * rows:
                                                       (r + 1) * rows]
        assert torch.equal(got["k"], want.reshape(got["k"].shape))
    positions = [20, 12]
    for write in ("rows", "token"):
        for r, pool in enumerate(ranks):
            want = pool.pool["k"].clone()
            cache = pool.gather_tables(tables)
            gen = torch.Generator().manual_seed(r)
            cache = {name: torch.randn(t.shape, generator=gen)
                     for name, t in cache.items()}
            if write == "rows":
                pool.scatter_rows(tables, torch.tensor(positions), cache)
            else:
                pool.scatter_new_token([0, 1], positions, cache)
            for b, pos in enumerate(positions):
                blk, sib = whole.manager.tables[b][pos // BS], pos % BS
                if sib // rows == r:
                    want[:, blk, sib % rows] = cache["k"][
                        :, b, pos // BS * rows + sib % rows]
            # the trash block takes the rows other ranks hold
            assert torch.equal(pool.pool["k"][:, :-1], want[:, :-1]), r


@pytest.mark.parametrize("m", [2, 4])
def test_rollback_and_copy_on_write_on_a_sequence_sharded_pool(m):
    """A copy-on-write fork copies each rank's own rows of the shared
    block (the unsharded pool's rows of that rank), and a rollback
    truncates every rank's table alike; a write after both lands on the
    rank that holds it."""
    _, tcfg, _ = _weights()
    whole, ranks = _pools(tcfg, m)
    shared = whole.manager.tables[0][:1]
    tail = whole.manager.tables[0][2:]
    for pool in (whole, *ranks):
        pool.manager.share(2, shared)
        pool.manager.allocate(2, BS)
        pool.ensure_writable(2, 3)
        assert pool.manager.tables[2][0] != shared[0]
        assert pool.manager.cow_copies == 1
        assert pool.rollback(0, 9) == tail
    _assert_rows(whole, ranks, m)
    assert len(whole.manager.tables[0]) == 2
    n_kv = whole.pool["k"].shape[0]
    cache = {name: torch.ones((n_kv, 1, 4, tcfg.n_kv_heads, tcfg.hd))
             for name in ("k", "v")}
    for pool in (whole, *ranks):
        pool.write_prefill(2, cache, 3, n_tokens=4)
    _assert_rows(whole, ranks, m)


# ------------------------------------------------------ plain versions --
@pytest.mark.parametrize("m", [1, 2, 4])
def test_decode_partials_combined_are_the_whole_kernel(m):
    """The contiguous kernel's partials entry over each of M ranks' rows
    of every block (a gather step's dense copy, at its local lengths) and
    the combine of the M pieces equal the contiguous kernel's plain
    version over the whole cache within 3e-5 of its largest (float32),
    and the reference's Pallas kernel in interpret mode; a rank with no
    row of a request gives an empty piece (``l = 0``, ``m = -inf``, ``acc
    = 0``), and a request of length 0 combines to exact zeros."""
    rng = np.random.default_rng(9)
    B, H, K, hd, nb = 6, 8, 2, 32, 5
    S = nb * BS
    lengths = np.array([1, 3, 8, 13, 40, 0], np.int32)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, K, hd))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, K, hd))
                         .astype(np.float32))
    lens = torch.from_numpy(lengths)
    rows = BS // m
    parts = []
    for r in range(m):
        local = local_lengths(lens, BS, rows, r)
        piece = k.reshape(B, nb, BS, K, hd)[:, :, r * rows:(r + 1) * rows]
        vpiece = v.reshape(B, nb, BS, K, hd)[:, :, r * rows:(r + 1) * rows]
        part = DK.decode_partials(q, piece.reshape(B, nb * rows, K, hd),
                                  vpiece.reshape(B, nb * rows, K, hd), local)
        assert part.shape == (B, H, hd + 2) and part.dtype == torch.float32
        empty = local == 0
        assert torch.isneginf(part[empty][..., hd]).all()
        assert (part[empty][..., hd + 1] == 0).all()
        assert (part[empty][..., :hd] == 0).all()
        parts.append(part)
    assert m == 1 or any((local_lengths(lens, BS, rows, r)[:5] == 0).any()
                         for r in range(m))
    got = PK.paged_decode_combine(torch.stack(parts), torch.float32)
    assert (got[5] == 0).all()
    whole = DK.gqa_decode_attention_torch(q, k, v, lens)
    atol = PARTIALS_TOL * float(whole[:5].abs().max())
    torch.testing.assert_close(got[:5], whole[:5], rtol=0, atol=atol)
    ref = np.asarray(j_decode(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                              jnp.asarray(v.numpy()), jnp.asarray(lengths),
                              interpret=True))
    np.testing.assert_allclose(got[:5].numpy(), ref[:5], rtol=0, atol=atol)
