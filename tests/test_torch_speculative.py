"""The port's speculative decoding (``repro_torch.serving.spec`` and its
engine, scheduler, executor and pool parts) on the CPU, against the JAX
reference: the prompt-lookup drafter's cases of
``tests/test_speculative.py`` through both drafters; ``rollback`` and
``truncate`` through both pools; the verify step against the reference's
``spec_verify_fn`` on the same weights, pool and inputs (greedy and
sampled, mixed draft lengths and padding rows), its iteration 0 against
the plain paged step bit for bit, its body free of host round trips; the
host key block against ``fold_keys``; the engine with speculation on
against off and against the reference engine with ``speculate=True``
(greedy with equal counters, sampled with the prefix cache and chunked
prefill, stop tokens, overlap), every block home after each run; the
guards (rollback mid-prefill, gather mode, config validation); a request
with a verify step in flight keeping its seat; and the verify bucket
set."""
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
from repro.kvcache.paged import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import init_params as j_init_params  # noqa: E402
from repro.models.sampler import \
    stack_sampling as j_stack_sampling  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import repetitive_workload as j_repetitive  # noqa: E402
from repro.serving.spec import PromptLookupDrafter as JDrafter  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kvcache.paged import PagedKVCache  # noqa: E402
from repro_torch.models import sampler  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, SamplingParams,
                                 repetitive_workload)
from repro_torch.serving.spec import PromptLookupDrafter  # noqa: E402
from repro_torch.serving.spec.verify import verify_keys  # noqa: E402
from repro_torch.serving.steps import (StepFunctions,  # noqa: E402
                                       split_verify)

BS = 8
BASE = dict(max_batch=4, block_size=BS, kv_pool_tokens=4096,
            max_model_len=128, prefill_bucket=16)


# ------------------------------------------------------------ drafter --
class _Req:
    """The request shape the drafter reads (req_id, prompt, prompt_len,
    state.output_tokens)."""

    def __init__(self, rid, prompt, out):
        self.req_id = rid
        self.prompt = np.asarray(prompt, np.int64)
        self.prompt_len = len(prompt)
        self.state = types.SimpleNamespace(output_tokens=list(out))


def _tiles(D):
    d = D(max_k=8, start_k=8)
    got = d.propose(_Req(0, [7, 9, 7, 9, 7, 9], []), 8).tolist()
    assert got == [7, 9, 7, 9, 7, 9, 7, 9]
    return got


def _longest(D):
    d = D(max_ngram=3, max_k=4, start_k=4)
    got = d.propose(_Req(0, [1, 2, 3, 5, 6, 3, 1, 2, 3], []), 4).tolist()
    assert got[0] == 5
    return got


def _novel(D):
    got = D().propose(_Req(0, list(range(100, 140)), []), 8).tolist()
    assert got == []
    return got


def _history(D):
    d = D(min_ngram=1)
    got = d.propose(_Req(0, [1, 2, 3, 4], [50, 60, 70, 50, 60]), 2).tolist()
    assert got and got[0] == 70
    return got


def _grows(D):
    d = D(start_k=2, max_k=8)
    ks = []
    for n in (2, 4, 8):
        d.observe(0, n, n)
        ks.append(d._k[0])
    assert ks == [4, 8, 8]
    return ks


def _partial(D):
    d = D(start_k=8, max_k=8)
    d.observe(0, 3, 8)
    ks = [d._k[0]]
    d.observe(0, 0, 3)
    ks.append(d._k[0])
    assert ks == [3, 1]
    return ks


def _cooldown(D):
    d = D(start_k=4, streak_limit=2, cooldown=3)
    r = _Req(0, [7, 9, 7, 9, 7, 9], [])
    d.observe(0, 0, 4)
    d.observe(0, 0, 2)
    got = [d.propose(r, 8).tolist() for _ in range(4)]
    assert got[:3] == [[], [], []] and got[3]
    return got


def _rebuild(D):
    d = D()
    r = _Req(0, [7, 9, 7, 9], [1, 2, 3, 4, 5])
    first = d.propose(r, 4).tolist()
    r.state.output_tokens = []
    got = d.propose(r, 4).tolist()
    assert got == [7, 9, 7, 9]
    return [first, got]


def _forget(D):
    d = D()
    d.propose(_Req(5, [7, 9, 7, 9], []), 4)
    d.observe(5, 0, 4)
    d.forget(5)
    left = [5 in store for store in (d._k, d._streak, d._cool, d._ctx)]
    assert not any(left)
    return left


def _validates(D):
    msgs = []
    for kw, match in ((dict(max_ngram=2, min_ngram=3), "min_ngram"),
                      (dict(max_k=0), "max_k")):
        with pytest.raises(ValueError, match=match) as info:
            D(**kw)
        msgs.append(str(info.value))
    return msgs


def _stream(D):
    """A long run of propose / observe over a growing output: the
    adaptive K, streaks and cooldowns interleaved."""
    d = D(max_k=6, start_k=3)
    rng = np.random.default_rng(4)
    phrase = rng.integers(0, 50, 5)
    r = _Req(3, np.tile(phrase, 4), [])
    trace = []
    for step in range(40):
        got = d.propose(r, 6)
        acc = int(rng.integers(0, len(got) + 1)) if len(got) else 0
        d.observe(3, acc, len(got))
        trace.append((got.tolist(), d._k.get(3), d._cool.get(3)))
        r.state.output_tokens += (phrase.tolist() if step % 3
                                  else rng.integers(50, 99, 2).tolist())
    return trace


DRAFTER_CASES = {f.__name__[1:]: f for f in (
    _tiles, _longest, _novel, _history, _grows, _partial, _cooldown,
    _rebuild, _forget, _validates, _stream)}


@pytest.mark.parametrize("case", list(DRAFTER_CASES))
def test_drafter_equals_reference(case):
    """Each case of the reference's drafter tests, through the reference's
    drafter and the port's: the same proposals, the same adaptive K."""
    run = DRAFTER_CASES[case]
    assert run(PromptLookupDrafter) == run(JDrafter)


# ----------------------------------------------------------- rollback --
def _rollback_exact_boundary(pool):
    pool.manager.allocate(0, 24)                      # 3 blocks
    assert pool.rollback(0, 17) == []                 # 17 tokens: 3 blocks
    dropped = pool.rollback(0, 16)                    # 16 tokens: 2 blocks
    assert len(dropped) == 1 and len(pool.manager.tables[0]) == 2
    return dropped


def _rollback_zero_and_validation(pool):
    pool.manager.allocate(0, 20)
    dropped = pool.rollback(0, 0)
    assert len(dropped) == 3 and pool.manager.tables[0] == []
    with pytest.raises(ValueError, match="n_tokens"):
        pool.rollback(0, -1)
    with pytest.raises(ValueError, match="keep_blocks"):
        pool.manager.truncate(0, -1)
    assert pool.rollback(99, 0) == []                 # unknown: a no-op
    return dropped


def _rollback_cow_shared(pool):
    mgr = pool.manager
    blocks = mgr.allocate(0, 16)
    mgr.share(1, blocks)                              # refcount 2 on both
    dropped = pool.rollback(1, 8)
    assert dropped == [blocks[1]] and mgr.ref_count(blocks[1]) == 1
    assert mgr.free_blocks == mgr.num_blocks - 2      # nothing freed
    pool.rollback(0, 8)                               # its last owner
    assert mgr.free_blocks == mgr.num_blocks - 1
    return dropped


@pytest.mark.parametrize("case", [_rollback_exact_boundary,
                                  _rollback_zero_and_validation,
                                  _rollback_cow_shared],
                         ids=lambda f: f.__name__[10:])
def test_rollback_equals_reference(case):
    """``PagedKVCache.rollback`` over ``BlockManager.truncate``: the same
    dropped blocks, tables and free lists as the reference's pool, and
    every block accounted for."""
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    tpool = PagedKVCache(reduced(get_config("opt-1.3b")), num_blocks=8,
                         block_size=BS, device="cpu")
    jpool = JPagedKVCache(jcfg, num_blocks=8, block_size=BS, max_batch=2)
    assert case(tpool) == case(jpool)
    for mgr in (tpool.manager, jpool.manager):
        assert mgr.free_blocks + len(mgr.refs) == mgr.num_blocks
    assert tpool.manager.tables == jpool.manager.tables
    assert tpool.manager.free == jpool.manager.free


# -------------------------------------------------------- verify step --
@pytest.fixture(scope="module")
def models(rules):
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    tcfg = reduced(get_config("opt-1.3b"))
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jmodel = JModel(jcfg, rules)
    return (jmodel, jp, JStepFunctions.build(jmodel, BS),
            Model(tcfg, tp, device="cpu"))


def _pools(tcfg, jcfg, n_blocks=40):
    """The port's pool, a twin of it and the reference's, all holding the
    same random rows."""
    gen = torch.Generator().manual_seed(5)
    pools = [PagedKVCache(tcfg, num_blocks=n_blocks, block_size=BS,
                          device="cpu") for _ in range(2)]
    for name, leaf in pools[0].pool.items():
        leaf.normal_(generator=gen)
        pools[1].pool[name].copy_(leaf)
    jpool = JPagedKVCache(jcfg, num_blocks=n_blocks, block_size=BS,
                          max_batch=8)
    jpool.pool["stack"][0] = {name: jax.numpy.asarray(leaf.numpy())
                              for name, leaf in pools[0].pool.items()}
    return pools[0], pools[1], jpool


LENS = [5, 17, 30, 9, 41]
K_PAD = 4


def _verify_rows(sampled):
    return [types.SimpleNamespace(req_id=r, sampling=SamplingParams(
        temperature=0.9 if sampled and r != 2 else 0.0, top_k=r * 7 % 11,
        top_p=0.9 if r % 2 else 1.0, seed=100 + r))
        for r in range(len(LENS))]


@pytest.mark.parametrize("sampled", [False, True])
def test_verify_step_equals_reference(models, sampled):
    """One verify step (batch 5 in the 8 bucket: three padding rows) with
    a full draft, a draft wrong at its third token, none, one wrong at
    its first and a one-token draft, drafts taken from the serial steps'
    tokens: ``ys`` and ``oks`` equal the reference ``spec_verify_fn``'s on
    the same weights, pool and inputs, the pool within 1e-5 of its pool,
    the accepted prefixes are as drafted, and iteration 0's logits are
    the plain paged step's bit for bit."""
    jmodel, jp, jsteps, model = models
    cfg = model.cfg
    tpool, twin, jpool = _pools(cfg, jmodel.cfg)
    rids = list(range(len(LENS)))
    for rid, n in enumerate(LENS):
        for mgr in (tpool.manager, twin.manager, jpool.manager):
            mgr.allocate(rid, n + K_PAD + 2)
    reqs = _verify_rows(sampled)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               len(rids)).tolist()
    # the serial steps' tokens: the twin pool, one plain step at a time
    serial = StepFunctions(model, twin, max_batch=8, max_model_len=128)
    batch_pad, nb_pad = serial.paged_bucket(rids)
    dev, hot = serial._stage(reqs, LENS, tokens, None, batch_pad, nb_pad,
                             rids)
    out, plain_logits = serial._paged_body(dev, hot)
    ys_serial = [out[:len(rids)].tolist()]
    for j in range(1, K_PAD + 1):
        ys_serial.append(serial.paged(
            reqs, rids, [n + j for n in LENS], ys_serial[-1])
            [:len(rids)].tolist())
    s = np.asarray(ys_serial).T                          # [B, K_PAD + 1]
    wrong = (s + 1) % cfg.vocab_size
    drafts = [s[0, :4], np.r_[s[1, :2], wrong[1, 2], s[1, 3]],
              s[2, :0], wrong[3, :1], s[4, :1]]
    drafts = [np.asarray(d, np.int32) for d in drafts]
    want_prefix = [4, 2, 0, 0, 1]

    steps = StepFunctions(model, tpool, max_batch=8, max_model_len=128,
                          spec_k=K_PAD)
    assert steps.verify_bucket(rids, drafts) == (batch_pad, nb_pad, K_PAD)
    dev, hot = steps._stage(reqs, LENS, tokens, None, batch_pad, nb_pad,
                            rids, drafts, K_PAD)
    assert hot == sampled
    packed, logits0 = steps._verify_body(dev, K_PAD, sampled)
    ys, oks = split_verify(packed.numpy())
    assert torch.equal(logits0, plain_logits)
    assert bool(steps.finite)

    view = jpool.view(rids, LENS, nb_pad, batch_pad)
    tok_pad = np.zeros((batch_pad,), np.int32)
    tok_pad[:len(rids)] = tokens
    mat = np.zeros((batch_pad, K_PAD), np.int32)
    dlen = np.zeros((batch_pad,), np.int32)
    for i, d in enumerate(drafts):
        mat[i, :len(d)] = d
        dlen[i] = len(d)
    jys, joks, new_pool = jsteps.spec_verify(
        jp, view.pool, view.tables, view.lengths, view.positions,
        view.slots, tok_pad, mat, dlen,
        *j_stack_sampling([r.sampling for r in reqs], pad_to=batch_pad))
    jpool.commit(new_pool)
    jys, joks = np.asarray(jys), np.asarray(joks)
    assert ys[:len(rids)].tolist() == jys[:len(rids)].tolist()
    assert oks.tolist() == joks.tolist()
    assert [int(oks[i].sum()) for i in rids] == want_prefix
    assert not oks[len(rids):].any()                # padding rows dead
    for i, n in enumerate(want_prefix):             # the serial tokens
        assert ys[i, :n + 1].tolist() == s[i, :n + 1].tolist()
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tpool.pool[name][:, :tpool.num_blocks].numpy(),
            np.asarray(jpool.pool["stack"][0][name])[:, :tpool.num_blocks],
            atol=1e-5, rtol=0)


@pytest.mark.parametrize("sampled", [False, True])
def test_verify_body_makes_no_host_round_trip(models, monkeypatch, sampled):
    """The verify body a graph captures, run on the CPU with every way to
    make a tensor from host data or read one back patched to raise."""
    model = models[3]
    pool = PagedKVCache(model.cfg, num_blocks=32, block_size=BS,
                        device="cpu")
    for rid in range(3):
        pool.manager.allocate(rid, 40)
    steps = StepFunctions(model, pool, max_batch=4, max_model_len=64,
                          spec_k=4)
    reqs = _verify_rows(sampled)[:3]
    drafts = [np.array([1, 2, 3], np.int32), np.zeros(0, np.int32),
              np.array([5], np.int32)]
    dev, hot = steps._stage(reqs, [10, 20, 29], [1, 2, 3], None, 4, 8,
                            [0, 1, 2], drafts, 4)

    def refuse(*a, **k):
        raise AssertionError("host round trip inside the verify body")
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    packed, logits = steps._verify_body(dev, 4, hot)
    monkeypatch.undo()
    assert packed.shape == (4, 10) and packed.dtype == torch.int32
    assert logits.shape[0] == 4


def test_key_block_equals_fold_keys_at_every_offset():
    """The host key block of a verify step holds, at offset ``o``, the
    key of counter ``position + 1 + o``: ``fold_keys``' (and JAX's
    ``fold_in``) at every offset."""
    seeds = np.array([0, 1, 7, 123456, 2 ** 32 - 1], np.uint32)
    pos = np.array([0, 5, 161, 1023, 2 ** 31 - 12], np.int64)
    K = 8
    block = verify_keys(seeds, pos, K)
    assert block.shape == (len(seeds), K + 1, 2)
    for o in range(K + 1):
        want = sampler.fold_keys(seeds, pos + 1 + o)
        assert block[:, o].tolist() == want.tolist()
    for i in (0, 3, 4):
        jk = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seeds[i]),
                                           np.uint32(pos[i] + 1 + K)))
        assert block[i, K].tolist() == jk.astype(np.int64).tolist()


# ------------------------------------------------------------- engine --
def _wl(ref, seed, sampling=None, stops=()):
    make, params = ((j_repetitive, JSamplingParams) if ref
                    else (repetitive_workload, SamplingParams))
    sp = None
    if sampling or stops:
        sp = params(**(sampling or {}), stop_token_ids=tuple(stops),
                    max_new_tokens=16)
    return make(5, 512, prompt_len=32, max_new_tokens=16, repeat_rate=1.0,
                phrase_len=8, pool_size=1, seed=seed, sampling=sp)


# low temperature and top-k: some sampled tokens repeat the context, so
# drafts are accepted at offsets past 0 of the key block
SAMPLED = dict(temperature=0.5, top_k=3, top_p=0.9, seed=11)

# family: (workload seed, sampling, the port's settings, the reference's)
FAMILIES = {
    "greedy": (3, None, {}, {}),
    "sampled_prefix_chunked": (5, SAMPLED, dict(prefix_cache=True,
                                                prefill_chunk_tokens=16),
                               {}),
    "overlap": (7, None, dict(overlap=True), dict(overlap=True)),
}
_REF = {}


def _outputs(reqs):
    return [(list(map(int, r.output_tokens)), r.finish_reason)
            for r in reqs]


def _reference(models, seed, sampling, stops=(), **kw):
    """The reference engine with speculation, once a module a key."""
    key = (seed, str(sampling), tuple(stops), tuple(sorted(kw.items())))
    if key not in _REF:
        jmodel, jp, jsteps, _ = models
        eng = JEngine(jmodel, jp, JEngineConfig(**BASE, speculate=True,
                                                **kw), steps=jsteps)
        reqs = _wl(True, seed, sampling, stops)
        m = eng.run(reqs)
        assert eng.speculator is not None and m.spec_steps > 0
        _REF[key] = (_outputs(reqs), m)
    return _REF[key]


def _serve(models, seed, sampling, stops=(), **kw):
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**BASE, **kw),
                                   device="cpu")
    reqs = _wl(False, seed, sampling, stops)
    m = eng.run(reqs)
    assert all(r.t_done is not None for r in reqs)
    mgr = eng.pool.manager
    if eng.prefix is not None:
        eng.prefix.clear()
    assert mgr.free_blocks == mgr.num_blocks        # every block home
    assert not eng._executor._inflight and not eng._executor._spec_pending
    return _outputs(reqs), m, eng


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_speculation_equals_reference(models, family):
    """Speculation on against off and against the reference engine with
    ``speculate=True``: the same tokens and finish reasons; in sync mode
    the same verify steps, drafts and acceptances as the reference."""
    seed, sampling, kw, ref_kw = FAMILIES[family]
    want, jm = _reference(models, seed, sampling, **ref_kw)
    off, _, _ = _serve(models, seed, sampling, **kw)
    on, m, eng = _serve(models, seed, sampling, speculate=True, **kw)
    assert eng.speculator is not None
    assert on == off == want
    assert m.spec_steps > 0 and m.spec_accepted > 0
    assert m.spec_drafted == m.spec_accepted + m.spec_rejected
    assert eng.verify_iterations >= 2 * m.spec_steps
    # a step's decode-token sample counts the tokens it committed
    assert sum(eng.decode_token_samples) == sum(len(t) - 1 for t, _ in on)
    if family == "greedy":
        got = (m.spec_steps, m.spec_drafted, m.spec_accepted,
               m.spec_rejected, m.spec_acceptance_series)
        assert got == (jm.spec_steps, jm.spec_drafted, jm.spec_accepted,
                       jm.spec_rejected, list(jm.spec_acceptance_series))
    if family == "sampled_prefix_chunked":
        assert eng.chunking and eng.chunks and eng.prefix is not None


def test_engine_speculation_stop_tokens(models):
    """Stop tokens inside an accepted span end the request there (the
    tokens after it are discarded), sync and overlapped, as the
    reference's."""
    free, _, _ = _serve(models, 3, None)
    stops = (free[0][0][5], free[2][0][3])
    want, _ = _reference(models, 3, None, stops)
    sync, _, _ = _serve(models, 3, None, stops, speculate=True)
    over, _, _ = _serve(models, 3, None, stops, speculate=True,
                        overlap=True)
    assert sum(f == "stop" for _, f in sync) >= 2
    assert sync == over == want


def test_verify_in_flight_keeps_its_seat(models):
    """Under overlap a request whose verify step is in flight is not
    planned, but it keeps its batch seat: the prefilling requests, those
    with a verify step in flight and those below their budget never
    outnumber ``max_batch`` (a request whose last token is in flight has
    given its seat up), with requests queued while verify steps fly."""
    eng = ContinuousBatchingEngine(
        models[3], EngineConfig(**{**BASE, "max_batch": 2}, overlap=True,
                                speculate=True, spec_probe_every=2),
        device="cpu")
    reqs = _wl(False, 3)
    for r in reqs:
        eng.add_request(r)
    seen = 0
    while eng.busy or eng._executor._inflight:
        eng.step(0.0)
        pending = eng._executor._spec_pending
        seated = len(eng.prefilling) + sum(
            r.req_id in pending
            or eng.sched._dispatched.get(r.req_id, 0) < eng._limit(r)
            for r in eng.running)
        assert seated <= 2
        if pending and eng.waiting:
            seen += 1
            assert eng.sched._seats() == 2
            assert not any(eng.sched._needs_step(r) for r in eng.running
                           if r.req_id in pending)
    assert seen and eng.spec_steps and max(eng.batch_samples) <= 2
    assert all(r.finish_reason == "length" for r in reqs)


def test_rollback_refused_mid_prefill(models):
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**BASE),
                                   device="cpu")
    eng._prefilled[42] = 16                  # chunked prefill in flight
    with pytest.raises(RuntimeError, match="PREFILLING"):
        eng.rollback_kv(42, 8)


def test_spec_disabled_reason_in_gather_mode(models):
    """Gather mode cannot roll a table back: the engine falls back with
    the reference's recorded reason."""
    eng = ContinuousBatchingEngine(
        models[3], EngineConfig(**BASE, speculate=True,
                                decode_mode="gather"), device="cpu")
    jmodel, jp, jsteps, _ = models
    jeng = JEngine(jmodel, jp, JEngineConfig(**BASE, speculate=True,
                                             decode_mode="gather"),
                   steps=jsteps)
    assert eng.speculator is None and jeng.speculator is None
    assert eng.spec_disabled_reason == jeng.spec_disabled_reason


@pytest.mark.parametrize("field", ["spec_k", "spec_ngram",
                                   "spec_probe_every"])
def test_spec_config_validation(field):
    with pytest.raises(ValueError) as want:
        JEngineConfig(**{field: 0})
    with pytest.raises(ValueError) as got:
        EngineConfig(**{field: 0})
    assert str(got.value) == str(want.value)
    assert getattr(EngineConfig(), field) == getattr(JEngineConfig(), field)


def test_verify_buckets_are_bounded():
    """max_batch 16, max_model_len 1024 in 16-token blocks, spec_k 8:
    batch pads 1..16, table pads 4..64, draft pads 1..8, greedy or
    sampled: (log2 16 + 1) x (log2 64/4 + 1) x (log2 8 + 1) x 2 = 200
    verify graphs at most."""
    cfg = reduced(get_config("opt-1.3b"))
    pool = PagedKVCache(cfg, num_blocks=16 * 64 + 8, block_size=16,
                        device="cpu")
    steps = StepFunctions(None, pool, max_batch=16, max_model_len=1024,
                          spec_k=8)
    keys = set()
    for B in range(1, 17):
        rids = list(range(B))
        for blocks in range(1, 65, 3):
            for r in rids:
                pool.manager.tables[r] = [0] * (blocks if r == 0 else 1)
            for k in range(0, 9):
                drafts = [np.zeros(k, np.int32)] + [np.zeros(0, np.int32)] \
                    * (B - 1)
                keys.add(steps.verify_bucket(rids, drafts))
    assert {k[0] for k in keys} == {1, 2, 4, 8, 16}
    assert {k[1] for k in keys} == {4, 8, 16, 32, 64}
    assert {k[2] for k in keys} == {1, 2, 4, 8}
    assert 2 * len(keys) == 200
