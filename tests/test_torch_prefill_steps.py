"""The port's prefill steps and gather step on static buffers
(``repro_torch.serving.steps``) on the CPU, where each body runs eagerly
on the buffers a CUDA graph replays on the card: every body against
today's eager path (logits bit for bit, the pool's valid rows equal),
across buffers reused by other requests and prefix lengths; no host round
trip inside a body; the prefix length as a device tensor in the flash
kernel's plain version; the suffix body against the reference's fused
``_chunk_prefill_fn``; the serial prefill's padding rows in the trash
block; the bucket sets; and a prefill replay's launch accounting."""
import types

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.kvcache.paged import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import init_params as j_init_params  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ops import launch_counters  # noqa: E402
from repro_torch.kvcache.paged import PagedKVCache  # noqa: E402
from repro_torch.models import sampler  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving.steps import (CapturedStep,  # noqa: E402
                                       StepFunctions, launch_counts,
                                       take_launches)
from repro_torch.serving.workload import SamplingParams  # noqa: E402

BS = 8
BUCKET = 16          # prefill_bucket: prompt rows pad to multiples of 16


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("opt-1.3b"))
    return Model(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(4))


def _pools(cfg, n_blocks=48):
    """Two pools with the same random contents."""
    gen = torch.Generator().manual_seed(6)
    a, b = (PagedKVCache(cfg, num_blocks=n_blocks, block_size=BS,
                         device="cpu") for _ in range(2))
    for name, leaf in a.pool.items():
        leaf.normal_(generator=gen)
        b.pool[name].copy_(leaf)
    return a, b


def _steps(model, pool):
    return StepFunctions(model, pool, max_batch=8, max_model_len=128,
                         prefill_bucket=BUCKET)


def _eager_prefill(model, pool, rid, tokens, start, prefix_blocks, nb_pad,
                   token_write):
    """Today's eager prefill: the prefix gathered with a host table, the
    model with an int prefix length, then the write (token by token, or
    the serial path's block-aligned write)."""
    n = len(tokens)
    S = -(-n // BUCKET) * BUCKET
    toks = torch.zeros((1, S), dtype=torch.int64)
    toks[0, :n] = torch.tensor(tokens)
    prefix = None
    if start:
        prefix = pool.gather_prefix(pool.manager.tables[rid][:prefix_blocks],
                                    nb_pad)
    logits, cache = model.prefill(toks, torch.tensor([n]), cache_len=S,
                                  prefix=prefix, prefix_len=start)
    if token_write:
        pool.write_prefill(rid, cache, start_pos=start, n_tokens=n)
    else:
        pool.write_prefill(rid, cache, start_pos=start)
    return logits


def _same_valid_rows(pool, twin, lengths):
    """Every request's rows below its written length equal, and every
    block no request holds untouched by either (the trash block aside)."""
    held = set()
    for rid, n in lengths.items():
        table = pool.manager.tables[rid]
        held.update(table)
        for p in range(n):
            b, s = table[p // BS], p % BS
            for name in pool.pool:
                assert torch.equal(pool.pool[name][:, b, s],
                                   twin.pool[name][:, b, s]), (rid, p)
    free = [b for b in range(pool.num_blocks) if b not in held]
    for name in pool.pool:
        assert torch.equal(pool.pool[name][:, free], twin.pool[name][:, free])


# (prompt length, cached/prefilled start, tokens this call, serial?): a
# serial prefill, a serial one over a 2-block cache hit, a chunked
# prompt's first chunk, and a chunk starting mid-block
CASES = {"serial": (37, 0, 37, True), "cache hit": (37, 16, 21, True),
         "first chunk": (37, 0, 13, False), "mid-block chunk": (37, 13, 11,
                                                                False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_body_equals_eager_prefill(model, case):
    N, start, n, serial = CASES[case]
    pool, twin = _pools(model.cfg)
    for p in (pool, twin):
        p.manager.allocate(0, N + 1 if serial else start + n)
    steps = _steps(model, pool)
    prompt = np.random.default_rng(1).integers(0, model.cfg.vocab_size, N)
    toks = prompt[start:start + n].tolist()
    prefix_blocks = start // BS if serial else -(-start // BS)
    nb_pad = 1
    while nb_pad < prefix_blocks:
        nb_pad *= 2
    got = steps.prefill(0, toks, start, prefix_blocks, nb_pad)
    want = _eager_prefill(model, twin, 0, toks, start, prefix_blocks, nb_pad,
                          token_write=not serial)
    assert torch.equal(got, want)
    assert steps.prefill_key(n, start, nb_pad)[0] == (
        "suffix" if start else "prefill")
    _same_valid_rows(pool, twin, {0: start + n})
    assert not steps.graphs and bool(steps.finite)


def test_one_suffix_bucket_across_requests_and_prefix_lengths(model):
    """Reused buffers: two requests, at prefix lengths 17 and 27 (both
    mid-block, both padded to 4 blocks, 10 rows in a 16-row bucket), with
    a third request's prefill between them and each request's first and
    last chunks in other buckets; each call equal to the eager path."""
    pool, twin = _pools(model.cfg)
    rng = np.random.default_rng(2)
    prompts = {r: rng.integers(0, model.cfg.vocab_size, 40) for r in (0, 1)}
    for p in (pool, twin):
        p.manager.allocate(0, 40)
        p.manager.allocate(1, 40)
        p.manager.allocate(2, 30)
    steps = _steps(model, pool)
    written = {0: 0, 1: 0, 2: 0}
    calls = [(0, 0, 17), (1, 0, 27), (0, 17, 10), (1, 27, 10), (2, 0, 29),
             (0, 27, 10), (1, 37, 3)]
    keys = []
    for rid, start, n in calls:
        toks = (prompts[rid][start:start + n] if rid in prompts else
                rng.integers(0, model.cfg.vocab_size, n)).tolist()
        nb = -(-start // BS)
        nb_pad = 1
        while nb_pad < nb:
            nb_pad *= 2
        keys.append(steps.prefill_key(n, start, nb_pad))
        got = steps.prefill(rid, toks, start, nb, nb_pad)
        want = _eager_prefill(model, twin, rid, toks, start, nb, nb_pad,
                              token_write=True)
        assert torch.equal(got, want), (rid, start)
        written[rid] = start + n
        _same_valid_rows(pool, twin, written)
    assert keys[2] == keys[3] == keys[5] == ("suffix", 16, 4)
    assert set(keys) == {("prefill", 32), ("suffix", 16, 4),
                         ("suffix", 16, 8)}


def _req(rid, temperature=0.0):
    return types.SimpleNamespace(req_id=rid, sampling=SamplingParams(
        temperature=temperature, top_k=7, top_p=0.9, seed=50 + rid))


# (request ids, sampled rows) a step: batch 1, 3 and 5 rows, greedy and
# sampled, the table pad moving with the longest context
GATHER_STEPS = [([0, 1, 2], ()), ([0, 1, 2], (1,)), ([3], ()),
                ([0, 1, 2, 3, 4], (0, 4)), ([4, 2], ()), ([0, 1, 2], (1,))]


def test_gather_body_equals_eager_gather_step(model):
    """The gather step on static buffers, step after step with other
    batches, pads and sampling: the same logits bit for bit and tokens as
    today's eager step (host table upload, host addresses, the host
    sampler), and the same pool."""
    cfg = model.cfg
    pool, twin = _pools(cfg)
    lens = [5, 17, 30, 9, 41]
    for rid, n in enumerate(lens):
        for p in (pool, twin):
            p.manager.allocate(rid, n + len(GATHER_STEPS) + 1)
    steps = _steps(model, pool)
    pos = dict(enumerate(lens))
    rng = np.random.default_rng(3)
    pads = set()
    for rids, hot in GATHER_STEPS:
        reqs = [_req(r, 0.8 if r in hot else 0.0) for r in rids]
        positions = [pos[r] for r in rids]
        tokens = rng.integers(0, cfg.vocab_size, len(rids)).tolist()
        pad = steps.gather_bucket(positions)
        pads.add(pad)
        dev, sampled = steps._stage(reqs, positions, tokens, None, len(rids),
                                    pad, rids)
        got, logits = steps._gather_body(dev, sampled)
        cache = twin.gather(rids, pad)
        p_t = torch.tensor(positions)
        want_logits = model.decode_step(torch.tensor(tokens), cache, p_t,
                                        lengths=p_t + 1)
        twin.scatter_new_token(rids, positions, cache)
        want = sampler.sample_tokens(
            want_logits, *sampler.stack_sampling([r.sampling for r in reqs]),
            sampler.positions_array([p + 1 for p in positions]))
        assert torch.equal(logits, want_logits), rids
        assert got.tolist() == want.tolist(), rids
        for r in rids:
            pos[r] += 1
    assert len(pads) >= 2
    for name in pool.pool:
        assert torch.equal(pool.pool[name], twin.pool[name])
    # the public entry over the same buffers: the eager step's tokens
    got = steps.gather([_req(0)], [0], [pos[0]], [3])
    cache = twin.gather([0], steps.gather_bucket([pos[0]]))
    p_t = torch.tensor([pos[0]])
    want = model.decode_step(torch.tensor([3]), cache, p_t,
                             lengths=p_t + 1).argmax(-1)
    assert got.tolist() == want.tolist()
    assert not steps.graphs and bool(steps.finite)


BODIES = ["prefill", "suffix", "gather greedy", "gather sampled"]


@pytest.mark.parametrize("body", BODIES)
def test_bodies_make_no_host_round_trip(model, monkeypatch, body):
    """Each body a graph captures, run on the CPU with every way to make
    a tensor from host data or read one back patched to raise: the CPU's
    proxy for capture safety (a capture refuses host copies and syncs)."""
    pool, _ = _pools(model.cfg)
    for rid in range(3):
        pool.manager.allocate(rid, 30)
    steps = _steps(model, pool)
    if body.startswith("gather"):
        sampled = body.endswith("sampled")
        reqs = [_req(r, 0.8 if sampled else 0.0) for r in range(3)]
        dev, hot = steps._stage(reqs, [10, 20, 29], [1, 2, 3], None, 3, 4,
                                [0, 1, 2])
        assert hot == sampled
        run = lambda: steps._gather_body(dev, sampled)  # noqa: E731
    else:
        from repro_torch.kvcache.view import prefill_fields, prefill_size
        start, nb = (0, 0) if body == "prefill" else (13, 2)
        n = prefill_size(16, nb)
        f = prefill_fields(steps._prefill_staging.host()[:n], 16, nb)
        pool.fill_prefill(f, 0, list(range(1, 12)), start, -(-start // BS))
        dev = prefill_fields(steps._prefill_staging.upload(n), 16, nb)
        run = lambda: steps._prefill_body(dev, bool(start))  # noqa: E731

    def refuse(*a, **k):
        raise AssertionError("host round trip inside the step body")
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    tokens, logits = run()
    monkeypatch.undo()
    assert logits.shape == (1 if tokens is None else 3,
                            model.cfg.vocab_size)


@pytest.mark.parametrize("pl", [0, 1, 9, 16])
def test_plain_prefix_attention_takes_a_tensor_prefix_len(pl):
    """The prefix-masked entry's plain version and its CPU wrapper with a
    0-dim tensor prefix length give the int form's output exactly; the
    wrapper refuses a tensor of another shape or type."""
    gen = torch.Generator().manual_seed(pl)
    P, S, K, G, hd = 16, 24, 2, 2, 32
    q = torch.randn(2, S, K * G, hd, generator=gen)
    k = torch.randn(2, P + S, K, hd, generator=gen)
    v = torch.randn(2, P + S, K, hd, generator=gen)
    lens = torch.tensor([pl + S, pl + S - 5])
    want = fa.flash_prefix_attention_torch(q, k, v, prefix_pad=P,
                                           prefix_len=pl, lengths=lens)
    t = torch.tensor(pl, dtype=torch.int32)
    assert torch.equal(fa.flash_prefix_attention_torch(
        q, k, v, prefix_pad=P, prefix_len=t, lengths=lens), want)
    assert torch.equal(fa.flash_prefix_attention(
        q, k, v, prefix_pad=P, prefix_len=t, lengths=lens), want)
    assert torch.equal(fa.prefix_kv_ids(P, t, S), fa.prefix_kv_ids(P, pl, S))
    for bad in (t.reshape(1), t.float()):
        with pytest.raises(ValueError, match="prefix_len"):
            fa.flash_prefix_attention(q, k, v, prefix_pad=P, prefix_len=bad,
                                      lengths=lens)


def test_suffix_body_matches_the_reference_chunk_prefill(rules):
    """The suffix body against one jitted ``_chunk_prefill_fn`` of the
    reference (its ``StepFunctions.chunk_prefill``), one bucket (16 rows
    over a prefix padded to 4 blocks) at prefix lengths 17 and 27 in turn,
    on pools holding the same prefix: the logits within the reference's
    float32 tolerance, the written rows within it too, every other row of
    the pool as it was."""
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    tcfg = reduced(get_config("opt-1.3b"))
    jp = j_init_params(jcfg, jax.random.PRNGKey(1))
    tmodel = Model(tcfg, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                           device="cpu"), device="cpu")
    jsteps = JStepFunctions.build(JModel(jcfg, rules), BS)
    tpool = PagedKVCache(tcfg, num_blocks=24, block_size=BS, device="cpu")
    jpool = JPagedKVCache(jcfg, num_blocks=24, block_size=BS, max_batch=4)
    rng = np.random.default_rng(4)
    for mgr in (tpool.manager, jpool.manager):
        mgr.allocate(0, 40)
    kv = {k: rng.normal(size=(tcfg.n_layers, 1, 40, tcfg.n_kv_heads,
                              tcfg.hd)).astype(np.float32) for k in "kv"}
    tpool.write_prefill(0, {k: torch.from_numpy(a) for k, a in kv.items()})
    jpool.write_prefill(0, {"stack": [kv], "rem": []})
    before = {k: tpool.pool[k].clone() for k in "kv"}
    steps = _steps(tmodel, tpool)
    prompt = rng.integers(0, tcfg.vocab_size, 40)
    table = np.full((8,), jpool.trash_block, np.int32)
    table[:5] = jpool.manager.tables[0]
    for done, chunk in ((17, 10), (27, 10)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :chunk] = prompt[done:done + chunk]
        lj, new_pool = jsteps.chunk_prefill(
            jp, jpool.pool, jnp.asarray(table),
            {"tokens": jnp.asarray(toks),
             "lengths": jnp.asarray([chunk], jnp.int32)},
            jnp.int32(done), jnp.int32(chunk), cache_len=16, nb_prefix=4)
        jpool.commit(new_pool)
        assert steps.prefill_key(chunk, done, 4) == ("suffix", 16, 4)
        lt = steps.prefill(0, prompt[done:done + chunk].tolist(), done,
                           -(-done // BS), 4)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=1e-4)
    blocks = tpool.manager.tables[0]
    for k in "kv":
        t, j = tpool.pool[k], np.asarray(jpool.pool["stack"][0][k])
        for p in range(17, 37):
            np.testing.assert_allclose(t[:, blocks[p // BS], p % BS].numpy(),
                                       j[:, blocks[p // BS], p % BS],
                                       atol=1e-4, rtol=1e-4)
        written = torch.zeros(t.shape[1:3], dtype=torch.bool)
        for p in range(17, 37):
            written[blocks[p // BS], p % BS] = True
        written[tpool.trash_block] = True
        assert torch.equal(t[:, ~written], before[k][:, ~written])


def test_serial_prefill_padding_rows_go_to_the_trash_block(model):
    """The one departure of the captured serial prefill: its padding rows
    (past the prompt, in the bucket) go to the trash block, where the
    reference's block-aligned write, and the port's eager one, put them in
    the unused slots of the prompt's last block. Every reader masks those
    slots (positions at or past a request's length)."""
    cfg = model.cfg
    pool = PagedKVCache(cfg, num_blocks=8, block_size=BS, device="cpu")
    twin = PagedKVCache(cfg, num_blocks=8, block_size=BS, device="cpu")
    for p in (pool, twin):
        p.manager.allocate(0, 12)              # 2 blocks for 11 + 1 tokens
    toks = list(range(3, 14))
    steps = _steps(model, pool)
    steps.prefill(0, toks, 0, 0, 1)
    _eager_prefill(model, twin, 0, toks, 0, 0, 1, token_write=False)
    last = pool.manager.tables[0][1]
    for name in pool.pool:
        assert bool(pool.pool[name][:, last, :3].any())
        assert not bool(pool.pool[name][:, last, 3:].any())
        assert bool(twin.pool[name][:, last, 3:].any())
        assert bool(pool.pool[name][:, pool.trash_block].any())
        assert not bool(twin.pool[name][:, twin.trash_block].any())
    _same_valid_rows(pool, twin, {0: 11})


def test_prefill_and_gather_buckets_are_bounded():
    """max_model_len 1024, 16-token blocks, prefill_bucket 64: 16 prefill
    buckets without a prefix and 16 x 7 over one (prefix pads 1..64
    blocks); the gather step's batch 1..16 x 16 table pads (4..64 blocks)
    x greedy or sampled."""
    cfg = reduced(get_config("opt-1.3b"))
    pool = PagedKVCache(cfg, num_blocks=16 * 64 + 8, block_size=16,
                        device="cpu")
    steps = StepFunctions(None, pool, max_batch=16, max_model_len=1024)
    prefill = set()
    for start in range(0, 1023, 5):
        nb = -(-start // 16)
        nb_pad = 1
        while nb_pad < nb:
            nb_pad *= 2
        for n in range(1, 1024 - start, 7):
            prefill.add(steps.prefill_key(n, start, nb_pad))
    assert len({k for k in prefill if k[0] == "prefill"}) == 16
    assert {k[2] for k in prefill if k[0] == "suffix"} == {
        1, 2, 4, 8, 16, 32, 64}
    assert len(prefill) <= 16 + 16 * 7
    pads = {steps.gather_bucket([p]) for p in range(1023)}
    assert pads == set(range(4, 65, 4))
    assert 16 * len(pads) * 2 == 512


@pytest.fixture
def counters():
    saved = launch_counts()
    yield launch_counters()
    for name, fn in launch_counters().items():
        fn.launches = saved[name]


@pytest.mark.parametrize("start", [0, 13])
def test_prefill_replay_launch_accounting(model, counters, monkeypatch,
                                          start):
    """A prefill's attention launches (one a layer, of the plain or the
    prefix-masked entry), recorded at its bucket's first use and taken
    back as a capture's are, are added at each replay; the replay returns
    the graph's static logits."""
    for name, fn, kernel in (
            ("prefill_attention", ops.prefill_attention, "flash_attention"),
            ("prefill_prefix_attention", ops.prefill_prefix_attention,
             "flash_prefix_attention")):
        def counted(*a, _fn=fn, _kernel=kernel, **k):
            counters[_kernel].launches += 1      # as the kernel counts
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    pool, _ = _pools(model.cfg)
    pool.manager.allocate(0, 30)
    steps = _steps(model, pool)
    toks = list(range(1, 12))
    nb = -(-start // BS)
    before = launch_counts()
    steps.prefill(0, toks, start, nb, 2)
    delta = take_launches(before)
    assert launch_counts() == before
    kernel = "flash_prefix_attention" if start else "flash_attention"
    assert delta == {"paged_decode_attention": 0, "decode_attention": 0,
                     "flash_attention": 0, "flash_prefix_attention": 0,
                     "paged_decode_partials": 0, "paged_decode_combine": 0,
                     "decode_partials": 0, kernel: model.cfg.n_layers}
    replays = []
    static = torch.zeros(1, model.cfg.vocab_size)
    steps.graphs[steps.prefill_key(len(toks), start, 2)] = CapturedStep(
        types.SimpleNamespace(replay=lambda: replays.append(1)), None,
        static, delta)
    for _ in range(3):
        assert steps.prefill(0, toks, start, nb, 2) is static
    assert len(replays) == 3 and steps.replays == 3
    assert launch_counts()[kernel] == before[kernel] + 3 * model.cfg.n_layers
