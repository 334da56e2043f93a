"""The port's decode steps on static buffers (``repro_torch.serving.steps``)
on the CPU, where the paged step's body runs eagerly on the buffers a CUDA
graph replays on the card: the same tokens and the same pool as today's
eager step (fresh view tensors, the host-vector sampler) across steps
that reuse the buffers with other requests, buckets and greedy/sampled
mixes; the device-vector sampler against the host entry and the host key
fold against JAX's; no host round trip inside the body; the replay launch
accounting; and the bucket set."""
import types

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.ops import launch_counters  # noqa: E402
from repro_torch.kvcache.paged import PagedKVCache  # noqa: E402
from repro_torch.models import sampler  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.steps import (CapturedStep,  # noqa: E402
                                       StepFunctions, add_launches,
                                       launch_counts, take_launches)
from repro_torch.serving.workload import SamplingParams  # noqa: E402

BS = 8


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("opt-1.3b"))
    return Model(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(3))


def _pools(cfg, n_blocks=48):
    """Two pools with the same random contents and tables."""
    gen = torch.Generator().manual_seed(5)
    a, b = (PagedKVCache(cfg, num_blocks=n_blocks, block_size=BS,
                         device="cpu") for _ in range(2))
    for name, leaf in a.pool.items():
        leaf.normal_(generator=gen)
        b.pool[name].copy_(leaf)
    return a, b


def _req(rid, temperature=0.0, top_k=0, top_p=1.0):
    return types.SimpleNamespace(req_id=rid, sampling=SamplingParams(
        temperature=temperature, top_k=top_k, top_p=top_p, seed=100 + rid))


def _eager_step(model, pool, reqs, positions, tokens, nb_pad, batch_pad):
    """Today's eager step: a fresh view, the host-vector sampler."""
    B = len(reqs)
    view = pool.view([r.req_id for r in reqs], positions, nb_pad, batch_pad)
    toks = torch.zeros((batch_pad,), dtype=torch.int64)
    toks[:B] = torch.tensor(tokens)
    logits = model.decode_step(toks, view)
    out = sampler.sample_tokens(
        logits, *sampler.stack_sampling([r.sampling for r in reqs],
                                        pad_to=batch_pad),
        sampler.positions_array([p + 1 for p in positions], batch_pad))
    return out[:B]


# (request ids, sampled rows) a step: buckets move between batch 1, 3, 5
# and 8 rows, tables between 4 and 8 blocks, greedy, mixed and all sampled
STEPS = [([0, 1, 2], ()), ([0, 1, 2], (1,)), ([3], (3,)),
         ([0, 1, 2, 3, 4], ()), ([4, 2], (4, 2)), ([0, 1, 2, 3, 4], (0, 3)),
         ([5, 6, 7, 0, 1, 2, 3, 4], (6,)), ([1], ())]


def test_static_buffer_steps_equal_eager_steps(model):
    cfg = model.cfg
    pool, twin = _pools(cfg)
    lens = [5, 17, 30, 9, 41, 3, 60, 26]
    for rid, n in enumerate(lens):
        for p in (pool, twin):
            p.manager.allocate(rid, n + len(STEPS) + 1)
    steps = StepFunctions(model, pool, max_batch=8, max_model_len=128)
    pos = dict(enumerate(lens))
    rng = np.random.default_rng(0)
    buckets = set()
    for rids, hot in STEPS:
        reqs = [_req(r, 0.9 if r in hot else 0.0, top_k=r * 7 % 11,
                     top_p=0.9 if r % 2 else 1.0) for r in rids]
        positions = [pos[r] for r in rids]
        tokens = rng.integers(0, cfg.vocab_size, len(rids)).tolist()
        buckets.add(steps.paged_bucket(rids) + (bool(hot),))
        got = steps.paged(reqs, rids, positions, tokens)
        nb_pad = steps.paged_bucket(rids)[1]
        want = _eager_step(model, twin, reqs, positions, tokens, nb_pad,
                           len(got))
        assert got[:len(rids)].tolist() == want.tolist(), rids
        for r in rids:
            pos[r] += 1
    assert len(buckets) >= 6                  # the buffers served many
    for name in pool.pool:
        assert torch.equal(pool.pool[name], twin.pool[name])
    assert not steps.graphs and not steps.graphs_on    # the CPU is eager
    assert bool(steps.finite)


def test_chained_tokens_read_the_previous_output(model):
    """Rows in the chain take their input from the previous step's
    output, the others from the host."""
    cfg = model.cfg
    pool, twin = _pools(cfg)
    for p in (pool, twin):
        p.manager.allocate(0, 20)
        p.manager.allocate(1, 20)
    steps = StepFunctions(model, pool, max_batch=4, max_model_len=64)
    reqs = [_req(0), _req(1)]
    prev = torch.tensor([11, 22, 33, 44], dtype=torch.int32)
    got = steps.paged(reqs, [0, 1], [4, 7], [5, 0], chain=(prev, {1: 2}))
    want = _eager_step(model, twin, reqs, [4, 7], [5, 33], 4, 2)
    assert got[:2].tolist() == want.tolist()


GRID = [(t, k, p) for t in (0.0, 0.7, 1.5) for k in (0, 3, 40)
        for p in (1.0, 0.8)]


@pytest.mark.parametrize("temp,top_k,top_p", GRID)
def test_device_sampler_equals_host_entry(temp, top_k, top_p):
    """``sample_tokens_device`` on vectors already on the device, keys
    folded on the host, gives the host entry's tokens; a greedy row is
    the argmax in both."""
    rng = np.random.default_rng(int(temp * 10) + top_k)
    B, V = 5, 301
    logits = torch.from_numpy((rng.normal(size=(B, V)) * 3).astype(
        np.float32))
    t = np.full((B,), temp, np.float32)
    t[0] = 0.0
    k = np.full((B,), top_k, np.int32)
    p = np.full((B,), top_p, np.float32)
    seed = (np.arange(B) * 13 + 1).astype(np.uint32)
    pos = (np.arange(B) * 9 + 2).astype(np.int32)
    want = sampler.sample_tokens(logits, t, k, p, seed, pos)
    keys = torch.from_numpy(sampler.fold_keys(seed, pos))
    got = sampler.sample_tokens_device(
        logits, torch.from_numpy(t), torch.from_numpy(k),
        torch.from_numpy(p), keys, sampled=bool((t > 0).any()))
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist()
    assert got[0].item() == int(logits[0].argmax())


def test_host_key_fold_equals_jax_and_the_torch_fold():
    seeds = np.array([0, 1, 7, 123456, 2 ** 32 - 1], np.uint32)
    for pos in (0, 1, 161, 1023, 2 ** 31 - 1):
        got = sampler.fold_keys(seeds, np.full(len(seeds), pos))
        want = [np.asarray(jax.random.fold_in(jax.random.PRNGKey(s),
                                              np.int32(pos)))
                for s in seeds]
        assert got.tolist() == np.asarray(want).astype(np.int64).tolist()
        torch_fold = sampler.fold_in(
            sampler.prng_key(torch.from_numpy(seeds.astype(np.int64))),
            torch.full((len(seeds),), pos))
        assert got.tolist() == torch_fold.tolist()


@pytest.mark.parametrize("sampled", [False, True])
def test_step_body_makes_no_host_round_trip(model, monkeypatch, sampled):
    """The body a graph captures, run on the CPU with every way to make a
    tensor from host data or read one back patched to raise: the CPU's
    proxy for capture safety (a capture refuses host copies and syncs)."""
    pool, _ = _pools(model.cfg)
    for rid in range(3):
        pool.manager.allocate(rid, 30)
    steps = StepFunctions(model, pool, max_batch=4, max_model_len=64)
    reqs = [_req(r, 0.8 if sampled else 0.0, top_k=5) for r in range(3)]
    dev, hot = steps._stage(reqs, [10, 20, 29], [1, 2, 3], None, 4, 4,
                            [0, 1, 2])
    assert hot == sampled

    def refuse(*a, **k):
        raise AssertionError("host round trip inside the step body")
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    tokens, logits = steps._paged_body(dev, sampled)
    monkeypatch.undo()
    assert tokens.shape == (4,) and logits.shape[0] == 4


@pytest.fixture
def counters():
    saved = launch_counts()
    yield launch_counters()
    for name, fn in launch_counters().items():
        fn.launches = saved[name]


def test_replay_launch_accounting(counters):
    """A capture's launches are recorded and taken back (a capture runs
    nothing); each replay adds them."""
    before = launch_counts()
    counters["paged_decode_attention"].launches += 24     # as a capture
    counters["decode_attention"].launches += 1
    delta = take_launches(before)
    assert launch_counts() == before
    assert delta == {"paged_decode_attention": 24, "flash_attention": 0,
                     "flash_prefix_attention": 0, "decode_attention": 1,
                     "paged_decode_partials": 0, "paged_decode_combine": 0,
                     "decode_partials": 0}
    replays = []
    step = CapturedStep(types.SimpleNamespace(
        replay=lambda: replays.append(1)), torch.zeros(2), torch.zeros(2),
        delta)
    for _ in range(3):
        step.replay()
    assert len(replays) == 3
    got = launch_counts()
    assert got["paged_decode_attention"] == \
        before["paged_decode_attention"] + 72
    assert got["decode_attention"] == before["decode_attention"] + 3
    add_launches({k: -v for k, v in delta.items()})
    assert launch_counts()["flash_attention"] == before["flash_attention"]


def test_buckets_hold_at_most_fifty_graphs():
    """max_batch 16 and max_model_len 1024 in 16-token blocks: batch pads
    1..16 and table pads 4..64, greedy or sampled, 50 graphs at most."""
    cfg = reduced(get_config("opt-1.3b"))
    pool = PagedKVCache(cfg, num_blocks=16 * 64 + 8, block_size=16,
                        device="cpu")
    steps = StepFunctions(None, pool, max_batch=16, max_model_len=1024)
    keys = set()
    for B in range(1, 17):
        for blocks in range(1, 65):
            rids = list(range(B))
            for r in rids:
                pool.manager.tables[r] = [0] * (blocks if r == 0 else 1)
            keys.add(steps.paged_bucket(rids))
    assert {k[0] for k in keys} == {1, 2, 4, 8, 16}
    assert {k[1] for k in keys} == {4, 8, 16, 32, 64}
    assert 2 * len(keys) == 50
