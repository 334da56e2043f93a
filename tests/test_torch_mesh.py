"""The sharding rules executed across devices: the port's tensor-parallel
model and engine on 1, 2 and 4 gloo ranks on the CPU against the JAX
reference on one device, on the same weights (the reference's init
carried across as numpy) and the same inputs (a numpy seed).

Each rank is a process of its own (``repro_torch.distributed.spawn``:
one thread a rank, a free port a spawn); the ranks run
``repro_torch.launch.tensor_parallel``'s functions, several to a spawn,
one spawn a mesh size a module. The refusals and the shards need no
spawn."""
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
from jax.sharding import AbstractMesh  # noqa: E402

from repro.compat import make_mesh as j_make_mesh  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.kvcache.paged import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro.sharding import rules_for as j_rules_for  # noqa: E402
from repro_torch import distributed as D  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import input_specs as TI  # noqa: E402
from repro_torch.launch import tensor_parallel as TP  # noqa: E402
from repro_torch.launch.mesh import (MULTI_CARD_ITEM, make_mesh,  # noqa: E402
                                     make_model_mesh)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (init_params, init_shard,  # noqa: E402
                                       param_specs, params_from_numpy,
                                       rank_layout, tree_leaves)
from repro_torch.serving import (EngineConfig, SamplingParams,  # noqa: E402
                                 sharegpt_like)
from repro_torch.serving.engine import refuse_data  # noqa: E402
from repro_torch.sharding import rules_for  # noqa: E402

# the tolerance of tests/test_torch_model.py: float32, of the largest logit
TOL = 1e-5
CONFIGS = {
    # H = K = 4, d_ff 512, vocab 512
    "opt": lambda get, red: red(get("opt-1.3b")),
    # grouped-query: H 8, K 4
    "gqa": lambda get, red: red(get("deepseek-coder-33b"), n_heads=8,
                                n_kv_heads=4),
}
ENGINE = dict(max_batch=4, block_size=8, kv_pool_tokens=1024,
              max_model_len=96, prefill_bucket=16)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
DECODE_STEPS = 4


def _configs(name):
    return CONFIGS[name](j_get_config, j_reduced), \
        CONFIGS[name](get_config, reduced)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The reference's init (numpy leaves) and the port's config."""
    jcfg, tcfg = _configs(name)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                 jax.random.PRNGKey(3)))
    return jcfg, tcfg, jp


def _inputs(vocab):
    rng = np.random.default_rng(11)
    lengths = np.array([13, 21], np.int32)
    toks = np.zeros((2, 24), np.int32)
    for b, n in enumerate(lengths):
        toks[b, :n] = rng.integers(0, vocab, n)
    feed = rng.integers(0, vocab, (DECODE_STEPS, 2)).astype(np.int32)
    return toks, lengths, feed


@functools.lru_cache(maxsize=None)
def _reference_logits(name):
    """The reference's ``prefill`` and paged ``decode_step`` logits on one
    device (blocks of 8, tables 4 wide)."""
    jcfg, tcfg, jp = _weights(name)
    toks, lengths, feed = _inputs(tcfg.vocab_size)
    rules = j_rules_for(j_make_mesh((1, 1), ("data", "model")))
    lj, cj, _ = JM.prefill(jp, jcfg, rules, {
        "tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths)},
        cache_len=toks.shape[1])
    pool = JPagedKVCache(jcfg, num_blocks=16, block_size=8, max_batch=2)
    for b, n in enumerate(lengths):
        pool.manager.allocate(b, int(n) + 1)
        pool.write_prefill(b, jax.tree.map(lambda a: a[:, b:b + 1], cj))
    positions = lengths.astype(np.int64).copy()
    decode = []
    for row in feed:
        for b in range(2):
            pool.manager.append_token(b, int(positions[b]) + 1)
        view = pool.view([0, 1], positions.tolist(), nb_pad=4, batch_pad=2)
        lj_d, new_pool = JM.decode_step(jp, jcfg, rules, view,
                                        jnp.asarray(row), None)
        pool.commit(new_pool)
        decode.append(np.asarray(lj_d))
        positions += 1
    return np.asarray(lj), np.stack(decode)


def _requests(make, sampling_cls):
    """8 ShareGPT-shaped requests with Poisson arrivals; every other one
    sampled (its own seed)."""
    reqs = make(8, 512, seed=5, mean_in=14, mean_out=12, max_len=40,
                sigma=0.5, arrival_rate=200.0)
    return [type(r)(r.req_id, r.prompt, arrival_s=r.arrival_s,
                    sampling=sampling_cls(**SAMPLED, seed=100 + i,
                                          max_new_tokens=r.max_new_tokens)
                    if i % 2 else r.sampling)
            for i, r in enumerate(reqs)]


@functools.lru_cache(maxsize=None)
def _reference_serve():
    jcfg, _, jp = _weights("opt")
    reqs = _requests(j_sharegpt_like, JSamplingParams)
    rules = j_rules_for(j_make_mesh((1, 1), ("data", "model")))
    JEngine(JM.Model(jcfg, rules), jp, JEngineConfig(**ENGINE)).run(reqs)
    return [list(r.output_tokens) for r in reqs], \
        [r.finish_reason for r in reqs]


def _case_args(tcfg):
    """A reduced long-context decode case, as the dry-run's long_500k on a
    dense decoder: a sliding window (here 16) whose ring wraps."""
    return dict(cfg=dataclasses.replace(tcfg, sliding_window=16),
                shape=TI.ShapeSpec("long", "decode", 40, 2))


@functools.lru_cache(maxsize=None)
def _ranks(m):
    """One spawn of ``m`` gloo ranks running every check's rank side:
    each config's logits; at 2, the engine's serve (collectives recorded)
    and a dry-run decode case."""
    jobs = []
    for name in CONFIGS:
        _, tcfg, jp = _weights(name)
        jobs.append((TP.logits_rank, (tcfg, jp, *_inputs(tcfg.vocab_size)),
                     {}))
    if m == 2:
        _, tcfg, jp = _weights("opt")
        jobs.append((TP.serve_rank, (tcfg, EngineConfig(**ENGINE),
                                     _requests(sharegpt_like,
                                               SamplingParams), jp),
                     dict(record=True)))
        jobs.append((TP.case_rank, (_case_args(tcfg),), dict(steps=2)))
    return D.spawn(TP.run_jobs, D.devices_mesh(m, "cpu"), jobs)


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


# ------------------------------------------------------------- shards --
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_shards_are_the_reference_specs_blocks(name, m):
    """Every leaf of a rank's shard (cut from the reference's weights, and
    drawn by ``init_shard``) is the numpy block the reference's
    ``act_replicated`` spec on a ``(1, M)`` mesh gives that device."""
    jcfg, tcfg, jp = _weights(name)
    jrules = j_rules_for(AbstractMesh((1, m), ("data", "model")),
                         act_replicated=True)
    trules = rules_for(make_mesh((1, m), ("data", "model")),
                       act_replicated=True)
    jspecs = dict(tree_leaves(JM.param_shardings(jcfg, jrules)))
    specs = dict(tree_leaves(param_specs(tcfg)))
    whole = dict(tree_leaves(jp))
    drawn = dict(tree_leaves(init_params(tcfg, torch.Generator().manual_seed(
        4), device="cpu")))
    for rank in range(m):
        cut = dict(tree_leaves(params_from_numpy(tcfg, jp, rules=trules,
                                                 rank=rank)))
        mine = dict(tree_leaves(init_shard(
            tcfg, torch.Generator().manual_seed(4), trules, rank)))
        sharded = 0
        for path, ps in specs.items():
            spec = tuple(jspecs[path].spec)
            spec += (None,) * (len(ps.shape) - len(spec))
            assert trules.spec(ps.logical, ps.shape) == spec, path
            index = []
            for dim, axis in zip(ps.shape, spec):
                if axis is None:
                    index.append(slice(None))
                else:
                    assert axis == "model", (path, spec)
                    n = dim // m
                    index.append(slice(rank * n, (rank + 1) * n))
            sharded += any(a is not None for a in spec)
            np.testing.assert_array_equal(cut[path].numpy(),
                                          whole[path][tuple(index)], path)
            assert torch.equal(mine[path], drawn[path][tuple(index)]), path
        # tok, unemb, wq/wk/wv/wo, w1/w2 (and w3): every projection sharded
        assert sharded == len([p for p in specs if p.split("/")[-1] in (
            "tok", "unemb", "wq", "wk", "wv", "wo", "w1", "w2", "w3")])


# -------------------------------------------------------------- model --
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_the_reference_across_ranks(name, m):
    """``prefill`` and 4 paged ``decode_step`` logits over M ranks, within
    1e-5 of the reference's largest on one device; every rank holds its
    H/M heads and K/M KV heads and returns the same logits."""
    want_prefill, want_decode = _reference_logits(name)
    outs = [r[list(CONFIGS).index(name)] for r in _ranks(m)]
    _, tcfg, _ = _weights(name)
    for out in outs:
        assert out["heads"] == tcfg.n_heads // m
        assert out["kv_heads"] == tcfg.n_kv_heads // m
        np.testing.assert_array_equal(out["prefill"], outs[0]["prefill"])
        np.testing.assert_array_equal(out["decode"], outs[0]["decode"])
    _close(outs[0]["prefill"], want_prefill)
    _close(outs[0]["decode"], want_decode)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world_of_one_is_the_plain_model_bit_for_bit(name):
    """At M = 1 the sharded path (a gloo group of one, the collectives
    issued) equals the plain ``Model`` on one device bit for bit."""
    _, tcfg, jp = _weights(name)
    out = _ranks(1)[0][list(CONFIGS).index(name)]
    model = Model(tcfg, params_from_numpy(tcfg, jp), device="cpu")
    want = TP.paged_logits(model, *_inputs(tcfg.vocab_size))
    np.testing.assert_array_equal(out["prefill"], want["prefill"])
    np.testing.assert_array_equal(out["decode"], want["decode"])


# ------------------------------------------------------------- engine --
def test_engine_tokens_equal_the_reference_engine():
    """A serve of 8 requests (half sampled, Poisson arrivals) over 2 ranks:
    every request's tokens and finish reason equal the reference engine's
    on one device; both ranks launched the same kernels."""
    serve = [r[len(CONFIGS)] for r in _ranks(2)]
    tokens, finish = _reference_serve()
    assert serve[0]["tokens"] == tokens
    assert serve[0]["finish"] == finish
    assert serve[0]["prefills"] == 8 and serve[0]["decode_steps"] > 0
    assert serve[1]["launches"] == serve[0]["launches"]
    assert serve[1]["graphs"] == serve[0]["graphs"] == []


def test_every_rank_issues_the_same_collectives():
    """The lock step: both ranks' sequences of collectives (op, shape,
    dtype), recorded through the serve, are the same; every prefill and
    decode step issued its embedding's, 2 a layer and the logits'
    gather."""
    serve = [r[len(CONFIGS)] for r in _ranks(2)]
    a, b = serve[0]["record"], serve[1]["record"]
    assert a == b and len(a) > 0
    _, tcfg, _ = _weights("opt")
    calls = serve[0]["prefills"] + serve[0]["decode_steps"]
    assert len(a) == calls * (2 + 2 * tcfg.n_layers)
    assert sum(op == "all_gather" for op, _, _ in a) == calls


# ------------------------------------------------------------ dry-run --
def test_materialize_gives_each_rank_its_block():
    """Over a 1 x 2 mesh each rank's materialized arguments are its block
    of the one-device case's (drawn from the same seed), and the decode
    case run over two ranks gives the one-device case's logits."""
    _, tcfg, _ = _weights("opt")
    one = make_mesh((1, 1), ("data", "model"), ["cpu"])
    two = make_model_mesh(["cpu", "cpu"])
    args = _case_args(tcfg)
    case1 = TI.case_for(mesh=one, **args)
    case2 = TI.case_for(mesh=two, act_replicated=True, **args)
    want = TI.materialize(case1, one, torch.Generator().manual_seed(0))
    for rank in range(2):
        got = TI.materialize(case2, two, torch.Generator().manual_seed(0),
                             rank=rank)
        for part in (0, 1):             # the weights, the cache
            w, g = dict(tree_leaves(want[part])), dict(tree_leaves(got[part]))
            for path in w:
                assert _is_block(g[path], w[path], rank), (part, path)
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    steps = _ranks(2)[0][len(CONFIGS) + 1]
    params, cache, tokens, pos = want
    for step in steps:
        lo, cache = case1.fn(params, cache, tokens, pos)
        _close(step, lo.numpy())
        tokens, pos = lo.argmax(-1).to(torch.int32), pos + 1


def _is_block(block, whole, rank):
    """Is ``block`` rank ``rank``'s contiguous block of ``whole`` along
    the one dim they differ in (or all of it)?"""
    if block.shape == whole.shape:
        return torch.equal(block, whole)
    dims = [d for d, (a, b) in enumerate(zip(block.shape, whole.shape))
            if a != b]
    if len(dims) != 1:
        return False
    n = block.shape[dims[0]]
    return torch.equal(block, whole.narrow(dims[0], rank * n, n))


# ----------------------------------------------------------- refusals --
def _item(excinfo):
    assert MULTI_CARD_ITEM in str(excinfo.value), str(excinfo.value)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-1.3b",
                                  "zamba2-7b", "llama-3.2-vision-90b",
                                  "hubert-xlarge"])
def test_other_families_refused_across_devices(arch):
    cfg = reduced(get_config(arch))
    mesh = make_model_mesh(["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="left 2") as e:
        Model(cfg, mesh=mesh)
    _item(e)


def test_refusals_name_their_roadmap_item():
    """What a data axis of 2 still refuses (a family other than the dense
    decoder, and the prefix cache in one engine), a CUDA mesh without
    cards, and materialize without a rank each raise, naming what is
    left in ROADMAP.md; a data axis of 2 and FSDP, refused before, now
    pass the check for the dense decoder (they run:
    tests/test_torch_mesh_data.py) and reach the group check, as do the
    default rules and KV heads the model axis does not divide."""
    cfg = reduced(get_config("opt-1.3b"))
    two_data = make_mesh((2, 1), ("data", "model"), ["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="left 1") as e:
        Model(reduced(get_config("olmoe-1b-7b")), mesh=two_data)
    _item(e)
    with pytest.raises(NotImplementedError, match="left 1") as e:
        refuse_data(EngineConfig(**ENGINE, prefix_cache=True), 2)
    _item(e)
    with pytest.raises(RuntimeError, match="has not joined the mesh"):
        Model(cfg, mesh=two_data, rules=rules_for(two_data,
                                                  act_replicated=True))
    mesh = make_model_mesh(["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="has not joined the mesh"):
        Model(cfg, mesh=mesh, rules=rules_for(mesh, fsdp=True))
    with pytest.raises(RuntimeError, match="has not joined the mesh"):
        Model(cfg, mesh=mesh, rules=rules_for(mesh))
    gqa = reduced(get_config("qwen2.5-3b"), n_heads=8, n_kv_heads=2)
    four = make_model_mesh(["cpu"] * 4)
    with pytest.raises(RuntimeError, match="has not joined the mesh"):
        Model(gqa, mesh=four)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.MeshGroup.init(make_model_mesh(["cuda:0", "cuda:1"]), 0,
                             f"tcp://127.0.0.1:{D.free_port()}")
    with pytest.raises(RuntimeError, match="has not joined the mesh"):
        Model(cfg, mesh=mesh)
    case = TI.case_for(mesh=mesh, act_replicated=True, **_case_args(cfg))
    with pytest.raises(ValueError, match="needs a rank"):
        TI.materialize(case, mesh, torch.Generator())
    train = TI.case_for(cfg, TI.ShapeSpec("t", "train", 16, 4), mesh,
                        act_replicated=True)
    with pytest.raises(NotImplementedError, match="left 3") as e:
        TI.materialize(train, mesh, torch.Generator(), rank=0)
    _item(e)


def test_the_gqa_config_and_engine_config_are_dense():
    """The configs the spawns run are the dense decoders the mesh runs,
    with heads and KV heads both divisible by 4: under the act_replicated
    rules their plan on 4 ranks is the Megatron one (every projection
    sharded by heads, the residual replicated). A K of 2 on 4, refused
    before, now holds the KV heads its query heads read."""
    four = make_mesh((1, 4), ("data", "model"))
    for name in CONFIGS:
        _, tcfg, _ = _weights(name)
        assert tcfg.arch_type == "dense" and tcfg.moe is None
        assert tcfg.n_heads % 4 == 0 and tcfg.n_kv_heads % 4 == 0
        lay = rank_layout(tcfg, rules_for(four, act_replicated=True), 1)
        assert (lay.wq, lay.wkv, lay.wo, lay.residual, lay.ffn) == \
            ("heads", "heads", "heads", False, True)
        assert lay.kv_heads == (tcfg.n_kv_heads // 4,
                                2 * tcfg.n_kv_heads // 4)
    gqa = reduced(get_config("qwen2.5-3b"), n_heads=8, n_kv_heads=2)
    lay = rank_layout(gqa, rules_for(four, act_replicated=True), 3)
    assert lay.wkv == "held" and lay.kv_heads == (1, 2)
    assert dataclasses.asdict(EngineConfig(**ENGINE))["decode_mode"] == \
        "paged"
