"""The reference's own sharding rules executed across devices: the default
rules' d_model-sharded residual, ``attn_row_parallel``'s row-sharded
``wq/wk/wv``, the head-dim and replication fallbacks, and paged decode
over a KV sequence sharded on the model axis (``shard_kv_seq``), on 2
and 4 gloo ranks on the CPU against the JAX reference on one device, on
the same weights (the reference's init carried across as numpy) and the
same inputs (a numpy seed); and the paged kernel's partials entry and
combine (their plain versions) against the whole kernel.

Each rank is a process of its own (``repro_torch.distributed.spawn``);
one spawn a mesh size runs every check's rank side
(``tensor_parallel.run_jobs``). The blocks, the plain versions and the
refusals need no spawn."""
import dataclasses
import functools
import types

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
from repro.kernels.paged_decode_attention import \
    paged_gqa_decode_attention as j_paged  # noqa: E402
from repro.kvcache.paged import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro.serving import \
    shared_prefix_workload as j_shared_prefix  # noqa: E402
from repro.sharding import rules_for as j_rules_for  # noqa: E402
from repro_torch import distributed as D  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.census import mesh_collectives  # noqa: E402
from repro_torch.kernels import paged_decode_attention as PK  # noqa: E402
from repro_torch.kvcache.paged import PagedKVCache  # noqa: E402
from repro_torch.launch import input_specs as TI  # noqa: E402
from repro_torch.launch import tensor_parallel as TP  # noqa: E402
from repro_torch.launch.mesh import (MULTI_CARD_ITEM, make_mesh,  # noqa: E402
                                     make_model_mesh)
from repro_torch.models.attention import local_lengths  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (draw_block, draw_leaf,  # noqa: E402
                                       init_params, init_shard, param_specs,
                                       params_from_numpy, rank_layout,
                                       tree_leaves)
from repro_torch.serving import (EngineConfig, SamplingParams,  # noqa: E402
                                 sharegpt_like, shared_prefix_workload)
from repro_torch.sharding import (BATCH, HEAD_DIM, KV_HEADS,  # noqa: E402
                                  KV_SEQ, check_executable, rules_for)

# the tolerance of tests/test_torch_model.py: float32, of the largest logit
TOL = 1e-5
CONFIGS = {
    # LayerNorm, learned positions; H = K = 4, d_ff 512
    "opt": lambda get, red: red(get("opt-1.3b")),
    # RMSNorm, RoPE; grouped-query H 8, K 4
    "gqa": lambda get, red: red(get("deepseek-coder-33b"), n_heads=8,
                                n_kv_heads=4),
    # qwen-like: K 2 (the KV-head fallback on 4), qkv_bias
    "qwen": lambda get, red: red(get("qwen2.5-3b"), n_heads=8,
                                 n_kv_heads=2),
    # H 6 (the head-dim fallback on 4, hd 32) and d_ff 198 (replicated
    # on 4)
    "fallback": lambda get, red: red(get("deepseek-coder-33b"), n_heads=6,
                                     n_kv_heads=6, d_model=192, d_ff=198),
}
# each rule set: (the config's attn_row_parallel, rules_for's flags)
RULES = {
    "default": (False, {}),
    "act_replicated": (False, {"act_replicated": True}),
    "row_parallel": (True, {}),
    "kv_seq": (False, {"shard_kv_seq": True}),
}
# the logits cases run on 2 and 4 ranks: (config, rule set)
CASES = [("opt", "default"), ("gqa", "default"), ("qwen", "default"),
         ("fallback", "default"), ("opt", "row_parallel"),
         ("qwen", "row_parallel"), ("opt", "kv_seq"), ("gqa", "kv_seq"),
         ("qwen", "kv_seq")]
ENGINE = dict(max_batch=4, block_size=8, kv_pool_tokens=1024,
              max_model_len=96, prefill_bucket=16)
# the one earlier engine mode served under the default rules
MODE = dict(prefill_chunk_tokens=16, prefix_cache=True)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
DECODE_STEPS = 4


def _configs(name, rules="default"):
    row = RULES[rules][0]
    return tuple(dataclasses.replace(CONFIGS[name](get, red),
                                     attn_row_parallel=row)
                 for get, red in ((j_get_config, j_reduced),
                                  (get_config, reduced)))


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The reference's init (numpy leaves) and the configs; the
    attn_row_parallel variant has the same leaves (its specs differ)."""
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
    device (blocks of 8, tables 4 wide). On one device no rule set
    changes the arithmetic, so every case of a config is held to these."""
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


def _sharegpt(ref):
    """8 ShareGPT-shaped requests with Poisson arrivals; every other one
    sampled (its own seed)."""
    make, params = ((j_sharegpt_like, JSamplingParams) if ref
                    else (sharegpt_like, SamplingParams))
    reqs = make(8, 512, seed=5, mean_in=14, mean_out=12, max_len=40,
                sigma=0.5, arrival_rate=200.0)
    return [type(r)(r.req_id, r.prompt, arrival_s=r.arrival_s,
                    sampling=params(**SAMPLED, seed=100 + i,
                                    max_new_tokens=r.max_new_tokens)
                    if i % 2 else r.sampling)
            for i, r in enumerate(reqs)]


def _shared_prefix(ref):
    """Two tenants of four requests, a 32-token prefix each."""
    make = j_shared_prefix if ref else shared_prefix_workload
    return make(2, 4, 512, prefix_len=32, suffix_len=12, max_new_tokens=6,
                seed=0)


# the reference's two serves: (config, workload, engine settings)
SERVES = {"sync": ("qwen", _sharegpt, {}),
          "mode": ("opt", _shared_prefix, MODE)}


@functools.lru_cache(maxsize=None)
def _reference_serve(serve):
    name, make, kw = SERVES[serve]
    jcfg, _, jp = _weights(name)
    reqs = make(True)
    rules = j_rules_for(j_make_mesh((1, 1), ("data", "model")))
    JEngine(JM.Model(jcfg, rules), jp, JEngineConfig(**ENGINE, **kw)).run(
        reqs)
    return [list(r.output_tokens) for r in reqs], \
        [r.finish_reason for r in reqs]


# the serves over the mesh: (reference serve, rule set) by mesh size
MESH_SERVES = {2: [("sync", "default"), ("mode", "default")],
               4: [("sync", "default"), ("sync", "kv_seq")]}


@functools.lru_cache(maxsize=None)
def _ranks(m):
    """One spawn of ``m`` gloo ranks running every check's rank side:
    each logits case (collectives recorded), then the serves."""
    jobs = []
    for name, rules in CASES:
        _, tcfg = _configs(name, rules)
        jp = _weights(name)[2]
        jobs.append((TP.logits_rank, (tcfg, jp, *_inputs(tcfg.vocab_size)),
                     dict(rules=RULES[rules][1], record=True)))
    for serve, rules in MESH_SERVES[m]:
        name, make, kw = SERVES[serve]
        _, tcfg = _configs(name, rules)
        jobs.append((TP.serve_rank, (tcfg, EngineConfig(**ENGINE, **kw),
                                     make(False), _weights(name)[2]),
                     dict(rules=RULES[rules][1], record=True)))
    return D.spawn(TP.run_jobs, D.devices_mesh(m, "cpu"), jobs)


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _layout(name, rules, m, rank):
    _, tcfg = _configs(name, rules)
    return rank_layout(tcfg, rules_for(make_mesh((1, m), ("data", "model")),
                                       **RULES[rules][1]), rank)


# ------------------------------------------------------------- blocks --
BLOCKS = [("opt", "default"), ("opt", "row_parallel"), ("opt", "kv_seq"),
          ("qwen", "default"), ("qwen", "act_replicated"),
          ("qwen", "kv_seq"), ("fallback", "default")]


def _axis(a):
    """A reference spec entry as the model axis's name or None (the data
    axis has one device here)."""
    axes = (a,) if isinstance(a, str) else tuple(a or ())
    axes = tuple(x for x in axes if x != "data")
    return axes[0] if axes else None


def _spec_block(whole, spec, rank, m):
    index = []
    for dim, axis in zip(whole.shape, map(_axis, spec)):
        if axis is None:
            index.append(slice(None))
        else:
            assert axis == "model", spec
            n = dim // m
            index.append(slice(rank * n, (rank + 1) * n))
    return whole[tuple(index)]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name,rules", BLOCKS)
def test_blocks_are_the_reference_specs_or_the_departure(name, rules, m):
    """Every parameter leaf of a rank (cut from the reference's weights,
    and drawn by ``init_shard``) and its pool leaf is the block the
    reference's spec on a ``(1, M)`` ``AbstractMesh`` gives that device,
    except where the KV heads fall back: there ``wk``, ``wv`` (their
    biases; where the query heads are sharded) and the pool hold the KV
    heads the rank's attention reads, whole, where the spec shards the
    head dim or replicates (the departures ``Layout.cut`` writes down),
    and only there."""
    jcfg, tcfg = _configs(name, rules)
    jp = _weights(name)[2]
    flags = RULES[rules][1]
    jrules = j_rules_for(AbstractMesh((1, m), ("data", "model")), **flags)
    trules = rules_for(make_mesh((1, m), ("data", "model")), **flags)
    jspecs = dict(tree_leaves(JM.param_shardings(jcfg, jrules)))
    specs = dict(tree_leaves(param_specs(tcfg)))
    whole = dict(tree_leaves(jp))
    drawn = dict(tree_leaves(init_params(tcfg, torch.Generator().manual_seed(
        4), device="cpu")))
    # the pool leaf [NB + 1, BS, K, hd] with the reference's cache axes
    jpool = JM.abstract_cache(jcfg, 1, 8)["stack"][0]["k"]
    pool_shape = (17, 8, tcfg.n_kv_heads, tcfg.hd)
    pool_logical = jpool.logical[1:]
    assert pool_logical == (BATCH, KV_SEQ, KV_HEADS, HEAD_DIM)
    pool_whole = np.arange(np.prod(pool_shape)).reshape(pool_shape)
    for rank in range(m):
        lay = _layout(name, rules, m, rank)
        held = lay.wkv == "held"
        cut = dict(tree_leaves(params_from_numpy(tcfg, jp, rules=trules,
                                                 rank=rank)))
        mine = dict(tree_leaves(init_shard(
            tcfg, torch.Generator().manual_seed(4), trules, rank)))
        departed = set()
        for path, ps in specs.items():
            spec = tuple(jspecs[path].spec)
            spec += (None,) * (len(ps.shape) - len(spec))
            assert trules.spec(ps.logical, ps.shape) == tuple(
                map(_axis, spec)), path
            want = _spec_block(whole[path], spec, rank, m)
            drawn_want = drawn[path][tuple(
                slice(a, b) for a, b in lay.cut(ps.logical, ps.shape,
                                                trules))]
            leaf = path.split("/")[-1]
            if held and leaf in ("wk", "wv", "bk", "bv"):
                departed.add(leaf)
                k0, k1 = lay.kv_heads
                want = whole[path][:, :, k0:k1] if leaf[0] == "w" else \
                    whole[path][:, k0:k1]
                assert want.shape != _spec_block(whole[path], spec, rank,
                                                 m).shape
            np.testing.assert_array_equal(cut[path].numpy(), want, path)
            assert torch.equal(mine[path], drawn_want), path
        assert departed == (({"wk", "wv", "bk", "bv"} if tcfg.qkv_bias
                              else {"wk", "wv"}) if held else set())
        # the pool: the reference's pool spec, or the held KV heads
        spec = tuple(jrules.spec(pool_logical, pool_shape))
        spec += (None,) * (4 - len(spec))
        got = pool_whole[tuple(slice(a, b) for a, b in lay.cut(
            pool_logical, pool_shape, trules))]
        want = _spec_block(pool_whole, spec, rank, m)
        if held or _axis(spec[3]) is not None:
            assert want.shape != got.shape
            want = pool_whole[:, :, lay.kv_heads[0]:lay.kv_heads[1]]
        np.testing.assert_array_equal(got, want)
        pool = PagedKVCache(tcfg, num_blocks=16, block_size=8, device="cpu",
                            kv_heads=lay.kv_heads[1] - lay.kv_heads[0],
                            seq_shard=(rank, m) if lay.kv_seq else None)
        assert tuple(pool.pool["k"].shape[1:]) == got.shape


def test_the_plans_read_off_the_specs():
    """What each rule set runs on 4 ranks: the default rules shard the
    residual, act_replicated keeps it whole; K 2 falls back to the held
    KV heads; attn_row_parallel shards wq's rows; H 6 falls back to the
    head dim and d_ff 198 to replication; shard_kv_seq holds every KV
    head; on one device every plan keeps the residual and the heads as
    the Megatron one does (shard_kv_seq still carries the partials)."""
    lay = _layout("opt", "default", 4, 1)
    assert lay.residual and (lay.wq, lay.wkv, lay.wo) == ("heads",) * 3
    assert not _layout("opt", "act_replicated", 4, 1).residual
    q = _layout("qwen", "default", 4, 3)
    assert q.wkv == "held" and q.heads == (6, 8) and q.kv_heads == (1, 2)
    assert _layout("opt", "row_parallel", 4, 0).wq == "rows"
    f = _layout("fallback", "default", 4, 2)
    assert (f.wq, f.wkv, f.wo, f.ffn) == ("head_dim", "head_dim",
                                          "head_dim", False)
    assert f.heads == f.attn_heads == (0, 6)
    s = _layout("qwen", "kv_seq", 4, 1)
    assert s.kv_seq and s.kv_heads == (0, 2) and s.wkv == "head_dim"
    for rules in RULES:
        one = _layout("qwen", rules, 1, 0)
        assert not one.residual and one.wo == "heads"
        assert one.kv_seq == (rules == "kv_seq")


def test_draw_block_is_the_sliced_draw_cut():
    """A block drawn slice by slice (a cache no card holds whole) is the
    block of the leaf ``draw_leaf`` draws in the same slices."""
    _, tcfg = _configs("qwen")
    spec = TI.abstract_cache(tcfg, 3, 40)["k"]
    whole = draw_leaf(spec, torch.float32, torch.Generator().manual_seed(1),
                      torch.device("cpu"), slice_bytes=4 * 999)
    for dim, (a, b) in ((2, (10, 20)), (3, (1, 2)), (1, (0, 3))):
        ranges = [(0, n) for n in spec.shape]
        ranges[dim] = (a, b)
        got = draw_block(spec, torch.float32,
                         torch.Generator().manual_seed(1),
                         torch.device("cpu"), ranges, slice_bytes=4 * 999)
        assert torch.equal(got, whole.narrow(dim, a, b - a)), dim


# -------------------------------------------------------------- model --
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name,rules", CASES)
def test_logits_match_the_reference_under_the_rules(name, rules, m):
    """``prefill`` and 4 paged ``decode_step`` logits over M ranks under
    each rule set, within 1e-5 of the reference's largest on one device;
    every rank returns the same logits and issues the same collectives,
    in order and in shape."""
    want_prefill, want_decode = _reference_logits(name)
    outs = [r[CASES.index((name, rules))] for r in _ranks(m)]
    for rank, out in enumerate(outs):
        lay = _layout(name, rules, m, rank)
        assert out["heads"] == lay.heads[1] - lay.heads[0]
        assert out["kv_heads"] == lay.kv_heads[1] - lay.kv_heads[0]
        np.testing.assert_array_equal(out["prefill"], outs[0]["prefill"])
        np.testing.assert_array_equal(out["decode"], outs[0]["decode"])
        assert out["record"] == outs[0]["record"] and out["record"]
    _close(outs[0]["prefill"], want_prefill)
    _close(outs[0]["decode"], want_decode)


_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter"}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name,rules", CASES)
def test_census_counts_the_collectives_issued(name, rules, m):
    """The collective bytes the census prices for the layout
    (``mesh_collectives``: a prefill of 2 x 24 rows, then 4 decode steps
    of 2) equal those the rank recorded, kind by kind."""
    out = _ranks(m)[0][CASES.index((name, rules))]
    got = dict.fromkeys(_KINDS.values(), 0.0)
    for op, shape, dtype in out["record"]:
        n = np.prod(shape) * torch.empty((), dtype=getattr(
            torch, dtype.split(".")[-1])).element_size()
        got[_KINDS[op]] += {"all_reduce": 2 * n, "all_gather": m * n,
                            "reduce_scatter": n}[op]
    _, tcfg = _configs(name, rules)
    lay = _layout(name, rules, m, 0)
    want = mesh_collectives(tcfg, lay, "prefill", 48, 2)
    for kind, n in mesh_collectives(tcfg, lay, "decode", 2, 2).items():
        want[kind] += DECODE_STEPS * n
    assert got == want


# ------------------------------------------------------------- engine --
@pytest.mark.parametrize("m,serve,rules",
                         [(m, s, r) for m, serves in MESH_SERVES.items()
                          for s, r in serves])
def test_engine_tokens_equal_the_reference_engine(m, serve, rules):
    """The paged sync engine over M ranks (8 ShareGPT requests, half
    sampled, Poisson arrivals) under the default rules (qwen's K 2 on 4:
    the KV-head fallback) and under shard_kv_seq on 4, and chunked
    prefill with the prefix cache under the default rules on 2: every
    request's tokens and finish reason equal the reference engine's on
    one device; every rank issued the same collectives and kernels."""
    out = [r[len(CASES) + MESH_SERVES[m].index((serve, rules))]
           for r in _ranks(m)]
    tokens, finish = _reference_serve(serve)
    assert out[0]["tokens"] == tokens
    assert out[0]["finish"] == finish
    for r in out[1:]:
        assert r["record"] == out[0]["record"]
        assert r["launches"] == out[0]["launches"]
    if serve == "mode":
        assert out[0]["chunks"] > 0 and out[0]["prefix_hit_tokens"] > 0
    ops = {op for op, _, _ in out[0]["record"]}
    assert ("reduce_scatter" in ops) == (rules != "act_replicated")


# ------------------------------------------------------ plain versions --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [2, 4])
def test_partials_combined_are_the_whole_kernel(m, dtype):
    """The partials entry over each of M pieces of every block's rows
    (rank ``r`` holds rows ``[r BS/M, (r+1) BS/M)``, at its local
    lengths) and the combine of the M partials equal the paged kernel's
    plain version over the whole pool and the reference's Pallas kernel
    in interpret mode; lengths 0, 1 (a piece with no row of it), a tail
    and whole blocks; a length-0 row gives exact zeros."""
    rng = np.random.default_rng(7)
    B, H, K, hd, BS, nb, NB = 5, 8, 2, 32, 8, 5, 28
    lengths = np.array([0, 1, 13, 37, 40], np.int32)
    table = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, K, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, K, hd)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    lens = torch.from_numpy(lengths)
    tab = torch.from_numpy(table)
    rows = BS // m
    parts = []
    for r in range(m):
        local = local_lengths(lens, BS, rows, r)
        piece = slice(r * rows, (r + 1) * rows)
        assert int(local[1]) == (1 if r == 0 else 0)
        parts.append(PK.paged_decode_partials(
            t(q), t(kp)[:, piece].contiguous(),
            t(vp)[:, piece].contiguous(), tab, local))
    parts = torch.stack(parts)
    assert parts.dtype == torch.float32 and parts.shape == (m, B, H, hd + 2)
    assert torch.isneginf(parts[:, 0, :, hd]).all()
    assert (parts[:, 0, :, hd + 1] == 0).all()
    got = PK.paged_decode_combine(parts, dtype)
    assert got.dtype == dtype
    assert (got[0] == 0).all()
    whole = PK.paged_gqa_decode_attention_torch(t(q), t(kp), t(vp), tab,
                                                lens).float()
    atol = (1e-5 if dtype == torch.float32 else 3e-2) * \
        float(whole.abs().max())
    torch.testing.assert_close(got.float(), whole, rtol=0, atol=atol)
    ref = np.asarray(j_paged(jnp.asarray(t(q).float().numpy()),
                             jnp.asarray(t(kp).float().numpy()),
                             jnp.asarray(t(vp).float().numpy()),
                             jnp.asarray(table), jnp.asarray(lengths),
                             interpret=True))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


# ------------------------------------------------------------ refusals --
def _item(excinfo):
    assert MULTI_CARD_ITEM in str(excinfo.value), str(excinfo.value)


def test_remaining_refusals_name_their_roadmap_item():
    """What still does not run across cards: the other families over a
    data axis of 2 or a model axis of 4, training; every rule set of
    rules_for passes, FSDP included, over 1 x 4 and 2 x 2 (a data axis
    and FSDP, refused before, run: tests/test_torch_mesh_data.py)."""
    _, tcfg = _configs("qwen")
    two_data = make_mesh((2, 1), ("data", "model"), ["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="left 1") as e:
        Model(reduced(get_config("zamba2-7b")), mesh=two_data,
              rules=rules_for(two_data))
    _item(e)
    four = make_model_mesh(["cpu"] * 4)
    square = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    for mesh in (four, square):
        check_executable(tcfg, rules_for(mesh, fsdp=True))
    with pytest.raises(NotImplementedError, match="left 2") as e:
        Model(reduced(get_config("mamba2-1.3b")), mesh=four,
              rules=rules_for(four, shard_kv_seq=True))
    _item(e)
    case = TI.case_for(tcfg, TI.ShapeSpec("t", "train", 16, 4), four)
    with pytest.raises(NotImplementedError, match="left 3") as e:
        TI.materialize(case, four, torch.Generator(), rank=0)
    _item(e)
    for _, flags in RULES.values():
        check_executable(tcfg, rules_for(four, **flags))
        check_executable(tcfg, rules_for(square, **flags))


# ------------------------------------------------------- default rules --
def test_model_defaults_to_the_act_replicated_rules():
    """The recorded departure from the reference (ROADMAP.md queue 3):
    ``Model(mesh=)`` without rules runs ``rules_for(mesh,
    act_replicated=True)``, the Megatron layout, where the reference's
    ``rules_for`` defaults to ``act_replicated=False``
    (``src/repro/sharding.py`` ``rules_for``)."""
    _, tcfg = _configs("opt")
    mesh = make_mesh((1, 1), ("data", "model"), ["cpu"])
    group = types.SimpleNamespace(mesh=mesh, rank=0,
                                  device=torch.device("cpu"))
    model = Model(tcfg, mesh=mesh, group=group)
    assert model.rules == rules_for(mesh, act_replicated=True)
    assert model.rules != rules_for(mesh)
    assert not j_rules_for(j_make_mesh((1, 1),
                                       ("data", "model"))).act_replicated


def test_ranks_default_to_the_act_replicated_rules():
    """The same departure where a rank builds its model:
    ``tensor_parallel.DEFAULT_RULES`` is ``{"act_replicated": True}``,
    and ``mesh_rules`` without flags gives those rules."""
    assert TP.DEFAULT_RULES == {"act_replicated": True}
    mesh = make_model_mesh(["cpu"] * 2)
    assert TP.mesh_rules(mesh) == rules_for(mesh, act_replicated=True)
    assert TP.mesh_rules(mesh, {}) == rules_for(mesh)
