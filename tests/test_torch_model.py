"""The PyTorch port's dense decoder against the JAX reference on the CPU:
the registry, every ported layer, the attention functions, and the
model's prefill, paged-decode and dense-cache decode logits, on the same
weights and caches (the JAX init and prefill carried across as numpy)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores (about 3x faster there)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import ALL as J_ALL  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.kvcache.paged import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ALL as T_ALL  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kvcache.paged import PagedKVCache  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (cache_from_numpy,  # noqa: E402
                                       init_params, param_specs,
                                       params_from_numpy)

TOL = 1e-4     # float32 on the CPU: the reference's own kernel tolerance
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=tol, rtol=tol)


def _configs(name, **kw):
    return (j_reduced(j_get_config(name), **kw),
            t_reduced(t_get_config(name), **kw))


def _params(jcfg, tcfg, seed=0, bias=False):
    """JAX init (numpy leaves) and the same weights as torch tensors; with
    ``bias`` the zero-initialised QKV biases get random values."""
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    if bias:
        rng = np.random.default_rng(seed)
        attn = jp["stack"][0]["attn"]
        for k in ("bq", "bk", "bv"):
            attn[k] = rng.normal(size=attn[k].shape).astype(np.float32) * 0.1
    return jp, params_from_numpy(tcfg, jp, device=CPU)


# ------------------------------------------------------------ registry ----
@pytest.mark.parametrize("name", sorted(J_ALL))
def test_registry_entry_equal(name):
    assert sorted(T_ALL) == sorted(J_ALL)
    assert dataclasses.asdict(T_ALL[name]) == dataclasses.asdict(J_ALL[name])
    assert dataclasses.asdict(t_reduced(T_ALL[name])) == \
        dataclasses.asdict(j_reduced(J_ALL[name]))


def test_activation_dtype_is_torch():
    assert t_get_config("opt-1.3b").activation_dtype == torch.bfloat16
    assert t_reduced(t_get_config("opt-1.3b")).activation_dtype == \
        torch.float32


@pytest.mark.parametrize("name", ["opt-1.3b", "qwen2.5-3b", "llama-2-7b"])
def test_param_specs_match_reference(name):
    jcfg, tcfg = _configs(name)
    jtree = JM.abstract_params(jcfg)
    ttree = param_specs(tcfg)
    jl, _ = jax.tree.flatten(jtree, is_leaf=lambda x: hasattr(x, "fan_in"))
    tl, _ = jax.tree.flatten(ttree, is_leaf=lambda x: hasattr(x, "fan_in"))
    assert [(s.shape, s.init, s.fan_in) for s in jl] == \
        [(s.shape, s.init, s.fan_in) for s in tl]


def test_init_params_scales():
    _, tcfg = _configs("opt-1.3b")
    g = torch.Generator(CPU).manual_seed(0)
    p = init_params(tcfg, g)
    d, f = tcfg.d_model, tcfg.d_ff
    assert p["stack"][0]["ln1"]["scale"].eq(1).all()
    assert p["stack"][0]["ln1"]["bias"].eq(0).all()
    for w, fan in ((p["stack"][0]["attn"]["wq"], d),
                   (p["stack"][0]["ffn"]["w2"], f),
                   (p["embed"]["tok"], d)):
        assert abs(float(w.std()) * fan ** 0.5 - 1.0) < 0.05


def test_params_from_numpy_rejects_wrong_shape():
    jcfg, tcfg = _configs("opt-1.3b")
    jp, _ = _params(jcfg, tcfg)
    jp["final_norm"]["scale"] = np.ones((3,), np.float32)
    with pytest.raises(ValueError):
        params_from_numpy(tcfg, jp)


# -------------------------------------------------------------- layers ----
@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norm_apply(norm):
    jcfg, tcfg = _configs("opt-1.3b")
    jcfg, tcfg = (dataclasses.replace(c, norm=norm) for c in (jcfg, tcfg))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 256)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=256).astype(np.float32),
         "bias": rng.normal(size=256).astype(np.float32)}
    _close(TL.norm_apply({k: _t(v) for k, v in p.items()}, _t(x), tcfg),
           JL.norm_apply(p, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)])
def test_rope(pos_shape):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 500, size=pos_shape).astype(np.int32)
    _close(TL.rope(_t(x), _t(pos), 10000.0),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu"])
def test_mlp_apply(act, rules):
    jcfg, tcfg = _configs("llama-2-7b")
    jcfg, tcfg = (dataclasses.replace(c, act=act) for c in (jcfg, tcfg))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 256)).astype(np.float32)
    p = {k: rng.normal(size=s).astype(np.float32) / 16 for k, s in
         (("w1", (256, 512)), ("w3", (256, 512)), ("w2", (512, 256)))}
    _close(TL.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), tcfg),
           JL.mlp_apply(p, jnp.asarray(x), jcfg, rules))


def test_embed_and_unembed_padded_vocab(rules):
    jcfg, tcfg = _configs("opt-1.3b", vocab=500)     # padded to 512
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 500, size=(2, 6)).astype(np.int32)
    pos = np.arange(6, dtype=np.int32)
    x_t = TL.embed_apply(tp["embed"], _t(toks).long(), _t(pos).long(), tcfg)
    x_j = JL.embed_apply(jp["embed"], jnp.asarray(toks), jnp.asarray(pos),
                         jcfg, rules)
    _close(x_t, x_j)
    lt = TL.unembed_apply(tp["embed"], x_t, tcfg)
    lj = JL.unembed_apply(jp["embed"], x_j, jcfg, rules)
    _close(lt[..., :500], np.asarray(lj)[..., :500])
    assert lt.shape[-1] == 512 and bool((lt[..., 500:] == -1e30).all())


# ----------------------------------------------------------- attention ----
def _attn_inputs(name, bias):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, tcfg, bias=bias)
    return jcfg, tcfg, jax.tree.map(lambda a: a[0], jp["stack"][0]["attn"]), \
        {k: v[0] for k, v in tp["stack"][0]["attn"].items()}


@pytest.mark.parametrize("name,bias", [("opt-1.3b", False),
                                       ("qwen2.5-3b", True)])
def test_qkv_and_out_project(name, bias, rules):
    jcfg, tcfg, pj, pt = _attn_inputs(name, bias)
    x = np.random.default_rng(5).normal(size=(2, 9, 256)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    qt, kt, vt = TA.qkv_project(pt, _t(x), tcfg, _t(pos))
    qj, kj, vj = JA.qkv_project(pj, jnp.asarray(x), jcfg, rules,
                                jnp.asarray(pos))
    for a, b in ((qt, qj), (kt, kj), (vt, vj)):
        _close(a, b)
    o = np.random.default_rng(6).normal(size=(2, 9, 256)).astype(np.float32)
    _close(TA.out_project(pt, _t(o), tcfg),
           JA.out_project(pj, jnp.asarray(o), jcfg, rules))


@pytest.mark.parametrize("name,bias", [("opt-1.3b", False),
                                       ("qwen2.5-3b", True)])
def test_self_attn_seq_valid_rows(name, bias, rules):
    """Valid query rows agree with the reference's length-masked prefill
    attention; K/V agree everywhere."""
    jcfg, tcfg, pj, pt = _attn_inputs(name, bias)
    x = np.random.default_rng(7).normal(size=(2, 16, 256)).astype(np.float32)
    lengths = np.array([16, 11], np.int32)
    pos = np.arange(16, dtype=np.int32)
    ot, (kt, vt) = TA.self_attn_seq(pt, _t(x), tcfg, positions=_t(pos),
                                    causal=True)
    oj, (kj, vj) = JA.self_attn_seq(pj, jnp.asarray(x), jcfg, rules,
                                    positions=jnp.asarray(pos), causal=True,
                                    lengths=jnp.asarray(lengths))
    for b, n in enumerate(lengths):
        _close(ot[b, :n], np.asarray(oj)[b, :n])
    _close(kt, kj)
    _close(vt, vj)


@pytest.mark.parametrize("name,bias", [("opt-1.3b", False),
                                       ("qwen2.5-3b", True)])
@pytest.mark.parametrize("P,pl", [(16, 11), (32, 32), (0, 0)])
def test_self_attn_seq_prefix_and_lengths_every_row(name, bias, P, pl,
                                                    rules):
    """A suffix over a gathered prefix (``prefix_len`` mid-block, the
    whole pad, or no prefix) with each request's length: every query
    row, padded rows included, and the suffix's K/V against the
    reference's ``self_attn_seq``."""
    jcfg, tcfg, pj, pt = _attn_inputs(name, bias)
    rng = np.random.default_rng(P + pl)
    S = 16
    x = rng.normal(size=(2, S, 256)).astype(np.float32)
    pk, pv = (rng.normal(size=(2, P, tcfg.n_kv_heads, tcfg.hd))
              .astype(np.float32) for _ in range(2))
    lengths = np.array([S, 9], np.int32) + pl
    pos = (pl + np.arange(S)).astype(np.int32)
    kw = dict(prefix_len=pl) if P else {}
    ot, (kt, vt) = TA.self_attn_seq(
        pt, _t(x), tcfg, positions=_t(pos), causal=True,
        lengths=_t(lengths), prefix_k=_t(pk) if P else None,
        prefix_v=_t(pv) if P else None, **kw)
    oj, (kj, vj) = JA.self_attn_seq(
        pj, jnp.asarray(x), jcfg, rules, positions=jnp.asarray(pos),
        causal=True, lengths=jnp.asarray(lengths),
        prefix_k=jnp.asarray(pk) if P else None,
        prefix_v=jnp.asarray(pv) if P else None,
        prefix_len=jnp.int32(pl) if P else None)
    _close(ot, oj)
    _close(kt, kj)
    _close(vt, vj)


def test_self_attn_seq_refuses_a_window_over_a_prefix():
    _, tcfg, _, pt = _attn_inputs("opt-1.3b", False)
    x = torch.zeros(1, 8, 256)
    pk = torch.zeros(1, 16, tcfg.n_kv_heads, tcfg.hd)
    with pytest.raises(NotImplementedError, match="window"):
        TA.self_attn_seq(pt, x, tcfg, positions=torch.arange(8) + 4,
                         causal=True, window=4, lengths=torch.tensor([12]),
                         prefix_k=pk, prefix_v=pk, prefix_len=4)


def test_paged_self_attn_decode(rules):
    jcfg, tcfg, pj, pt = _attn_inputs("qwen2.5-3b", True)
    rng = np.random.default_rng(8)
    NB, BS, K, hd = 12, 8, tcfg.n_kv_heads, tcfg.hd
    kp = rng.normal(size=(NB, BS, K, hd)).astype(np.float32)
    vp = rng.normal(size=(NB, BS, K, hd)).astype(np.float32)
    x = rng.normal(size=(3, 1, 256)).astype(np.float32)
    tables = np.array([[3, 7, 1], [5, 11, 11], [11, 11, 11]], np.int32)
    positions = np.array([20, 5, 0], np.int32)
    lengths = np.array([21, 6, 0], np.int32)
    kt, vt = _t(kp.copy()), _t(vp.copy())
    ot = TA.paged_self_attn_decode(pt, _t(x), kt, vt, tcfg, tables=_t(tables),
                                   lengths=_t(lengths),
                                   positions=_t(positions), block_size=BS)
    oj, (kj, vj) = JA.paged_self_attn_decode(
        pj, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp), jcfg, rules,
        tables=jnp.asarray(tables), lengths=jnp.asarray(lengths),
        positions=jnp.asarray(positions), block_size=BS)
    _close(ot[:2], np.asarray(oj)[:2])
    _close(kt[:11], np.asarray(kj)[:11])       # block 11 is the trash block
    _close(vt[:11], np.asarray(vj)[:11])


@pytest.mark.parametrize("ragged", [True, False])
def test_self_attn_decode_dense_cache(ragged, rules):
    """One layer's decode against a dense cache: ragged positions with
    explicit lengths, or one position for the batch with a shorter length
    on one row; the output and the in-place write match the reference."""
    jcfg, tcfg, pj, pt = _attn_inputs("qwen2.5-3b", True)
    rng = np.random.default_rng(10)
    B, S, K, hd = 3, 24, tcfg.n_kv_heads, tcfg.hd
    ck = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    cv = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    x = rng.normal(size=(B, 1, 256)).astype(np.float32)
    if ragged:
        pos, lengths = np.array([20, 5, 11], np.int32), np.array([21, 6, 12],
                                                                 np.int32)
    else:
        pos, lengths = np.int32(13), np.array([14, 9, 24], np.int32)
    kt, vt = _t(ck.copy()), _t(cv.copy())
    ot = TA.self_attn_decode(pt, _t(x), kt, vt, tcfg, pos=_t(pos),
                             lengths=_t(lengths))
    oj, (kj, vj) = JA.self_attn_decode(
        pj, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jcfg, rules,
        pos=jnp.asarray(pos), lengths=jnp.asarray(lengths))
    _close(ot, oj)
    _close(kt, kj)
    _close(vt, vj)


def test_self_attn_decode_refuses_windows():
    """The ring decode refuses what it does not reproduce: a cache longer
    than the window (this call's), ragged positions (the reference
    asserts against them) and lengths once the ring has wrapped. The
    windows it runs are held against the reference in
    ``tests/test_torch_window.py``."""
    _, tcfg, _, pt = _attn_inputs("opt-1.3b", False)
    c = torch.zeros(1, 8, tcfg.n_kv_heads, tcfg.hd)
    x = torch.zeros(1, 1, 256)
    with pytest.raises(ValueError, match="at most window=4"):
        TA.self_attn_decode(pt, x, c, c, tcfg, pos=3, window=4)
    with pytest.raises(NotImplementedError,
                       match="ragged decode does not support windows"):
        TA.self_attn_decode(pt, x, c, c, tcfg, pos=torch.tensor([3]),
                            window=8)
    with pytest.raises(NotImplementedError, match="wrapped"):
        TA.self_attn_decode(pt, x, c, c, tcfg, pos=9, window=8,
                            lengths=torch.tensor([10], dtype=torch.int32))


# --------------------------------------------------------------- model ----
@pytest.mark.parametrize("name,bias", [("opt-1.3b", False),
                                       ("qwen2.5-3b", True)])
def test_prefill_and_paged_decode_logits(name, bias, rules):
    """Prefill logits and K/V, then three paged decode steps' logits, on a
    padded two-request batch with a padding row in the decode bucket."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, tcfg, seed=1, bias=bias)
    model = Model(tcfg, tp, device=CPU)
    rng = np.random.default_rng(9)
    lengths = np.array([13, 21], np.int32)
    S, BS = 32, 8
    toks = np.zeros((2, S), np.int32)
    for b, n in enumerate(lengths):
        toks[b, :n] = rng.integers(0, tcfg.vocab_size, n)
    lt, ct = model.prefill(_t(toks), _t(lengths), cache_len=S)
    lj, cj, _ = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lengths)},
                           cache_len=S)
    _close(lt, lj)
    for name_ in ("k", "v"):
        for b, n in enumerate(lengths):
            _close(ct[name_][:, b, :n], np.asarray(cj["stack"][0][name_])[:, b, :n])

    tpool = PagedKVCache(tcfg, num_blocks=16, block_size=BS,
                         device=CPU)
    jpool = JPagedKVCache(jcfg, num_blocks=16, block_size=BS, max_batch=4)
    for b, n in enumerate(lengths):
        for mgr in (tpool.manager, jpool.manager):
            mgr.allocate(b, int(n) + 1)
        tpool.write_prefill(b, {k: v[:, b:b + 1] for k, v in ct.items()})
        jpool.write_prefill(b, jax.tree.map(lambda a: a[:, b:b + 1], cj))
    tokens = np.asarray(jnp.argmax(lj, -1), np.int32)
    positions = lengths.copy()
    for _ in range(3):
        for b in range(2):
            for mgr in (tpool.manager, jpool.manager):
                mgr.append_token(b, int(positions[b]) + 1)
        tok_pad = np.zeros((4,), np.int32)
        tok_pad[:2] = tokens
        tv = tpool.view([0, 1], positions.tolist(), nb_pad=4, batch_pad=4)
        jv = jpool.view([0, 1], positions.tolist(), nb_pad=4, batch_pad=4)
        lt = model.decode_step(_t(tok_pad), tv)
        lj, new_pool = JM.decode_step(jp, jcfg, rules, jv,
                                      jnp.asarray(tok_pad), None)
        jpool.commit(new_pool)
        _close(lt[:2], np.asarray(lj)[:2])
        tokens = np.asarray(jnp.argmax(lj[:2], -1), np.int32)
        assert tokens.tolist() == lt[:2].argmax(-1).tolist()
        positions += 1


@pytest.mark.parametrize("name,bias", [("opt-1.3b", False),
                                       ("llama-2-7b", False),
                                       ("qwen2.5-3b", True)])
def test_suffix_prefill_over_a_cached_prefix(name, bias, rules):
    """``prefill(prefix=, prefix_len=)`` (the prefix cache's and chunked
    prefill's call): the suffix's logits and K/V equal the reference's
    suffix prefill on the same gathered prefix, and the whole prompt's
    prefill (the prefix ends mid-block, its masked tail is garbage)."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, tcfg, seed=2, bias=bias)
    model = Model(tcfg, tp, device=CPU)
    rng = np.random.default_rng(8)
    N, pl, P, S = 29, 19, 32, 16
    prompt = rng.integers(0, tcfg.vocab_size, N).astype(np.int32)
    full_l, full_c = model.prefill(_t(prompt[None]), _t(np.array([N])),
                                   cache_len=N)
    _, pre = model.prefill(_t(prompt[None, :pl]), _t(np.array([pl])))
    prefix = {k: torch.cat([c, torch.randn(c.shape[0], 1, P - pl,
                                           *c.shape[3:])], dim=2)
              for k, c in pre.items()}
    toks = np.zeros((1, S), np.int32)
    toks[0, :N - pl] = prompt[pl:]
    lens = np.array([N - pl], np.int32)
    lt, ct = model.prefill(_t(toks), _t(lens), cache_len=S, prefix=prefix,
                           prefix_len=pl)
    jprefix = {"stack": [{k: jnp.asarray(c.numpy())
                          for k, c in prefix.items()}], "rem": []}
    lj, cj, _ = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lens)},
                           cache_len=S, prefix=jprefix, prefix_len=pl)
    _close(lt, lj)
    _close(lt, full_l)
    for k in ("k", "v"):
        _close(ct[k], cj["stack"][0][k])
        _close(ct[k][:, :, :N - pl], full_c[k][:, :, pl:N])
    with pytest.raises(ValueError, match="lengths"):
        model.prefill(_t(toks), prefix=prefix, prefix_len=pl)


DENSE = [("opt-1.3b", False), ("llama-2-7b", False),
         ("internlm2-1.8b", False), ("qwen2.5-3b", True)]


@pytest.mark.parametrize("name,bias", DENSE)
def test_dense_decode_ragged_positions(name, bias, rules):
    """The gather fallback's model step: three decode steps on a dense
    cache at per-request positions with ``lengths = pos + 1``, from the
    reference's own prefill cache; logits and the written cache match."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, tcfg, seed=2, bias=bias)
    model = Model(tcfg, tp, device=CPU)
    rng = np.random.default_rng(11)
    lengths = np.array([9, 20, 14], np.int32)
    S = 32
    toks = np.zeros((3, S), np.int32)
    for b, n in enumerate(lengths):
        toks[b, :n] = rng.integers(0, tcfg.vocab_size, n)
    lj, cj, _ = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lengths)},
                           cache_len=S)
    ct = cache_from_numpy(tcfg, jax.tree.map(np.asarray, cj), device=CPU)
    tokens = np.array(jnp.argmax(lj, -1), np.int32)
    pos = lengths.copy()
    for _ in range(3):
        lt = model.decode_step(_t(tokens), ct, _t(pos), lengths=_t(pos + 1))
        lj, cj = JM.decode_step(jp, jcfg, rules, cj, jnp.asarray(tokens),
                                jnp.asarray(pos),
                                lengths=jnp.asarray(pos + 1))
        _close(lt, lj)
        tokens = np.array(jnp.argmax(lj, -1), np.int32)
        assert tokens.tolist() == lt.argmax(-1).tolist()
        pos += 1
    for n in ("k", "v"):
        _close(ct[n], cj["stack"][0][n])


@pytest.mark.parametrize("name,bias", DENSE)
def test_static_batch_decode_quickstart_loop(name, bias, rules):
    """The quickstart loop: ``prefill(cache_len=24)`` on a 16-token batch,
    then six decode steps at one position for the whole batch; logits and
    the cache match the reference."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, tcfg, seed=3, bias=bias)
    model = Model(tcfg, tp, device=CPU)
    toks = np.random.default_rng(12).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    lt, ct = model.prefill(_t(toks), cache_len=24)
    lj, cj, _ = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)},
                           cache_len=24)
    _close(lt, lj)
    assert ct["k"].shape == cj["stack"][0]["k"].shape
    ct = cache_from_numpy(tcfg, jax.tree.map(np.asarray, cj), device=CPU)
    nxt = np.array(jnp.argmax(lj, -1), np.int32)
    for t in range(16, 22):
        lt = model.decode_step(_t(nxt), ct, t)
        lj, cj = JM.decode_step(jp, jcfg, rules, cj, jnp.asarray(nxt),
                                jnp.int32(t))
        _close(lt, lj)
        nxt = np.array(jnp.argmax(lj, -1), np.int32)
    for n in ("k", "v"):
        _close(ct[n], cj["stack"][0][n])


def test_init_cache_and_cache_from_numpy_layouts(rules):
    jcfg, tcfg = _configs("internlm2-1.8b")
    model = Model(tcfg, _params(jcfg, tcfg)[1], device=CPU)
    ct = model.init_cache(3, 40)
    jc = jax.tree.map(np.asarray, JM.init_cache(jcfg, 3, 40))
    assert ct["k"].shape == jc["stack"][0]["k"].shape
    assert ct["k"].dtype == torch.float32 and not ct["v"].any()
    assert cache_from_numpy(tcfg, jc)["v"].shape == ct["v"].shape
    jc["stack"][0]["k"] = jc["stack"][0]["k"][:, :, :, :1]
    with pytest.raises(ValueError, match="cache k shape"):
        cache_from_numpy(tcfg, jc)


def test_model_rejects_out_of_slice_configs():
    """Every config of the registry builds a ``Model`` now (the VLM, the
    encoder, a sliding window, a bidirectional decoder); what the
    reference's engine cannot decode, the port's engine refuses at
    construction, with the reference's reason: an encoder (its first
    prefill fails there, ``KeyError: 'embeds'``) and a sliding window
    (its ragged decode asserts against windows)."""
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    base = t_reduced(t_get_config("opt-1.3b"))
    ecfg = EngineConfig(max_batch=2, block_size=8, kv_pool_tokens=256,
                        max_model_len=64, prefill_bucket=16)
    for cfg in (t_reduced(t_get_config("llama-3.2-vision-90b")),
                t_reduced(t_get_config("hubert-xlarge")),
                dataclasses.replace(base, sliding_window=16),
                dataclasses.replace(base, causal=False)):
        model = Model(cfg, device=CPU)
        assert len(model.layers) == cfg.n_layers
        if cfg.embedding_inputs:
            with pytest.raises(NotImplementedError, match="'embeds'"):
                ContinuousBatchingEngine(model, ecfg, device=CPU)
        elif cfg.sliding_window:
            with pytest.raises(NotImplementedError,
                               match="ragged decode does not support "
                                     "windows"):
                ContinuousBatchingEngine(model, ecfg, device=CPU)
        else:
            ContinuousBatchingEngine(model, ecfg, device=CPU)


def test_model_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(t_reduced(t_get_config("opt-1.3b")))
