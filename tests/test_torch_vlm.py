"""The port's VLM family (``llama-3.2-vision-90b``: a cross-attention block
every ``cross_every`` layers over a request's image K/V) against the JAX
reference on the CPU: ``cross_attn_kv`` and ``cross_attn_apply`` (a
prefill's rows and a decode row, with a query bias), the model's
prefill, dense decode and forward with random image embeddings at 4
layers (a stacked period of two, ``n_rep = 2``), one paged step whose
slot leaves hold the same non-zero image K/V in both packages' pools,
the pool's slots and byte counts, the engine's tokens (paged and
gather, sync and overlapped; the engine's zero image stub, so the cross
output is 0 there and the tokens hold the plumbing, the model tests the
math), the disabled reasons, and the census against the reference's
HLO census."""
import dataclasses

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
from repro.core import perfmodel as j_perf  # noqa: E402
from repro.kvcache.paged import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.kvcache.prefix import \
    prefix_cache_supported as j_prefix_supported  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Observability as JObservability  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import census as C  # noqa: E402
from repro_torch.core import perfmodel  # noqa: E402
from repro_torch.core.hardware import H100_SXM5_80GB  # noqa: E402
from repro_torch.kvcache.paged import PagedKVCache  # noqa: E402
from repro_torch.kvcache.prefix import prefix_cache_supported  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (cache_from_numpy,  # noqa: E402
                                       cache_layers, params_from_numpy,
                                       plan_structure)
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, sharegpt_like)
from repro_torch.serving.obs.observer import Observability  # noqa: E402

CPU = torch.device("cpu")
ATOL = 1e-5          # float32, module level (the reference's)
LOGIT_ATOL = 1e-4    # float32 logits
NAME = "llama-3.2-vision-90b"
LAYERS = dict(n_layers=4)     # (attn, cross) twice: n_rep = 2


def _cfgs(**kw):
    return (j_reduced(j_get_config(NAME), **{**LAYERS, **kw}),
            reduced(get_config(NAME), **{**LAYERS, **kw}))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-5,
                               atol=atol)


_PARAMS = {}


def _params(jcfg, tcfg):
    """The reference's weights (numpy) and the port's copy, once a
    module."""
    if tcfg not in _PARAMS:
        jp = jax.tree.map(np.asarray,
                          JM.init_params(jcfg, jax.random.PRNGKey(0)))
        _PARAMS[tcfg] = jp, params_from_numpy(tcfg, jp, device=CPU)
    return _PARAMS[tcfg]


def _img(cfg, B, seed=5):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------ layers ----
def test_plan_and_cache_layers():
    """The period is ``cross_every`` blocks, as in the reference; the
    cross layers hold per-request image K/V, not paged K/V."""
    jcfg, tcfg = _cfgs()
    assert plan_structure(tcfg) == JM.plan_structure(jcfg) == \
        (("attn", "cross"), 2, 0)
    assert cache_layers(tcfg) == {"kv": [0, 2], "ssm": [], "cross": [1, 3]}
    full = get_config(NAME)
    assert plan_structure(full)[1:] == (20, 0)


@pytest.mark.parametrize("S,decode", [(9, False), (1, True)],
                         ids=["prefill", "decode"])
def test_cross_attn_matches_reference(rules, S, decode):
    """``cross_attn_kv`` (no bias, no RoPE) and ``cross_attn_apply`` (the
    query bias only) equal the reference's, through the flash kernel's
    plain entry (a prefill's rows) and the contiguous decode kernel's (a
    decode row, every length ``n_img``)."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, qkv_bias=True)
    tcfg = dataclasses.replace(tcfg, qkv_bias=True)
    rng = np.random.default_rng(S)
    d, h, k, hd = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd
    p = {"wq": rng.normal(size=(d, h, hd)) / np.sqrt(d),
         "wk": rng.normal(size=(d, k, hd)) / np.sqrt(d),
         "wv": rng.normal(size=(d, k, hd)) / np.sqrt(d),
         "wo": rng.normal(size=(h, hd, d)) / np.sqrt(h * hd),
         "bq": rng.normal(size=(h, hd)) * 0.1,
         "bk": rng.normal(size=(k, hd)) * 0.1,
         "bv": rng.normal(size=(k, hd)) * 0.1}
    p = {n: a.astype(np.float32) for n, a in p.items()}
    img = _img(tcfg, 2, seed=S)
    x = rng.normal(size=(2, S, d)).astype(np.float32)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: _t(a) for n, a in p.items()}
    jk, jv = JA.cross_attn_kv(jp, jnp.asarray(img), jcfg, rules)
    tk, tv = TA.cross_attn_kv(tp, _t(img), tcfg)
    _close(tk, jk)
    _close(tv, jv)
    jo = JA.cross_attn_apply(jp, jnp.asarray(x), jk, jv, jcfg, rules)
    to = TA.cross_attn_apply(tp, _t(x), tk, tv, tcfg, decode=decode)
    assert to.shape == (2, S, d)
    _close(to, jo)


# ------------------------------------------------------------- model ----
def test_model_matches_reference_with_random_images(rules):
    """Prefill logits and cache (each self-attention layer's K/V, each
    cross layer's image K/V), three dense decode steps and ``forward``
    with random image embeddings; the image changes the logits."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    model = Model(tcfg, tp, device=CPU)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, size=(3, 16)).astype(np.int32)
    lens = np.array([16, 11, 5], np.int32)
    img = _img(tcfg, 3)
    batch = {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens),
             "img_embeds": jnp.asarray(img)}
    jl, jc, _ = JM.prefill(jp, jcfg, rules, batch, cache_len=32)
    tl, tc = model.prefill(_t(toks), _t(lens), cache_len=32,
                           img_embeds=_t(img))
    _close(tl, jl, LOGIT_ATOL)
    want = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc))
    assert set(tc) == set(want) == {"k", "v", "xk", "xv"}
    for k in tc:
        assert tc[k].shape == want[k].shape
        _close(tc[k], want[k])
    assert tc["xk"].abs().max() > 0.1
    zero_l, _ = model.prefill(_t(toks), _t(lens), cache_len=32,
                              img_embeds=torch.zeros(img.shape))
    assert (zero_l - tl).abs().max() > 1e-3, "the image left no trace"
    pos = lens.copy()
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, jc = JM.decode_step(jp, jcfg, rules, jc, jnp.asarray(nxt),
                                jnp.asarray(pos), lengths=jnp.asarray(pos + 1))
        tl = model.decode_step(_t(nxt), tc, _t(pos), lengths=_t(pos + 1))
        _close(tl, jl, LOGIT_ATOL)
        assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    jf, _ = JM.forward(jp, jcfg, rules, batch)
    tf = model.forward(_t(toks), lengths=_t(lens), img_embeds=_t(img))
    assert tf.shape == (3, 16, tcfg.vocab_size)
    _close(tf, np.asarray(jf)[..., :tcfg.vocab_size], LOGIT_ATOL)
    with pytest.raises(ValueError, match="img_embeds"):
        model.prefill(_t(toks), _t(lens))


def test_paged_step_over_nonzero_image_slots_matches_reference(rules):
    """One request's prefill with its own random image written into both
    packages' pools (the image K/V in its dense-state slot, slot order
    differing from the request order), then three paged decode steps at
    a batch padded to 4 (the padding row reads the trash slot): the
    logits are the reference's, and so are the greedy tokens."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    model = Model(tcfg, tp, device=CPU)
    rng = np.random.default_rng(2)
    BS, lengths = 8, [13, 6, 20]
    tpool = PagedKVCache(tcfg, num_blocks=24, block_size=BS, device=CPU,
                         max_batch=4)
    jpool = JPagedKVCache(jcfg, num_blocks=24, block_size=BS, max_batch=4)
    tokens = []
    for b, n in enumerate(lengths):
        toks = rng.integers(0, tcfg.vocab_size, (1, 24)).astype(np.int32)
        img = _img(tcfg, 1, seed=10 + b)
        lens = np.array([n], np.int32)
        jl, jc, _ = JM.prefill(jp, jcfg, rules, {
            "tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens),
            "img_embeds": jnp.asarray(img)}, cache_len=24)
        tl, tc = model.prefill(_t(toks), _t(lens), cache_len=24,
                               img_embeds=_t(img))
        _close(tl, jl, LOGIT_ATOL)
        for mgr in (tpool.manager, jpool.manager):
            mgr.allocate(b, n + 1)
        tpool.write_prefill(b, tc)
        jpool.write_prefill(b, jc)
        tokens.append(int(np.asarray(jl).argmax(-1)[0]))
    assert tpool.pool["xk"].abs().max() > 0.1
    _close(tpool.pool["xk"][:, [tpool._slot(b) for b in range(3)]],
           np.asarray(jpool.pool["stack"][1]["k"])[
               :, [jpool._slot(b) for b in range(3)]])
    positions = list(lengths)
    for _ in range(3):
        for b in range(3):
            for mgr in (tpool.manager, jpool.manager):
                mgr.append_token(b, positions[b] + 1)
        tok_pad = np.zeros((4,), np.int32)
        tok_pad[:3] = tokens
        tv = tpool.view([0, 1, 2], positions, nb_pad=4, batch_pad=4)
        jv = jpool.view([0, 1, 2], positions, nb_pad=4, batch_pad=4)
        assert tv.slots.tolist() == np.asarray(jv.slots).tolist()
        lt = model.decode_step(_t(tok_pad), tv)
        lj, new_pool = JM.decode_step(jp, jcfg, rules, jv,
                                      jnp.asarray(tok_pad), None)
        jpool.commit(new_pool)
        _close(lt[:3], np.asarray(lj)[:3], LOGIT_ATOL)
        tokens = np.asarray(lj)[:3].argmax(-1).tolist()
        assert lt[:3].argmax(-1).tolist() == tokens
        positions = [p + 1 for p in positions]


# ------------------------------------------------------------ engine ----
# a batch of 3 (a paged step pads it to 4) in a pool of 24 blocks
ENGINE = dict(max_batch=3, block_size=8, kv_pool_tokens=192,
              max_model_len=96, prefill_bucket=16)
WORKLOAD = dict(seed=11, mean_in=20, mean_out=30, max_len=60, sigma=0.3)
N_REQ = 6


@pytest.fixture(scope="module")
def vlm(rules):
    """(reference model, its weights, its StepFunctions, the port's model,
    the reference runs' memo), once a module."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    jmodel = JM.Model(jcfg, rules)
    return (jmodel, jp, JStepFunctions.build(jmodel, ENGINE["block_size"]),
            Model(tcfg, tp, device=CPU), {})


def _reference(models, mode):
    """The reference engine's sync run in ``mode`` (memoised a module;
    the paged run with its observer, whose HLO census the census test
    reads)."""
    jmodel, jp, steps, _, memo = models
    if mode not in memo:
        reqs = j_sharegpt_like(N_REQ, jmodel.cfg.vocab_size, **WORKLOAD)
        eng = JEngine(jmodel, jp, JEngineConfig(decode_mode=mode, **ENGINE),
                      steps=steps)
        if mode == "paged":
            JObservability().attach(eng)
        eng.run(reqs)
        memo[mode] = (eng, reqs)
    return memo[mode]


def _serve(models, obs=None, **kw):
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**ENGINE, **kw),
                                   device="cpu")
    if obs is not None:
        obs.attach(eng)
    reqs = sharegpt_like(N_REQ, eng.cfg.vocab_size, **WORKLOAD)
    eng.run(reqs)
    pool = eng.pool
    assert pool.manager.free_blocks == pool.manager.num_blocks
    assert pool.free_slots == eng.ecfg.max_batch and not pool._slots
    return eng, reqs


def _tokens(reqs):
    return [(list(map(int, r.output_tokens)), r.finish_reason)
            for r in reqs]


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("mode", ["paged", "gather"])
def test_engine_matches_reference(vlm, mode, overlap):
    """The port's engine gives the reference engine's tokens and finish
    reasons mode by mode, synchronous and overlapped (against the
    reference's sync loop), at a batch of 3 with six requests (the later
    ones wait for a slot); every block and every slot comes home."""
    _, jreqs = _reference(vlm, mode)
    eng, reqs = _serve(vlm, decode_mode=mode, overlap=overlap)
    assert _tokens(reqs) == _tokens(jreqs)
    assert eng.pool.state_names == ("xk", "xv")
    assert eng.pool.written_state == ()


def test_disabled_reasons_and_pool_bytes_match_reference(vlm):
    """Prefix cache, chunked prefill and speculation fall back with the
    reference's reasons; the pool's byte counts (the image K/V slots in
    ``dense_state_bytes``) are the reference's."""
    jmodel, jp, steps, tmodel, _ = vlm
    kw = dict(ENGINE, prefix_cache=True, prefill_chunk_tokens=16,
              speculate=True)
    jeng = JEngine(jmodel, jp, JEngineConfig(**kw), steps=steps)
    eng = ContinuousBatchingEngine(tmodel, EngineConfig(**kw), device="cpu")
    assert prefix_cache_supported(eng.cfg) == j_prefix_supported(jmodel.cfg)
    for attr in ("prefix_disabled_reason", "chunking_disabled_reason",
                 "spec_disabled_reason"):
        assert getattr(eng, attr) == getattr(jeng, attr) is not None
    assert (eng.prefix, eng.chunking, eng.speculator) == (None, False, None)
    for attr in ("block_bytes", "pool_bytes", "dense_state_bytes",
                 "trash_slot"):
        assert getattr(eng.pool, attr) == getattr(jeng.pool, attr)
    cfg = tmodel.cfg
    assert eng.pool.dense_state_bytes == 2 * 2 * (ENGINE["max_batch"] + 1) \
        * cfg.n_img_tokens * cfg.n_kv_heads * cfg.hd * 4
    with pytest.raises(ValueError, match="max_batch"):
        PagedKVCache(cfg, num_blocks=7, block_size=16, device=CPU)


def test_max_batch_prices_the_image_slots():
    """``max_batch_for`` prices each request's image K/V beside its KV
    (the reference prices only SSM state there): at the full width, two
    periods deep, the port's batch is smaller than the reference's by
    exactly that term."""
    cfg = dataclasses.replace(get_config(NAME), n_layers=10)
    jcfg = dataclasses.replace(j_get_config(NAME), n_layers=10)
    hw = H100_SXM5_80GB
    ctx = 331
    free = hw.hbm_bytes * 0.9 - cfg.num_params() * 2
    per_tok = cfg.kv_bytes_per_token(2) * ctx
    image = 2 * 2 * cfg.n_img_tokens * cfg.n_kv_heads * cfg.hd * 2
    assert perfmodel.max_batch_for(cfg, hw, ctx) == \
        int(free // (per_tok + image))
    assert j_perf.max_batch_for(jcfg, hw, ctx) == int(free // per_tok)


def test_census_matches_reference_hlo_census(vlm):
    """Every (variant, bucket) the reference's census met on the paged
    workload, the port's observed run met too, and the port's analytic
    matmul and head FLOPs (the cross layers' MLPs; their projections and
    attention are the reference's ``attention`` class, their image K/V
    projection its ``other``) are its HLO census's within 0.1%."""
    jeng, jreqs = _reference(vlm, "paged")
    obs = Observability(hw=H100_SXM5_80GB, strict_census=True)
    eng, reqs = _serve(vlm, obs=obs)
    assert _tokens(reqs) == _tokens(jreqs)
    jcensus = jeng.obs.census
    want = {(v, tuple(key)): sc for (v, _, key), sc in
            jcensus._cache.items()}
    assert not jcensus.errors and want
    assert set(obs.census._cache) == set(want)
    for (variant, key), jsc in want.items():
        port = C.step_census(eng.cfg, variant, key, ENGINE["block_size"])
        for cls in ("matmul", "head"):
            ref = jsc.census.per_class.get(cls, C.ClassCost()).flops
            assert port.per_class[cls].flops == pytest.approx(
                ref, rel=1e-3), (variant, key, cls)
        assert port.per_class["attention"].flops > 0
