"""The port's MoE family against the JAX reference on the CPU: the router
and the capacity dispatch (slot and keep exactly equal, with drops at the
decode and the prefill capacity), ``moe_ffn`` with and without the dense
residual branch and past the token chunk, the tie rule of the top-k, the
model's prefill and decode logits, and the engine's tokens on reduced
``olmoe-1b-7b`` at its own 64 experts (paged and gather, sync and
overlapped, a non-power-of-two batch, a preempting pool), where capacity
drops occur in both prefill and decode."""
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
from repro.kvcache.prefix import \
    prefix_cache_supported as j_prefix_supported  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Observability as JObservability  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import census as C  # noqa: E402
from repro_torch.core.hardware import H100_SXM5_80GB  # noqa: E402
from repro_torch.kvcache.paged import PagedKVCache  # noqa: E402
from repro_torch.kvcache.prefix import prefix_cache_supported  # noqa: E402
from repro_torch.kvcache.view import PagedCacheView  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving.obs.observer import Observability  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, sharegpt_like)

CPU = torch.device("cpu")
ATOL = 1e-5          # float32, module level (the reference's)
LOGIT_ATOL = 1e-4    # float32 logits
# olmoe at its own 64 experts, top 8, 5 layers
OLMOE = dict(max_experts=64, d_ff=64, n_layers=5)


def _cfgs(name, **kw):
    return j_reduced(j_get_config(name), **kw), reduced(get_config(name),
                                                        **kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-5,
                               atol=atol)


_PARAMS = {}


def _moe_params(jcfg, tcfg):
    """The reference's weights for a config (numpy) and the port's copy,
    drawn once a module."""
    if tcfg not in _PARAMS:
        jp = jax.tree.map(np.asarray,
                          JM.init_params(jcfg, jax.random.PRNGKey(0)))
        _PARAMS[tcfg] = jp, params_from_numpy(tcfg, jp, device=CPU)
    return _PARAMS[tcfg]


def _first_ffn(tree):
    return tree["stack"][0]["ffn"]


def _layer0(tree):
    """The first layer's FFN leaves of a stacked tree."""
    return jax.tree.map(lambda a: a[0], _first_ffn(tree))


# --------------------------------------------------------- routing ----
@pytest.mark.parametrize("cf,T", [(2.0, 4), (2.0, 16), (1.25, 32)],
                         ids=["decode_T4", "decode_T16", "prefill_T32"])
def test_route_and_dispatch_match_reference(cf, T):
    """At olmoe's own 64 experts and top 8, the router's probabilities and
    weights to 1e-5, its expert ids exactly, and the dispatch's slot and
    keep exactly equal; assignments past the capacity are dropped at the
    decode factor and at the prefill factor."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b", **OLMOE)
    rng = np.random.default_rng(T)
    d, E, k = tcfg.d_model, tcfg.moe.num_experts, tcfg.moe.top_k
    x = rng.normal(size=(T, d)).astype(np.float32)
    router = (rng.normal(size=(d, E)) / np.sqrt(d)).astype(np.float32)
    jp, jw, ji = JMOE._route(jnp.asarray(x), jnp.asarray(router), k)
    tp, tw, ti = TMOE._route(_t(x), _t(router), k)
    _close(tp, jp)
    _close(tw, jw)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    C = TMOE.capacity(cf, k, T, E)
    assert C == max(1, int(np.ceil(cf * k * T / E)))
    js, jk = JMOE._dispatch_indices(jnp.asarray(ji), E, C)
    ts, tk = TMOE._dispatch_indices(ti, E, C)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert not tk.all(), "the case was meant to drop assignments"


def test_topk_ties_break_to_the_lower_expert():
    """``lax.top_k`` keeps the lower index among equal values; the port's
    stable sort does too: all-equal probabilities (a zero router) and
    pairwise ties pick the same experts in the same order."""
    k, E = 3, 8
    x = np.ones((3, 4), np.float32)
    pairs = np.tile((np.arange(E) // 2 * 0.1).astype(np.float32), (4, 1))
    for router in (np.zeros((4, E), np.float32), pairs):
        _, _, ji = JMOE._route(jnp.asarray(x), jnp.asarray(router), k)
        _, _, ti = TMOE._route(_t(x), _t(router), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji))


# ----------------------------------------------------------- moe_ffn ----
@pytest.mark.parametrize("name,kw,shape,cf", [
    ("olmoe-1b-7b", OLMOE, (2, 9), 1.25),
    ("olmoe-1b-7b", OLMOE, (4, 1), 2.0),
    ("arctic-480b", {}, (2, 7), 1.25),
], ids=["olmoe_prefill", "olmoe_decode", "arctic_dense_residual"])
def test_moe_ffn_matches_reference(rules, name, kw, shape, cf):
    """``moe_ffn`` on the reference's weights: olmoe's routed experts at
    the prefill and decode capacity, and arctic's dense-residual branch
    beside its experts."""
    jcfg, tcfg = _cfgs(name, **kw)
    jp, tp = _moe_params(jcfg, tcfg)
    if tcfg.moe.dense_residual:
        assert "dense" in _first_ffn(tp)
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape + (tcfg.d_model,)).astype(np.float32)
    want, _ = JMOE.moe_ffn(_layer0(jp), jnp.asarray(x), jcfg, rules,
                           capacity_factor=cf)
    got = TMOE.moe_ffn(jax.tree.map(lambda a: a[0], _first_ffn(tp)),
                       _t(x), tcfg, capacity_factor=cf)
    _close(got, want)


def test_moe_ffn_past_the_token_chunk(rules):
    """More rows than ``MOE_TOKEN_CHUNK`` at a narrow width: the rows go
    in two chunks, each with its own capacity, as in the reference."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b", d_model=32, d_ff=16, n_heads=2)
    T = 2 * TMOE.MOE_TOKEN_CHUNK
    assert TMOE.token_chunks(T) == 2
    assert TMOE.MOE_TOKEN_CHUNK == JMOE.MOE_TOKEN_CHUNK
    jp, tp = _moe_params(jcfg, tcfg)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, T // 2, tcfg.d_model)).astype(np.float32)
    want, _ = JMOE.moe_ffn(_layer0(jp), jnp.asarray(x), jcfg, rules,
                           capacity_factor=1.25)
    got = TMOE.moe_ffn(jax.tree.map(lambda a: a[0], _first_ffn(tp)),
                       _t(x), tcfg, capacity_factor=1.25)
    _close(got, want)


# ------------------------------------------------------------- model ----
def test_model_prefill_and_decode_match_reference(rules):
    """Reduced olmoe at 64 experts: prefill logits and K/V, then three
    decode steps on the dense cache (the serve capacity factor), within
    the reference's float32 logit tolerance; and the paged decode step on
    a pool holding the same K/V, its batch padded to 4 (the padding row
    routes last, so it displaces no live row), equal to the dense one."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b", **OLMOE)
    jp, tp = _moe_params(jcfg, tcfg)
    model = Model(tcfg, tp, device=CPU)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, size=(3, 16)).astype(np.int32)
    lens = np.array([16, 11, 5], np.int32)
    jl, jc, _ = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lens)},
                           cache_len=24)
    tl, tc = model.prefill(_t(toks), _t(lens), cache_len=24)
    _close(tl, jl, LOGIT_ATOL)
    _close(tc["k"], jc["stack"][0]["k"])
    BS, nb = 8, 3
    pool = PagedKVCache(tcfg, num_blocks=9, block_size=BS, device=CPU)
    for name in ("k", "v"):
        pool.pool[name][:, :9] = tc[name].reshape(
            tcfg.n_layers, 9, BS, *tc[name].shape[3:])
    tables = torch.cat([torch.arange(9, dtype=torch.int32).reshape(3, nb),
                        torch.full((1, nb), 9, dtype=torch.int32)])
    pos = lens.copy()
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, jc = JM.decode_step(jp, jcfg, rules, jc, jnp.asarray(nxt),
                                jnp.asarray(pos), lengths=jnp.asarray(pos + 1))
        tl = model.decode_step(_t(nxt), tc, _t(pos), lengths=_t(pos + 1))
        _close(tl, jl, LOGIT_ATOL)
        view = PagedCacheView(pool.pool, tables, _t(np.r_[pos + 1, 0]),
                              _t(np.r_[pos, 0]), BS)
        _close(model.decode_step(_t(np.r_[nxt, 0]), view)[:3], tl,
               LOGIT_ATOL)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1


# ------------------------------------------------------------ engine ----
# a batch of 3 (a paged step pads it to 4) in a pool of 24 blocks that
# holds the first workload's requests and preempts the second's
ENGINE = dict(max_batch=3, block_size=8, kv_pool_tokens=192,
              max_model_len=96, prefill_bucket=16)
WORKLOAD = dict(seed=11, mean_in=20, mean_out=30, max_len=60, sigma=0.3)
PREEMPTING = dict(seed=11, mean_in=30, mean_out=60, max_len=90, sigma=0.3)
N_REQ = 6


@pytest.fixture(scope="module")
def olmoe(rules):
    jcfg, tcfg = _cfgs("olmoe-1b-7b", **OLMOE)
    jp, tp = _moe_params(jcfg, tcfg)
    jmodel = JM.Model(jcfg, rules)
    return (jmodel, jp, JStepFunctions.build(jmodel, ENGINE["block_size"]),
            Model(tcfg, tp, device=CPU), {})


def _reference(models, mode, preempting=False):
    """The reference engine's sync run in ``mode`` (memoised a module)."""
    jmodel, jp, steps, _, memo = models
    key = (mode, preempting)
    if key not in memo:
        reqs = j_sharegpt_like(N_REQ, jmodel.cfg.vocab_size,
                               **(PREEMPTING if preempting else WORKLOAD))
        eng = JEngine(jmodel, jp, JEngineConfig(decode_mode=mode, **ENGINE),
                      steps=steps)
        if key == ("paged", False) or key == ("paged", "plain", ()):
            # the reference's HLO census of every bucket the run meets
            JObservability().attach(eng)
        eng.run(reqs)
        memo[key] = (eng, reqs)
    return memo[key]


def _tokens(reqs):
    return [(list(map(int, r.output_tokens)), r.finish_reason)
            for r in reqs]


def _serve_counting_drops(models, monkeypatch, workload=WORKLOAD, **kw):
    """The port's run of the workload, with the assignments its dispatch
    dropped counted in prefill (rows of a prompt bucket) and in decode."""
    drops = {"prefill": 0, "decode": 0}
    inner = TMOE._dispatch_indices

    def counting(idx, E, C):
        slot, keep = inner(idx, E, C)
        kind = "decode" if idx.shape[0] <= ENGINE["max_batch"] + 1 \
            else "prefill"
        drops[kind] += int((~keep).sum())
        return slot, keep

    monkeypatch.setattr(TMOE, "_dispatch_indices", counting)
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**ENGINE, **kw),
                                   device="cpu")
    reqs = sharegpt_like(N_REQ, eng.cfg.vocab_size, **workload)
    eng.run(reqs)
    assert eng.pool.manager.free_blocks == eng.pool.manager.num_blocks
    return eng, reqs, drops


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("mode", ["paged", "gather"])
def test_engine_matches_reference(olmoe, monkeypatch, mode, overlap):
    """The port's engine gives the reference engine's tokens and finish
    reasons mode by mode (overlapped against the reference's sync loop,
    whose batches it keeps), at a batch of 3; the dispatch drops
    assignments both in prefill and in decode."""
    _, jreqs = _reference(olmoe, mode)
    _, reqs, drops = _serve_counting_drops(
        olmoe, monkeypatch, decode_mode=mode, overlap=overlap)
    assert _tokens(reqs) == _tokens(jreqs)
    assert drops["prefill"] > 0 and drops["decode"] > 0, drops


@pytest.mark.parametrize("mode", ["paged", "gather"])
def test_preempting_engine_matches_reference(olmoe, monkeypatch, mode):
    """A pool that preempts: the same preemptions and tokens as the
    reference's sync loop. (Overlapped, the executor preempts at other
    steps than the sync loop, so its batches, and with them an MoE
    step's capacity and drops, differ: its tokens are held above, on a
    workload that does not preempt.)"""
    jeng, jreqs = _reference(olmoe, mode, preempting=True)
    eng, reqs, drops = _serve_counting_drops(
        olmoe, monkeypatch, PREEMPTING, decode_mode=mode)
    assert _tokens(reqs) == _tokens(jreqs)
    assert eng.preemptions == jeng.preemptions > 0
    assert drops["decode"] > 0


def test_disabled_reasons_match_reference(olmoe):
    """Prefix cache, chunked prefill and speculation fall back with the
    reference's reasons; the pool's byte counts are the reference's."""
    jmodel, jp, steps, tmodel, _ = olmoe
    kw = dict(ENGINE, prefix_cache=True, prefill_chunk_tokens=16,
              speculate=True)
    jeng = JEngine(jmodel, jp, JEngineConfig(**kw), steps=steps)
    eng = ContinuousBatchingEngine(tmodel, EngineConfig(**kw), device="cpu")
    assert prefix_cache_supported(eng.cfg) == j_prefix_supported(jmodel.cfg)
    for attr in ("prefix_disabled_reason", "chunking_disabled_reason",
                 "spec_disabled_reason"):
        assert getattr(eng, attr) == getattr(jeng, attr) is not None
    assert (eng.prefix, eng.chunking, eng.speculator) == (None, False, None)
    for attr in ("block_bytes", "pool_bytes", "dense_state_bytes"):
        assert getattr(eng.pool, attr) == getattr(jeng.pool, attr)
    assert eng.pool.state_names == () and eng.pool.free_slots == 0


def test_paged_and_gather_part_once_drops_occur(olmoe):
    """The reference's paged and gather runs (their capacities differ:
    the paged step counts its padding rows) are each held by the tests
    above; where they part, the port parts the same way."""
    same_ref = _tokens(_reference(olmoe, "paged")[1]) == \
        _tokens(_reference(olmoe, "gather")[1])
    outs = {}
    for mode in ("paged", "gather"):
        eng = ContinuousBatchingEngine(
            olmoe[3], EngineConfig(decode_mode=mode, **ENGINE), device="cpu")
        reqs = sharegpt_like(N_REQ, eng.cfg.vocab_size, **WORKLOAD)
        eng.run(reqs)
        outs[mode] = _tokens(reqs)
    assert (outs["paged"] == outs["gather"]) == same_ref


def test_capacity_of_a_paged_bucket_counts_its_padding():
    """A paged step of 3 rows is padded to 4, and its capacity is the
    bucket's; the gather step's is its own rows' (here both 1 at 64
    experts, top 8: any shared expert drops)."""
    cfg = reduced(get_config("olmoe-1b-7b"), **OLMOE)
    k, E = cfg.moe.top_k, cfg.moe.num_experts
    f = cfg.serve_capacity_factor
    assert TMOE.capacity(f, k, 4, E) == 1 and TMOE.capacity(f, k, 3, E) == 1
    assert TMOE.capacity(f, k, 16, E) == 4
    assert TMOE.capacity(cfg.moe.capacity_factor, k, 32, E) == 5


def test_census_matches_reference_hlo_census(olmoe):
    """Every (variant, bucket) the reference's census met on the paged
    workload, the port's observed run met too, and the port's analytic
    matmul and head FLOPs (the expert GEMMs over every expert's
    capacity rows, the shared block's, none for the SSM mixer, which the
    reference files under its own class) are its HLO census's within
    0.1%."""
    jeng, jreqs = _reference(olmoe, "paged")
    eng = ContinuousBatchingEngine(olmoe[3], EngineConfig(**ENGINE),
                                   device="cpu")
    obs = Observability(hw=H100_SXM5_80GB, strict_census=True)
    obs.attach(eng)
    reqs = sharegpt_like(N_REQ, eng.cfg.vocab_size, **WORKLOAD)
    eng.run(reqs)
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
