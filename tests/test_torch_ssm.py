"""The port's SSM (Mamba2) and hybrid families against the JAX reference
on the CPU: the SSD scan, the full-sequence mixer (a length not a
multiple of the chunk, one shorter than the conv tail, a continuation
from a state), the single-token step, the model's prefill and decode
logits for reduced ``mamba2-1.3b`` and ``zamba2-7b`` at 5 layers (a
stacked period, a remainder, the shared attention block), the paged
decode step against the dense one, the pool's state slots and byte
counts, and the engine's tokens (paged and gather, sync and overlapped,
a batch of 3, a preempting pool, a co-located cluster of two), with the
reference's padded-prefill state quirk kept."""
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
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.kernels.decode_attention import \
    gqa_decode_attention as j_decode  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro.kernels.paged_decode_attention import \
    paged_gqa_decode_attention as j_paged  # noqa: E402
from repro.models.layers import \
    gated_rmsnorm_apply as j_gated_rmsnorm  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Observability as JObservability  # noqa: E402
from repro.serving import ReplicatedCluster as JCluster  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import census as C  # noqa: E402
from repro_torch.core.hardware import H100_SXM5_80GB  # noqa: E402
from repro_torch.kernels import decode_attention as TDEC  # noqa: E402
from repro_torch.kernels import flash_attention as TFLASH  # noqa: E402
from repro_torch.kernels import paged_decode_attention as TPAGED  # noqa: E402
from repro_torch.kvcache.paged import PagedKVCache  # noqa: E402
from repro_torch.kvcache.view import PagedCacheView  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.layers import gated_rmsnorm_apply  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (cache_from_numpy,  # noqa: E402
                                       params_from_numpy, ssm_dims)
from repro_torch.serving.obs.observer import Observability  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, ReplicatedCluster,
                                 sharegpt_like)

CPU = torch.device("cpu")
ATOL = 1e-5          # float32, module level (the reference's)
LOGIT_ATOL = 1e-4    # float32 logits
FAMILIES = {"mamba2-1.3b": dict(n_layers=5),
            "zamba2-7b": dict(n_layers=5)}     # attn_every 2 when reduced


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


def _params(jcfg, tcfg):
    """The reference's weights (numpy) and the port's copy, once a
    module."""
    if tcfg not in _PARAMS:
        jp = jax.tree.map(np.asarray,
                          JM.init_params(jcfg, jax.random.PRNGKey(0)))
        _PARAMS[tcfg] = jp, params_from_numpy(tcfg, jp, device=CPU)
    return _PARAMS[tcfg]


def _ssm_leaves(tree):
    """The first SSM layer's mixer leaves (stack slot 0, period 0)."""
    return jax.tree.map(lambda a: a[0], tree["stack"][0]["ssm"])


# ------------------------------------------------------------ modules ----
def test_gated_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x, z = (rng.normal(size=(2, 3, 64)).astype(np.float32) for _ in "xz")
    scale = rng.normal(size=64).astype(np.float32)
    _close(gated_rmsnorm_apply(_t(scale), _t(x), _t(z)),
           j_gated_rmsnorm(jnp.asarray(scale), jnp.asarray(x),
                           jnp.asarray(z)))


@pytest.mark.parametrize("S,with_h0", [(45, False), (64, True), (7, False)],
                         ids=["ragged_chunks", "two_chunks_h0", "one_short"])
def test_ssd_chunked_matches_reference(rules, S, with_h0):
    """The chunked scan (chunk 32 when reduced): the output and the final
    state, over a length that pads its last chunk, two whole chunks from
    a given state, and a length shorter than one chunk."""
    jcfg, tcfg = _cfgs("mamba2-1.3b")
    rng = np.random.default_rng(S)
    H, P, G, N = 8, 16, 1, 16
    xs = rng.normal(size=(2, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(2, S, H)).astype(np.float32)
    A = -rng.uniform(1, 4, size=H).astype(np.float32)
    B_, C_ = (rng.normal(size=(2, S, G, N)).astype(np.float32)
              for _ in "BC")
    h0 = rng.normal(size=(2, H, P, N)).astype(np.float32) if with_h0 \
        else None
    jy, jh = JSSM.ssd_chunked(*map(jnp.asarray, (xs, dt, A, B_, C_)), jcfg,
                              rules, h0=None if h0 is None else
                              jnp.asarray(h0))
    ty, th = TSSM.ssd_chunked(*map(_t, (xs, dt, A, B_, C_)), tcfg,
                              h0=None if h0 is None else _t(h0))
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("S,cont", [(45, False), (2, False), (19, True)],
                         ids=["ragged_chunks", "shorter_than_conv_tail",
                              "from_h0_and_conv0"])
def test_ssm_seq_matches_reference(rules, S, cont):
    """The full-sequence mixer on the reference's weights: its output,
    final state and conv tail (zero-padded on the left when ``S`` is
    shorter than ``W - 1``), and a continuation from ``h0`` / ``conv0``."""
    jcfg, tcfg = _cfgs("mamba2-1.3b")
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, tcfg.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if cont:
        _, nh, conv_ch = ssm_dims(tcfg)
        s = tcfg.ssm
        h0 = rng.normal(size=(2, nh, s.head_dim, s.d_state)).astype(
            np.float32)
        conv0 = rng.normal(size=(2, s.conv_width - 1, conv_ch)).astype(
            np.float32)
        kw_j = dict(h0=jnp.asarray(h0), conv0=jnp.asarray(conv0))
        kw_t = dict(h0=_t(h0), conv0=_t(conv0))
    jo, jc = JSSM.ssm_seq(_ssm_leaves(jp), jnp.asarray(x), jcfg, rules,
                          **kw_j)
    to, tc = TSSM.ssm_seq(jax.tree.map(lambda a: a[0],
                                       tp["stack"][0]["ssm"]),
                          _t(x), tcfg, **kw_t)
    _close(to, jo)
    for name in ("h", "conv"):
        _close(tc[name], jc[name])


def test_ssm_decode_matches_reference(rules):
    jcfg, tcfg = _cfgs("mamba2-1.3b")
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    _, nh, conv_ch = ssm_dims(tcfg)
    s = tcfg.ssm
    x = rng.normal(size=(3, 1, tcfg.d_model)).astype(np.float32)
    state = {"h": rng.normal(size=(3, nh, s.head_dim, s.d_state)).astype(
                 np.float32),
             "conv": rng.normal(size=(3, s.conv_width - 1, conv_ch)).astype(
                 np.float32)}
    jo, jc = JSSM.ssm_decode(_ssm_leaves(jp), jnp.asarray(x),
                             jax.tree.map(jnp.asarray, state), jcfg, rules)
    to, tc = TSSM.ssm_decode(jax.tree.map(lambda a: a[0],
                                          tp["stack"][0]["ssm"]),
                             _t(x), {k: _t(v) for k, v in state.items()},
                             tcfg)
    _close(to, jo)
    for name in ("h", "conv"):
        _close(tc[name], jc[name])


# ------------------------------------------------------ head dim 112 ----
def test_kernels_take_zamba2s_head_dim():
    """zamba2's head dim, 3584 / 32 = 112, is in every kernel's head dims
    and passes each wrapper's argument checks (a CUDA tensor of another
    head dim raises there, before any build)."""
    assert get_config("zamba2-7b").hd == 112
    for mod in (TDEC, TFLASH):
        assert 112 in mod.KERNEL_HEAD_DIMS
    q = torch.zeros(2, 32, 112)
    pool = torch.zeros(4, 16, 32, 112)
    lens = torch.ones(2, dtype=torch.int32)
    TPAGED._check_args(q, pool, pool, torch.zeros(2, 2, dtype=torch.int32),
                       lens)
    TDEC._check_args(q, pool[:2], pool[:2], lens)
    TFLASH._check_args(torch.zeros(1, 8, 4, 112), torch.zeros(1, 8, 2, 112),
                       torch.zeros(1, 8, 2, 112))


def test_plain_kernels_at_head_dim_112_match_the_tpu_kernels():
    """The three kernels' plain versions (what a CPU tensor runs) at head
    dim 112 against the TPU kernels in interpret mode, float32, at the
    reference's kernel tolerance."""
    rng = np.random.default_rng(112)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    B, K, G, hd, BS, nb = 2, 2, 2, 112, 8, 3
    q, kp, vp = f(B, K * G, hd), f(B * nb + 1, BS, K, hd), \
        f(B * nb + 1, BS, K, hd)
    table = np.arange(B * nb, dtype=np.int32).reshape(B, nb)
    lens = np.array([nb * BS, 5], np.int32)
    np.testing.assert_allclose(
        TPAGED.paged_gqa_decode_attention_torch(*map(_t, (q, kp, vp, table,
                                                          lens))),
        j_paged(*map(jnp.asarray, (q, kp, vp, table, lens)),
                interpret=True), atol=1e-4, rtol=1e-4)
    k, v = f(B, 40, K, hd), f(B, 40, K, hd)
    lens = np.array([40, 17], np.int32)
    np.testing.assert_allclose(
        TDEC.gqa_decode_attention_torch(*map(_t, (q, k, v, lens))),
        j_decode(*map(jnp.asarray, (q, k, v, lens)), interpret=True),
        atol=1e-4, rtol=1e-4)
    qs = f(1, 24, K * G, hd)
    ks, vs = f(1, 24, K, hd), f(1, 24, K, hd)
    np.testing.assert_allclose(
        TFLASH.flash_attention_torch(*map(_t, (qs, ks, vs))),
        j_flash(*map(jnp.asarray, (qs, ks, vs)), interpret=True),
        atol=1e-4, rtol=1e-4)


# -------------------------------------------------------------- model ----
@pytest.mark.parametrize("name", list(FAMILIES))
def test_model_prefill_decode_and_paged_match_reference(rules, name):
    """Prefill logits and cache (K/V of the shared block's occurrences,
    each SSM layer's state), three decode steps on the dense cache, and
    the paged decode step on a pool holding the same cache (state in its
    slots, the trash slot for a padding row) equal to the dense one."""
    jcfg, tcfg = _cfgs(name, **FAMILIES[name])
    jp, tp = _params(jcfg, tcfg)
    model = Model(tcfg, tp, device=CPU)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, size=(3, 16)).astype(np.int32)
    lens = np.array([16, 11, 5], np.int32)
    jl, jc, _ = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lens)},
                           cache_len=32)
    tl, tc = model.prefill(_t(toks), _t(lens), cache_len=32)
    _close(tl, jl, LOGIT_ATOL)
    want = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc))
    assert set(tc) == set(want)
    for k in tc:
        _close(tc[k], want[k])
    # a pool of the same rows: request i in blocks [4i, 4i+4), slot 2 - i
    BS, nb = 8, 4
    pool = PagedKVCache(tcfg, num_blocks=16, block_size=BS, device=CPU,
                        max_batch=3)
    for name_ in pool.kv_names:
        pool.pool[name_][:, :12] = tc[name_].reshape(
            tc[name_].shape[0], 12, BS, *tc[name_].shape[3:])
    for name_ in pool.state_names:
        pool.pool[name_][:, [2, 1, 0]] = tc[name_]
    pos = lens.copy()
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    tables = torch.arange(12, dtype=torch.int32).reshape(3, nb)
    tables = torch.cat([tables, torch.full((1, nb), 16, dtype=torch.int32)])
    for _ in range(3):
        jl, jc = JM.decode_step(jp, jcfg, rules, jc, jnp.asarray(nxt),
                                jnp.asarray(pos), lengths=jnp.asarray(pos + 1))
        dense = model.decode_step(_t(nxt), tc, _t(pos), lengths=_t(pos + 1))
        _close(dense, jl, LOGIT_ATOL)
        view = PagedCacheView(pool.pool, tables, _t(np.r_[pos + 1, 0]),
                              _t(np.r_[pos, 0]), BS,
                              torch.tensor([2, 1, 0, 3], dtype=torch.int32))
        paged = model.decode_step(_t(np.r_[nxt, 0]), view)[:3]
        _close(paged, dense, LOGIT_ATOL)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1


# ------------------------------------------------------------- engine ----
# a batch of 3 (a paged step pads it to 4) in a pool of 24 blocks that
# holds the first workload's requests and preempts the second's
ENGINE = dict(max_batch=3, block_size=8, kv_pool_tokens=192,
              max_model_len=96, prefill_bucket=16)
WORKLOAD = dict(seed=11, mean_in=20, mean_out=30, max_len=60, sigma=0.3)
PREEMPTING = dict(seed=11, mean_in=30, mean_out=60, max_len=90, sigma=0.3)
N_REQ = 6


_MODELS = {}


def _models(name, rules):
    """(reference model, its weights, its shared StepFunctions, the
    port's model, the reference runs' memo) of a family, once a module."""
    if name not in _MODELS:
        jcfg, tcfg = _cfgs(name, **FAMILIES[name])
        jp, tp = _params(jcfg, tcfg)
        jmodel = JM.Model(jcfg, rules)
        _MODELS[name] = (jmodel, jp,
                         JStepFunctions.build(jmodel, ENGINE["block_size"]),
                         Model(tcfg, tp, device=CPU), {})
    return _MODELS[name]


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request, rules):
    return _models(request.param, rules)


def _reference(models, mode, workload="plain", **kw):
    """The reference engine's sync run (memoised a module)."""
    jmodel, jp, steps, _, memo = models
    kw = {k: v for k, v in kw.items() if ENGINE.get(k) != v}
    key = (mode, workload, tuple(sorted(kw.items())))
    if key not in memo:
        wl = PREEMPTING if workload == "preempting" else WORKLOAD
        reqs = j_sharegpt_like(N_REQ, jmodel.cfg.vocab_size, **wl)
        eng = JEngine(jmodel, jp, JEngineConfig(
            decode_mode=mode, **{**ENGINE, **kw}), steps=steps)
        if key == ("paged", False) or key == ("paged", "plain", ()):
            # the reference's HLO census of every bucket the run meets
            JObservability().attach(eng)
        eng.run(reqs)
        memo[key] = (eng, reqs)
    return memo[key]


def _serve(models, workload="plain", **kw):
    wl = PREEMPTING if workload == "preempting" else WORKLOAD
    eng = ContinuousBatchingEngine(models[3], EngineConfig(**{**ENGINE,
                                                              **kw}),
                                   device="cpu")
    reqs = sharegpt_like(N_REQ, eng.cfg.vocab_size, **wl)
    eng.run(reqs)
    pool = eng.pool
    assert pool.manager.free_blocks == pool.manager.num_blocks
    assert pool.free_slots == eng.ecfg.max_batch and not pool._slots
    return eng, reqs


def _tokens(reqs):
    return [(list(map(int, r.output_tokens)), r.finish_reason)
            for r in reqs]


@pytest.mark.parametrize("mode,workload,overlap", [
    ("paged", "plain", False), ("paged", "plain", True),
    ("gather", "plain", False), ("gather", "plain", True),
    ("paged", "preempting", False), ("paged", "preempting", True)],
    ids=["paged-sync", "paged-overlap", "gather-sync", "gather-overlap",
         "paged-preempting-sync", "paged-preempting-overlap"])
def test_engine_matches_reference(family, mode, workload, overlap):
    """The port's engine gives the reference engine's tokens and finish
    reasons mode by mode, synchronous and overlapped (against the
    reference's sync loop), at a batch of 3, in a pool that holds the
    workload and in one that preempts (as often as the reference's, in
    sync mode); every block and every state slot comes home."""
    jeng, jreqs = _reference(family, mode, workload)
    eng, reqs = _serve(family, workload, decode_mode=mode, overlap=overlap)
    assert _tokens(reqs) == _tokens(jreqs)
    if workload == "preempting":
        assert eng.preemptions > 0
        if not overlap:
            assert eng.preemptions == jeng.preemptions


def test_padded_prefill_state_quirk(rules):
    """The state after a serial prefill has scanned the prefill bucket's
    padding rows (the reference's ``ssm_seq`` takes no lengths): the
    same mamba2 requests served at ``prefill_bucket`` 16 and 64 give
    other tokens in both engines, and each engine's tokens are the
    other's at each bucket."""
    models = _models("mamba2-1.3b", rules)
    runs = {}
    for b in (16, 64):
        _, jreqs = _reference(models, "paged", prefill_bucket=b)
        _, reqs = _serve(models, prefill_bucket=b)
        assert _tokens(reqs) == _tokens(jreqs)
        runs[b] = _tokens(reqs)
    assert runs[16] != runs[64]


def test_disabled_reasons_and_pool_bytes_match_reference(family):
    jmodel, jp, steps, tmodel, _ = family
    kw = dict(ENGINE, prefix_cache=True, prefill_chunk_tokens=16,
              speculate=True)
    jeng = JEngine(jmodel, jp, JEngineConfig(**kw), steps=steps)
    eng = ContinuousBatchingEngine(tmodel, EngineConfig(**kw), device="cpu")
    for attr in ("prefix_disabled_reason", "chunking_disabled_reason",
                 "spec_disabled_reason"):
        assert getattr(eng, attr) == getattr(jeng, attr) is not None
    for attr in ("block_bytes", "pool_bytes", "dense_state_bytes",
                 "trash_slot"):
        assert getattr(eng.pool, attr) == getattr(jeng.pool, attr)
    jpool = JPagedKVCache(jmodel.cfg, num_blocks=7, block_size=16,
                          max_batch=5)
    pool = PagedKVCache(tmodel.cfg, num_blocks=7, block_size=16,
                        device=CPU, max_batch=5)
    assert (pool.block_bytes, pool.dense_state_bytes) == \
        (jpool.block_bytes, jpool.dense_state_bytes) != (0, 0)
    with pytest.raises(ValueError, match="max_batch"):
        PagedKVCache(tmodel.cfg, num_blocks=7, block_size=16, device=CPU)


def test_slots_come_home(family):
    """A slot is taken at prefill and returned with the blocks on finish,
    abort, eviction and preemption; a reset frees them all."""
    eng = ContinuousBatchingEngine(family[3], EngineConfig(**ENGINE),
                                   device="cpu")
    pool = eng.pool
    reqs = sharegpt_like(N_REQ, eng.cfg.vocab_size, **PREEMPTING)
    for r in reqs:
        eng.add_request(r)
    held, now = [], 0.0
    while len(eng.running) < 3:
        eng.step(now)
        now += 0.01
    held = [r.req_id for r in eng.running]
    assert sorted(pool._slots) == sorted(held) and pool.free_slots == 0
    assert len(set(pool._slots.values())) == 3
    eng.abort(held[0], now)
    assert held[0] not in pool._slots and pool.free_slots == 1
    eng.evict_request(held[1], now)
    assert held[1] not in pool._slots
    preempted = 0
    while eng.busy:
        eng.step(now)
        now += 0.01
        if eng.preemptions > preempted:
            preempted = eng.preemptions
            waiting = {r.req_id for r in eng.waiting}
            assert not waiting & set(pool._slots)
        assert set(pool._slots) <= {r.req_id for r in eng.running}
    assert preempted > 0
    assert pool.free_slots == 3 and not pool._slots
    pool._slot(99)
    pool.reset()
    assert pool.free_slots == 3 and not pool._slots


def test_colocated_cluster_matches_reference(rules):
    """Two co-located mamba2 replicas, round robin, sync: the reference
    cluster's tokens, every state slot home."""
    jmodel, jp, steps, tmodel, memo = _models("mamba2-1.3b", rules)
    if "cluster" not in memo:
        engines = [JEngine(jmodel, jp, JEngineConfig(**ENGINE), steps=steps)
                   for _ in range(2)]
        reqs = j_sharegpt_like(N_REQ, jmodel.cfg.vocab_size, **WORKLOAD)
        JCluster(engines, policy="round-robin", mode="sync").run(reqs)
        memo["cluster"] = reqs
    engines = [ContinuousBatchingEngine(tmodel, EngineConfig(**ENGINE),
                                        device="cpu") for _ in range(2)]
    reqs = sharegpt_like(N_REQ, tmodel.cfg.vocab_size, **WORKLOAD)
    m = ReplicatedCluster(engines, policy="round-robin", mode="sync").run(
        reqs)
    assert _tokens(reqs) == _tokens(memo["cluster"])
    assert m.completed == N_REQ
    for e in engines:
        assert e.pool.free_slots == 3


def test_census_matches_reference_hlo_census(family):
    """Every (variant, bucket) the reference's census met on the paged
    workload, the port's observed run met too, and the port's analytic
    matmul and head FLOPs (the expert GEMMs over every expert's
    capacity rows, the shared block's, none for the SSM mixer, which the
    reference files under its own class) are its HLO census's within
    0.1%."""
    jeng, jreqs = _reference(family, "paged")
    eng = ContinuousBatchingEngine(family[3], EngineConfig(**ENGINE),
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
