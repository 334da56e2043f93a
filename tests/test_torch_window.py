"""The port's sliding-window ring decode against the JAX reference on the
CPU, on reduced ``internlm2-1.8b`` (RoPE, GQA) with a window of 16: the
prefill's ring layout (prompts shorter than, equal to and longer than
the window; a longer prompt's ring keeps its padded bucket's last ``W``
rows, the reference's quirk), ``init_cache``'s ring, greedy decode at one
position for the batch across a wrap (logits within 1e-4, tokens
equal), lengths before a wrap, the refusals (ragged positions, which the
reference asserts against; lengths after a wrap), and the engine's
refusal, with the reason the reference's engine fails for."""
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
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (cache_from_numpy,  # noqa: E402
                                       params_from_numpy)
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig)

CPU = torch.device("cpu")
ATOL = 1e-5          # float32 K/V (the reference's module tolerance)
LOGIT_ATOL = 1e-4    # float32 logits
NAME = "internlm2-1.8b"
W = 16
ENGINE = dict(max_batch=2, block_size=8, kv_pool_tokens=256,
              max_model_len=64, prefill_bucket=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-5,
                               atol=atol)


_MODELS = {}


def _models(window=W):
    """The reference config and weights (numpy), and the port's model on
    the same weights, with ``sliding_window = window``, once a module."""
    if window not in _MODELS:
        jcfg = dataclasses.replace(j_reduced(j_get_config(NAME)),
                                   sliding_window=window)
        tcfg = dataclasses.replace(reduced(get_config(NAME)),
                                   sliding_window=window)
        jp = jax.tree.map(np.asarray,
                          JM.init_params(jcfg, jax.random.PRNGKey(0)))
        _MODELS[window] = (jcfg, jp, Model(
            tcfg, params_from_numpy(tcfg, jp, device=CPU), device=CPU))
    return _MODELS[window]


def _prompts(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("S,cache_len,slots", [
    (10, 40, W), (10, 12, 12), (16, 40, W), (24, 40, W), (37, None, W)],
    ids=["short", "short-cache", "equal", "longer", "wraps-twice"])
def test_prefill_ring_layout(rules, S, cache_len, slots):
    """The prefill's K/V in its decode layout equal the reference's
    (``_finalize_prefill_cache``): a prompt within the window padded to
    ``min(cache_len, W)`` slots, a longer one a ring of ``W`` slots with
    row ``t`` at slot ``t % W`` (checked by hand on the first layer's K,
    which the window does not touch, against a prefill without one)."""
    jcfg, jp, model = _models()
    cfg = model.cfg
    toks = _prompts(cfg, 2, S, seed=S)
    jl, jc, _ = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)},
                           cache_len=cache_len)
    tl, tc = model.prefill(_t(toks), cache_len=cache_len)
    _close(tl, jl, LOGIT_ATOL)
    want = cache_from_numpy(cfg, jax.tree.map(np.asarray, jc))
    assert tc["k"].shape[2] == want["k"].shape[2] == slots
    for name in ("k", "v"):
        _close(tc[name], want[name])
    if S > W:
        plain = Model(dataclasses.replace(cfg, sliding_window=None),
                      params_from_numpy(cfg, jp, device=CPU), device=CPU)
        _, pc = plain.prefill(_t(toks))
        for t in range(S - W, S):
            _close(tc["k"][0, :, t % W], pc["k"][0, :, t])
    else:
        assert not tc["k"][:, :, S:].any()
    ic = model.init_cache(2, 40)
    assert ic["k"].shape == cache_from_numpy(cfg, jax.tree.map(
        np.asarray, JM.init_cache(jcfg, 2, 40)))["k"].shape
    assert ic["k"].shape[2] == W


@pytest.mark.parametrize("S,lens", [(10, (10, 6)), (24, (24, 19))],
                         ids=["wraps-in-decode", "wrapped-at-prefill"])
def test_decode_across_a_wrap_matches_reference(rules, S, lens):
    """Right-padded prompts, then greedy decode at one position for the
    batch (the static-batch loop) across the ring's wrap: every step's
    logits within 1e-4 of the reference's, the greedy tokens equal, the
    ring equal after the last step. The longer prompt's ring holds the
    padded bucket's last ``W`` rows, padding rows of the shorter request
    included (the reference's quirk, kept)."""
    jcfg, jp, model = _models()
    cfg = model.cfg
    toks = _prompts(cfg, 2, S, seed=S + 1)
    lengths = np.asarray(lens, np.int32)
    jl, jc, _ = JM.prefill(jp, jcfg, rules, {
        "tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths)},
        cache_len=S + 24)
    tl, tc = model.prefill(_t(toks), _t(lengths), cache_len=S + 24)
    _close(tl, jl, LOGIT_ATOL)
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    for i in range(24):
        pos = S + i
        jl, jc = JM.decode_step(jp, jcfg, rules, jc, jnp.asarray(nxt),
                                jnp.int32(pos))
        tl = model.decode_step(_t(nxt), tc, pos)
        _close(tl, jl, LOGIT_ATOL)
        assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    assert S + 23 >= 2 * W - 1, "the case was meant to wrap in decode"
    want = cache_from_numpy(cfg, jax.tree.map(np.asarray, jc))
    _close(tc["k"], want["k"])


def test_ring_decode_with_lengths_before_a_wrap(rules):
    """One layer's ring decode with lengths while the ring has not
    wrapped (its valid slots a prefix): the reference's output and
    write."""
    jcfg, jp, model = _models()
    cfg = model.cfg
    p = jax.tree.map(lambda a: a[0], jp["stack"][0]["attn"])
    tp = {n: _t(a) for n, a in p.items()}
    rng = np.random.default_rng(4)
    B, K, hd = 3, cfg.n_kv_heads, cfg.hd
    ck = rng.normal(size=(B, W, K, hd)).astype(np.float32)
    cv = rng.normal(size=(B, W, K, hd)).astype(np.float32)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    lengths = np.array([12, 5, 16], np.int32)
    kt, vt = _t(ck), _t(cv)
    ot = TA.self_attn_decode(tp, _t(x), kt, vt, cfg, pos=11, window=W,
                             lengths=_t(lengths))
    oj, (kj, vj) = JA.self_attn_decode(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), jcfg, rules, pos=jnp.int32(11),
        window=W, lengths=jnp.asarray(lengths))
    _close(ot, oj)
    _close(kt, kj)
    _close(vt, vj)


def test_ragged_decode_with_a_window_raises(rules):
    """Ragged positions over a ring: the reference asserts, the port
    raises with the reference's words; lengths after a wrap are
    refused."""
    jcfg, jp, model = _models()
    cfg = model.cfg
    toks = _prompts(cfg, 2, 8, seed=3)
    _, tc = model.prefill(_t(toks), cache_len=W)
    _, jc, _ = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)},
                          cache_len=W)
    pos = np.array([8, 8], np.int32)
    with pytest.raises(AssertionError, match="ragged decode"):
        JM.decode_step(jp, jcfg, rules, jc, jnp.zeros((2,), jnp.int32),
                       jnp.asarray(pos))
    with pytest.raises(NotImplementedError,
                       match="ragged decode does not support windows"):
        model.decode_step(torch.zeros(2, dtype=torch.long), tc, _t(pos))
    with pytest.raises(NotImplementedError, match="wrapped"):
        model.decode_step(torch.zeros(2, dtype=torch.long), tc, W + 3,
                          lengths=_t(np.array([W + 4, W], np.int32)))


def test_engine_refuses_windows(rules):
    """No decode step of the reference's engine runs a ring: it selects
    its gather mode and fails at the first decode (``ragged decode does
    not support windows``); the port's engine refuses at construction,
    naming that reason."""
    jcfg, jp, model = _models()
    jeng = JEngine(JM.Model(jcfg, rules), jp, JEngineConfig(**ENGINE))
    assert jeng.decode_mode == "gather"
    reqs = j_sharegpt_like(1, jcfg.vocab_size, seed=0, mean_in=10,
                           mean_out=4, max_len=30)
    with pytest.raises(AssertionError,
                       match="ragged decode does not support windows"):
        jeng.run(reqs)
    for mode in ("paged", "gather"):
        with pytest.raises(NotImplementedError,
                           match="ragged decode does not support windows"):
            ContinuousBatchingEngine(model, EngineConfig(
                decode_mode=mode, **ENGINE), device=CPU)
