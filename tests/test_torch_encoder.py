"""The port's bidirectional encoder (``hubert-xlarge``: embeddings as
input, learned positions, GELU, LayerNorm, ``causal=False``) against the
JAX reference on the CPU: the flash kernel's plain entry, not causal,
with a length a request, at hubert's heads (hd 80) against the
reference's masked attention; ``Model.forward`` and ``Model.prefill``
with lengths and ``Model.decode_step`` on a row of embeddings at
``reduced()`` sizes; and the engine's refusal, with the reason the
reference's engine fails for."""
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
from repro.models import model as JM  # noqa: E402
from repro.models.attention import _attention_core, _mask_builder  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_torch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig)

CPU = torch.device("cpu")
KERNEL_ATOL = 3e-5   # float32 attention (the reference's kernel tests')
LOGIT_ATOL = 1e-4    # float32 logits
NAME = "hubert-xlarge"
ENGINE = dict(max_batch=2, block_size=8, kv_pool_tokens=256,
              max_model_len=64, prefill_bucket=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-5,
                               atol=atol)


_MODELS = {}


def _models(n_layers=2):
    """The reference config and weights (numpy) and the port's model on
    the same weights, once a module."""
    if n_layers not in _MODELS:
        jcfg = j_reduced(j_get_config(NAME), n_layers=n_layers)
        tcfg = reduced(get_config(NAME), n_layers=n_layers)
        jp = jax.tree.map(np.asarray,
                          JM.init_params(jcfg, jax.random.PRNGKey(0)))
        _MODELS[n_layers] = (jcfg, jp, Model(
            tcfg, params_from_numpy(tcfg, jp, device=CPU), device=CPU))
    return _MODELS[n_layers]


def _embeds(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("S,lens", [(40, (40, 33, 1)), (24, (7, 24, 12))])
def test_flash_bidirectional_with_lengths_at_hubert_heads(S, lens):
    """The plain entry, not causal, each request's keys cut at its length
    (padded query rows included: each keeps a valid key), at hubert's
    heads (H = K = 16, hd 80), against the reference's masked attention
    (``_attention_core`` under ``_mask_builder``)."""
    cfg = get_config(NAME)
    K, hd, B = cfg.n_kv_heads, cfg.hd, len(lens)
    assert (cfg.n_heads, K, hd) == (16, 16, 80) and not cfg.causal
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(B, S, K, hd)).astype(np.float32)
               for _ in range(3))
    lengths = np.asarray(lens, np.int32)
    out = flash_attention_torch(_t(q), _t(k), _t(v), causal=False,
                                lengths=_t(lengths))
    mask_fn = _mask_builder(causal=False, window=None, kv_ids=jnp.arange(S),
                            lengths=jnp.asarray(lengths))
    ref = _attention_core(jnp.asarray(q).reshape(B, S, K, 1, hd),
                          jnp.asarray(k), jnp.asarray(v), mask_fn, 512,
                          q_offset=0).reshape(B, S, K, hd)
    _close(out, ref, KERNEL_ATOL)


@pytest.mark.parametrize("n_layers", [2, 3])
def test_forward_matches_reference(rules, n_layers):
    """``Model.forward`` on seeded embeddings with a length a row: the
    reference's logits (its padded vocab cut to the vocab) within 1e-4,
    every row, padded rows included; the learned positions are added to
    the embeddings."""
    jcfg, jp, model = _models(n_layers)
    cfg = model.cfg
    emb = _embeds(cfg, 3, 40, seed=n_layers)
    lens = np.array([40, 33, 5], np.int32)
    jl, _ = JM.forward(jp, jcfg, rules, {"embeds": jnp.asarray(emb),
                                         "lengths": jnp.asarray(lens)})
    tl = model.forward(embeds=_t(emb), lengths=_t(lens))
    assert tl.shape == (3, 40, cfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, np.asarray(jl)[..., :cfg.vocab_size], LOGIT_ATOL)
    shifted = model.forward(embeds=_t(emb), lengths=_t(lens - 1))
    assert (shifted[0] - tl[0]).abs().max() > 1e-3, "lengths masked nothing"
    jl, _ = JM.forward(jp, jcfg, rules, {"embeds": jnp.asarray(emb)})
    _close(model.forward(embeds=_t(emb)),
           np.asarray(jl)[..., :cfg.vocab_size], LOGIT_ATOL)


def test_prefill_matches_reference_and_forward(rules):
    """``Model.prefill`` on embeddings: the reference's last-row logits
    and K/V, and the rows of ``forward`` at each length."""
    jcfg, jp, model = _models()
    cfg = model.cfg
    emb = _embeds(cfg, 2, 24, seed=9)
    lens = np.array([24, 13], np.int32)
    jl, jc, _ = JM.prefill(jp, jcfg, rules, {"embeds": jnp.asarray(emb),
                                             "lengths": jnp.asarray(lens)})
    tl, tc = model.prefill(None, _t(lens), embeds=_t(emb))
    _close(tl, jl, LOGIT_ATOL)
    _close(tc["k"], np.asarray(jc["stack"][0]["k"]), KERNEL_ATOL)
    full = model.forward(embeds=_t(emb), lengths=_t(lens))
    _close(tl, full[torch.arange(2), _t(lens - 1).long()], 1e-5)
    with pytest.raises(ValueError, match="embeddings"):
        model.forward(tokens=torch.zeros((1, 4), dtype=torch.long))


def test_engine_refuses_the_encoder(rules):
    """No decode step runs an encoder: the reference's engine is built
    and fails at its first prefill (``KeyError: 'embeds'``); the port's
    refuses at construction, naming that reason."""
    jcfg, jp, model = _models()
    jeng = JEngine(JM.Model(jcfg, rules), jp, JEngineConfig(**ENGINE))
    reqs = j_sharegpt_like(1, jcfg.vocab_size, seed=0, mean_in=10,
                           mean_out=4, max_len=30)
    with pytest.raises(KeyError, match="embeds"):
        jeng.run(reqs)
    with pytest.raises(NotImplementedError, match="KeyError: 'embeds'"):
        ContinuousBatchingEngine(model, EngineConfig(**ENGINE), device=CPU)


def test_decode_step_takes_embeddings(rules):
    """``decode_step(..., embeds=)`` takes a row of embeddings as it is
    (the reference's ``_decode_embed`` adds no position to them) against
    the cache of an embedding prefill: the reference's logits and cache
    write."""
    jcfg, jp, model = _models()
    cfg = model.cfg
    emb = _embeds(cfg, 2, 12, seed=4)
    step = _embeds(cfg, 2, 1, seed=5)
    jl, jc, _ = JM.prefill(jp, jcfg, rules, {"embeds": jnp.asarray(emb)},
                           cache_len=16)
    _, tc = model.prefill(None, embeds=_t(emb), cache_len=16)
    jl, jc = JM.decode_step(jp, jcfg, rules, jc, None, jnp.int32(12),
                            embeds=jnp.asarray(step))
    tl = model.decode_step(None, tc, 12, embeds=_t(step))
    _close(tl, jl, LOGIT_ATOL)
    _close(tc["k"], np.asarray(jc["stack"][0]["k"]), KERNEL_ATOL)
