"""The port's sampler against the JAX reference on the CPU: the threefry
key, random bits and uniforms bit for bit, the Gumbel draw within 1e-6,
``sample_tokens`` token for token over a grid of temperature, top-k and
top-p, and sampled serving through both engines, token-identical across
batch sizes, preemption and chunked prefill."""
import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores (about 3x faster there)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import init_params as j_init_params  # noqa: E402
from repro.models.sampler import sample_tokens as j_sample  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import StepFunctions  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import sampler  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, SamplingParams, sharegpt_like)

# draws a key in the sweep: an odd count past 2**13 (chip_smoke.py holds
# the card's bits to the CPU's over OPT's whole vocabulary, 50272)
V = 8195
SEEDS = [0, 1, 7, 123456, 2 ** 32 - 1]
POSITIONS = [0, 1, 5, 161, 1023, 2 ** 31 - 1]


def _key(seed, pos):
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                              np.int32(pos))


def test_jax_rng_is_the_scheme_the_port_reproduces():
    """The port implements the partitionable random bits and the
    low-range Gumbel, the installed JAX's defaults."""
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_high_dynamic_range_gumbel
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniforms_equal_jax(seed):
    """A (seed, position) sweep: the folded key, ``jax.random.bits`` and
    ``jax.random.uniform`` (both ranges the sampler uses) equal bit for
    bit; the Gumbel draw within 1e-6 (``log`` may differ by an ULP)."""
    tiny = float(np.finfo(np.float32).tiny)
    for pos in POSITIONS:
        jk = _key(seed, pos)
        tk = sampler.fold_in(sampler.prng_key(torch.tensor([seed])),
                             torch.tensor([pos]))[0]
        assert tk.tolist() == np.asarray(jk).astype(np.int64).tolist()
        bits = np.asarray(jax.random.bits(jk, (V,), jnp.uint32))
        np.testing.assert_array_equal(sampler.random_bits(tk, V).numpy(),
                                      bits.astype(np.int64))
        for lo in (0.0, tiny):
            u = np.asarray(jax.random.uniform(jk, (V,), jnp.float32, lo, 1.0))
            np.testing.assert_array_equal(
                sampler.uniform(tk, V, lo, 1.0).numpy(), u)
        g = np.asarray(jax.random.gumbel(jk, (V,), jnp.float32))
        np.testing.assert_allclose(sampler.gumbel(tk, V).numpy(), g,
                                   atol=1e-6, rtol=0)


def test_threefry_batches_keys_like_one_at_a_time():
    """Keys stacked in a batch give each row the bits it gets alone."""
    seeds = torch.tensor([3, 9, 3])
    pos = torch.tensor([4, 4, 5])
    keys = sampler.fold_in(sampler.prng_key(seeds), pos)
    batch = sampler.random_bits(keys, 257)
    for i in range(3):
        assert torch.equal(batch[i], sampler.random_bits(keys[i], 257))


GRID = [(t, k, p) for t in (0.5, 1.0, 1.7) for k in (0, 1, 5, 50)
        for p in (1.0, 0.9, 0.3)]


@pytest.mark.parametrize("temp,top_k,top_p", GRID)
def test_sample_tokens_equal_reference(temp, top_k, top_p):
    """A batch of six rows, one greedy, the rest sampled with their own
    seeds and positions, over a 513-token vocabulary with ties."""
    rng = np.random.default_rng(int(temp * 10) + top_k)
    B, n = 6, 513
    logits = (rng.normal(size=(B, n)) * 3).astype(np.float32)
    logits[:, 7] = logits[:, 3]                # a tie top-k must keep
    t = np.full((B,), temp, np.float32)
    t[0] = 0.0
    k = np.full((B,), top_k, np.int32)
    p = np.full((B,), top_p, np.float32)
    seed = (np.arange(B) * 7 + 3).astype(np.uint32)
    pos = (np.arange(B) * 11).astype(np.int32)
    want = np.asarray(j_sample(jnp.asarray(logits),
                               *map(jnp.asarray, (t, k, p, seed, pos))))
    got = sampler.sample_tokens(torch.from_numpy(logits), t, k, p, seed, pos)
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist()
    assert got[0].item() == int(np.argmax(logits[0]))


def test_greedy_batch_is_one_argmax():
    logits = torch.randn(4, 33)
    zeros = np.zeros((4,), np.float32)
    out = sampler.sample_tokens(logits, zeros, np.zeros(4, np.int32),
                                np.ones(4, np.float32),
                                np.zeros(4, np.uint32), np.arange(4))
    assert out.tolist() == logits.argmax(-1).tolist()


# ------------------------------------------------------------- engines ----
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.95, seed=7)
BASE = dict(max_batch=4, block_size=8, kv_pool_tokens=4096,
            max_model_len=256, prefill_bucket=16)


@pytest.fixture(scope="module")
def models(rules):
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    tcfg = reduced(get_config("opt-1.3b"))
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jmodel = JModel(jcfg, rules)
    return (jmodel, jp, StepFunctions.build(jmodel, 8),
            Model(tcfg, tp, device="cpu"))


_REFERENCE_RUNS = {}


def _reference(models, wl, sampling, **kw):
    """The reference engine's run, made once a module per workload and
    configuration (its compiles are the tests' main cost)."""
    key = (repr(wl), repr(sampling), tuple(sorted(kw.items())))
    if key not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[key] = _serve(models, wl, sampling, reference=True,
                                      **kw)
    return _REFERENCE_RUNS[key]


def _serve(models, wl, sampling, *, reference=False, **kw):
    jmodel, jp, steps, tmodel = models
    kw = {**BASE, **kw}
    if reference:
        reqs = j_sharegpt_like(*wl[:2], **wl[2],
                               sampling=JSamplingParams(**sampling))
        eng = JEngine(jmodel, jp, JEngineConfig(**kw), steps=steps)
    else:
        reqs = sharegpt_like(*wl[:2], **wl[2],
                             sampling=SamplingParams(**sampling))
        eng = ContinuousBatchingEngine(tmodel, EngineConfig(**kw),
                                       device="cpu")
    eng.run(reqs)
    assert all(r.t_done is not None for r in reqs)
    return [list(map(int, r.output_tokens)) for r in reqs], eng


SHORT = (5, 512, dict(seed=2, mean_in=12, mean_out=8, max_len=48,
                      sigma=0.3))


def test_sampled_serve_equals_reference_across_batch_sizes(models):
    """The reference's sampled tokens, at max_batch 1, 4 and 8 in the
    port (the reference's own test shows its tokens do not depend on the
    batch), and different from greedy."""
    want, _ = _serve(models, SHORT, SAMPLED, reference=True)
    for mb in (1, 4, 8):
        got, _ = _serve(models, SHORT, SAMPLED, max_batch=mb)
        assert got == want, mb
    greedy, _ = _serve(models, SHORT, dict(temperature=0.0))
    assert greedy != want


def test_sampled_serve_equals_reference_under_preemption(models):
    """A pool small enough to preempt: both engines preempt alike and
    emit the reference's tokens, which a roomy pool also gives."""
    wl = (6, 512, dict(seed=11, mean_in=20, mean_out=36, max_len=60,
                       sigma=0.1))
    kw = dict(max_batch=6, kv_pool_tokens=256, max_model_len=96)
    want, jeng = _serve(models, wl, SAMPLED, reference=True, **kw)
    got, teng = _serve(models, wl, SAMPLED, **kw)
    assert jeng.preemptions > 0, "workload was meant to force preemption"
    assert teng.preemptions == jeng.preemptions
    assert got == want
    roomy, eng = _serve(models, wl, SAMPLED, **{**kw,
                                                "kv_pool_tokens": 8192})
    assert eng.preemptions == 0 and roomy == want


@pytest.mark.parametrize("decode_mode,chunk", [("gather", None),
                                               ("paged", 16)])
def test_sampled_serve_other_paths_equal_reference(models, decode_mode,
                                                   chunk):
    """The gather fallback and chunked prefill sample the reference's
    tokens too (the RNG counter is the position in every path)."""
    wl = (5, 512, dict(seed=6, mean_in=40, mean_out=8, max_len=90,
                       sigma=0.3))
    want, _ = _reference(models, wl, SAMPLED)
    got, eng = _serve(models, wl, SAMPLED, decode_mode=decode_mode,
                      prefill_chunk_tokens=chunk)
    assert eng.chunking == (chunk is not None)
    assert got == want
