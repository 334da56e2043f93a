"""The port's optimizer, data, checkpoints and the flash kernel's
autograd Function against the JAX reference on the CPU: ``schedule`` at
several steps, ``adamw_update`` on the same parameters and gradients
(stacked norm scales decayed, ``final_norm`` not; the clip reporting the
norm before clipping), ``synthetic_batches`` array for array (dense,
encoder, VLM), checkpoints written by either package read by the other
(float32 and bfloat16 leaves), the MoE load-balance loss, and
``FlashAttentionFn``'s gradients against autograd of the plain
version."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.training import checkpoint as JC  # noqa: E402
from repro.training import data as JD  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFn, flash_attention, flash_attention_torch,
    flash_prefix_attention)
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.params import (map_tree,  # noqa: E402
                                       params_from_numpy, params_to_numpy,
                                       tree_leaves)
from repro_torch.training import (AdamWConfig, adamw_init,  # noqa: E402
                                  adamw_update, load_checkpoint,
                                  save_checkpoint, schedule,
                                  synthetic_batches)

CPU = torch.device("cpu")
# the reference's update, compiled once a config (op by op it is slow)
_ref_update = jax.jit(JO.adamw_update, static_argnums=0)


def _cfgs(name, **kw):
    return j_reduced(j_get_config(name), **kw), reduced(get_config(name),
                                                        **kw)


def _leaf_np(t):
    """A port tensor as numpy, bfloat16 as ml_dtypes' (the reference's)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _ref_tree(jcfg, seed=0):
    return jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))


def _close_trees(port, ref, atol, rtol=0.0):
    """Every leaf of the port's tree against the reference's (numpy),
    matched by path."""
    want = dict(tree_leaves(jax.tree.map(np.asarray, ref,
                                         is_leaf=lambda x: x is None)))
    got = dict(tree_leaves(port))
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        np.testing.assert_allclose(
            _leaf_np(t).astype(np.float64),
            np.asarray(want[k]).astype(np.float64), atol=atol, rtol=rtol,
            err_msg=k)


# ------------------------------------------------------------- schedule --
@pytest.mark.parametrize("opt", [
    dict(), dict(lr=1e-3, warmup_steps=2, total_steps=10),
    dict(warmup_steps=0, total_steps=50, min_lr_ratio=0.0)])
def test_schedule_matches_reference(opt):
    steps = [0, 1, 2, 3, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 10000, 20000]
    got = [float(schedule(AdamWConfig(**opt), torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(JO.schedule(JO.AdamWConfig(**opt), jnp.int32(s)))
            for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------- AdamW --
def _grads(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(a.dtype),
        tree)


def test_adamw_update_matches_reference():
    """Three steps on the same parameters and gradients (stacked,
    remainder and final-norm leaves): parameters, moments, step and the
    global norm within 1e-6."""
    jcfg, tcfg = _cfgs("zamba2-7b", n_layers=5)
    ref = _ref_tree(jcfg)
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=5.0)
    jp, jo = jax.tree.map(jnp.asarray, ref), JO.adamw_init(ref)
    tp = params_from_numpy(tcfg, ref, device=CPU)
    to = adamw_init(tp)
    for i in range(3):
        g = _grads(ref, i, scale=0.05 * (i + 1))
        jp, jo, jn = _ref_update(JO.AdamWConfig(**opt), jp, g, jo)
        _, _, tn = adamw_update(AdamWConfig(**opt), tp,
                                params_from_numpy(tcfg, g, device=CPU), to)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close_trees(tp, jp, atol=1e-6)
    _close_trees(to[0], jo[0], atol=1e-6)
    _close_trees(to[1], jo[1], atol=1e-6)
    assert int(to[2]) == int(jo[2]) == 3


def test_adamw_decays_by_reference_layout_rank():
    """With zero gradients only the decay moves a leaf: the stacked
    layers' norm scales (``[n_rep, d]``) decay, the final norm's and a
    remainder block's (``[d]``) do not, as in the reference."""
    jcfg, tcfg = _cfgs("zamba2-7b", n_layers=5)
    ref = _ref_tree(jcfg)
    ref = jax.tree.map(lambda a: a + np.ones_like(a), ref)
    zeros = jax.tree.map(np.zeros_like, ref)
    opt = dict(lr=0.5, warmup_steps=1, total_steps=10)
    jp, _, _ = _ref_update(JO.AdamWConfig(**opt),
                               jax.tree.map(jnp.asarray, ref), zeros,
                               JO.adamw_init(ref))
    tp = params_from_numpy(tcfg, ref, device=CPU)
    adamw_update(AdamWConfig(**opt), tp,
                 params_from_numpy(tcfg, zeros, device=CPU), adamw_init(tp))
    _close_trees(tp, jp, atol=1e-6)
    stacked = tp["stack"][0]["ln1"]["scale"]
    assert stacked.dim() == 2
    assert not torch.equal(stacked, torch.from_numpy(
        ref["stack"][0]["ln1"]["scale"]))
    assert torch.equal(tp["final_norm"]["scale"],
                       torch.from_numpy(ref["final_norm"]["scale"]))
    assert torch.equal(tp["rem"][0]["ln1"]["scale"],
                       torch.from_numpy(ref["rem"][0]["ln1"]["scale"]))


def test_grad_clip_reports_the_norm_before_clipping():
    p = {"w": np.ones((4, 4), np.float32)}
    g = {"w": np.full((4, 4), 100.0, np.float32)}
    opt = dict(grad_clip=1.0, warmup_steps=1, total_steps=10, lr=1e-2)
    jp, _, jn = JO.adamw_update(JO.AdamWConfig(**opt),
                                jax.tree.map(jnp.asarray, p), g,
                                JO.adamw_init(p))
    tp = {"w": torch.ones(4, 4)}
    _, _, tn = adamw_update(AdamWConfig(**opt), tp,
                            {"w": torch.from_numpy(g["w"])}, adamw_init(tp))
    assert float(tn) == pytest.approx(400.0, rel=1e-6)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               atol=1e-6)


# ----------------------------------------------------------------- data --
@pytest.mark.parametrize("name", ["opt-1.3b", "hubert-xlarge",
                                  "llama-3.2-vision-90b"])
def test_synthetic_batches_equal_reference(name):
    jcfg, tcfg = _cfgs(name)
    a = JD.synthetic_batches(jcfg, batch=3, seq=20, seed=5)
    b = synthetic_batches(tcfg, batch=3, seq=20, seed=5)
    for _ in range(3):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ---------------------------------------------------------- checkpoints --
def _bf16(jcfg, tcfg):
    return (dataclasses.replace(jcfg, dtype="bfloat16"),
            dataclasses.replace(tcfg, dtype="bfloat16"))


def _moved_opt(ref, jcfg):
    """The reference's optimizer state after one update (moments non-zero)
    and its parameters."""
    jp, jo, _ = _ref_update(
        JO.AdamWConfig(warmup_steps=1, total_steps=10),
        jax.tree.map(jnp.asarray, ref), _grads(ref, 1), JO.adamw_init(ref))
    return jp, jo


def _port_state(tcfg, jp, jo):
    """The reference's parameters and optimizer state as the port's
    (float32 moments, an int32 step)."""
    def moment(tree):
        return map_tree(lambda a: torch.from_numpy(np.array(a)), tree)
    return (params_from_numpy(tcfg, jax.tree.map(np.asarray, jp)),
            (moment(jo[0]), moment(jo[1]),
             torch.tensor(int(jo[2]), dtype=torch.int32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_loads_in_the_port(dtype, tmp_path):
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    if dtype == "bfloat16":
        jcfg, tcfg = _bf16(jcfg, tcfg)
    jp, jo = _moved_opt(_ref_tree(jcfg), jcfg)
    path = str(tmp_path / "ref.npz")
    JC.save_checkpoint(path, jp, jo, step=7)
    tmpl = params_from_numpy(tcfg, _ref_tree(jcfg, seed=3), device=CPU)
    tp, to, step = load_checkpoint(path, tmpl, adamw_init(tmpl))
    assert step == 7
    _close_trees(tp, jp, atol=0)
    _close_trees(to[0], jo[0], atol=0)
    _close_trees(to[1], jo[1], atol=0)
    assert tp["stack"][0]["attn"]["wq"].dtype == tcfg.activation_dtype
    assert tp["stack"][0]["ffn"]["router"].dtype == torch.float32
    assert int(to[2]) == 1


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """A float32 checkpoint the port writes loads through the reference's
    ``load_checkpoint``, leaf for leaf."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    jp, jo = _moved_opt(_ref_tree(jcfg), jcfg)
    tp, to = _port_state(tcfg, jp, jo)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, tp, to, step=9)
    rp, ro, step = JC.load_checkpoint(path, _ref_tree(jcfg, seed=3),
                                      JO.adamw_init(_ref_tree(jcfg)))
    assert step == 9
    _close_trees(tp, rp, atol=0)
    _close_trees(to[0], ro[0], atol=0)
    assert int(ro[2]) == int(jo[2])


def test_bf16_checkpoints_hold_the_same_words(tmp_path):
    """With bfloat16 leaves both packages write the same file: every key,
    dtype (``|V2`` for bfloat16) and byte equal. (The reference's own
    ``load_checkpoint`` cannot cast ``|V2`` back to bfloat16; the port's
    reads the words, as the test above shows.)"""
    jcfg, tcfg = _bf16(*_cfgs("opt-1.3b"))
    jp, jo = _moved_opt(_ref_tree(jcfg), jcfg)
    JC.save_checkpoint(str(tmp_path / "ref.npz"), jp, jo, step=3)
    tp, to = _port_state(tcfg, jp, jo)
    assert tp["embed"]["tok"].dtype == torch.bfloat16
    save_checkpoint(str(tmp_path / "port.npz"), tp, to, step=3)
    a = np.load(tmp_path / "ref.npz")
    b = np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)
    assert "p/embed/tok" in a.files and "o/2" in a.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k
    assert b["p/embed/tok"].dtype.str == "|V2"


def test_params_numpy_round_trip():
    jcfg, tcfg = _bf16(*_cfgs("olmoe-1b-7b"))
    ref = _ref_tree(jcfg)
    back = params_to_numpy(tcfg, params_from_numpy(tcfg, ref))
    for (k, a), (k2, b) in zip(tree_leaves(ref), tree_leaves(back)):
        assert k == k2 and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), k
    assert back["embed"]["tok"].dtype.str == "|V2"
    assert back["stack"][0]["ffn"]["router"].dtype == np.float32


# ------------------------------------------------- MoE load-balance loss --
@pytest.mark.parametrize("rows", [32, 2 * TMOE.MOE_TOKEN_CHUNK])
def test_moe_aux_loss_matches_reference(rows, rules):
    """``moe_ffn(with_aux=True)`` at the training capacity, within one
    chunk and over two: the output equal to the call without it and to
    the reference's, the aux loss within 1e-6."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b", max_experts=64, d_ff=32, d_model=32)
    ref = _ref_tree(jcfg)
    jp = jax.tree.map(lambda a: a[0], ref["stack"][0]["ffn"])
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(0).standard_normal(
        (2, rows // 2, 32)).astype(np.float32)
    cf = jcfg.moe.capacity_factor
    want, want_aux = JMOE.moe_ffn(jp, jnp.asarray(x), jcfg, rules,
                                  capacity_factor=cf)
    out, aux = TMOE.moe_ffn(tp, torch.from_numpy(x), tcfg,
                            capacity_factor=cf, with_aux=True)
    assert torch.equal(out, TMOE.moe_ffn(tp, torch.from_numpy(x), tcfg,
                                         capacity_factor=cf))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert float(aux) > 0


# ------------------------------------------------------- FlashAttentionFn --
CASES = [  # (B, S, Skv, K, G, hd, causal, window, lengths)
    (2, 24, 24, 2, 1, 32, True, None, None),
    (2, 24, 24, 2, 3, 32, True, None, [24, 17]),
    (1, 40, 40, 1, 4, 64, True, 9, None),
    (2, 16, 16, 2, 2, 80, False, None, [16, 5]),
    (2, 12, 30, 2, 2, 32, False, None, None),      # a VLM's cross shape
]


def _qkv(B, S, Skv, K, G, hd, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    return (mk(B, S, K * G, hd).requires_grad_(),
            mk(B, Skv, K, hd).requires_grad_(),
            mk(B, Skv, K, hd).requires_grad_())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_fn_gradients_match_autograd_of_plain(case):
    B, S, Skv, K, G, hd, causal, window, lens = case
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    q, k, v = _qkv(B, S, Skv, K, G, hd)
    w = torch.randn(B, S, K * G, hd, generator=torch.Generator()
                    .manual_seed(1))
    out = FlashAttentionFn.apply(q, k, v, causal, window, lengths, 128, 128)
    assert isinstance(out.grad_fn, FlashAttentionFn._backward_cls)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    ref = flash_attention_torch(q, k, v, causal=causal, window=window,
                                lengths=lengths)
    want = torch.autograd.grad((ref * w).sum(), (q, k, v))
    assert torch.equal(out, ref)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")


def test_flash_fn_bf16_gradients_in_input_dtype():
    q, k, v = _qkv(2, 24, 24, 2, 2, 64, dtype=torch.bfloat16)
    out = ops.prefill_attention(q, k, v, causal=True)
    assert isinstance(out.grad_fn, FlashAttentionFn._backward_cls)
    got = torch.autograd.grad(out.float().sum(), (q, k, v))
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(
        flash_attention_torch(qf, kf, vf, causal=True).sum(), (qf, kf, vf))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=3e-2,
                                   rtol=1e-2)


def test_flash_fn_without_grad_is_the_plain_call():
    """Under ``no_grad`` (and with inputs that need no gradient) the route
    is the wrapper's call: the same bits, no graph."""
    q, k, v = (t.detach() for t in _qkv(2, 24, 24, 2, 2, 32))
    lengths = torch.tensor([24, 11], dtype=torch.int32)
    with torch.no_grad():
        a = ops.prefill_attention(q, k, v, causal=True, lengths=lengths)
    b = flash_attention(q, k, v, causal=True, lengths=lengths)
    assert a.grad_fn is None and torch.equal(a, b)


def test_prefix_entry_refuses_gradients():
    q, k, v = _qkv(1, 8, 8, 1, 1, 32)
    lengths = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_prefix_attention(q, k, v, prefix_pad=0, prefix_len=0,
                               lengths=lengths)
    with torch.no_grad():
        flash_prefix_attention(q, k, v, prefix_pad=0, prefix_len=0,
                               lengths=lengths)
