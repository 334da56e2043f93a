"""The port's training path against the JAX reference on the CPU:
``Model.loss`` and its gradients on every family (against
``jax.value_and_grad(repro.models.model.loss)``), one
``make_train_step`` against the reference's jitted step, microbatching,
the serving entry points reading the trained weights, and the train
launcher's printed lines against the reference launcher's."""
import dataclasses
import re
import sys

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
from repro.training import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training import adamw_init as j_adamw_init  # noqa: E402
from repro.training import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import FlashAttentionFn  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (params_from_numpy,  # noqa: E402
                                       params_to_numpy, tree_leaves)
from repro_torch.training import (AdamWConfig, TrainState,  # noqa: E402
                                  adamw_init, make_train_step)

CPU = torch.device("cpu")
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4      # a gradient leaf's error, of its largest magnitude

FAMILIES = {   # name -> reduced() arguments
    "opt-1.3b": {},
    "olmoe-1b-7b": dict(max_experts=64, d_ff=64),    # capacity drops
    "mamba2-1.3b": {},
    "zamba2-7b": dict(n_layers=5),                   # 2 periods + 1 block
    "llama-3.2-vision-90b": dict(n_layers=5),        # 2 periods + 1 block
    "hubert-xlarge": {},
}


def _cfgs(name, **kw):
    jcfg = j_reduced(j_get_config(name), **kw)
    tcfg = reduced(get_config(name), **kw)
    if jcfg.arch_type == "hybrid":    # as tests/test_archs_smoke.py
        jcfg = dataclasses.replace(jcfg, attn_every=2)
        tcfg = dataclasses.replace(tcfg, attn_every=2)
    return jcfg, tcfg


def _batch(cfg, B=2, S=16, seed=0, lengths=None):
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.embedding_inputs:
        b["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.02
                       ).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.arch_type == "vlm":
        b["img_embeds"] = (rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if lengths is not None:
        b["lengths"] = np.asarray(lengths, np.int32)
        b["labels"][np.arange(S)[None, :] >= b["lengths"][:, None]] = -1
    return b


def _ref(jcfg, seed=0):
    return jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))


def _grads_close(got, want):
    """Each port gradient leaf (a dict by path) within GRAD_REL of the
    reference leaf's largest magnitude."""
    want = dict(tree_leaves(jax.tree.map(np.asarray, want)))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = np.asarray(want[k], np.float64)
        err = np.abs(g.detach().double().numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max() + 1e-30, \
            (k, err, np.abs(w).max())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_loss_and_grads_match_reference(name, rules, monkeypatch):
    jcfg, tcfg = _cfgs(name, **FAMILIES[name])
    ref = _ref(jcfg)
    batch = _batch(jcfg, lengths=[16, 11] if name == "hubert-xlarge"
                   else None)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss(p, jcfg, rules, b)))(
            jax.tree.map(jnp.asarray, ref),
            {k: jnp.asarray(v) for k, v in batch.items()})

    kept = []
    dispatch = TMOE._dispatch_indices

    def recording(idx, E, C):
        slot, keep = dispatch(idx, E, C)
        kept.append(bool(keep.all()))
        return slot, keep
    monkeypatch.setattr(TMOE, "_dispatch_indices", recording)

    model = Model(tcfg, params_from_numpy(tcfg, ref), device=CPU)
    model.requires_grad_(True)
    loss = model.loss(batch)
    leaves = tree_leaves(model.params)
    grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True)
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_ATOL
    _grads_close({k: torch.zeros_like(t) if g is None else g
                  for (k, t), g in zip(leaves, grads)}, want_g)
    if tcfg.moe is not None:
        assert False in kept, "no capacity drop: the case tests nothing"
    attn = [k for k, _ in leaves if k.endswith(("/wq", "/wk", "/wv"))]
    for (k, _), g in zip(leaves, grads):
        if k in attn:
            assert g is not None and bool(g.abs().max() > 0), k


def test_attention_gradient_goes_through_the_function():
    """The loss's graph reaches every self-attention layer through the
    flash kernel's Function, on the CPU as on the card (so the backward
    these tests hold is the card's)."""
    _, tcfg = _cfgs("opt-1.3b")
    model = Model(tcfg, device=CPU)
    model.requires_grad_(True)
    loss = model.loss(_batch(tcfg))
    nodes, stack = set(), [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and fn not in nodes:
            nodes.add(fn)
            stack.extend(f for f, _ in fn.next_functions)
    flash = [f for f in nodes
             if isinstance(f, FlashAttentionFn._backward_cls)]
    # the forward's node; the recompute's are made in the backward
    assert len(flash) == tcfg.n_layers


@pytest.mark.parametrize("name", ["opt-1.3b", "olmoe-1b-7b"])
def test_train_step_matches_reference(name, rules):
    """One step: loss and gradient norm within 1e-5, every parameter within
    1e-3 at lr 1e-3 (the reference's bound for Adam's sign-like first
    step), the optimizer's step counted."""
    jcfg, tcfg = _cfgs(name, **FAMILIES[name])
    ref = _ref(jcfg)
    batch = _batch(jcfg, B=4)
    jo = JAdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jp, _, jm = jax.jit(j_make_train_step(jcfg, rules, jo))(
        jax.tree.map(jnp.asarray, ref), j_adamw_init(ref),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(tcfg, params_from_numpy(tcfg, ref), device=CPU)
    state = TrainState(model=model, opt_state=adamw_init(model.params))
    m = make_train_step(tcfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=10))(state, batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-5 * max(1.0, float(jm["grad_norm"]))
    want = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    for k, t in tree_leaves(state.params):
        np.testing.assert_allclose(t.detach().numpy(), want[k], atol=1e-3,
                                   rtol=0, err_msg=k)
    assert int(state.opt_state[2]) == 1


def test_microbatched_step_matches_full():
    """``microbatches=2`` against 1 on the same state: the loss within the
    reference's 1e-4 and the parameters within its 1e-3."""
    _, tcfg = _cfgs("opt-1.3b")
    batch = _batch(tcfg, B=4)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    s1 = TrainState.create(tcfg, device="cpu")
    s2 = TrainState.create(tcfg, device="cpu")
    m1 = make_train_step(tcfg, opt, 1)(s1, batch)
    m2 = make_train_step(tcfg, opt, 2)(s2, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    d = max(float((a - b).detach().abs().max()) for (_, a), (_, b) in
            zip(tree_leaves(s1.params), tree_leaves(s2.params)))
    assert d < 1e-3, d
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tcfg, opt, 3)(s1, batch)


def test_serving_reads_the_trained_weights():
    """After a step the model's prefill (views taken once, under no_grad)
    equals a model built afresh from its updated parameter tree, bit for
    bit, and differs from before the step."""
    _, tcfg = _cfgs("zamba2-7b", n_layers=5)
    state = TrainState.create(tcfg, device="cpu")
    tokens = torch.from_numpy(_batch(tcfg)["tokens"])
    before, _ = state.model.prefill(tokens)
    make_train_step(tcfg, AdamWConfig(lr=1e-2, warmup_steps=1,
                                      total_steps=10))(state, _batch(tcfg))
    after, _ = state.model.prefill(tokens)
    fresh = Model(tcfg, params_from_numpy(
        tcfg, params_to_numpy(tcfg, state.params)), device=CPU)
    again, _ = fresh.prefill(tokens)
    assert torch.equal(after, again)
    assert not torch.equal(before, after)


# ------------------------------------------------------------- launcher --
LINE = re.compile(r"step\s+(\d+)\s+loss (\S+)\s+gnorm (\S+)")


def _printed(text):
    return [(int(s), float(loss), float(g)) for s, loss, g in
            LINE.findall(text)]


def test_launcher_prints_the_reference_lines(monkeypatch, capsys):
    """The port's launcher on the CPU against the reference's on a reduced
    config, the same weights (the port's ``make_model`` gives it the
    reference's): every printed loss and gnorm equal to their last
    printed digit."""
    from repro.launch import train as JLT
    argv = ["--arch", "qwen2.5-3b", "--reduced", "--steps", "4", "--batch",
            "2", "--seq", "24", "--log-every", "1"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    JLT.main()
    want = _printed(capsys.readouterr().out)

    def make_model(cfg, device):
        jcfg = j_reduced(j_get_config("qwen2.5-3b"))
        return Model(cfg, params_from_numpy(cfg, _ref(jcfg)), device=device)
    monkeypatch.setattr(LT, "make_model", make_model)
    records = LT.main(argv + ["--device", "cpu"])
    got = _printed(capsys.readouterr().out)
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == [0, 1, 2, 3]
    for (_, l1, g1), (_, l2, g2) in zip(got, want):
        assert abs(l1 - l2) <= 1.01e-4 and abs(g1 - g2) <= 1.01e-3
    assert [r["step"] for r in records] == [0, 1, 2, 3]
    assert records[-1]["loss"] < records[0]["loss"]


def test_launcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        LT.main(["--arch", "opt-1.3b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainState.create(reduced(get_config("opt-1.3b")))
