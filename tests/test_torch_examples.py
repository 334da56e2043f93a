"""The port's examples (``repro_torch.examples``) on the CPU, against the
reference's ``examples/*.py``: ``bca_replication`` prints the reference's
lines character for character; ``quickstart`` decodes the reference's
tokens from its weights and prompt (the forward's logits within 1e-4,
the full config's decode-step verdict equal under the paper's H100);
``serve_engine``, ``stream_generate``, ``speculative_decode`` and
``serve_cluster`` (sliced over two ``"cpu"`` devices) give every request
the reference engine's tokens at the example's own ``EngineConfig`` and
workload; ``train_tiny``'s losses are within 1e-4 relative of the
reference's ``make_train_step`` on the same batches, and its checkpoint
loads in the reference's ``load_checkpoint``. Every ``main`` offers the
reference's options plus ``--device`` and ``--full``, and raises
without a card unless given ``--device cpu``.

The reference's engines share one compiled ``StepFunctions`` a block
size and each runs once a module (``_REF``): their compiles dominate."""
import argparse
import dataclasses
import os
import pathlib
import re
import runpy
import sys

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.model as JM  # noqa: E402
import repro.serving as jserving  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core import hardware as j_hardware  # noqa: E402
from repro.core import perfmodel as j_perfmodel  # noqa: E402
from repro.training import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training import adamw_init as j_adamw_init  # noqa: E402
from repro.training import load_checkpoint as j_load_checkpoint  # noqa: E402
from repro.training import make_train_step as j_make_train_step  # noqa: E402
from repro.training import \
    synthetic_batches as j_synthetic_batches  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import H100_PAPER, H100_SXM5_80GB  # noqa: E402
from repro_torch.examples import (bca_replication, quickstart,  # noqa: E402
                                  serve_cluster, serve_engine,
                                  speculative_decode, stream_generate,
                                  train_tiny)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (params_from_numpy,  # noqa: E402
                                       tree_leaves)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    bca_replication, quickstart, serve_engine, stream_generate,
    speculative_decode, serve_cluster, train_tiny)}
CPU = torch.device("cpu")


def _reference_path(name):
    return str(ROOT / "examples" / f"{name}.py")


def _run_reference(name, monkeypatch, argv=()):
    """Run the reference's example as a script in this process (its
    ``XLA_FLAGS`` default restored afterwards)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(_reference_path(name), run_name="__main__")


def _port_model(cfg, tree):
    return Model(cfg, params_from_numpy(cfg, tree, device=CPU), device=CPU)


def _as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _hw_for_reference(hw):
    fields = {f.name for f in dataclasses.fields(j_hardware.Hardware)}
    return j_hardware.Hardware(**{k: v for k, v in
                                  dataclasses.asdict(hw).items()
                                  if k in fields})


# ---------------------------------------------- the reference's engines ----
_REF = {}


def _opt(rules):
    """Reduced OPT-1.3B in both packages on the reference's seed-0 weights,
    and one reference ``StepFunctions`` a block size."""
    if "opt" not in _REF:
        jcfg = j_reduced(j_get_config("opt-1.3b"))
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        jmodel = JM.Model(jcfg, rules)
        tcfg = reduced(get_config("opt-1.3b"))
        _REF["opt"] = dict(
            jcfg=jcfg, jp=jp, jmodel=jmodel, tcfg=tcfg,
            tmodel=_port_model(tcfg, _as_numpy(jp)),
            steps={bs: jserving.StepFunctions.build(jmodel, bs)
                   for bs in (8, 16)})
    return _REF["opt"]


def _ref_engine(o, ecfg):
    return jserving.ContinuousBatchingEngine(
        o["jmodel"], o["jp"], jserving.EngineConfig(**ecfg),
        steps=o["steps"][ecfg["block_size"]])


def _ecfg_fields(ecfg):
    return {f.name: getattr(ecfg, f.name)
            for f in dataclasses.fields(ecfg)}


def _tokens(reqs):
    return {r.req_id: [int(t) for t in r.output_tokens] for r in reqs}


# ------------------------------------------------------------ options ----
class _Parsed(Exception):
    pass


def _reference_options(name, monkeypatch):
    """The reference example's options, caught at its ``parse_args`` (none
    for an example without a parser)."""
    if "ArgumentParser" not in pathlib.Path(
            _reference_path(name)).read_text():
        return {}
    seen = {}

    def catch(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed):
        _run_reference(name, monkeypatch)
    monkeypatch.undo()
    return _options(seen["parser"])


def _options(parser):
    return {tuple(a.option_strings): (a.default, a.choices, a.required,
                                      a.nargs, type(a).__name__)
            for a in parser._actions if a.option_strings}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_help_has_the_reference_options_plus_device_and_full(
        name, monkeypatch, capsys):
    ref = _reference_options(name, monkeypatch) or \
        _options(argparse.ArgumentParser())
    port = _options(EXAMPLES[name].build_parser())
    assert port.pop(("--device",))[0] == "cuda"
    assert port.pop(("--full",))[:2] == (False, None)
    assert port == ref
    with pytest.raises(SystemExit) as e:
        EXAMPLES[name].main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for opts in list(ref) + [("--device",), ("--full",)]:
        assert all(o in text for o in opts)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_main_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        EXAMPLES[name].main([])


# ----------------------------------------------------------- examples ----
def test_bca_replication_prints_the_reference_lines(monkeypatch, capsys):
    _run_reference("bca_replication", monkeypatch)
    ref = capsys.readouterr().out
    lines = bca_replication.main(["--device", "cpu"])
    assert capsys.readouterr().out == ref
    assert "\n".join(lines) + "\n" == ref
    assert "replication plan" in ref and "vs MAX" in ref


def test_quickstart_decodes_the_reference_tokens(monkeypatch, capsys):
    """The reference's example as it runs (reduced qwen2.5-3b, float32):
    its weights, prompt, forward logits and decoded tokens, against the
    port's ``run`` on the same weights and prompt; then the full config's
    decode-step terms under the paper's H100 in both packages."""
    seen = {}
    init, fwd = JM.init_params, JM.forward

    def keep_init(cfg, key):
        seen["params"] = init(cfg, key)
        return seen["params"]

    def keep_forward(params, cfg, rules, batch):
        seen["tokens"] = np.asarray(batch["tokens"])
        seen["logits"], seen["aux"] = fwd(params, cfg, rules, batch)
        return seen["logits"], seen["aux"]
    monkeypatch.setattr(JM, "init_params", keep_init)
    monkeypatch.setattr(JM, "forward", keep_forward)
    _run_reference("quickstart", monkeypatch)
    text = capsys.readouterr().out
    want = [int(t) for t in re.search(r"decoded tokens: \[([^\]]*)\]",
                                      text).group(1).split(",")]
    full = get_config("qwen2.5-3b")
    cfg = reduced(full)
    got = quickstart.run(_port_model(cfg, _as_numpy(seen["params"])), full,
                         torch.from_numpy(seen["tokens"].copy()),
                         H100_PAPER,
                         "the paper's", echo=False)
    assert got["tokens"] == want
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(seen["logits"]), atol=1e-4,
                               rtol=0)
    assert got["aux"] == float(seen["aux"]) == 0.0
    assert got["lines"][:2] == text.splitlines()[:2]
    ref = j_perfmodel.decode_step_terms(j_get_config("qwen2.5-3b"), batch=64,
                                        ctx=2048,
                                        hw=_hw_for_reference(H100_PAPER))
    port = got["terms"]
    assert list(port.classes) == list(ref.classes)
    for name, c in port.classes.items():
        assert port.ai(name) == pytest.approx(ref.ai(name), rel=1e-12)
        rc = ref.classes[name]
        assert (c["memory_s"] > c["compute_s"]) == \
            (rc["memory_s"] > rc["compute_s"])
        for key in ("flops", "bytes", "memory_s", "compute_s"):
            assert c[key] == pytest.approx(rc[key], rel=1e-12)
    verdict = [line for line in got["lines"] if "-bound" in line]
    assert len(verdict) == len(port.classes)


def test_quickstart_takes_the_card_or_the_data_sheet():
    """Without a card the verdict names the H100 SXM5 entry, labelled as
    the data sheet (the reference names a TPU v5e)."""
    from repro_torch.examples import card_hardware
    hw, label = card_hardware(CPU)
    assert hw is H100_SXM5_80GB and "data sheet" in label
    full = get_config("qwen2.5-3b")
    cfg = reduced(full, n_layers=1)
    got = quickstart.run(Model(cfg, device=CPU), full, quickstart.prompt(cfg),
                         hw, label, echo=False)
    assert any(line.startswith("h100-sxm5-80gb (the data sheet")
               for line in got["lines"])
    assert len(got["tokens"]) == quickstart.DECODE_STEPS + 1


def test_serve_engine_matches_reference(rules):
    """Every request's tokens at ``max_batch`` 4 equal the reference
    engine's on the example's config and workload; at 1 and 8 the port's
    tokens equal its own at 4."""
    o = _opt(rules)
    ref_cfg = dict(max_batch=4, block_size=16, kv_pool_tokens=1 << 14,
                   max_model_len=128, prefill_bucket=32)
    assert _ecfg_fields(serve_engine.engine_config(4)) == _ecfg_fields(
        serve_engine.EngineConfig(**ref_cfg))
    if "serve_engine" not in _REF:
        reqs = jserving.sharegpt_like(8, o["jcfg"].vocab_size, seed=0,
                                      mean_in=20, mean_out=20, max_len=80,
                                      sigma=0.3)
        _ref_engine(o, ref_cfg).run(reqs)
        _REF["serve_engine"] = _tokens(reqs)
    got = serve_engine.run(o["tmodel"], echo=False)
    want = list(_REF["serve_engine"].values())
    assert got["outputs"][4] == want
    assert got["outputs"][1] == got["outputs"][8] == want
    assert [line.split(":")[0] for line in got["lines"]] == [
        f"max_batch={mb}" for mb in serve_engine.BATCHES]


def test_stream_generate_matches_reference(rules, monkeypatch, capsys):
    """The reference's example as it runs (its engine on the shared
    model and compiled steps, the same config and weights): the same
    streamed, aborted and drained lines (all
    but the session's timing row), the greedy and sampled requests'
    tokens and every finish reason."""
    o = _opt(rules)
    seen = {}

    class Keep(jserving.ServingAPI):
        def drain(self):
            seen["outs"] = super().drain()
            return seen["outs"]

    real = jserving.ContinuousBatchingEngine
    monkeypatch.setattr(jserving, "ServingAPI", Keep)
    monkeypatch.setattr(jserving, "ContinuousBatchingEngine",
                        lambda model, params, ecfg: real(
                            o["jmodel"], params, ecfg,
                            steps=o["steps"][ecfg.block_size]))
    _run_reference("stream_generate", monkeypatch)
    ref_lines = capsys.readouterr().out.splitlines()
    monkeypatch.undo()
    got = stream_generate.run(o["tmodel"], echo=False)

    def compared(lines):
        return [line for line in lines if not line.startswith(
            "-- session: T=")]
    assert compared(got["lines"]) == compared(ref_lines)
    ref_outs = seen["outs"]
    assert sorted(got["outputs"]) == sorted(ref_outs)
    for rid, want in ref_outs.items():
        have = got["outputs"][rid]
        assert [int(t) for t in have.token_ids] == \
            [int(t) for t in want.token_ids]
        assert have.finish_reason == want.finish_reason
    assert got["outputs"][got["ids"]["aborted"]].finish_reason == "abort"
    assert len(got["outputs"][got["ids"]["sampled"]].token_ids) == 12


def test_speculative_decode_matches_reference(rules):
    """Speculation on: every request's tokens and the ``spec_*`` counters
    equal the reference engine's; off and on equal (the example's
    assertion); the advisor's line equals the reference's."""
    o = _opt(rules)
    ref_cfg = dict(max_batch=4, block_size=8, kv_pool_tokens=1 << 13,
                   max_model_len=256, prefill_bucket=32, speculate=True,
                   spec_k=4)
    assert _ecfg_fields(speculative_decode.engine_config(True)) == \
        _ecfg_fields(speculative_decode.EngineConfig(**ref_cfg))
    if "spec" not in _REF:
        reqs = jserving.repetitive_workload(
            6, o["jcfg"].vocab_size, seed=3, prompt_len=64,
            max_new_tokens=32, repeat_rate=1.0, phrase_len=8, pool_size=1)
        m = _ref_engine(o, ref_cfg).run(reqs)
        _REF["spec"] = (_tokens(reqs), m)
    want, jm = _REF["spec"]
    got = speculative_decode.run(o["tmodel"], get_config("opt-1.3b"),
                                 echo=False)
    assert got["outputs"][True] == got["outputs"][False] == \
        list(want.values())
    m = got["metrics"][True]
    assert (m.spec_steps, m.spec_drafted, m.spec_accepted) == \
        (jm.spec_steps, jm.spec_drafted, jm.spec_accepted)
    assert m.spec_accepted > 0
    from repro.core import H100_PAPER as J_H100_PAPER
    from repro.core import speculation_advisor as j_advisor
    assert got["lines"][0] == j_advisor(j_get_config("opt-1.3b"),
                                        J_H100_PAPER, batch=4).summary()
    assert got["lines"][-1] == \
        "outputs bit-identical with and without speculation"


def test_serve_cluster_slices_two_cpu_devices(rules):
    """On two ``"cpu"`` devices the example takes the sliced branch (one
    replica a device, each its own copy of the weights), every request
    finishes and its tokens equal the reference's cluster on the
    example's config and workload (the reference served in sync mode:
    greedy tokens do not depend on the routing)."""
    o = _opt(rules)
    ref_cfg = dict(max_batch=2, block_size=16, kv_pool_tokens=4096,
                   max_model_len=128, prefill_bucket=32)
    assert _ecfg_fields(serve_cluster.engine_config(2)) == _ecfg_fields(
        serve_cluster.EngineConfig(**ref_cfg))
    if "cluster" not in _REF:
        reqs = jserving.sharegpt_like(
            8, o["jcfg"].vocab_size, seed=0, mean_in=12, mean_out=8,
            max_len=64, sigma=0.3, arrival_rate=4.0, arrival_pattern="burst",
            burst_size=4)
        cluster = jserving.ReplicatedCluster(
            [_ref_engine(o, ref_cfg) for _ in range(2)], mode="sync")
        assert cluster.run(reqs).completed == 8
        _REF["cluster"] = _tokens(reqs)
    got = serve_cluster.run(o["tcfg"], params_from_numpy(
        o["tcfg"], _as_numpy(o["jp"]), device=CPU), [CPU] * 2,
        H100_SXM5_80GB, echo=False)
    assert got["branch"] == "sliced"
    assert got["lines"][0] == "[cluster] 2 replicas on disjoint mesh slices"
    reps = got["cluster"].replicas
    assert [r.engine.device for r in reps] == [CPU, CPU]
    assert reps[0].engine.model is not reps[1].engine.model
    assert all(r.requests for r in reps)
    assert _tokens(got["requests"]) == _REF["cluster"]
    assert got["metrics"].completed == 8


def test_serve_cluster_colocates_on_one_device():
    """With one device, or a replica count it does not divide, the
    replicas share one model on the first device (the reference's
    co-located branch)."""
    cfg = reduced(get_config("opt-1.3b"), n_layers=1)
    params = Model(cfg, device=CPU).params
    kw = dict(requests=2, mean_out=2, arrival_rate=1e3, echo=False)
    got = serve_cluster.run(cfg, params, [CPU] * 1, H100_SXM5_80GB,
                            **kw)
    assert got["branch"] == "colocated"
    assert got["cluster"].replicas[0].engine.model is \
        got["cluster"].replicas[1].engine.model
    got = serve_cluster.run(cfg, params, [CPU] * 2, H100_SXM5_80GB,
                            replicas=3, **kw)
    assert got["branch"] == "colocated"


def test_train_tiny_losses_match_reference(rules, tmp_path):
    """The example's configuration reduced, two steps of batch 2 x 32:
    each step's loss within 1e-4 relative of the reference's jitted
    ``make_train_step`` on the same batches (the example's AdamW and
    schedule); the checkpoint loads in the reference's
    ``load_checkpoint`` with the port's trained values."""
    tcfg = reduced(train_tiny.tiny_config())
    jfull = dataclasses.replace(
        j_get_config("qwen2.5-3b"), n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab_size=32000, dtype="float32",
        q_block=128)
    assert jfull.num_params() == train_tiny.tiny_config().num_params()
    jcfg = j_reduced(jfull)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    steps, B, S = 2, 2, 32
    step = jax.jit(j_make_train_step(
        jcfg, rules, JAdamWConfig(lr=6e-4, warmup_steps=20,
                                  total_steps=steps)))
    params, opt_state, want = jp, j_adamw_init(jp), []
    data = j_synthetic_batches(jcfg, batch=B, seq=S)
    for _ in range(steps):
        batch = {k: jnp.asarray(v) for k, v in next(data).items()}
        params, opt_state, m = step(params, opt_state, batch)
        want.append(float(m["loss"]))
    path = str(tmp_path / "tiny_ckpt.npz")
    got = train_tiny.run(_port_model(tcfg, _as_numpy(jp)), steps, B, S, path,
                         echo=False)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4, atol=0)
    assert [r["step"] for r in got["records"]] == [0, 1]
    rp, ro, n = j_load_checkpoint(path, jp, j_adamw_init(jp))
    assert n == steps
    loaded = dict(tree_leaves(_as_numpy(rp)))
    for k, t in tree_leaves(got["state"].params):
        np.testing.assert_array_equal(loaded[k], t.detach().numpy())
    assert got["lines"][-1] == f"checkpoint saved to {path}"


def test_serve_cluster_takes_one_card_a_replica():
    """More devices than replicas (four for two, where the reference's
    slices would hold two devices each): one replica on each of the
    first R devices, as a replica runs on one card."""
    cfg = reduced(get_config("opt-1.3b"), n_layers=1)
    got = serve_cluster.run(cfg, Model(cfg, device=CPU).params,
                            [CPU] * 4, H100_SXM5_80GB, requests=2,
                            mean_out=2, arrival_rate=1e3, echo=False)
    assert got["branch"] == "sliced"
    assert [r.devices for r in got["cluster"].replicas] == [[CPU], [CPU]]


def test_serve_cluster_autoscale_plans_for_the_card(monkeypatch, capsys):
    """``--autoscale`` measures curves on one replica and decides for the
    card's own ``Hardware`` (the H100 SXM5 entry on the CPU; the
    reference passes a TPU v5e), capped by the devices' count; its
    summary prints first."""
    seen = {}
    real = serve_cluster.autoscale_cluster

    def keep(*a, **kw):
        seen.update(kw)
        seen["decision"] = real(*a, **kw)
        return seen["decision"]
    monkeypatch.setattr(serve_cluster, "autoscale_cluster", keep)
    got = serve_cluster.main(["--device", "cpu", "--autoscale",
                              "--requests", "2", "--mean-out", "2",
                              "--arrival-rate", "1000"])
    assert seen["hw"] is H100_SXM5_80GB and seen["mesh_slices"] == 2
    assert got["lines"][0] == seen["decision"].summary().split("\n")[0]
    assert got["metrics"].completed == 2
    assert len(got["cluster"].replicas) == seen["decision"].n_replicas
