"""The port's serving launcher (``repro_torch.launch.serve``) and its last
analytics (``repro_torch.core.simulator``, ``repro_torch.core.intensity``)
on the CPU, against the JAX reference: the same flags and defaults (plus
``--device``); two in-process runs of each launcher on reduced OPT-1.3B
with the same weights print the same advisor, replication, simulator,
speculation, streaming and finish lines; the port's launcher refuses to
run without a card unless given ``--device cpu``; and the simulator and
intensity functions equal the reference's to 1e-12 on the paper's four
models and two GQA configs."""
import argparse
import dataclasses
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core import hardware as j_hardware  # noqa: E402
from repro.core import intensity as j_intensity  # noqa: E402
from repro.core import simulator as j_simulator  # noqa: E402
from repro.models.model import init_params as j_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (H100_PAPER, H100_SXM5_80GB,  # noqa: E402
                              intensity_sweep, replication_sweep,
                              roofline_position, simulate_decode)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


class _Parsed(Exception):
    pass


def _reference_parser(monkeypatch):
    """The reference launcher's parser, caught at its ``parse_args`` (the
    reference builds it inside ``main``)."""
    seen = {}

    def catch(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    monkeypatch.setattr(sys, "argv", ["serve"])
    with pytest.raises(_Parsed):
        jserve.main()
    monkeypatch.undo()
    return seen["parser"]


def _options(parser):
    return {tuple(a.option_strings): (a.default, a.choices, a.required,
                                      a.nargs, type(a).__name__)
            for a in parser._actions if a.option_strings}


def test_help_has_the_reference_options_and_defaults(monkeypatch):
    ref = _options(_reference_parser(monkeypatch))
    port = _options(tserve.build_parser())
    assert port.pop(("--device",))[0] == "cuda"
    assert port == ref
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--help"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for opts in list(ref) + [("--device",)]:
        assert all(o in out.stdout for o in opts)


def test_reference_help_imports_no_jax_before_parse_args():
    """The reference defers its JAX import past ``parse_args``; its
    ``--help`` itself raises on the unescaped ``%`` of two help strings,
    which the port escapes (its ``--help`` prints, above)."""
    code = (
        "import argparse, runpy, sys\n"
        "real = argparse.ArgumentParser.parse_args\n"
        "def check(self, *a, **k):\n"
        "    print('jax loaded:', any(m.split('.')[0] in ('jax', 'jaxlib')\n"
        "                             for m in sys.modules))\n"
        "    return real(self, *a, **k)\n"
        "argparse.ArgumentParser.parse_args = check\n"
        "sys.argv = ['serve', '--help']\n"
        "runpy.run_module('repro.launch.serve', run_name='__main__')\n")
    out = subprocess.run(
        [sys.executable, "-c", code],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=120)
    assert "jax loaded: False" in out.stdout
    assert out.returncode != 0 and "TypeError" in out.stderr


def test_launcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "opt-1.3b", "--reduced", "--requests", "1"])


# lines that carry no wall-clock value, so both launchers print them alike
COMPARED = ("[BCA]", "[replication]", "[sim]", "[spec]", "[stream]",
            "[engine] finish", "  finish:", "  spec:", "  queue depth:",
            "  KV pool:")


def _compared(text):
    return [line for line in text.splitlines() if line.startswith(COMPARED)]


_WEIGHTS = {}


def _reference_weights(arch):
    """The reference's reduced weights of ``arch`` (numpy), once a
    module."""
    if arch not in _WEIGHTS:
        cfg = j_reduced(j_get_config(arch))
        _WEIGHTS[arch] = jax.tree.map(
            np.asarray, j_init_params(cfg, jax.random.PRNGKey(0)))
    return _WEIGHTS[arch]


def _plan_for_the_card(monkeypatch):
    """The reference plans a model other than the paper's for a TPU v5e,
    the port for the card it runs on (the H100 SXM5 entry on the CPU):
    the reference is given the port's entry."""
    fields = {f.name for f in dataclasses.fields(j_hardware.Hardware)}
    monkeypatch.setattr("repro.core.TPU_V5E", j_hardware.Hardware(**{
        k: v for k, v in dataclasses.asdict(H100_SXM5_80GB).items()
        if k in fields}))


@pytest.mark.parametrize("arch,flags", [
    ("opt-1.3b", ["--bca", "--no-speculate"]),
    ("opt-1.3b", ["--replicas", "auto", "--stream"]),
    ("llama-3.2-vision-90b", ["--bca", "--replicas", "auto"])],
    ids=["bca", "replicas-auto-stream", "vlm-bca-replicas-auto"])
def test_launcher_prints_the_reference_lines(arch, flags, monkeypatch,
                                             capsys):
    """The same advisor, replication plan, simulator sweep, speculation,
    streamed events and finish lines as the reference's launcher, with
    its weights (the replicated run is capped at 8 replicas, 4 of them
    serving one request each, with speculation on; the BCA run leaves it
    off, which spares the reference a verify step's compiles). The VLM
    (``llama-3.2-vision-90b``, its full config's analytics: one replica
    of 175 GB, the speculation advisor, which the engine then turns off
    for cross-attention) serves its reduced model through the engine's
    zero image stub."""
    argv = ["--arch", arch, "--reduced", "--requests", "4"] + flags
    weights = _reference_weights(arch)
    if arch != "opt-1.3b":
        _plan_for_the_card(monkeypatch)
    monkeypatch.setattr(tserve, "make_model", lambda cfg, device: Model(
        cfg, params_from_numpy(cfg, weights, device=device),
        device=device))
    tserve.main(argv + ["--device", "cpu"])
    port = _compared(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    ref = _compared(capsys.readouterr().out)
    assert port == ref
    heads = {line.split()[0] for line in ref}
    want = ({"[BCA]", "[engine]"} if "--bca" in flags else
            {"[replication]", "[sim]", "[spec]", "[stream]", "finish:"})
    if arch != "opt-1.3b":
        want |= {"[replication]", "[sim]", "[spec]"}
    assert want <= heads


def test_launcher_prints_the_reference_lines_on_olmoe(monkeypatch, capsys):
    """``--arch olmoe-1b-7b``: the same advisor line (the full config's
    analytics: BCA over the model's decode curves, the chunk budget) and
    finish lines as the reference's launcher, on its reduced weights.
    The reference plans a model other than the paper's for a TPU v5e,
    the port for the card it runs on (the H100 SXM5 entry on the CPU):
    the reference is given the port's entry. (mamba2's and zamba2's
    analytics, none of which fails on a family, are held below with the
    simulator's.)"""
    argv = ["--arch", "olmoe-1b-7b", "--reduced", "--requests", "2",
            "--bca", "--no-speculate"]
    _plan_for_the_card(monkeypatch)
    jweights = _reference_weights("olmoe-1b-7b")
    monkeypatch.setattr(tserve, "make_model", lambda cfg, device: Model(
        cfg, params_from_numpy(cfg, jweights, device=device),
        device=device))
    tserve.main(argv + ["--device", "cpu"])
    port = _compared(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    ref = _compared(capsys.readouterr().out)
    assert port == ref
    assert {"[BCA]", "[engine]"} <= {line.split()[0] for line in ref}


# ----------------------------------------------------------- analytics ----
MODELS = ["opt-1.3b", "opt-2.7b", "llama-2-7b", "llama-2-13b", "qwen2.5-3b",
          "internlm2-1.8b", "olmoe-1b-7b", "mamba2-1.3b", "zamba2-7b"]


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    else:
        assert a == pytest.approx(b, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("hw_name", ["h100-paper", "h100-sxm5-80gb"])
@pytest.mark.parametrize("arch", MODELS)
def test_simulator_and_intensity_equal_reference(arch, hw_name):
    asdict = dataclasses.asdict
    hw = {"h100-paper": H100_PAPER, "h100-sxm5-80gb": H100_SXM5_80GB}[hw_name]
    ref_fields = {f.name for f in dataclasses.fields(j_hardware.Hardware)}
    jhw = j_hardware.Hardware(**{k: v for k, v in asdict(hw).items()
                                 if k in ref_fields})
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for batch, reps, ctx in ((8, 2, 331), (64, 4, 1024)):
        kw = dict(batch=batch, n_replicas=reps, ctx=ctx)
        _close(asdict(simulate_decode(cfg, hw, **kw)),
               asdict(j_simulator.simulate_decode(jcfg, jhw, **kw)))
    kw = dict(batch=32, ctx=331, max_replicas=4)
    for got, want in zip(replication_sweep(cfg, hw, **kw),
                         j_simulator.replication_sweep(jcfg, jhw, **kw)):
        _close(asdict(got), asdict(want))
        assert got.summary() == want.summary()
    kw = dict(ctx=331, batches=[1, 8, 64, 256])
    for got, want in zip(intensity_sweep(cfg, hw, **kw),
                         j_intensity.intensity_sweep(jcfg, jhw, **kw)):
        _close(asdict(got), asdict(want))
        for ai in got.ai.values():
            _close(roofline_position(ai, hw),
                   j_intensity.roofline_position(ai, jhw))
