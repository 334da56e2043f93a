"""Hygiene of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points default to the card, every feature outside
its slice raises instead of being ignored, and the ported speculation
flags are accepted."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores (about 3x faster there)
torch.set_num_threads(1)

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.sampler import sample_tokens  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax",
                                   "ml_dtypes"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


OBS_MODULES = ["core/__init__.py", "core/census.py", "core/hardware.py",
               "core/roofline.py"] + [
    f"serving/obs/{m}.py" for m in ("__init__", "auditor", "dashboard",
                                    "export", "observer", "roofline",
                                    "series", "trace", "windows")]


def test_observability_modules_are_checked():
    """Every module of the observability slice is among the files the
    import check above parses."""
    checked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(OBS_MODULES) <= checked


CLUSTER_MODULES = ["serving/faults.py", "core/replication.py",
                   "core/perfmodel.py", "core/bca.py",
                   "kernels/launches.py"] + [
    f"serving/cluster/{m}.py" for m in ("__init__", "autoscale", "cluster",
                                        "metrics", "router")]


def test_cluster_modules_are_checked():
    """Every module of the replication slice is among the files the
    import check above parses."""
    checked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(CLUSTER_MODULES) <= checked


API_MODULES = ["serving/__init__.py", "serving/api.py", "core/__init__.py",
               "core/simulator.py", "core/intensity.py", "launch/__init__.py",
               "launch/serve.py"]


def test_api_modules_are_checked():
    """Every module of the serving API and launcher slice is among the
    files the import check above parses."""
    checked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(API_MODULES) <= checked


TRAIN_MODULES = ["training/__init__.py", "training/optimizer.py",
                 "training/data.py", "training/checkpoint.py",
                 "training/train.py", "launch/train.py"]


def test_training_modules_are_checked():
    """Every module of the training slice is among the files the import
    check above parses."""
    checked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(TRAIN_MODULES) <= checked


SPMD_MODULES = ["sharding.py", "launch/mesh.py", "launch/input_specs.py",
                "launch/dryrun.py", "core/census.py", "core/replication.py"]


def test_spmd_modules_are_checked():
    """Every module of the SPMD and dry-run slice is among the files the
    import check above parses."""
    checked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(SPMD_MODULES) <= checked


EXAMPLE_MODULES = ["examples/__init__.py"] + [
    f"examples/{p.name}" for p in (ROOT / "examples").glob("*.py")]


def test_example_modules_are_checked():
    """Every example of the reference has its counterpart under
    ``repro_torch/examples``, and each is among the files the import check
    above parses."""
    checked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert len(EXAMPLE_MODULES) == 8
    assert set(EXAMPLE_MODULES) <= checked


def test_training_exports_every_name_of_the_reference():
    """``repro_torch.training`` exports every name ``repro.training``
    does (read from the reference's source)."""
    import repro_torch.training as port
    names = set()
    tree = ast.parse((ROOT / "src" / "repro" / "training" /
                      "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    assert len(names) == 8
    assert sorted(n for n in names if not hasattr(port, n)) == []


def test_serving_exports_every_name_of_the_reference():
    """``repro_torch.serving`` exports every name ``repro.serving`` does
    (read from the reference's source, so nothing of JAX is imported)."""
    import repro_torch.serving as port
    names = set()
    tree = ast.parse((ROOT / "src" / "repro" / "serving" /
                      "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    assert len(names) == 57
    assert sorted(n for n in names if not hasattr(port, n)) == []


def test_importing_the_engine_loads_no_jax():
    code = ("import sys; import repro_torch.serving.engine, "
            "repro_torch.serving.spec, repro_torch.kernels.ops, "
            "repro_torch.core.census, repro_torch.core.roofline, "
            "repro_torch.serving.obs.observer, "
            "repro_torch.serving.obs.export, "
            "repro_torch.serving.obs.dashboard, "
            "repro_torch.serving.cluster, repro_torch.serving.faults, "
            "repro_torch.core.replication, repro_torch.core.bca, "
            "repro_torch.serving.api, repro_torch.launch.serve, "
            "repro_torch.core.simulator, repro_torch.core.intensity, "
            "repro_torch.training, repro_torch.launch.train, "
            "repro_torch.sharding, repro_torch.launch.mesh, "
            "repro_torch.launch.input_specs, repro_torch.launch.dryrun; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = reduced(get_config("opt-1.3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(Model(cfg, device="cpu"), EngineConfig())
    assert resolve_device("cpu").type == "cpu"


# overlap, speculation and load shedding are in the slice since their
# ports: a shedding knob is accepted, and a value out of its range raises
# as the reference's does
@pytest.mark.parametrize("flag", [
    {"max_waiting": 4},
    {"shed_kv_fraction": 0.9}, {"shed_queue_delay_s": 1.0}])
def test_out_of_slice_engine_flags_raise(flag):
    (name, value), = flag.items()
    assert getattr(EngineConfig(**flag), name) == value
    with pytest.raises(ValueError, match=name):
        EngineConfig(**{name: 0 if name != "shed_kv_fraction" else 1.5})


@pytest.mark.parametrize("flag", [
    {"overlap": True, "speculate": True}, {"speculate": True}])
def test_speculation_flags_accepted(flag):
    """Speculative decoding is ported: the config is accepted and a paged
    engine on the CPU builds its drafter."""
    cfg = EngineConfig(**flag)
    assert cfg.speculate and cfg.overlap == flag.get("overlap", False)
    engine = ContinuousBatchingEngine(
        Model(reduced(get_config("opt-1.3b")), device="cpu"), cfg,
        device="cpu")
    assert engine.speculator is not None and \
        engine.spec_disabled_reason is None


def test_engine_config_validation_kept():
    with pytest.raises(ValueError):
        EngineConfig(kv_pool_tokens=100, block_size=16)
    with pytest.raises(ValueError):
        EngineConfig(max_model_len=4096, kv_pool_tokens=1024)
    with pytest.raises(ValueError):
        EngineConfig(decode_mode="dense")
    assert EngineConfig(decode_mode="gather").decode_mode == "gather"


def test_sampled_rows_raise():
    """Sampled rows are in the slice now and raise nothing: a greedy row
    stays the argmax, a top-1 sampled row is its argmax too, and a top-3
    row draws among its three largest logits."""
    logits = torch.randn(3, 10)
    out = sample_tokens(logits, [0.0, 0.8, 0.8], [0, 1, 3],
                        [1.0, 1.0, 1.0], [0, 5, 5], [3, 3, 3])
    assert out.dtype == torch.int32
    assert out[:2].tolist() == logits[:2].argmax(-1).tolist()
    assert out[2].item() in logits[2].topk(3).indices.tolist()
    greedy = sample_tokens(logits, [0.0] * 3, [0] * 3, [1.0] * 3, [0] * 3,
                           [3] * 3)
    assert greedy.tolist() == logits.argmax(-1).tolist()


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a CUDA device the script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {"PYTHONPATH": "", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
