"""Hygiene of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points default to the card, and every feature outside
its slice raises instead of being ignored."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

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


def test_importing_the_engine_loads_no_jax():
    code = ("import sys; import repro_torch.serving.engine, "
            "repro_torch.kernels.ops; "
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


@pytest.mark.parametrize("flag", [
    {"prefix_cache": True}, {"overlap": True},
    {"prefill_chunk_tokens": 64}, {"speculate": True}, {"max_waiting": 4},
    {"shed_kv_fraction": 0.9}, {"shed_queue_delay_s": 1.0}])
def test_out_of_slice_engine_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(**flag)


def test_engine_config_validation_kept():
    with pytest.raises(ValueError):
        EngineConfig(kv_pool_tokens=100, block_size=16)
    with pytest.raises(ValueError):
        EngineConfig(max_model_len=4096, kv_pool_tokens=1024)
    with pytest.raises(ValueError):
        EngineConfig(decode_mode="dense")
    assert EngineConfig(decode_mode="gather").decode_mode == "gather"


def test_sampled_rows_raise():
    logits = torch.randn(2, 10)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sample_tokens(logits, [0.0, 0.8], [0, 0], [1.0, 1.0], [0, 0], [3, 3])
    greedy = sample_tokens(logits, [0.0, 0.0], [0, 0], [1.0, 1.0], [0, 0],
                           [3, 3])
    assert greedy.dtype == torch.int32
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
