"""The port stands alone: no module of ``repro_torch``, and neither
``chip_smoke.py``, ``scripts/kernel_times.py``,
``scripts/lm_step_memory.py`` nor ``scripts/megascan_phases.py``,
imports ``jax`` or the
JAX package ``repro``; and its entry points run on the card unless the
caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                     ROOT / "scripts" / "kernel_times.py",
                                     ROOT / "scripts" / "lm_step_memory.py",
                                     ROOT / "scripts" / "megascan_phases.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_jax():
    mods = sorted("repro_torch." + ".".join(p.relative_to(PORT).with_suffix(
        "").parts).removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m.rstrip('.'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import FedConfig, HyperRepConfig
    from repro_torch.core.bilevel import quadratic_bilevel_problem
    from repro_torch.tasks import FedDriver, build_hyperrep
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_hyperrep(HyperRepConfig())
    eye = torch.eye(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedDriver(quadratic_bilevel_problem(eye, eye, torch.zeros(2), eye),
                  FedConfig(), n_clients=2, batch_fn=None, init_xy=None)
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.fed.runtime import FederatedTrainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(reduced(get_arch("qwen1.5-4b")), FedConfig(),
                         ShapeConfig("t", 32, 2, "train"))
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.models.params import TensorSpec
    from repro_torch.serve import load_serve_params
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serve_params("missing", reduced(get_arch("qwen1.5-4b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint("missing", {"a": TensorSpec((2,), torch.float32)})
    from repro_torch.data.synthetic import (FederatedLMData,
                                            make_client_batch,
                                            make_cohort_batch)
    data = FederatedLMData(vocab=8, n_clients=2)
    specs = {"tokens": TensorSpec((2, 1, 4), torch.int32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_client_batch(data, None, specs, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_cohort_batch(data, None, specs, 0, [1, 0])
    from repro_torch.launch.mesh import make_local_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh()
