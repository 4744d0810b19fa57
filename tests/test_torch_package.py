"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package (``repro``), and its entry points never fall back to the CPU
silently."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_rule_catches_reference_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.kernels\nfrom repro.core import qmap\n"
                   "import jax.numpy as jnp\n")
    found = [m for m in _imported_modules(src)
             if m.split(".")[0] in FORBIDDEN]
    assert found == ["repro.core", "jax.numpy"]


SERVING_MODULES = ("kernels/paged_kv.py", "telemetry/registry.py",
                   "serve/kvcache.py", "serve/engine.py",
                   "serve/scheduler.py", "launch/serve.py",
                   "models/layers.py", "models/model.py")


@pytest.mark.parametrize("rel", SERVING_MODULES)
def test_import_rule_covers_serving_modules(rel):
    """The fourth slice's modules are among the files the import rule
    checks (and so import neither JAX nor the JAX package)."""
    assert ROOT / "src" / "repro_torch" / rel in PORT_FILES


TELEMETRY_MODULES = ("telemetry/__init__.py", "telemetry/export.py",
                     "telemetry/registry.py", "telemetry/tracing.py",
                     "telemetry/qhealth.py", "telemetry/sentinel.py",
                     "telemetry/flight.py", "telemetry/inspect.py",
                     "launch/train.py")


@pytest.mark.parametrize("rel", TELEMETRY_MODULES)
def test_telemetry_modules_import_without_jax(rel):
    """The fifth slice's modules are among the files the import rule
    checks, and each imports in a process where JAX and the JAX package
    cannot be imported."""
    import subprocess
    import sys
    path = ROOT / "src" / "repro_torch" / rel
    assert path in PORT_FILES
    module = "repro_torch." + rel[:-3].replace("/", ".").replace(
        ".__init__", "")
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            f"import {module}\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("module", ["repro_torch.launch.train",
                                    "repro_torch.telemetry.inspect"])
def test_cli_help_runs(module):
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-m", module, "--help"],
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert "usage" in r.stdout


def _entry_points():
    from repro_torch import convert
    from repro_torch.configs import base
    from repro_torch.core import optim
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.models import model
    from repro_torch.train import loop
    cfg = base.reduced(base.get_config("paper-lm-209m"))
    return {
        "init_cache": lambda: model.init_cache(cfg, 1, 8),
        "init_paged_cache": lambda: model.init_paged_cache(cfg, 2, 4, 4),
        "serve_launcher": lambda: serve_launch.main(["--reduce"]),
        "train_launcher": lambda: train_launch.main(
            ["--d-model", "64", "--n-layers", "2", "--steps", "1"]),
        "make_optimizer_sentinel":
            lambda: optim.make_optimizer("adamw8", sentinel=True),
        "init_model": lambda: model.init_model(cfg),
        "Model": lambda: model.Model(cfg),
        "make_optimizer": lambda: optim.make_optimizer("adamw8"),
        "params_from_numpy": lambda: convert.params_from_numpy({}, cfg),
        "init_train_state": lambda: loop.init_train_state(
            cfg, optim.make_optimizer("adamw8", device="cpu")),
        "make_optimizer_lamb8": lambda: optim.make_optimizer("lamb8"),
        "make_optimizer_adafactor32":
            lambda: optim.make_optimizer("adafactor32"),
        "make_optimizer_muon8": lambda: optim.make_optimizer("muon8"),
        "make_optimizer_adam8_4bit":
            lambda: optim.make_optimizer("adam8", state_bits=(4, 8)),
        "Adafactor": lambda: optim.Adafactor(optim.AdafactorConfig()),
    }


@pytest.mark.parametrize("name", ["init_model", "Model", "make_optimizer",
                                  "params_from_numpy", "init_train_state",
                                  "make_optimizer_lamb8",
                                  "make_optimizer_adafactor32", "Adafactor",
                                  "make_optimizer_muon8",
                                  "make_optimizer_adam8_4bit", "init_cache",
                                  "init_paged_cache", "serve_launcher",
                                  "train_launcher",
                                  "make_optimizer_sentinel"])
def test_entry_point_without_device_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_wrapper_raises_on_other_devices():
    """A wrapper given a tensor that is neither on the CPU nor on a CUDA
    device raises instead of computing elsewhere."""
    from repro_torch.kernels import ops
    x = torch.zeros((2, 8), device="meta")
    q = torch.zeros(256, device="meta")
    with pytest.raises(ValueError, match="no quantize kernel"):
        ops.quantize_blockwise(x, q)
    from repro_torch.kernels import paged_kv
    codes = torch.zeros((2, 2, 1, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no paged gather kernel"):
        paged_kv.gather_pages(codes, torch.zeros((2, 2, 1), device="meta"),
                              torch.zeros((1, 2), dtype=torch.int32,
                                          device="meta"), bits=8)
