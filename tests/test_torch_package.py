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


def _entry_points():
    from repro_torch import convert
    from repro_torch.configs import base
    from repro_torch.core import optim
    from repro_torch.models import model
    from repro_torch.train import loop
    cfg = base.reduced(base.get_config("paper-lm-209m"))
    return {
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
                                  "make_optimizer_adam8_4bit"])
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
