"""deepsee_torch stands alone: it imports neither JAX nor flax nor
deepsee_tpu, it refuses to fall back to the CPU, and chip_smoke.py fails
without a card and outside a checkout."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from deepsee_torch.config import tiny_test_experiment
from deepsee_torch.system import SRSystem

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "deepsee_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "flax", "deepsee_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_port_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke, import in a process where
    importing jax, flax or deepsee_tpu raises."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES)
    code = ("import importlib, sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + f"for m in {modules!r}:\n    importlib.import_module(m)\n"
            + "print('imported', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "imported" in run.stdout


def test_system_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = tiny_test_experiment().replace(is_train=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SRSystem(exp)
    SRSystem(exp, device="cpu")  # the explicit CPU request is honoured


def test_system_refuses_training_config():
    with pytest.raises(NotImplementedError):
        SRSystem(tiny_test_experiment(), device="cpu")


def _chip_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = _chip_smoke(REPO, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = _chip_smoke(tmp_path, env)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
