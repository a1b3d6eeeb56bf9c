"""deepsee_torch stands alone: it imports neither JAX nor flax nor
deepsee_tpu (nor does its notebook, Demo_torch.ipynb), it imports and
decodes images where Pillow is not installed, it refuses to fall back to
the CPU, and chip_smoke.py fails without a card and outside a checkout."""

import ast
import dataclasses
import json
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
NOTEBOOK = REPO / "Demo_torch.ipynb"


def _sources(path):
    """A file's source, or each code cell's of a notebook."""
    if path.suffix == ".ipynb":
        return ["".join(c["source"]) for c in json.loads(path.read_text())["cells"]
                if c["cell_type"] == "code"]
    return [path.read_text()]


@pytest.mark.parametrize("path", PORT_FILES + [NOTEBOOK], ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax(path):
    sources = _sources(path)
    assert sources
    for node in (n for source in sources for n in ast.walk(ast.parse(source))):
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


def test_port_imports_and_decodes_without_pillow():
    """Every module of the port, and chip_smoke, import in a process where
    importing PIL raises; the native codec's paths still decode the committed
    corpus to its expectations, and a mode that needs Pillow says so."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES)
    code = f"""
import dataclasses, importlib, sys
import numpy as np
sys.modules["PIL"] = None
for m in {modules!r}:
    importlib.import_module(m)
from deepsee_torch.config import get_preset
from deepsee_torch.data import transforms as T
from deepsee_torch.utils.images import encode_png_bytes, label_file_to_array
root = "tests/data/torch_corpus"
expected = np.load(root + "/expected.npz")
p = T.TransformParams((0, 0), False)
for ds, preset, lm, stems in (("celebamaskhq", "8x_independent_256x256", None, ("0", "1")),
                              ("celeba", "8x_independent_128x128", "resize",
                               ("000001", "000002"))):
    exp = get_preset(preset)
    for stem in stems:
        x = T.load_image(f"{{root}}/{{ds}}/images/{{stem}}.jpg", exp.data, exp.model, p, False)
        y = T.load_label(f"{{root}}/{{ds}}/labels/{{stem}}.png", exp.data, exp.model, p, False, lm)
        u8 = expected[f"{{ds}}/{{stem}}/image"]
        assert np.array_equal(x, u8.astype(np.float32) / 255.0 * 2.0 - 1.0), (ds, stem)
        assert np.array_equal(y, expected[f"{{ds}}/{{stem}}/label"]), (ds, stem)
lab = label_file_to_array(root + "/celebamaskhq/labels/0.png", 256, 19)
assert np.array_equal(lab[0], expected["celebamaskhq/0/label"])
assert encode_png_bytes(np.zeros((4, 4, 3), np.uint8)).startswith(b"\\x89PNG")
exp = get_preset("8x_independent_256x256")
data = dataclasses.replace(exp.data, preprocess_mode="scale_width")
try:
    T.load_image(root + "/celeba/images/000001.jpg", data, exp.model, p, False)
except ImportError as e:
    assert "scale_width" in str(e), e
else:
    raise AssertionError("scale_width decoded without Pillow")
print("decoded")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "decoded" in run.stdout


def test_system_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = tiny_test_experiment().replace(is_train=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SRSystem(exp)
    SRSystem(exp, device="cpu")  # the explicit CPU request is honoured


def test_system_refuses_training_config(monkeypatch):
    """The training system is built (D and VGG beside G and E, in train
    mode), with remat too (either policy, on the CPU when asked); what it
    and the Trainer refuse is to run without a card unless the caller asks
    for the CPU."""
    from deepsee_torch.train.loop import Trainer

    exp = tiny_test_experiment()
    for policy in ("full", "convs"):
        remat = exp.replace(train=dataclasses.replace(exp.train, remat=True,
                                                      remat_policy=policy))
        gen = SRSystem(remat, device="cpu").generator
        assert gen.remat and gen.remat_policy == policy and gen.training
        with monkeypatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="CUDA"):
                SRSystem(remat)
            with pytest.raises(RuntimeError, match="CUDA"):
                Trainer(remat)
    system = SRSystem(exp, device="cpu")
    assert not system.generator.remat
    assert system.discriminator.training and system.generator.training
    assert not system.vgg.training
    assert not any(p.requires_grad for p in system.vgg.parameters())


def test_training_entry_points_without_card_raise(monkeypatch):
    from deepsee_torch.train.loop import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SRSystem(tiny_test_experiment())
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(tiny_test_experiment())


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


def test_tensor_parallel_modules_are_checked():
    """The tensor-parallel layer (its collectives and its plan) is among the
    files the import checks above cover."""
    for name in ("tensor.py", "shard.py", "distributed.py"):
        assert REPO / "deepsee_torch" / "parallel" / name in PORT_FILES


def test_a_layout_without_its_ranks_raises():
    """A model axis that the processes do not make up raises: nothing
    carries on in one process, and the collectives refuse to run without
    their group."""
    from deepsee_torch.config import MeshConfig
    from deepsee_torch.parallel import shard
    from deepsee_torch.train.state import create_train_state

    exp = tiny_test_experiment().replace(mesh=MeshConfig(model_axis=2))
    system = SRSystem(exp, device="cpu")
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        create_train_state(system)
    with pytest.raises(ValueError, match="the model group has 1 rank"):
        shard.shard_system(system, exp.mesh)
