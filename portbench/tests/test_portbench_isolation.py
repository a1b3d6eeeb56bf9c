"""Nothing the benchmark runs loads JAX, flax, optax or the JAX package
(top-level names compared whole: deepsee_torch is not deepsee_tpu), and
the reference imports nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness, spec

FILES = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((spec.HERE / "reference").glob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.REPO)))
def test_no_jax_import(path):
    for name in _imports(path):
        assert name.split(".")[0] not in harness.FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top != "deepsee_torch", f"{path} imports {name}"
        assert top in ("torch", "numpy", "math", "functools", "dataclasses", "typing",
                       "__future__", "portbench"), f"{path} imports {name}"
        if top == "portbench":
            assert name.startswith("portbench.reference"), f"{path} imports {name}"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "deepsee_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_a_run_loads_no_jax(tmp_path):
    """Every module of the benchmark and a whole tiny run in a process where
    importing jax, jaxlib, flax, optax or deepsee_tpu raises; after it no
    such module is loaded."""
    from portbench.tests.conftest import make_tree

    bench = make_tree(tmp_path)
    code = f"""
import sys
for m in {harness.FORBIDDEN!r}:
    sys.modules[m] = None
from pathlib import Path
from portbench import harness, spec
for path in sorted(spec.HERE.rglob("*.py")):
    if "tests" not in path.parts:
        spec.load_module(path)
cell = spec.load_cell("tiny.infer", Path({str(bench)!r}), Path({str(tmp_path / 'portbench')!r}))
r = harness.run(cell, 2 ** 31 + 1, 0.2, True, "cpu", log=lambda m: None)
for m in {harness.FORBIDDEN!r}:
    del sys.modules[m]
assert r.correct, r.checks
print("loaded", harness.forbidden_modules())
"""
    run = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO, capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(spec.REPO)))
    assert run.returncode == 0, run.stderr[-3000:]
    assert "loaded []" in run.stdout
