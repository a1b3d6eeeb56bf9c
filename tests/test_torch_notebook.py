"""Demo_torch.ipynb, the port's walkthrough (Demo.ipynb's story with
deepsee_torch alone), executed so that it is tested, not trusted.

Under DEMO_TINY=1 the notebook shrinks every preset to toy sizes and runs
on the CPU (its first cell; seeded weights, synthetic inputs, no download).
The Tier-1 test executes its code cells in order in this process and checks
the images it made; the `slow` one runs the whole notebook in a kernel of
its own through nbclient, as tests/test_demo_notebook.py runs Demo.ipynb.
"""

import json
import os

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOK = os.path.join(REPO_ROOT, "Demo_torch.ipynb")
TINY_SIZE = 32      # the tiny presets' output size (crop_size)


def code_cells():
    with open(NOTEBOOK) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]


@pytest.fixture
def tiny_env(monkeypatch):
    monkeypatch.setenv("DEMO_TINY", "1")
    monkeypatch.setenv("MPLBACKEND", "Agg")
    for key in ("CHECKPOINT_DIR", "TORCH_CHECKPOINT_DIR", "DEMO_DEVICE"):
        monkeypatch.delenv(key, raising=False)


def test_notebook_cells_run_in_order_and_make_the_images(tiny_env, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "show", lambda *a, **k: plt.close("all"))
    ns = {"__name__": "__main__"}
    for i, source in enumerate(code_cells()):
        exec(compile(source, f"Demo_torch.ipynb code cell {i}", "exec"), ns)
    assert ns["TINY"] and ns["DEVICE"] == "cpu"
    hw = (TINY_SIZE, TINY_SIZE, 3)
    for name in ("default_solution", "bicubic", "fake_lips", "fake_brows", "fake32", "before",
                 "after"):
        img = ns[name]
        assert tuple(img.shape) == (1,) + hw, name
        assert bool(torch.isfinite(img).all()) and float(img.abs().max()) <= 1.0, name
    assert tuple(ns["fakes"].shape) == (1, 5) + hw and bool(torch.isfinite(ns["fakes"]).all())
    # the manipulations move their regions' style rows and the image
    assert not torch.equal(ns["style_lips"], ns["style"])
    assert float((ns["fake_lips"] - ns["default_solution"]).abs().max()) > 0
    assert tuple(ns["style"].shape) == (1, 19, 16)
    assert {k: v.shape for k, v in ns["views"].items()} == {
        "encoded_style": (19, 16), "fake_image": hw, "image_lr": hw, "input_semantics": hw}
    assert all(v.dtype == np.uint8 for v in ns["views"].values())


def test_notebook_refuses_a_missing_card(monkeypatch):
    """Without DEMO_TINY or DEMO_DEVICE=cpu the notebook runs on cuda, and
    its first cell stops where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the first cell runs on it")
    for key in ("DEMO_TINY", "DEMO_DEVICE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="DEMO_DEVICE=cpu"):
        exec(compile(code_cells()[0], "Demo_torch.ipynb code cell 0", "exec"), {})


@pytest.mark.slow
def test_notebook_executes_clean(tiny_env):
    nbclient = pytest.importorskip("nbclient")
    import nbformat

    nb = nbformat.read(NOTEBOOK, as_version=4)
    client = nbclient.NotebookClient(nb, timeout=600, kernel_name="python3",
                                     resources={"metadata": {"path": REPO_ROOT}})
    client.execute()  # raises CellExecutionError on any failing cell
    executed = [c for c in nb.cells if c.cell_type == "code"]
    assert all(c.execution_count is not None for c in executed)
    for c in executed:
        for out in c.get("outputs", []):
            assert out.get("output_type") != "error", out
