"""The port's run utilities against the JAX package's
(deepsee_tpu/utils/{files,model_summary,profiling}.py; their JAX-side tests
are in test_counters_and_utils.py): the source snapshot and the trainer's
call of it, parameter counts and summaries of the tiny networks, and the
profiling hooks on the CPU (the card's timing through stand-in CUDA events;
without a card it raises and the memory statistics are empty).  The card
runs `timed` and `device_memory_stats` in chip_smoke.py's train 512 phase."""

import dataclasses
import os
import subprocess
import warnings
import zipfile

import jax
import pytest
import torch

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_tpu.utils import files as jfiles
from deepsee_tpu.utils import model_summary as jsummary
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.system import SRSystem
from deepsee_torch.train.loop import Trainer
from deepsee_torch.utils import files, model_summary, profiling
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(root):
    """A small source tree: sources at two depths, a non-Python file, and
    a cache directory both packages leave out."""
    for rel, text in (("a.py", "A = 1\n"), ("pkg/b.py", "B = 2\n"), ("pkg/notes.txt", "x\n"),
                      ("pkg/__pycache__/b.cpython-312.py", "stale\n")):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)


def _names(path):
    with zipfile.ZipFile(path) as zf:
        return sorted(zf.namelist())


def test_copy_src_writes_the_zip_jax_writes(tmp_path):
    _tree(str(tmp_path / "src"))
    got = files.copy_src(str(tmp_path / "run_port"), src_root=str(tmp_path / "src"))
    want = jfiles.copy_src(str(tmp_path / "run_jax"), src_root=str(tmp_path / "src"))
    assert os.path.basename(got).startswith("src_") and got.endswith(".zip")
    assert _names(got) == ["a.py", "pkg/b.py"]
    assert [n for n in _names(want) if n != "GIT_REVISION.txt"] == _names(got)
    with zipfile.ZipFile(got) as zf:
        assert zf.read("pkg/b.py") == b"B = 2\n"


def test_copy_src_of_the_repository(tmp_path):
    """The default root is the repository: the port's sources, the git
    revision where git names one, none of the trees .gitignore lists."""
    names = _names(files.copy_src(str(tmp_path)))
    assert "deepsee_torch/utils/files.py" in names and "chip_smoke.py" in names
    assert not any(part in n.split("/") for n in names for part in files.SKIPPED_DIRS)
    rev = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                         text=True)
    assert ("GIT_REVISION.txt" in names) == (rev.returncode == 0)


def test_trainer_snapshots_the_sources(tmp_path):
    exp = torch_tiny(checkpoints_dir=str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        Trainer(exp, device="cpu")
    zips = [f for f in os.listdir(tmp_path / exp.name) if f.startswith("src_")]
    assert len(zips) == 1


def _jax_params(model):
    jexp = jax_tiny()
    jexp = jexp.replace(model=dataclasses.replace(jexp.model, **dict(model)))
    return jax.eval_shape(JaxSystem(jexp).init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("model", [(), (("net_e", "fullstyle"), ("guiding_style_image", True))],
                         ids=["independent", "guided"])
def test_parameter_counts_match_jax(model):
    variables = _jax_params(model)
    exp = torch_tiny()
    system = SRSystem(exp.replace(model=dataclasses.replace(exp.model, **dict(model))),
                      device="cpu")
    nets = {"SR": (system.generator, variables.g), "E": (system.encoder, variables.e),
            "D": (system.discriminator, variables.d)}
    for name, (module, tree) in nets.items():
        assert model_summary.count_params(module) == jsummary.count_params(tree["params"]), name
    assert model_summary.summarize({k: m for k, (m, _) in nets.items()}) == jsummary.summarize(
        {k: dict(t) for k, (_, t) in nets.items()})
    assert model_summary.summarize({"SR": system.generator, "E": None}).count("Network") == 1


class _FakeEvent:
    """Stands in for torch.cuda.Event: each record() reads the next of
    `clock` (ms)."""
    clock = iter(())

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.ms = None

    def record(self):
        self.ms = next(self.clock)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_timed_reads_a_pair_of_events_per_call(monkeypatch):
    """Warm-up calls untimed, then one start and one end event around each
    timed call, read in seconds: the median, min and max of the calls."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "clock", iter([0.0, 4.0, 10.0, 12.0, 20.0, 29.0]))
    calls = []
    out = profiling.timed(lambda x, y=0: calls.append((x, y)), 7, iters=3, warmup=2, y=1)
    assert calls == [(7, 1)] * 5
    assert out == {"median_s": 4e-3, "min_s": 2e-3, "max_s": 9e-3}


def test_timed_on_the_card_needs_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiling.timed(lambda: calls.append(1))
    assert calls == []


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    written = os.listdir(tmp_path / "trace")
    assert any(f.endswith(".json") for f in written), written


def test_device_memory_stats(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 2 ** 29)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i: 3 * 2 ** 30)
    assert profiling.device_memory_stats() == {
        "cuda:0": {"bytes_in_use_gb": 0.5, "peak_bytes_in_use_gb": 3.0}}
