"""The command fails without a card and outside a checkout; the rest of a
run, driven on the CPU at the tiny size, sees `correct` false for each
fault the cells can have and for the control."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import controls, harness, spec

CMD = [sys.executable, "-m", "portbench.run", "--workload", "infer.8x_indep_256.b32",
       "--seed", str(2 ** 31 + 17), "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(CMD, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    r = _run(spec.REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "needs 1 CUDA card" in r.stderr


def test_outside_a_checkout_no_result(tmp_path):
    """A folder holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def _cell(tiny, name):
    bench, root = tiny
    return spec.load_cell(name, bench, root)


def _result(cell):
    return harness.run(cell, 2 ** 31 + 21, 0.3, False, "cpu", log=lambda m: None)


@pytest.mark.parametrize("name", ["tiny.infer", "tiny.int8", "tiny.guided", "tiny.train",
                                  "tiny.guided.train"])
def test_sound_runs_are_correct(tiny, name):
    r = _result(_cell(tiny, name))
    assert r.correct and r.failed == 0, r.checks
    line = r.line()
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}


def _altered_answer(monkeypatch):
    from deepsee_torch.system import SRSystem

    real = SRSystem.generate

    def generate(self, *args, **kwargs):
        fake, style = real(self, *args, **kwargs)
        fake = fake.clone()
        fake[0] += 0.1          # one answer off by 0.1 everywhere
        return fake, style

    monkeypatch.setattr(SRSystem, "generate", generate)


def _half_batch_answers(monkeypatch):
    from deepsee_torch.system import SRSystem

    real = SRSystem.generate

    def generate(self, batch, **kwargs):
        half = {k: v[: (v.shape[0] + 1) // 2] for k, v in batch.items()}
        if kwargs.get("style") is not None:
            kwargs["style"] = kwargs["style"][: (kwargs["style"].shape[0] + 1) // 2]
        fake, style = real(self, half, **kwargs)
        n = batch["image_lr"].shape[0]
        return torch.cat([fake, fake])[:n], style

    monkeypatch.setattr(SRSystem, "generate", generate)


@pytest.mark.parametrize("fault", [_altered_answer, _half_batch_answers],
                         ids=["answer altered", "half the batch"])
@pytest.mark.parametrize("name", ["tiny.infer", "tiny.int8"])
def test_inference_faults_are_caught(tiny, monkeypatch, fault, name):
    fault(monkeypatch)
    assert not _result(_cell(tiny, name)).correct


def _state_unchanged(monkeypatch):
    from deepsee_torch.train.state import ClippedAdam

    monkeypatch.setattr(ClippedAdam, "step", lambda self, closure=None: None)


def _half_batch_step(monkeypatch):
    from deepsee_torch.system import SRSystem

    real = SRSystem.train_preprocess

    def train_preprocess(self, batch):
        return real(self, {k: v[: v.shape[0] // 2 + 1] for k, v in batch.items()})

    monkeypatch.setattr(SRSystem, "train_preprocess", train_preprocess)


def _altered_loss(monkeypatch):
    import deepsee_torch.train.steps as steps

    real = steps.gan_loss
    monkeypatch.setattr(steps, "gan_loss", lambda *a, **k: real(*a, **k) * 1.5)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_step, _altered_loss],
                         ids=["state unchanged", "half the batch", "loss altered"])
def test_training_faults_are_caught(tiny, monkeypatch, fault):
    fault(monkeypatch)
    assert not _result(_cell(tiny, "tiny.guided.train")).correct


def test_controls_fail_the_check(tiny):
    """The nearest lower precision in the program's place reads above the
    tiny cells' limits, which sound runs read below."""
    device = torch.device("cpu")
    for name in ("tiny.infer", "tiny.int8"):
        cell = _cell(tiny, name)
        sound = controls.reading(cell, 31, 3, False, device)["worst_mse"]
        control = controls.reading(cell, 31, 3, True, device)["worst_mse"]
        assert sound < cell.limits["worst_mse"] < control
    cell = _cell(tiny, "tiny.guided.train")
    rows = controls.train_readings(cell, 31, True, device)
    sound = rows[0]
    for row in rows[1:]:
        assert any(row[k] > cell.limits[k] for k in cell.limits), row
    assert all(sound[k] < cell.limits[k] for k in cell.limits), sound


def test_card_run(card):
    """On the card: one short run of the main-path cell, correct."""
    r = subprocess.run(CMD, cwd=spec.REPO, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    import json

    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


test_card_run = pytest.mark.cuda(test_card_run)
