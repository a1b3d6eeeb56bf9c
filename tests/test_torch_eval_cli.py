"""The evaluation entry point `python -m deepsee_torch.evaluate` and the
training CLI's evaluation flags, on the CPU at the tiny test configuration
(get_preset monkeypatched): synthetic samples with the seeded init, the
default checkpoint (the port trainer's .pth files) against
--torch_checkpoint and --no_checkpoint, the card by default.  The data
flags are in test_torch_data_cli.py, --int8 in test_torch_int8.py."""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from deepsee_torch import evaluate as cli
from deepsee_torch.config import tiny_test_experiment
from deepsee_torch.train import __main__ as train_cli
from deepsee_torch.train import loop


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(cli, "get_preset", lambda name: tiny_test_experiment().replace(name=name))


def _argv(*extra):
    return ["--name", "tiny_test", "--synthetic", "--device", "cpu", "--num_samples", "4",
            "--batch_size", "2"] + list(extra)


def test_synthetic_run_writes_the_results(tiny, tmp_path, capsys):
    out = str(tmp_path / "out")
    result = cli.main(_argv("--no_checkpoint", "--out", out, "--save_images"))
    printed = json.loads(capsys.readouterr().out)
    assert printed.keys() == result.keys() and printed["n_samples"] == 4
    for key in ("FID", "psnr/mean", "ssim/mean", "ms_ssim/mean", "rmse/mean", "lpips/mean"):
        assert key in result
    assert np.isfinite(result["FID"]) and np.isfinite(result["lpips/mean"])
    with open(os.path.join(out, "metrics.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0] == "ID,PSNR,SSIM,MSSSIM,RMSE,LPIPS" and len(rows) == 5
    for side in ("fake", "real"):
        assert os.path.exists(os.path.join(out, f"fid_stats_4samples_{side}.npz"))
    for key in ("fake_image", "image_hr", "input_label", "combined"):
        assert sorted(os.listdir(os.path.join(out, "visuals", key))) == [
            "synthetic_0.png", "synthetic_1.png"]


def test_default_checkpoint_is_the_trainers(tiny, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    exp = tiny_test_experiment(checkpoints_dir=ckpt)
    exp = exp.replace(data=dataclasses.replace(exp.data, dataset="synthetic"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loop.Trainer(exp, device="cpu").run(max_steps=1)
    run_dir = os.path.join(ckpt, exp.name)
    quick = ("--no_fid", "--no_lpips")
    default = cli.main(_argv("--checkpoints_dir", ckpt, *quick))
    released = cli.main(_argv("--torch_checkpoint", run_dir, *quick))
    seeded = cli.main(_argv("--no_checkpoint", *quick))
    capsys.readouterr()
    for key in ("psnr/mean", "ssim/mean", "rmse/mean"):
        assert default[key] == released[key]
    assert default["rmse/mean"] != seeded["rmse/mean"]
    with pytest.raises(FileNotFoundError, match="export_torch.py"):
        cli.main(_argv("--checkpoints_dir", str(tmp_path / "empty"), *quick))


def test_runs_on_the_card_by_default(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--name", "tiny_test", "--synthetic", "--no_checkpoint"])


def test_train_cli_takes_the_evaluation_flags(monkeypatch, tmp_path):
    seen = {}

    class Recorder:
        def __init__(self, exp, device=None, continue_train=False):
            seen["exp"], self.system = exp, type("S", (), {"device": device})

        def run(self, max_steps=None):
            return type("State", (), {"step": max_steps})

    monkeypatch.setattr(loop, "Trainer", Recorder)
    monkeypatch.setattr(train_cli, "get_preset",
                        lambda name: tiny_test_experiment().replace(name=name))
    assert train_cli.main(["--name", "tiny", "--synthetic", "--device", "cpu", "--max_steps", "1",
                           "--checkpoints_dir", str(tmp_path), "--evaluation_freq", "8",
                           "--num_evaluation_samples", "16", "--inception_weights", "i.pth",
                           "--alexnet_weights", "a.pth"]) == 0
    train = seen["exp"].train
    assert train.batch_size == 2
    assert (train.evaluation_freq, train.num_evaluation_samples, train.inception_weights,
            train.alexnet_weights) == (8, 16, "i.pth", "a.pth")
