"""The entry points' data flags on the CPU at the tiny test configuration
(get_preset monkeypatched): `python -m deepsee_torch.train` takes
--image_dir / --label_dir / the *_val dirs / --identities_file /
--evaluate_val_set and trains from a tree without --synthetic;
`python -m deepsee_torch.evaluate` reads a test tree and writes its sample
IDs into the CSV; `python -m deepsee_torch.evaluate_folder` writes the
metrics.csv of the repository's evaluate_folder.py on the same folders."""

import csv
import dataclasses
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from deepsee_torch import evaluate as eval_cli
from deepsee_torch import evaluate_folder
from deepsee_torch.config import tiny_test_experiment
from deepsee_torch.train import __main__ as train_cli
from deepsee_torch.train import loop
from test_torch_eval_metrics import PSNR_ATOL_DB, RTOL
from torch_data_corpus import one_torch_thread, write_tree  # noqa: F401 (autouse)


def _tiny(name):
    return tiny_test_experiment().replace(name=name)


@pytest.fixture
def tree(tmp_path):
    return write_tree(str(tmp_path / "tree"), "celebamaskhq", 6, group=2)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("flag", ["image_dir", "label_dir", "image_dir_val", "label_dir_val",
                                  "identities_file", "evaluate_val_set", "synthetic", None])
def test_train_cli_takes_the_data_flags(monkeypatch, tmp_path, flag):
    seen = {}

    class Recorder:
        def __init__(self, exp, device=None, continue_train=False):
            seen["exp"], self.system = exp, type("S", (), {"device": device})

        def run(self, max_steps=None):
            return type("State", (), {"step": max_steps})

    monkeypatch.setattr(loop, "Trainer", Recorder)
    monkeypatch.setattr(train_cli, "get_preset", _tiny)
    argv = ["--name", "tiny", "--device", "cpu", "--checkpoints_dir", str(tmp_path)]
    if flag in ("evaluate_val_set", "synthetic"):
        argv.append(f"--{flag}")
    elif flag:
        argv += [f"--{flag}", f"/x/{flag}"]
    assert train_cli.main(argv) == 0
    exp = seen["exp"]
    assert exp.data.dataset == ("synthetic" if flag == "synthetic" else "celebamaskhq")
    assert exp.train.evaluate_val_set == (flag == "evaluate_val_set")
    for field in ("image_dir", "label_dir", "image_dir_val", "label_dir_val", "identities_file"):
        assert getattr(exp.data, field) == (f"/x/{field}" if field == flag else "")


def test_train_cli_trains_from_a_tree(monkeypatch, tmp_path, tree, capsys):
    """Two steps from the tree (no --synthetic): the checkpoint files, and
    the data settings in its config.json.  (The validation sweep itself:
    test_torch_eval_trainer.py::test_validation_set_is_evaluated.)"""
    monkeypatch.setattr(train_cli, "get_preset", _tiny)
    ckpt = str(tmp_path / "ckpt")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        assert train_cli.main([
            "--name", "tiny", "--device", "cpu", "--checkpoints_dir", ckpt,
            "--image_dir", tree[0], "--label_dir", tree[1], "--batch_size", "2",
            "--max_steps", "2"]) == 0
    assert "trained 2 steps on cpu" in capsys.readouterr().out
    run_dir = os.path.join(ckpt, "tiny")
    assert {"config.json", "latest_net_SR.pth", "latest_net_E.pth", "latest_net_D.pth",
            "latest_train_state.pth", "iter.txt"} <= set(os.listdir(run_dir))
    with open(os.path.join(run_dir, "config.json")) as f:
        data = json.load(f)["data"]
    assert (data["dataset"], data["image_dir"], data["label_dir"]) == (
        "celebamaskhq", tree[0], tree[1])


@pytest.mark.parametrize("flag", ["image_dir", "label_dir", "identities_file", None])
def test_evaluate_cli_takes_the_data_flags(flag):
    argv = [f"--{flag}", f"/x/{flag}"] if flag else []
    args = eval_cli.parse_args(argv)
    assert not args.synthetic
    for field in ("image_dir", "label_dir", "identities_file"):
        assert getattr(args, field) == (f"/x/{field}" if field == flag else "")


@pytest.mark.parametrize("guided", [False, True], ids=["independent", "guided"])
def test_evaluate_cli_reads_a_test_tree(monkeypatch, tmp_path, tree, capsys, guided):
    """Samples in file order, the last partial batch dropped; the guided
    model's samples whose identity has no other image are skipped; the CSV's
    ID column holds the file stems."""
    exp = tiny_test_experiment()
    if guided:
        exp = exp.replace(model=dataclasses.replace(
            exp.model, net_e="fullstyle", guiding_style_image=True, noisy_style_scale=0.05))
        os.remove(os.path.join(tree[0], "5.jpg"))
        os.remove(os.path.join(tree[1], "5.png"))  # 4 now has no other image
    monkeypatch.setattr(eval_cli, "get_preset", lambda name: exp.replace(name=name))
    out = str(tmp_path / "out")
    result = eval_cli.main([
        "--name", "tiny", "--device", "cpu", "--no_checkpoint", "--image_dir", tree[0],
        "--label_dir", tree[1], "--identities_file", tree[2], "--batch_size", "2",
        "--num_samples", "8", "--no_fid", "--no_lpips", "--out", out])
    capsys.readouterr()
    rows = _rows(os.path.join(out, "metrics.csv"))
    want = ["0", "1", "2", "3"] if guided else ["0", "1", "2", "3", "4", "5"]
    assert rows[0] == ["ID", "PSNR", "SSIM", "MSSSIM", "RMSE", "LPIPS"]
    assert [r[0] for r in rows[1:]] == want and result["n_samples"] == len(want)


def test_evaluate_folder_matches_the_root_script(monkeypatch, tmp_path, capsys):
    """The same metrics.csv rows (IDs exact, metrics within the metric
    tests' tolerances) as evaluate_folder.py on CelebA-format folders: the
    ground truth center-cropped to 178 and resized, fakes read as they are."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        import evaluate_folder as root_script
    finally:
        sys.path.pop(0)
    real_dir, _, _ = write_tree(str(tmp_path / "real"), "celeba", 3, image_size=(178, 218))
    fake_dir = tmp_path / "fake"
    fake_dir.mkdir()
    rng = np.random.RandomState(0)
    for stem in ("000001", "000002", "000003"):  # the ground truth, noisy
        real = (evaluate_folder.load_real(os.path.join(real_dir, f"{stem}.jpg"), "celeba", 64)
                + 1.0) * 127.5
        fake = np.clip(real + rng.randint(-20, 21, real.shape), 0, 255).astype(np.uint8)
        Image.fromarray(fake).save(fake_dir / f"{stem}.png")
    args = ["--fake_dir", str(fake_dir), "--real_dir", real_dir, "--dataset", "celeba",
            "--crop_size", "64", "--batch_size", "2", "--no_fid", "--no_lpips"]
    monkeypatch.setattr(sys, "argv", ["evaluate_folder.py", *args, "--out",
                                      str(tmp_path / "jax")])
    want = root_script.main()
    got = evaluate_folder.main([*args, "--out", str(tmp_path / "port"), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"psnr/mean: {got['psnr/mean']}" in printed and "ssim/std" in printed
    assert got["n_samples"] == want["n_samples"] == 3
    want_rows = _rows(str(tmp_path / "jax" / "metrics.csv"))
    got_rows = _rows(str(tmp_path / "port" / "metrics.csv"))
    assert [r[0] for r in got_rows] == [r[0] for r in want_rows]
    for g, w in zip(got_rows[1:], want_rows[1:]):
        np.testing.assert_allclose(float(g[1]), float(w[1]), rtol=0, atol=PSNR_ATOL_DB)
        for i, name in ((2, "ssim"), (3, "ms_ssim"), (4, "rmse")):
            np.testing.assert_allclose(float(g[i]), float(w[i]), rtol=RTOL[name], atol=0)
        assert g[5] == w[5] == ""


def test_evaluate_folder_metric_networks_and_device(monkeypatch, tmp_path, capsys):
    """With FID and LPIPS (seeded random networks) the result is finite; the
    card is the default."""
    real_dir, _, _ = write_tree(str(tmp_path / "real"), "celebamaskhq", 2,
                                image_size=(64, 64))
    args = ["--fake_dir", real_dir, "--real_dir", real_dir, "--crop_size", "64"]
    result = evaluate_folder.main(args + ["--device", "cpu"])
    capsys.readouterr()
    assert result["n_samples"] == 2 and np.isfinite(result["FID"])
    assert np.isfinite(result["lpips/mean"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_folder.main(args)
