"""The port's trainer on the CPU, tiny test configuration: the reference-
layout checkpoint files (the same keys as deepsee_tpu's
export_reference_checkpoint; net_SR / net_E load into an inference
SRSystem), resume (2 steps, save, resume, 1 step = 3 straight steps), the
evaluation trigger, the CLI's refusals, its remat flags and its device
rule, the synthetic
data and the iteration counter against the JAX package's.  The disk-fed
trainer is in test_torch_data_trainer.py."""

import dataclasses
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_tpu.utils.iter_counter import IterationCounter as JaxCounter
from deepsee_tpu.utils.torch_import import export_reference_checkpoint
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.data import DataLoader, SyntheticDataset
from deepsee_torch.system import SRSystem
from deepsee_torch.train import __main__ as cli
from deepsee_torch.train import loop
from deepsee_torch.train.loop import Trainer
from deepsee_torch.utils.iter_counter import IterationCounter
from deepsee_torch.weights import load_reference_checkpoint, reference_state_dict
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)


def _exp(tmp_path, **train):
    exp = torch_tiny(checkpoints_dir=str(tmp_path))
    return exp.replace(train=dataclasses.replace(exp.train, **train))


def _batches(cfg, n=2):
    rng = np.random.RandomState(0)
    return [{"image_hr": np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32),
             "label": rng.randint(0, cfg.label_nc, (2, 32, 32)).astype(np.int32)}
            for _ in range(n)]


def _trainer(exp, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        return Trainer(exp, device="cpu", **kw)


def test_trainer_writes_reference_checkpoint(tmp_path):
    exp = _exp(tmp_path)
    trainer = _trainer(exp)
    trainer.run(_batches(exp.model), max_steps=2)
    run_dir = os.path.join(str(tmp_path), exp.name)
    assert {"config.json", "iter.txt", "latest_net_SR.pth", "latest_net_E.pth",
            "latest_net_D.pth", "latest_train_state.pth", "loss_log.txt"} <= set(
        os.listdir(run_dir))
    # the same keys as the JAX package's reference export of the same model
    ref_dir = str(tmp_path / "jax")
    export_reference_checkpoint(JaxSystem(jax_tiny()).init(jax.random.PRNGKey(0)), ref_dir)
    for tag in ("SR", "E", "D"):
        ours = torch.load(os.path.join(run_dir, f"latest_net_{tag}.pth"), weights_only=True)
        theirs = torch.load(os.path.join(ref_dir, f"latest_net_{tag}.pth"), weights_only=True)
        assert set(ours) == {"model"} and set(ours["model"]) == set(theirs["model"])
    inference = SRSystem(exp.replace(is_train=False), device="cpu")
    load_reference_checkpoint(inference, run_dir)
    for name in ("g", "e"):
        trained = trainer.system.networks()[name].state_dict()
        for key, value in inference.networks()[name].state_dict().items():
            torch.testing.assert_close(value, trained[key], rtol=0, atol=0)
    fake, _ = inference.generate(inference.preprocess(_batches(exp.model)[0]), use_full=False)
    assert bool(torch.isfinite(fake).all())
    d = reference_state_dict(os.path.join(run_dir, "latest_net_D.pth"))
    trainer.system.discriminator.load_state_dict(d, strict=True)
    with open(os.path.join(run_dir, "config.json")) as f:
        assert json.load(f) == json.loads(exp.to_json())


def test_trainer_resume_matches_straight_run(tmp_path):
    """Two steps, a save, a resumed trainer and one more step give the
    networks, both optimizers and the step count of three straight steps
    (the resumed epoch restarts at its first batch, as the JAX trainer's
    does, which is the straight run's third batch here)."""
    data = _batches(torch_tiny().model)
    straight = _trainer(_exp(tmp_path / "a"))
    straight.run(data, max_steps=3)
    first = _trainer(_exp(tmp_path / "b"))
    first.run(data, max_steps=2)
    resumed = _trainer(_exp(tmp_path / "b"), continue_train=True)
    assert resumed.state.step == 2
    resumed.run(data, max_steps=3)
    assert resumed.state.step == straight.state.step == 3
    for name, net in straight.system.networks().items():
        other = resumed.system.networks()[name].state_dict()
        for key, value in net.state_dict().items():
            torch.testing.assert_close(other[key], value, rtol=0, atol=1e-7, msg=key)
    for opt in ("opt_g", "opt_d"):
        a = getattr(straight.state, opt).state_dict()["state"]
        b = getattr(resumed.state, opt).state_dict()["state"]
        for i, sa in a.items():
            for k, v in sa.items():
                torch.testing.assert_close(b[i][k], v, rtol=0, atol=1e-7)


def test_trainer_raises_at_an_evaluation_trigger(tmp_path, monkeypatch):
    """An evaluation trigger evaluates (it raised before the evaluation
    slice existed); an error inside the evaluation propagates, and the
    crash-safe save runs."""
    exp = _exp(tmp_path, evaluation_freq=2)
    trainer = _trainer(exp)
    trainer.run(_batches(exp.model), max_steps=1)
    run_dir = os.path.join(str(tmp_path), exp.name)
    assert {"fid_iter.txt", "metrics_iter.txt"} <= set(os.listdir(run_dir))
    os.remove(os.path.join(run_dir, "latest_train_state.pth"))

    def fail(evaluator, batches):
        raise RuntimeError("evaluation failed")

    monkeypatch.setattr(loop, "evaluate_set", fail)
    with pytest.raises(RuntimeError, match="evaluation failed"):
        trainer.run(_batches(exp.model), max_steps=2)
    assert os.path.exists(os.path.join(run_dir, "latest_train_state.pth"))


@pytest.mark.parametrize("flags,slice_name", [
    (["--partition", "spatial", "--model_axis", "3"], "does not divide start_size")])
def test_cli_refuses_flags_of_later_slices(capsys, flags, slice_name):
    argv = ["--name", "8x_independent_256x256"] + flags + ["--synthetic"]
    with pytest.raises(SystemExit):
        cli.parse_args(argv)
    assert slice_name in capsys.readouterr().err


@pytest.mark.parametrize("flags,remat,policy", [
    ([], False, "full"), (["--remat"], True, "full"),
    (["--remat", "--remat_policy", "convs"], True, "convs")])
def test_cli_takes_the_remat_flags(flags, remat, policy):
    """--remat and --remat_policy with the root train.py's defaults; an
    unknown policy is refused."""
    args = cli.parse_args(["--name", "32x_guided_512x512", "--synthetic"] + flags)
    assert (args.remat, args.remat_policy) == (remat, policy)
    with pytest.raises(SystemExit):
        cli.parse_args(["--remat", "--remat_policy", "dots"])


@pytest.mark.parametrize("policy", ["full", "convs"])
def test_cli_trains_with_remat(monkeypatch, capsys, tmp_path, policy):
    """The CLI's remat flags reach the Trainer's system, which trains 2
    steps on the CPU and writes its checkpoint."""
    built = []
    real = loop.SRSystem
    monkeypatch.setattr(loop, "SRSystem", lambda *a, **k: built.append(real(*a, **k)) or built[-1])
    monkeypatch.setattr(cli, "get_preset", lambda name: torch_tiny().replace(name=name))
    argv = ["--name", "tiny", "--synthetic", "--max_steps", "2", "--device", "cpu",
            "--batch_size", "2", "--checkpoints_dir", str(tmp_path), "--remat",
            "--remat_policy", policy]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli.main(argv) == 0
    gen = built[0].generator
    assert (gen.remat, gen.remat_policy) == (True, policy)
    assert "trained 2 steps on cpu" in capsys.readouterr().out
    assert os.path.exists(os.path.join(str(tmp_path), "tiny", "latest_net_SR.pth"))


def test_cli_needs_a_card_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "get_preset", lambda name: torch_tiny().replace(name=name))
    argv = ["--name", "tiny", "--synthetic", "--max_steps", "1",
            "--checkpoints_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli.main(argv + ["--device", "cpu", "--batch_size", "2"]) == 0
    assert os.path.exists(os.path.join(str(tmp_path), "tiny", "latest_net_SR.pth"))


@pytest.mark.parametrize("guided", [False, True])
def test_synthetic_dataset_matches_jax(guided):
    """Keys and labels as the JAX package's (PIL NEAREST, an integer
    upscale); images PIL's BICUBIC within one uint8 level."""
    model = dict(net_e="fullstyle", guiding_style_image=True) if guided else {}
    jexp, texp = jax_tiny(), torch_tiny()
    jds = JaxSynthetic(jexp.replace(model=dataclasses.replace(jexp.model, **model)), length=4)
    tds = SyntheticDataset(texp.replace(model=dataclasses.replace(texp.model, **model)),
                           length=4)
    for i in range(4):
        want, got = jds[i], tds[i]
        assert set(got) == set(want)
        for key, value in want.items():
            if key == "path":
                assert got[key] == value
            elif "label" in key:
                np.testing.assert_array_equal(got[key], value)
            else:
                assert got[key].dtype == np.float32 and got[key].shape == value.shape
                np.testing.assert_allclose(got[key], value, rtol=0, atol=1.01 / 127.5)
    batches = DataLoader(tds, 2, shuffle=False)
    assert len(batches) == 2
    first = next(iter(batches))
    assert first["image_hr"].shape == (2, 32, 32, 3)
    assert first["path"] == ["synthetic_0.png", "synthetic_1.png"]


def test_iteration_counter_matches_jax(tmp_path):
    """The triggers sample by sample, the epoch range and the resume record,
    against the JAX package's counter."""
    train = dict(print_freq=4, display_freq=6, save_latest_freq=8, evaluation_freq=10,
                 niter=2, niter_decay=1, batch_size=2)
    jexp = jax_tiny(checkpoints_dir=str(tmp_path / "jax"))
    jexp = jexp.replace(train=dataclasses.replace(jexp.train, **train))
    texp = _exp(tmp_path / "port", **train)
    jc, tc = JaxCounter(jexp, 20), IterationCounter(texp, 20)
    assert list(jc.training_epochs()) == list(tc.training_epochs())
    for c in (jc, tc):
        c.record_epoch_start(2)
    for _ in range(12):
        marks = []
        for c in (jc, tc):
            c.record_one_iteration()
            marks.append((c.needs_printing(), c.needs_displaying(), c.needs_saving(),
                          c.needs_evaluation(), c.total_steps_so_far, c.epoch_iter))
        assert marks[0] == marks[1]
    tc.record_current_iter()
    resumed = IterationCounter(texp, 20, continue_train=True)
    assert (resumed.first_epoch, resumed.epoch_iter, resumed.total_steps_so_far) == (2, 24, 24)
