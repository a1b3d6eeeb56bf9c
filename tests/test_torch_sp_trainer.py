"""The port's Trainer, display, checkpoints and training CLI under spatial
sharding: 2 gloo ranks laid out 1 x 2 (data x model, "spatial") in
processes of their own (tests/_torch_dist_worker.py, tasks "sp_trainer" and
"sp_cli"), float32 on the CPU, the tiny configuration, Adam, against one
process:

  * two steps from the seeded init with a display and an evaluation at the
    trigger after them: the state within 1e-5 relative L2 of one process's,
    or twice its spread under one-ulp nudges of the weights; rank 0 alone
    writes the run directory;
  * the display shows whole images (the counterpart of
    tests/test_multihost_hygiene.py::test_display_full_image_under_spatial_mesh):
    the first sample's label, LR input, output and HR image at full size,
    the output the one-process eval-mode generate with the ranks' weights;
  * the networks are whole on every rank, so the ranks' checkpoint is one
    process's layout: one process restores it to the ranks' state bit for
    bit, and the ranks restore a one-process checkpoint bit for bit and
    continue where one process's own continuation lands (the rule above,
    the spread over the nudge seeds of tests/test_torch_tp_trainer.py);
  * python -m deepsee_torch.train --multihost --model_axis 2 --partition
    spatial on gloo.
"""

import functools
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from deepsee_torch.system import SRSystem
from deepsee_torch.train.loop import Trainer
from deepsee_torch.weights import load_reference_checkpoint
from test_torch_dist_step import NUDGES
from test_torch_tp_trainer import CONTINUE_NUDGES, RUN, _same_state, _within_nudges
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)


def _trainer(root, nudge_seed=None, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        trainer = Trainer(worker.sp_trainer_exp(root), device="cpu", **kw)
    if nudge_seed is not None:
        worker.nudge(trainer.system, 1, nudge_seed)
    return trainer


def _run(trainer, max_steps):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer.run(worker.trainer_batches(), max_steps=max_steps)
    return worker.trainer_state(trainer)


@functools.cache
def _runs(tmp):
    fresh = [_run(_trainer(f"{tmp}/one"), 2)]
    fresh += [_run(_trainer(f"{tmp}/nudged{s}", nudge_seed=s), 2) for s in NUDGES]
    shutil.copytree(f"{tmp}/one", f"{tmp}/ranks/one")
    spawned = worker.Spawned(f"{tmp}/ranks", ["sp_trainer", "sp_cli"])
    continued = []
    for seed in (None,) + CONTINUE_NUDGES:
        root = f"{tmp}/cont{seed}"
        shutil.copytree(f"{tmp}/one", root)
        continued.append(_run(_trainer(root, nudge_seed=seed, continue_train=True), 3))
    ranks, _ = spawned.results(timeout=240.0)
    return fresh, continued, ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp_trainer"))
    return tmp, _runs(tmp)


def test_ranks_are_bit_identical(runs):
    _, (_, _, ranks) = runs
    for key in ("fresh", "restored", "resumed"):
        _same_state(ranks[0]["sp_trainer"][key], ranks[1]["sp_trainer"][key])


def test_fresh_steps_match_one_process(runs):
    _, (fresh, _, ranks) = runs
    assert ranks[0]["sp_trainer"]["fresh"]["step"] == 2
    _within_nudges(ranks[0]["sp_trainer"]["fresh"], fresh)


def test_display_shows_the_whole_first_sample(runs):
    """Rank 0 displays whole images; the output is the eval-mode generate
    of one process with the weights the ranks saved after their last step."""
    tmp, (_, _, ranks) = runs
    shown = ranks[0]["sp_trainer"]["shown"]
    assert ranks[1]["sp_trainer"]["shown"] == {}
    exp = worker.sp_trainer_exp(tmp).replace(is_train=False)
    cfg = exp.model
    assert shown["synthesized_image"].shape == (cfg.crop_size, cfg.crop_size, 3)
    assert shown["real_image"].shape == (cfg.crop_size, cfg.crop_size, 3)
    assert shown["image_lr"].shape == (cfg.start_size, cfg.start_size, 3)
    assert shown["input_label"].shape[:2] == (cfg.crop_size, cfg.crop_size)
    system = SRSystem(exp, device="cpu")
    load_reference_checkpoint(system, os.path.join(tmp, "ranks", "sp", RUN))
    batch = worker.trainer_batches()[1]
    fake, _ = system.generate(system.preprocess(batch), use_full=cfg.full_style_image)
    np.testing.assert_allclose(shown["synthesized_image"], fake[0].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(shown["real_image"], batch["image_hr"][0])


def test_one_process_restores_the_ranks_checkpoint(runs):
    tmp, (_, _, ranks) = runs
    root = f"{tmp}/from_ranks"
    shutil.copytree(f"{tmp}/ranks/sp", root)
    restored = worker.trainer_state(_trainer(root, continue_train=True))
    _same_state(ranks[0]["sp_trainer"]["fresh"], restored)


def test_ranks_restore_a_one_process_checkpoint_and_continue(runs):
    _, (fresh, continued, ranks) = runs
    _same_state(fresh[0], ranks[0]["sp_trainer"]["restored"])
    resumed = ranks[0]["sp_trainer"]["resumed"]
    assert resumed["step"] == continued[0]["step"] == 3
    _within_nudges(resumed, continued)


def test_only_rank_zero_writes_and_evaluates_at_the_trigger(runs):
    tmp, _ = runs
    run_dir = os.path.join(tmp, "ranks", "sp", RUN)
    assert {"latest_net_SR.pth", "latest_net_E.pth", "latest_net_D.pth",
            "latest_train_state.pth", "config.json", "fid_iter.txt",
            "metrics_iter.txt"} <= set(os.listdir(run_dir))


def test_cli_trains_with_the_spatial_partition(runs):
    tmp, (_, _, ranks) = runs
    assert [r["sp_cli"]["train_exit"] for r in ranks] == [0, 0]
    files = os.listdir(os.path.join(tmp, "ranks", "sp_cli", "tiny"))
    assert {"latest_net_SR.pth", "latest_train_state.pth"} <= set(files)
    with torch.no_grad():
        sd = torch.load(os.path.join(tmp, "ranks", "sp_cli", "tiny", "latest_net_SR.pth"),
                        weights_only=True)["model"]
    assert all(torch.isfinite(v).all() for v in sd.values())
