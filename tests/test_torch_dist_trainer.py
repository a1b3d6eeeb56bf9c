"""The port's trainer, evaluator and CLIs over 2 gloo ranks in processes of
their own (tests/_torch_dist_worker.py, one torch thread each), tiny
configuration on the CPU; imports no deepsee_tpu.

  * `Trainer.run` for one epoch of 8 synthetic samples at global batch 4:
    each rank's stripe is disjoint from the other's and together they cover
    the epoch, each step takes 4 / 2 rows per rank, the ranks end bit for
    bit alike, only rank 0 writes (checkpoint, config.json, loss_log.txt,
    iter.txt), and a one-process Trainer restores the checkpoint to rank 0's
    state;
  * `InferenceEvaluator.run` on 8 samples, each rank its stripe: PSNR, SSIM,
    MS-SSIM, RMSE, LPIPS and FID (seeded random networks) equal those of one
    process over the same samples in the gathered order, bit for bit (the
    same batches through the same operations, then the same rows);
  * `python -m deepsee_torch.train --multihost --data_axis 2` and
    `python -m deepsee_torch.evaluate --multihost` on gloo.
"""

import functools
import os
import warnings

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from deepsee_torch.train.loop import Trainer
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)


def _same_result(a, b) -> bool:
    """Equal result dicts, a NaN (MS-SSIM at 32^2) equal to a NaN; the wall
    time left out."""
    keys = set(a) - {"eval_seconds"}
    return keys == set(b) - {"eval_seconds"} and all(
        a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])) for k in keys)


@functools.cache
def _spawned(tmp):
    return worker.Spawned(tmp, ["trainer", "eval", "cli"]).results()


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_trainer"))
    return tmp, _spawned(tmp)[0]


def test_stripes_are_disjoint_and_cover_the_epoch(grouped):
    _, ranks = grouped
    seen = [sorted(p for step in r["trainer"]["paths"] for p in step) for r in ranks]
    assert not set(seen[0]) & set(seen[1])
    assert sorted(seen[0] + seen[1]) == sorted(f"synthetic_{i}.png"
                                               for i in range(worker.TRAIN_SAMPLES))


def test_each_step_takes_the_per_rank_batch(grouped):
    _, ranks = grouped
    steps = worker.TRAIN_SAMPLES // worker.GLOBAL_BATCH
    for r in ranks:
        assert r["trainer"]["step"] == steps
        assert [len(p) for p in r["trainer"]["paths"]] == [worker.GLOBAL_BATCH // 2] * steps


def test_trained_ranks_are_bit_identical(grouped):
    _, ranks = grouped
    a, b = (r["trainer"]["snapshot"] for r in ranks)
    assert all(torch.equal(a[net][k], b[net][k]) for net in a for k in a[net])


def test_only_rank_zero_writes(grouped):
    tmp, ranks = grouped
    run_dir = os.path.join(tmp, "ckpt", "tiny_test")
    assert ranks[1]["trainer"]["writes"] == []
    written = {os.path.basename(p) for p in ranks[0]["trainer"]["writes"]}
    assert {"config.json", "loss_log.txt", "iter.txt"} <= written
    assert {"latest_net_SR.pth", "latest_net_E.pth", "latest_net_D.pth",
            "latest_train_state.pth"} <= set(os.listdir(run_dir))
    with open(os.path.join(run_dir, "loss_log.txt")) as f:
        log = f.read()
    assert log.count("Training Loss") == 1
    assert log.count("(epoch: 1,") == worker.TRAIN_SAMPLES // worker.GLOBAL_BATCH


def test_one_process_restores_the_checkpoint(grouped):
    tmp, ranks = grouped
    want = ranks[0]["trainer"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = Trainer(worker.trainer_exp(os.path.join(tmp, "ckpt")), device="cpu",
                          continue_train=True)
    assert trainer.state.step == want["step"]
    got = worker.snapshot(trainer.system)
    assert all(torch.equal(got[net][k], want["snapshot"][net][k]) for net in got for k in got[net])
    for opt, key in ((trainer.state.opt_g, "opt_g"), (trainer.state.opt_d, "opt_d")):
        for i, state in opt.state_dict()["state"].items():
            for name, value in state.items():
                assert torch.equal(torch.as_tensor(value), torch.as_tensor(
                    want[key]["state"][i][name])), (key, i, name)


def test_evaluator_gathers_what_one_process_computes(grouped):
    _, ranks = grouped
    # rank 0's stripe, then rank 1's: the gathered order
    order = [i for r in range(2) for i in range(r, worker.EVAL_SAMPLES, 2)]
    want = worker.eval_run(order)
    for r in ranks:
        assert _same_result(r["eval"], want)
    assert {"FID", "psnr/mean", "ssim/mean", "ms_ssim/mean", "rmse/mean",
            "lpips/mean"} <= set(want)
    assert np.isfinite(want["FID"])


def test_clis_train_and_evaluate_over_two_ranks(grouped):
    tmp, _ = grouped
    ranks, outputs = _spawned(tmp)
    for r, out in zip(ranks, outputs):
        assert r["cli"]["train_exit"] == 0
        assert "of 2, backend gloo, device cpu" in out
    assert "trained 1 steps on cpu" in outputs[0]
    assert "trained 1 steps" not in outputs[1]
    assert _same_result(ranks[0]["cli"]["eval"], ranks[1]["cli"]["eval"])
    assert os.path.exists(os.path.join(tmp, "cli", "tiny", "latest_net_SR.pth"))
