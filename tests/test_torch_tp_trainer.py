"""The port's Trainer, checkpoints, in-training evaluation and training
CLI under tensor parallelism: 2 gloo ranks laid out 1 x 2 (data x model)
in processes of their own (tests/_torch_dist_worker.py, one torch thread
each), float32 on the CPU, the tiny configuration with min_shard_ch 8,
Adam, against one process:

  * two steps from the seeded init, with an evaluation at the trigger
    after them: the gathered state within 1e-5 relative L2 of one
    process's, or twice its spread under one-ulp nudges of the weights;
    rank 0 alone writes the run directory;
  * the checkpoint the ranks write (rank 0, from the gathered shards and
    Adam moments) is the one-process layout: one process restores it to
    the ranks' gathered state bit for bit, networks, moments and step;
  * a one-process checkpoint restored by the ranks gives them the
    one-process state bit for bit, and one more step lands where the one
    process's own continuation lands (the same rule, the spread over the
    8 nudge seeds CONTINUE_NUDGES: Adam's third step takes discrete turns,
    moving an element whose gradient is near zero by a whole step, under
    float32 noise of any origin; the one process's own continuations
    nudged from seeds 0-9 leave D 1.3e-7 to 4.2e-7 from the run itself,
    or, seeds 2, 4 and 8, 1.19e-3);
  * the evaluator on the ranks' gathered networks computes what one
    process computes with those weights, bit for bit;
  * python -m deepsee_torch.train --multihost --model_axis 2 on gloo.
"""

import functools
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from deepsee_torch.eval.evaluator import InferenceEvaluator
from deepsee_torch.system import SRSystem
from deepsee_torch.train.loop import Trainer
from deepsee_torch.weights import load_reference_checkpoint
from test_torch_dist_step import NUDGES, REL_L2
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

RUN = "tiny_test"
CONTINUE_NUDGES = tuple(range(8))


def _trainer(root, nudge_seed=None, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        trainer = Trainer(worker.tp_trainer_exp(root), device="cpu", **kw)
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
    """The one-process runs (fresh with nudged twins; continued from its
    checkpoint, with nudged twins) and the ranks' results; the ranks run
    while this process computes its continuations."""
    fresh = [_run(_trainer(f"{tmp}/one"), 2)]
    fresh += [_run(_trainer(f"{tmp}/nudged{s}", nudge_seed=s), 2) for s in NUDGES]
    shutil.copytree(f"{tmp}/one", f"{tmp}/ranks/one")
    spawned = worker.Spawned(f"{tmp}/ranks", ["tp_trainer", "tp_cli"])
    continued = []
    for seed in (None,) + CONTINUE_NUDGES:
        root = f"{tmp}/cont{seed}"
        shutil.copytree(f"{tmp}/one", root)
        continued.append(_run(_trainer(root, nudge_seed=seed, continue_train=True), 3))
    ranks, _ = spawned.results(timeout=240.0)
    return fresh, continued, ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_trainer"))
    return tmp, _runs(tmp)


def _flat(snap, net):
    return torch.cat([v.double().reshape(-1) for _, v in sorted(snap[net].items())])


def _within_nudges(got, runs):
    """`got` (a trainer_state) against runs[0] within REL_L2 or twice the
    spread of the nudged runs[1:], per network."""
    want, nudged = runs[0]["snapshot"], [r["snapshot"] for r in runs[1:]]
    for net in want:
        ref = _flat(want, net)
        err = float((_flat(got["snapshot"], net) - ref).norm() / ref.norm())
        spread = max(float((_flat(n, net) - ref).norm() / ref.norm()) for n in nudged)
        assert err <= max(REL_L2, 2 * spread), f"{net}: {err:.3e} (one-ulp spread {spread:.3e})"


def _same_state(a, b):
    assert a["step"] == b["step"]
    for net in a["snapshot"]:
        for key, value in a["snapshot"][net].items():
            assert torch.equal(b["snapshot"][net][key], value), f"{net} {key}"
    for opt in a["opt"]:
        sa, sb = a["opt"][opt]["state"], b["opt"][opt]["state"]
        assert set(sa) == set(sb)
        for i in sa:
            for k, v in sa[i].items():
                assert torch.equal(torch.as_tensor(sb[i][k]), torch.as_tensor(v)), (opt, i, k)


def test_ranks_are_bit_identical(runs):
    _, (_, _, ranks) = runs
    for key in ("fresh", "restored", "resumed"):
        _same_state(ranks[0]["tp_trainer"][key], ranks[1]["tp_trainer"][key])


def test_fresh_steps_match_one_process(runs):
    _, (fresh, _, ranks) = runs
    assert ranks[0]["tp_trainer"]["fresh"]["step"] == 2
    _within_nudges(ranks[0]["tp_trainer"]["fresh"], fresh)


def test_one_process_restores_the_ranks_checkpoint(runs):
    """The ranks' files hold their gathered state; a one-process Trainer
    restores it bit for bit (Adam moments included)."""
    tmp, (_, _, ranks) = runs
    root = f"{tmp}/from_ranks"
    shutil.copytree(f"{tmp}/ranks/tp", root)
    restored = worker.trainer_state(_trainer(root, continue_train=True))
    _same_state(ranks[0]["tp_trainer"]["fresh"], restored)


def test_ranks_restore_a_one_process_checkpoint_and_continue(runs):
    _, (fresh, continued, ranks) = runs
    _same_state(fresh[0], ranks[0]["tp_trainer"]["restored"])
    resumed = ranks[0]["tp_trainer"]["resumed"]
    assert resumed["step"] == continued[0]["step"] == 3
    _within_nudges(resumed, continued)


def test_only_rank_zero_writes_and_evaluates_at_the_trigger(runs):
    tmp, _ = runs
    run_dir = os.path.join(tmp, "ranks", "tp", RUN)
    assert {"latest_net_SR.pth", "latest_net_E.pth", "latest_net_D.pth",
            "latest_train_state.pth", "config.json", "fid_iter.txt",
            "metrics_iter.txt"} <= set(os.listdir(run_dir))


def test_evaluation_of_the_gathered_networks_is_one_process(runs):
    tmp, (_, _, ranks) = runs
    exp = worker.tp_trainer_exp(tmp).replace(is_train=False)
    system = SRSystem(exp, device="cpu")
    load_reference_checkpoint(system, os.path.join(tmp, "ranks", "tp", RUN))
    want = InferenceEvaluator(system, 4).run(worker.trainer_batches())
    want.pop("eval_seconds")
    for rank in ranks:
        got = rank["tp_trainer"]["eval"]
        assert set(got) == set(want)
        assert all(got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])) for k in want)


def test_cli_trains_with_a_model_axis(runs):
    tmp, (_, _, ranks) = runs
    assert [r["tp_cli"]["train_exit"] for r in ranks] == [0, 0]
    files = os.listdir(os.path.join(tmp, "ranks", "tp_cli", "tiny"))
    assert {"latest_net_SR.pth", "latest_train_state.pth"} <= set(files)
