"""The trainer's evaluation hook on the CPU, tiny test configuration: one
evaluation fires (evaluation_freq 4 samples at batch 2, three steps), writes
fid_iter.txt and metrics_iter.txt lines in the format of deepsee_tpu's
iteration counter (compared without the timestamp), and leaves the training
state bit for bit as a twin run without the evaluation: weights, running
statistics, spectral u/v, both optimizers and the step's generators."""

import dataclasses
import os
import re
import warnings

import numpy as np
import pytest
import torch

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.utils.iter_counter import IterationCounter as JaxCounter
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.train import loop
from torch_data_corpus import one_torch_thread, write_tree  # noqa: F401 (autouse)

STAMP = re.compile(r"^time=\d{4}/\d\d/\d\d-\d\d:\d\d:\d\d,")


def _exp(root, **train):
    exp = torch_tiny(checkpoints_dir=str(root))
    return exp.replace(train=dataclasses.replace(exp.train, **train))


def _batches(cfg, n=3):
    rng = np.random.RandomState(0)
    return [{"image_hr": np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32),
             "label": rng.randint(0, cfg.label_nc, (2, 32, 32)).astype(np.int32)}
            for _ in range(n)]


def _run(exp, steps=3):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        trainer = loop.Trainer(exp, device="cpu")
    trainer.run(_batches(exp.model), max_steps=steps)
    return trainer


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """Three steps with one evaluation, its result recorded."""
    root = tmp_path_factory.mktemp("evaluated")
    results = []
    real_evaluate_set = loop.evaluate_set

    def recording(evaluator, batches):
        results.append(real_evaluate_set(evaluator, batches))
        return results[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "evaluate_set", recording)
        exp = _exp(root / "port", evaluation_freq=4)
        trainer = _run(exp)
    return trainer, results, root, os.path.join(str(root / "port"), exp.name)


def test_history_lines_match_jax(evaluated):
    _, results, root, run_dir = evaluated
    assert len(results) == 1 and results[0]["n_samples"] == 4
    assert 0 < results[0]["FID"] < 500 and results[0]["lpips/mean"] > 0

    jexp = jax_tiny(checkpoints_dir=str(root / "jax"))
    jc = JaxCounter(jexp, 6)
    jc.record_epoch_start(1)
    jc.total_steps_so_far = 4  # the evaluation fired after the second step
    jc.record_fid(results[0]["FID"], "train", 4)
    jc.record_metrics(results[0], "train", 4)
    for name in ("fid_iter.txt", "metrics_iter.txt"):
        got = _lines(os.path.join(run_dir, name))
        want = _lines(os.path.join(str(root / "jax"), jexp.name, name))
        assert len(got) == len(want) == 1
        assert STAMP.match(got[0]) and STAMP.match(want[0])
        assert STAMP.sub("", got[0]) == STAMP.sub("", want[0])
    assert _lines(os.path.join(run_dir, "fid_iter.txt"))[0].endswith(
        f",split=train,num_samples=4,epoch=001,total_steps_so_far=0000000004,"
        f"fid={results[0]['FID']}")


def test_evaluation_leaves_the_training_state(evaluated, tmp_path):
    evaluated = evaluated[0]
    twin = _run(_exp(tmp_path, evaluation_freq=0))
    assert not os.path.exists(os.path.join(str(tmp_path), "tiny_test", "fid_iter.txt"))
    assert evaluated.state.step == twin.state.step == 3
    for name, net in twin.system.networks().items():
        other = evaluated.system.networks()[name]
        assert other.training == net.training
        got = other.state_dict()
        for key, value in net.state_dict().items():  # incl. running stats, u/v
            torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)
    for opt in ("opt_g", "opt_d"):
        a = getattr(twin.state, opt).state_dict()["state"]
        b = getattr(evaluated.state, opt).state_dict()["state"]
        for i, sa in a.items():
            for k, v in sa.items():
                torch.testing.assert_close(b[i][k], v, rtol=0, atol=0)
    for key, value in twin.state.generators_state().items():
        assert torch.equal(evaluated.state.generators_state()[key], value), key


def test_no_evaluation_before_its_start_epoch(tmp_path):
    _run(_exp(tmp_path, evaluation_freq=4, evaluation_start_epoch=2))
    assert not os.path.exists(os.path.join(str(tmp_path), "tiny_test", "fid_iter.txt"))


def test_validation_set_is_evaluated(tmp_path):
    """evaluate_val_set: each evaluation also sweeps the *_val dirs and
    appends a "validation" line to both histories."""
    images, labels, _ = write_tree(str(tmp_path / "val"), "celebamaskhq", 4)
    exp = _exp(tmp_path, evaluation_freq=4, evaluate_val_set=True)
    exp = exp.replace(data=dataclasses.replace(exp.data, image_dir_val=images,
                                               label_dir_val=labels))
    _run(exp)
    for name in ("fid_iter.txt", "metrics_iter.txt"):
        lines = _lines(os.path.join(str(tmp_path), exp.name, name))
        assert [",split=train," in lines[0], ",split=validation," in lines[1]] == [True, True]
        assert len(lines) == 2


def test_eval_history_line_matches_jax(tmp_path):
    """append_eval_history: "epoch,samples so far,value" lines, as the JAX
    package's counter writes them."""
    texp = _exp(tmp_path / "port")
    jexp = jax_tiny(checkpoints_dir=str(tmp_path / "jax"))
    lines = []
    for counter, root, name in ((loop.IterationCounter(texp, 6), tmp_path / "port", texp.name),
                                (JaxCounter(jexp, 6), tmp_path / "jax", jexp.name)):
        counter.record_epoch_start(3)
        counter.record_one_iteration()
        counter.append_eval_history("fid_iter.txt", 123.4)
        lines.append(_lines(os.path.join(str(root), name, "fid_iter.txt")))
    assert lines[0] == lines[1] == ["3,2,123.4"]
