"""The disk-fed trainer on the CPU, tiny test configuration, over fake CelebA
and CelebAMask-HQ trees, independent and guided: `Trainer.run()` consumes
the batches, in order, of the JAX package's loader built as its
`Trainer.make_dataloader()` builds it (deepsee_tpu/train/loop.py:87-99),
across an epoch boundary, and its periodic evaluation reads what the JAX
trainer's shuffled copy of the dataset yields (seed + 7919, :172-185).
Both packages' loaders decode with one worker here, so that the dataset's
augmentation draws reach the samples in index order."""

import copy
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.data import DataLoader as JaxLoader
from deepsee_tpu.data import create_dataset as jax_dataset
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.data import DataLoader
from deepsee_torch.train import loop
from torch_data_corpus import one_torch_thread, write_tree  # noqa: F401 (autouse)

GUIDED = dict(net_e="fullstyle", guiding_style_image=True, noisy_style_scale=0.05)
# dataset -> (model, data) fields: random 32^2 crops of 40^2 for
# CelebAMask-HQ; CelebA's center crop then a resize to 32^2 (labels: resize)
LAYOUTS = {
    "celebamaskhq": (dict(load_size=40), dict(preprocess_mode="resize_and_crop")),
    "celeba": (dict(), dict(preprocess_mode="center_crop_and_resize", center_crop_size=40)),
}


class OneWorker(DataLoader):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **{**kwargs, "num_workers": 1})


def _exps(root, dataset, guided, **train):
    dirs = write_tree(os.path.join(root, "tree"), dataset, 5, image_size=(44, 52),
                      label_size=(44, 52), group=3)
    model, data = LAYOUTS[dataset]
    model = dict(model, **(GUIDED if guided else {}))
    out = []
    for tiny in (torch_tiny, jax_tiny):
        exp = tiny(checkpoints_dir=os.path.join(root, "ckpt"))
        out.append(exp.replace(
            model=dataclasses.replace(exp.model, **model),
            train=dataclasses.replace(exp.train, **train),
            data=dataclasses.replace(exp.data, dataset=dataset, image_dir=dirs[0],
                                     label_dir=dirs[1], identities_file=dirs[2], **data)))
    return out


def _host(batch):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(g[key], value, err_msg=key)
            else:
                assert g[key] == value, key


@pytest.mark.parametrize("guided", [False, True], ids=["independent", "guided"])
@pytest.mark.parametrize("dataset", sorted(LAYOUTS))
def test_disk_fed_trainer_reads_the_jax_loaders_batches(tmp_path, monkeypatch, dataset,
                                                        guided):
    texp, jexp = _exps(str(tmp_path), dataset, guided, evaluation_freq=4)
    monkeypatch.setattr(loop, "DataLoader", OneWorker)
    consumed, evaluated = [], []

    class Evaluator:  # stands in for the metric networks: the loader is under test
        def __init__(self, *args, **kwargs):
            pass

    def record_evaluation(evaluator, loader):
        evaluated.extend(_host(b) for b in loader)
        return {"FID": 1.0}

    monkeypatch.setattr(loop, "InferenceEvaluator", Evaluator)
    monkeypatch.setattr(loop, "evaluate_set", record_evaluation)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        trainer = loop.Trainer(texp, device="cpu")
    step = trainer.step_gd

    def recording_step(state, batch):  # the batch stream is under test: one real step below
        consumed.append(_host(batch))
        state.step += 1
        return {}

    trainer.step_gd = recording_step
    loader = trainer.make_dataloader()
    assert (len(loader), loader.shuffle, loader.drop_last, loader.seed) == (2, True, True, 0)
    state = trainer.run(max_steps=3)  # two epochs: 5 samples at batch 2
    assert state.step == 3 and state.epoch == 2
    assert all(np.isfinite(float(v)) for v in step(state, consumed[-1]).values())

    tc = jexp.train
    jds = jax_dataset(jexp, phase="train")
    jloader = JaxLoader(jds, tc.batch_size, shuffle=True, drop_last=True, seed=tc.seed,
                        num_workers=1)
    first, second = list(jloader), list(jloader)
    _same(consumed, first + second[:1])
    assert {"path", "image_hr", "label"} <= set(consumed[0])
    assert ("guiding_image_id" in consumed[0]) == guided

    jeval = JaxLoader(copy.copy(jax_dataset(jexp, phase="train")), tc.batch_size, shuffle=True,
                      drop_last=True, seed=tc.seed + 7919, num_workers=1, prefetch=0)
    _same(evaluated, list(jeval))


def test_default_run_is_the_shuffled_synthetic_set(tmp_path, monkeypatch):
    """dataset="synthetic": make_dataloader shuffles the synthetic samples
    from the training seed, as the JAX trainer's loader does."""
    from deepsee_tpu.data import SyntheticDataset as JaxSynthetic

    exp = torch_tiny(checkpoints_dir=str(tmp_path))
    exp = exp.replace(data=dataclasses.replace(exp.data, dataset="synthetic"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = loop.Trainer(exp, device="cpu")
    loader = trainer.make_dataloader()
    jloader = JaxLoader(JaxSynthetic(jax_tiny(), phase="train"), 2, seed=0)
    got, want = next(iter(loader)), next(iter(jloader))
    assert got["path"] == want["path"] != ["synthetic_0.png", "synthetic_1.png"]
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_allclose(got["image_hr"], want["image_hr"], rtol=0, atol=1.01 / 127.5)
