"""The port's DataLoader (deepsee_torch/data/loader.py) against the JAX
package's over the same datasets: the same batches in the same order over
two epochs with shuffle, drop_last, shards and prefetch on and off; the
per-epoch reseed of the dataset and its opt-out; skipped samples;
abandoning the iteration stops the threads; a file that does not decode
ends the epoch as in the JAX package."""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest

from deepsee_tpu.config import get_preset as jax_preset
from deepsee_tpu.data import datasets as jd
from deepsee_tpu.data import loader as jl
from deepsee_torch.config import get_preset
from deepsee_torch.data import datasets as td
from deepsee_torch.data import loader as tl
from torch_data_corpus import write_tree


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(port dataset, JAX dataset): 7 CelebAMask-HQ samples, 32^2 crops from
    40^2 (random crops and flips), guided (ids drawn per sample)."""
    dirs = write_tree(str(tmp_path_factory.mktemp("tree")), "celebamaskhq", 7, group=3)
    out = []
    for preset, mod in ((get_preset, td), (jax_preset, jd)):
        exp = preset("8x_guided_256x256")
        exp = exp.replace(
            model=dataclasses.replace(exp.model, load_size=40, crop_size=32),
            data=dataclasses.replace(exp.data, image_dir=dirs[0], label_dir=dirs[1],
                                     identities_file=dirs[2]))
        out.append(mod.create_dataset(exp, "train"))
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            if isinstance(value, np.ndarray):
                assert g[key].dtype == value.dtype
                np.testing.assert_array_equal(g[key], value, err_msg=key)
            else:
                assert g[key] == value, key


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("shuffle,drop_last,shard", [
    (True, True, (0, 1)), (True, False, (0, 1)), (False, False, (0, 1)),
    (True, True, (1, 2)), (False, False, (0, 3))])
def test_batches_match_jax_over_two_epochs(pair, shuffle, drop_last, shard, prefetch):
    """One decode worker: the dataset's augmentation draws then reach the
    samples in index order in both packages."""
    kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=1, seed=5, prefetch=prefetch,
              shard_index=shard[0], num_shards=shard[1])
    tload, jload = tl.DataLoader(pair[0], 2, **kw), jl.DataLoader(pair[1], 2, **kw)
    assert len(tload) == len(jload)
    for _ in range(2):
        _same_batches(list(tload), list(jload))
    assert tload.epoch == jload.epoch == 2


def test_file_order_holds_with_more_workers(pair):
    """With four decode threads the draws reach the samples in thread order
    (as in the JAX package); the files of every batch stay in order."""
    tload = tl.DataLoader(pair[0], 3, num_workers=4, seed=9, drop_last=False)
    jload = jl.DataLoader(pair[1], 3, num_workers=4, seed=9, drop_last=False)
    for _ in range(2):
        got, want = list(tload), list(jload)
        assert [b["path"] for b in got] == [b["path"] for b in want]
        assert [b["image_hr"].shape for b in got] == [(3, 32, 32, 3)] * 2 + [(1, 32, 32, 3)]


class _Recorder:
    def __init__(self, n=10, skip=(), fail=(), skip_exception=td.SkipSampleException):
        self.n, self.skip, self.fail, self.seeds = n, set(skip), set(fail), []
        self.skip_exception = skip_exception

    def __len__(self):
        return self.n

    def seed(self, seed):
        self.seeds.append(seed)

    def __getitem__(self, i):
        if i in self.fail:
            raise OSError(f"cannot read sample {i}")
        if i in self.skip:
            raise self.skip_exception(str(i))
        return {"label": np.full((2, 2), i, np.int32), "path": f"{i}.png"}


@pytest.mark.parametrize("reseed", [True, False])
def test_reseed_and_skip_as_jax(reseed):
    got = _Recorder(skip=(2, 5))
    want = _Recorder(skip=(2, 5), skip_exception=jd.SkipSampleException)
    tload = tl.DataLoader(got, 3, seed=4, reseed_dataset=reseed, drop_last=False)
    jload = jl.DataLoader(want, 3, seed=4, reseed_dataset=reseed, drop_last=False)
    for _ in range(2):
        _same_batches(list(tload), list(jload))
    assert got.seeds == want.seeds == ([5, 6] if reseed else [])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_abandoning_stops_the_threads(prefetch):
    before = set(threading.enumerate())
    loader = tl.DataLoader(_Recorder(n=400), 2, num_workers=3, prefetch=prefetch)
    it = iter(loader)
    next(it)
    started = [t for t in threading.enumerate() if t not in before]
    assert started  # the decode pool (and the prefetch thread)
    it.close()
    deadline = time.time() + 30
    while any(t.is_alive() for t in started) and time.time() < deadline:
        time.sleep(0.05)
    assert not [t for t in started if t.is_alive()]


@pytest.fixture
def corrupt_pair(tmp_path):
    """(port dataset, JAX dataset) over 7 CelebAMask-HQ samples whose image
    5 is not a JPEG; new for each test, since a decode thread left behind by
    the error may still draw from its dataset's Random."""
    dirs = write_tree(str(tmp_path), "celebamaskhq", 7)
    with open(os.path.join(dirs[0], "5.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 not a jpeg")
    out = []
    for preset, mod in ((get_preset, td), (jax_preset, jd)):
        exp = preset("8x_independent_256x256")
        exp = exp.replace(
            model=dataclasses.replace(exp.model, load_size=40, crop_size=32),
            data=dataclasses.replace(exp.data, image_dir=dirs[0], label_dir=dirs[1]))
        out.append(mod.create_dataset(exp, "train"))
    return out


@pytest.mark.parametrize("prefetch", [0, 2])
def test_a_corrupt_file_ends_the_epoch_as_in_jax(corrupt_pair, monkeypatch, prefetch):
    """Without the prefetch thread the decode error reaches the consumer;
    with it, the thread raises it and the consumer's epoch ends after the
    batches before the file, in both packages."""
    thread_errors = []
    monkeypatch.setattr(threading, "excepthook", thread_errors.append)
    results = []
    for mod, dataset in ((tl, corrupt_pair[0]), (jl, corrupt_pair[1])):
        loader = mod.DataLoader(dataset, 2, shuffle=False, num_workers=1, prefetch=prefetch)
        got = []
        try:
            for b in loader:
                got.append(b)
            results.append((got, None))
        except OSError as e:
            results.append((got, str(e)))
    (got, error), (want, jax_error) = results
    _same_batches(got, want)
    assert [os.path.basename(p) for b in got for p in b["path"]] == [
        "0.jpg", "1.jpg", "2.jpg", "3.jpg"]
    assert error == jax_error
    assert (error is None) == (prefetch > 0)
    if prefetch:
        assert [type(e.exc_value) for e in thread_errors] == [OSError, OSError]
        assert str(thread_errors[0].exc_value) == str(thread_errors[1].exc_value)
