"""The port's datasets (deepsee_torch/data/datasets.py) against the JAX
package's on the same fake trees: file pairing and its mismatch assertion,
the files.list cache, samples and guiding ids from the same seed for CelebA
and CelebAMask-HQ (independent and guided, train and test),
SkipSampleException off-train, create_dataset; and the label size read
from the file's bytes without Pillow's header parse."""

import dataclasses
import os

import numpy as np
import pytest

from deepsee_tpu.config import get_preset as jax_preset
from deepsee_tpu.data import datasets as jd
from deepsee_torch.config import get_preset
from deepsee_torch.data import datasets as td
from torch_data_corpus import write_tree

PRESETS = {"celebamaskhq": "8x_{}_256x256", "celeba": "8x_{}_128x128"}


def _exps(dataset, variant, dirs, **data):
    """The same small experiment in both packages: 32^2 crops from 40^2."""
    out = []
    for preset in (get_preset, jax_preset):
        exp = preset(PRESETS[dataset].format(variant))
        model = dataclasses.replace(exp.model, load_size=40, crop_size=32)
        d = dataclasses.replace(exp.data, image_dir=dirs[0], label_dir=dirs[1],
                                identities_file=dirs[2], **data)
        out.append(exp.replace(model=model, data=d))
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    return {"celebamaskhq": write_tree(str(root / "hq"), "celebamaskhq", 6, group=3),
            "celeba": write_tree(str(root / "celeba"), "celeba", 6, image_size=(44, 52),
                                 label_size=(44, 52), group=3)}


def _same_sample(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("phase", ["train", "test"])
@pytest.mark.parametrize("variant", ["independent", "guided"])
@pytest.mark.parametrize("dataset", ["celebamaskhq", "celeba"])
def test_samples_and_guiding_ids_match_jax(trees, dataset, variant, phase):
    texp, jexp = _exps(dataset, variant, trees[dataset])
    tds, jds = td.create_dataset(texp, phase), jd.create_dataset(jexp, phase)
    assert type(tds).__name__ == type(jds).__name__ and len(tds) == len(jds) == 6
    assert tds.image_paths == jds.image_paths and tds.label_paths == jds.label_paths
    for seed in (3, 11):
        tds.seed(seed)
        jds.seed(seed)
        for i in range(len(tds)):
            _same_sample(tds[i], jds[i])


def test_pairing_and_its_mismatch_assertion(trees, tmp_path):
    images, labels, ids = write_tree(str(tmp_path), "celebamaskhq", 3)
    os.rename(os.path.join(labels, "2.png"), os.path.join(labels, "7.png"))
    texp, jexp = _exps("celebamaskhq", "independent", (images, labels, ids))
    for mod, exp in ((td, texp), (jd, jexp)):
        with pytest.raises(AssertionError, match="pair mismatch"):
            mod.CelebAMaskHQDataset(exp)
    os.remove(os.path.join(labels, "7.png"))
    for mod, exp in ((td, texp), (jd, jexp)):
        with pytest.raises(AssertionError, match="#labels"):
            mod.CelebAMaskHQDataset(exp)
    for mod, exp in ((td, texp), (jd, jexp)):
        ds = mod.CelebAMaskHQDataset(exp.replace(data=dataclasses.replace(
            exp.data, no_pairing_check=True, max_dataset_size=2)))
        assert len(ds) == 2


def test_files_list_cache(tmp_path):
    images, _, _ = write_tree(str(tmp_path), "celeba", 12)
    want = jd.list_images(images)
    assert td.list_images(images) == want
    assert [os.path.basename(p) for p in want[:3]] == ["000001.jpg", "000002.jpg", "000003.jpg"]
    assert td.list_images(images, write_cache=True) == want
    with open(os.path.join(images, "files.list")) as f:
        assert f.read().splitlines() == want
    with open(os.path.join(images, "files.list"), "w") as f:
        f.write("\n".join(want[:2]) + "\n")
    assert td.list_images(images, read_cache=True) == jd.list_images(images, read_cache=True) \
        == want[:2]
    assert td.natural_sort_key("img10b") == jd.natural_sort_key("img10b")


@pytest.mark.parametrize("dataset", ["celebamaskhq", "celeba"])
def test_skip_sample_off_train(tmp_path, dataset):
    """A test-phase sample whose identity has no other image raises
    SkipSampleException, in both packages."""
    dirs = write_tree(str(tmp_path), dataset, 3, group=2)  # the third is alone
    texp, jexp = _exps(dataset, "guided", dirs)
    tds, jds = td.create_dataset(texp, "test"), jd.create_dataset(jexp, "test")
    _same_sample(tds[0], jds[0])
    for ds, exc in ((tds, td.SkipSampleException), (jds, jd.SkipSampleException)):
        with pytest.raises(exc):
            ds[2]
    td.create_dataset(texp, "train")[2]  # itself on train


def test_create_dataset(trees):
    texp, _ = _exps("celebamaskhq", "independent", trees["celebamaskhq"])
    assert isinstance(td.create_dataset(texp), td.CelebAMaskHQDataset)
    synthetic = td.create_dataset(texp.replace(data=dataclasses.replace(
        texp.data, dataset="synthetic")), phase="test")
    assert isinstance(synthetic, td.SyntheticDataset) and len(synthetic) == 64
    with pytest.raises(ValueError, match="Unknown dataset"):
        td.create_dataset(texp.replace(data=dataclasses.replace(texp.data, dataset="x")))


def test_image_size_reads_the_whole_file(tmp_path):
    """The codec's probe finds a JPEG's frame header behind a 60 KB APP
    segment, as Pillow's header parse does."""
    from PIL import Image

    img = Image.fromarray(np.zeros((37, 23, 3), np.uint8))
    path = str(tmp_path / "exif.jpg")
    img.save(path, quality=90, icc_profile=b"\0" * 60000)
    assert td.image_size(path) == td.image_size(path, native=False) == (23, 37)
