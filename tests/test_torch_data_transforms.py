"""The port's transforms (deepsee_torch/data/transforms.py) against the JAX
package's: the same get_params draws from the same seed, and load_image /
load_label bit for bit in every preprocess mode, through the native codec
and through Pillow, with and without the flip."""

import dataclasses
import random

import numpy as np
import pytest

from deepsee_tpu.config import get_preset as jax_preset
from deepsee_tpu.data import transforms as jt
from deepsee_torch.config import get_preset
from deepsee_torch.data import transforms as tt
from torch_data_corpus import write_tree

MODES = ("resize_and_crop", "crop", "scale_width_and_crop", "scale_shortside_and_crop",
         "center_crop_and_resize", "resize", "scale_width", "scale_shortside", "fixed", "none")


def _configs(mode, native, center=36, **model):
    """(port (data, model), JAX (data, model)) at 32^2 crops from 40^2 loads."""
    out = []
    for preset in (get_preset, jax_preset):
        exp = preset("8x_independent_128x128")
        m = dataclasses.replace(exp.model, load_size=40, crop_size=32, **model)
        d = dataclasses.replace(exp.data, preprocess_mode=mode, center_crop_size=center,
                                native_codec=native)
        out.append((d, m))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("files"))
    jpg = write_tree(root + "/jpg", "celeba", 2, image_size=(45, 53), label_size=(45, 53))
    png = write_tree(root + "/png", "celeba", 1, image_size=(53, 45), label_size=(53, 45),
                     fmt="png")
    return [(f"{jpg[0]}/{s}.jpg", f"{jpg[1]}/{s}.png") for s in ("000001", "000002")] + [
        (f"{png[0]}/000001.png", f"{png[1]}/000001.png")]


@pytest.mark.parametrize("mode", MODES)
def test_get_params_draws_as_jax(mode):
    (td, tm), (jd, jm) = _configs(mode, "auto")
    for size in ((45, 53), (53, 45), (40, 40), (600, 300)):
        ra, rb = random.Random(7), random.Random(7)
        for _ in range(5):
            got = tt.get_params(td, tm, size, ra)
            want = jt.get_params(jd, jm, size, rb)
            assert (got.crop_pos, got.flip) == (want.crop_pos, want.flip)
            assert tt.scaled_size(mode, 40, size) == jt.scaled_size(mode, 40, size)


@pytest.mark.parametrize("native", ["auto", "off"])
@pytest.mark.parametrize("mode", MODES)
def test_load_image_and_label_match_jax(files, mode, native):
    (td, tm), (jd, jm) = _configs(mode, native)
    for bilinear in (False, True):
        if bilinear:
            tm = dataclasses.replace(tm, downsampling_method="bilinear")
            jm = dataclasses.replace(jm, downsampling_method="bilinear")
        for image, label in files:
            for crop_pos, flip, is_train in (((0, 0), False, True), ((3, 5), True, True),
                                             ((8, 1), True, False)):
                tp, jp = tt.TransformParams(crop_pos, flip), jt.TransformParams(crop_pos, flip)
                got = tt.load_image(image, td, tm, tp, is_train)
                want = jt.load_image(image, jd, jm, jp, is_train)
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want)
                for label_mode in (None, "resize"):
                    got = tt.load_label(label, td, tm, tp, is_train, label_mode)
                    want = jt.load_label(label, jd, jm, jp, is_train, label_mode)
                    assert got.dtype == want.dtype == np.int32
                    np.testing.assert_array_equal(got, want)


def test_native_plan_covers_the_modes_jax_covers():
    for mode in MODES:
        (td, tm), (jd, jm) = _configs(mode, "auto")
        p = tt.TransformParams((2, 3), True)
        for for_label in (False, True):
            got = tt._native_plan(td, tm, p, True, for_label, None)
            want = jt._native_plan(jd, jm, jt.TransformParams((2, 3), True), True, for_label,
                                   None)
            assert (got is None) == (want is None), mode
            if got is not None:
                assert got[1] == want[1]
                assert [getattr(got[0], f) for f, _ in got[0]._fields_] == [
                    getattr(want[0], f) for f, _ in want[0]._fields_]
