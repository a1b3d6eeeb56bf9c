"""The port's native codec (deepsee_torch/data/codec.py over its own build of
csrc/codec.cpp) against the JAX package's (deepsee_tpu/native/codec.py over
the same source) and Pillow, bit for bit: decode_image, decode_label,
decode_u8, probe and encode_png over JPEG and PNG in gray, palette, RGB and
RGBA, through each op; the status codes on the adversarial corpus; the
committed corpus (tests/data/torch_corpus) and its expectations; the build
and the fallback where the library cannot be built."""

import io
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
from PIL import Image

from deepsee_tpu import native as jax_native
from deepsee_tpu.native import codec as jax_codec
from deepsee_torch.data import codec
from deepsee_torch.ops import _build
from torch_data_corpus import CORPUS, LAYOUT, STEMS, expected_arrays

ADVERSARIAL = os.path.join(os.path.dirname(__file__), "data", "codec_corpus")


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert codec.available(), codec.unavailable_reason()
    assert jax_native.available(build_if_missing=True)


def _encode(img, fmt):
    buf = io.BytesIO()
    img.save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _sources():
    """name -> (encoded bytes, Pillow image): 61 x 47, smooth enough to JPEG."""
    rng = np.random.RandomState(0)
    rgb = Image.fromarray(rng.randint(0, 256, (6, 5, 3), np.uint8)).resize((61, 47),
                                                                          Image.BICUBIC)
    gray = rgb.convert("L")
    rgba = rgb.copy()
    rgba.putalpha(Image.fromarray(rng.randint(0, 256, (47, 61), np.uint8)))
    pal = Image.fromarray(rng.randint(0, 19, (47, 61)).astype(np.uint8), mode="P")
    pal.putpalette([v for i in range(256) for v in (i, 255 - i, i // 2)])
    imgs = {"jpeg_rgb": (rgb, "JPEG"), "jpeg_gray": (gray, "JPEG"), "png_rgb": (rgb, "PNG"),
            "png_gray": (gray, "PNG"), "png_rgba": (rgba, "PNG"), "png_palette": (pal, "PNG")}
    out = {}
    for name, (img, fmt) in imgs.items():
        data = _encode(img, fmt)
        out[name] = (data, Image.open(io.BytesIO(data)))
    return out


SOURCES = _sources()
# op -> (make_ops keywords with the resample filled per route, output (h, w))
OPS = {
    "none": ({}, (47, 61)),
    "center_crop": ({"center_crop": 40}, (40, 40)),
    "resize_nearest": ({"resize": (33, 29), "resample": codec.NEAREST}, (29, 33)),
    "resize_bilinear": ({"resize": (33, 29), "resample": codec.BILINEAR}, (29, 33)),
    "resize_bicubic": ({"resize": (90, 70), "resample": codec.BICUBIC}, (70, 90)),
    "crop": ({"resize": (40, 40), "crop": (3, 5, 32, 32)}, (32, 32)),
    "flip": ({"center_crop": 40, "resize": (32, 32), "flip": True}, (32, 32)),
    "scaled_decode": ({"resize": (30, 23), "scaled_decode": True}, (23, 30)),
}
PIL_FILTERS = {codec.NEAREST: Image.NEAREST, codec.BILINEAR: Image.BILINEAR,
               codec.BICUBIC: Image.BICUBIC}


def _pil_pipeline(img, kw, mode):
    """The ops in Pillow: center crop (Python's round), resize, crop, flip."""
    img = img.convert(mode) if mode == "RGB" else img
    if kw.get("center_crop"):
        cc = kw["center_crop"]
        w, h = img.size
        left, top = int(round((w - cc) / 2.0)), int(round((h - cc) / 2.0))
        img = img.crop((left, top, left + cc, top + cc))
    if kw.get("resize"):
        img = img.resize(kw["resize"], PIL_FILTERS[kw.get("resample", codec.BICUBIC)])
    if kw.get("crop"):
        x, y, w, h = kw["crop"]
        img = img.crop((x, y, x + w, y + h))
    if kw.get("flip"):
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return np.asarray(img)


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_decode_matches_jax_codec_and_pillow(source, op):
    data, img = SOURCES[source]
    kw, hw = OPS[op]
    got = {"image": codec.decode_image(data, codec.make_ops(**kw), hw),
           "u8": codec.decode_u8(data, codec.make_ops(**kw), hw),
           "label": codec.decode_label(data, codec.make_ops(**kw), hw, 19),
           "u8_1": codec.decode_u8(data, codec.make_ops(**kw), hw, channels=1)}
    want = {"image": jax_codec.decode_image(data, jax_codec.make_ops(**kw), hw),
            "u8": jax_codec.decode_u8(data, jax_codec.make_ops(**kw), hw),
            "label": jax_codec.decode_label(data, jax_codec.make_ops(**kw), hw, 19),
            "u8_1": jax_codec.decode_u8(data, jax_codec.make_ops(**kw), hw, channels=1)}
    for key in got:
        if want[key] is None:  # outside the envelope (RGBA labels): both decline
            assert got[key] is None, key
        else:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["image"] is not None
    if op != "scaled_decode":  # the DCT-scaled decode is approximate by design
        u8 = _pil_pipeline(img, kw, "RGB")
        np.testing.assert_array_equal(got["u8"], u8)
        np.testing.assert_array_equal(got["image"], u8.astype(np.float32) / 255.0 * 2.0 - 1.0)
        nearest = "resize" not in kw or kw.get("resample") == codec.NEAREST
        if source in ("png_gray", "png_palette") and nearest:  # labels resize NEAREST
            lab = _pil_pipeline(img, kw, img.mode).astype(np.int32)
            lab[lab == 255] = 19
            np.testing.assert_array_equal(got["label"], lab)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_probe_and_file_entry_points(source, tmp_path):
    data, img = SOURCES[source]
    assert codec.probe(data) == jax_codec.probe(data) == img.size
    path = tmp_path / "x.bin"
    path.write_bytes(data)
    ops = codec.make_ops(resize=(20, 16))
    np.testing.assert_array_equal(codec.decode_image(str(path), ops, (16, 20)),
                                  codec.decode_image(data, ops, (16, 20)))
    lab = codec.decode_label(str(path), codec.make_ops(resize=(20, 16), resample=codec.NEAREST),
                             (16, 20), 19)
    assert (lab is None) == (source == "png_rgba")


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("channels", [1, 3])
def test_encode_png_matches_jax(level, channels):
    rng = np.random.RandomState(level)
    arr = rng.randint(0, 256, (37, 53, 3) if channels == 3 else (37, 53), np.uint8)
    data = codec.encode_png(arr, level=level)
    assert data == jax_codec.encode_png(arr, level=level)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), arr)


@pytest.mark.parametrize("name", sorted(os.listdir(ADVERSARIAL)))
def test_adversarial_status_codes_match_jax(name):
    """Every entry point declines the adversarial inputs as the JAX codec's
    does, with the same status codes."""
    import ctypes

    with open(os.path.join(ADVERSARIAL, name), "rb") as f:
        data = f.read()
    ours, theirs = codec.load(), jax_native.load()
    ops = codec.make_ops(resize=(32, 32))
    out = np.empty((32, 32, 3), np.float32)
    lab = np.empty((32, 32), np.int32)
    u8 = np.empty((32, 32, 3), np.uint8)
    codes = []
    for lib, mod in ((ours, codec), (theirs, jax_native)):
        opsp = ctypes.byref(mod.DsnOps(*[getattr(ops, f) for f, _ in ops._fields_]))
        buf = ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))
        w, h = ctypes.c_int32(), ctypes.c_int32()
        codes.append((
            lib.dsn_decode_image(buf, len(data), opsp, 32, 32,
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))),
            lib.dsn_decode_label(buf, len(data), opsp, 18, 32, 32,
                                 lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))),
            lib.dsn_decode_u8(buf, len(data), opsp, 3, 32, 32,
                              u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))),
            lib.dsn_probe(buf, len(data), ctypes.byref(w), ctypes.byref(h))))
    assert codes[0] == codes[1]
    assert all(c != codec.OK for c in codes[0][:3])
    assert codec.decode_image(data, ops, (32, 32)) is None


def test_expected_npz_is_the_jax_pillow_path():
    """expected.npz regenerated from the committed files through
    deepsee_tpu.data.transforms equals the committed file."""
    want = expected_arrays()
    with np.load(os.path.join(CORPUS, "expected.npz")) as got:
        assert sorted(got.files) == sorted(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype
            np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("dataset", sorted(LAYOUT))
def test_corpus_decodes_to_the_expectations(dataset):
    """The corpus through the port's codec under each preset's transform: the
    expectations bit for bit; flipped, their mirror."""
    import dataclasses

    from deepsee_torch.config import get_preset
    from deepsee_torch.data import transforms

    preset = get_preset(LAYOUT[dataset][0])
    data = dataclasses.replace(preset.data, native_codec="on")
    label_mode = "resize" if dataset == "celeba" else None
    with np.load(os.path.join(CORPUS, "expected.npz")) as expected:
        for stem in STEMS[dataset]:
            for flip in (False, True):
                params = transforms.TransformParams((0, 0), flip)
                x = transforms.load_image(os.path.join(CORPUS, dataset, "images", f"{stem}.jpg"),
                                          data, preset.model, params, True)
                y = transforms.load_label(os.path.join(CORPUS, dataset, "labels", f"{stem}.png"),
                                          data, preset.model, params, True, label_mode)
                u8, lab = expected[f"{dataset}/{stem}/image"], expected[f"{dataset}/{stem}/label"]
                if flip:
                    u8, lab = u8[:, ::-1], lab[:, ::-1]
                np.testing.assert_array_equal(x, u8.astype(np.float32) / 255.0 * 2.0 - 1.0)
                np.testing.assert_array_equal(y, lab)


def test_library_builds_into_the_hashed_build_dir():
    lib = _build.build(["codec"])["codec"]
    assert lib == _build.build_dir() / "libcodec.so" and lib.exists()
    assert _build.build_dir().parent == _build.BUILD_ROOT


def test_nothing_builds_at_import(tmp_path):
    """Importing the data package starts no compiler: the library is built
    at the first decode."""
    code = ("import deepsee_torch.data, deepsee_torch.utils.images\n"
            "from deepsee_torch.data import codec\n"
            "assert codec._lib is None and codec._failure is None\n"
            "print('ok')\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert run.returncode == 0 and "ok" in run.stdout, run.stderr


def test_unbuildable_library_falls_back(monkeypatch):
    """Where the library cannot be built, load() warns once and returns None,
    the numpy functions return None, "on" raises and "auto" decodes with
    Pillow."""
    import dataclasses

    from deepsee_torch.config import get_preset
    from deepsee_torch.data import transforms

    def no_compiler(names):
        raise RuntimeError("g++ failed on codec.cpp: jpeglib.h: No such file or directory")

    monkeypatch.setattr(codec, "_lib", None)
    monkeypatch.setattr(codec, "_failure", None)
    monkeypatch.setattr(_build, "build", no_compiler)
    with pytest.warns(RuntimeWarning, match="jpeglib.h"):
        assert codec.load() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once only
        assert codec.load() is None and not codec.available()
    assert "jpeglib.h" in codec.unavailable_reason()
    data, _ = SOURCES["png_rgb"]
    assert codec.decode_image(data, codec.make_ops(), (47, 61)) is None
    assert codec.probe(data) is None and codec.encode_png(np.zeros((2, 2), np.uint8)) is None
    preset = get_preset("8x_independent_256x256")
    path = os.path.join(CORPUS, "celebamaskhq", "labels", "0.png")
    params = transforms.TransformParams((0, 0), False)
    with pytest.raises(RuntimeError, match="native_codec='on'"):
        transforms.load_label(path, dataclasses.replace(preset.data, native_codec="on"),
                              preset.model, params, False)
    with np.load(os.path.join(CORPUS, "expected.npz")) as expected:
        np.testing.assert_array_equal(
            transforms.load_label(path, preset.data, preset.model, params, False),
            expected["celebamaskhq/0/label"])
