"""The committed image corpus of the port's data tests and of chip_smoke.py's
data phase (tests/data/torch_corpus/), and the helpers that wrote it.

    celebamaskhq/images/{0,1}.jpg   1024^2 JPEG, quality 95, blobby (as
                                    scripts/bench_loader.py writes them)
    celebamaskhq/labels/{0,1}.png   512^2 label maps, values 0-18 and a 255 band
    celeba/images/00000{1,2}.jpg    178x218 JPEG, quality 95
    celeba/labels/00000{1,2}.png    178x218 label maps
    expected.npz                    what the JAX package's Pillow path makes of
                                    each file under its preset's transform, flip
                                    off: uint8 pixels "<dataset>/<stem>/image",
                                    int32 labels "<dataset>/<stem>/label"

`write_corpus(root)` wrote the files once (Pillow); `expected_arrays(root)`
recomputes expected.npz through deepsee_tpu.data.transforms.  The test files
that run the tiny model import the fixture `one_torch_thread`.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_corpus")
# dataset -> (the preset whose transform the expectations use, image size, label size)
LAYOUT = {"celebamaskhq": ("8x_independent_256x256", (1024, 1024), (512, 512)),
          "celeba": ("8x_independent_128x128", (178, 218), (178, 218))}
STEMS = {"celebamaskhq": ("0", "1"), "celeba": ("000001", "000002")}


def write_corpus(root: str = CORPUS, seed: int = 0) -> None:
    from PIL import Image

    rng = np.random.RandomState(seed)
    for dataset, (_, (iw, ih), (lw, lh)) in LAYOUT.items():
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(root, dataset, sub), exist_ok=True)
        for stem in STEMS[dataset]:
            small = rng.randint(0, 255, (32, 32, 3), np.uint8)
            Image.fromarray(small).resize((iw, ih), Image.BICUBIC).save(
                os.path.join(root, dataset, "images", f"{stem}.jpg"), quality=95)
            lab = rng.randint(0, 19, (lh // 8, lw // 8)).astype(np.uint8)
            lab[: max(1, lh // 64)] = 255  # the "unknown" band
            Image.fromarray(lab).resize((lw, lh), Image.NEAREST).save(
                os.path.join(root, dataset, "labels", f"{stem}.png"))


def expected_arrays(root: str = CORPUS) -> dict:
    """The JAX package's Pillow path on each file (flip off, crop at the
    origin: the presets' load and crop sizes are equal)."""
    import dataclasses

    from PIL import Image

    from deepsee_tpu.config import get_preset
    from deepsee_tpu.data import transforms
    from deepsee_tpu.data.datasets import CelebADataset

    out = {}
    params = transforms.TransformParams(crop_pos=(0, 0), flip=False)
    for dataset, (preset, _, _) in LAYOUT.items():
        exp = get_preset(preset)
        data = dataclasses.replace(exp.data, native_codec="off")
        label_mode = CelebADataset.label_preprocess_mode if dataset == "celeba" else None
        for stem in STEMS[dataset]:
            with Image.open(os.path.join(root, dataset, "images", f"{stem}.jpg")) as img:
                x = transforms.apply_image_transform(img, data, exp.model, params, False)
            with Image.open(os.path.join(root, dataset, "labels", f"{stem}.png")) as lab:
                y = transforms.apply_label_transform(lab, data, exp.model, params, False,
                                                     preprocess_mode=label_mode)
            u8 = np.rint((x + 1.0) / 2.0 * 255.0).astype(np.uint8)
            assert np.array_equal(u8.astype(np.float32) / 255.0 * 2.0 - 1.0, x)
            out[f"{dataset}/{stem}/image"] = u8
            out[f"{dataset}/{stem}/label"] = y.astype(np.int32)
    return out


def save_expected(root: str = CORPUS) -> None:
    np.savez_compressed(os.path.join(root, "expected.npz"), **expected_arrays(root))


def write_tree(root: str, dataset: str, n: int, image_size=(48, 40), label_size=(40, 40),
               group: int = 2, seed: int = 0, fmt: str = "jpg"):
    """A small fake dataset tree: <root>/images/<stem>.<fmt>, <root>/labels/
    <stem>.png (values 0-18 and some 255) and the identities file in
    `group`s of consecutive samples (CelebAMask-HQ: identities.csv with
    hq_file_id,identity; CelebA: identity_CelebA.txt).  Stems are 0..n-1
    (CelebAMask-HQ) or 000001.. (CelebA).  Returns (image_dir, label_dir,
    identities_file)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    images, labels = os.path.join(root, "images"), os.path.join(root, "labels")
    os.makedirs(images, exist_ok=True)
    os.makedirs(labels, exist_ok=True)
    stems = [str(i) if dataset == "celebamaskhq" else f"{i + 1:06d}" for i in range(n)]
    for stem in stems:
        small = rng.randint(0, 255, (8, 8, 3), np.uint8)
        img = Image.fromarray(small).resize(image_size, Image.BICUBIC)
        if fmt == "jpg":
            img.save(os.path.join(images, f"{stem}.jpg"), quality=95)
        else:
            img.save(os.path.join(images, f"{stem}.{fmt}"))
        lab = rng.randint(0, 19, (label_size[1], label_size[0])).astype(np.uint8)
        lab[0, : label_size[0] // 3] = 255
        Image.fromarray(lab).save(os.path.join(labels, f"{stem}.png"))
    if dataset == "celebamaskhq":
        ids = os.path.join(root, "identities.csv")
        with open(ids, "w") as f:
            f.write("hq_file_id,identity\n")
            f.writelines(f"{stem},{i // group}\n" for i, stem in enumerate(stems))
    else:
        ids = os.path.join(root, "identity_CelebA.txt")
        with open(ids, "w") as f:
            f.writelines(f"{stem}.jpg {i // group}\n" for i, stem in enumerate(stems))
    return images, labels, ids


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tiny model's CPU work is too small to share,
    and beside other test processes a pool of a thread per core
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
