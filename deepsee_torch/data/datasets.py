"""Datasets: file pairing, splits, identity-based guiding-image sampling; an
own copy of deepsee_tpu/data/datasets.py (reference: data/celeba_dataset.py,
data/celebamaskhq_dataset.py, data/base_dataset.py, data/image_folder.py).

Host-side Python: each sample is a dict of numpy arrays and strings;
batching and prefetch live in loader.py, everything after decode runs on
the device.  A SyntheticDataset stands in where no CelebA data is on disk
(tests, smoke runs): the same keys and shapes, deterministic.
"""

from __future__ import annotations

import csv
import os
import random as _random
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepsee_torch.config import DataConfig, Experiment, ModelConfig
from deepsee_torch.data import codec
from deepsee_torch.data.transforms import get_params, load_image, load_label
from deepsee_torch.ops.resize import resize_matrix

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tiff", ".webp")


class SkipSampleException(Exception):
    """Raised when a sample cannot be formed (data/custom_exception.py:1);
    loaders skip it and go on, as inference_manager.py:99-106 does."""


def natural_sort_key(s: str):
    # util/util.py:181-186
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]


def list_images(directory: str, read_cache: bool = False,
                write_cache: bool = False) -> List[str]:
    """Recursive image listing with an optional `files.list` cache in the
    directory (data/image_folder.py:36-64, --cache_filelist_read/write)."""
    cache = os.path.join(directory, "files.list")
    if read_cache and os.path.exists(cache):
        with open(cache) as f:
            return [line.rstrip("\n") for line in f if line.strip()]
    out = []
    for root, _, files in os.walk(directory):
        for f in files:
            if f.lower().endswith(IMG_EXTENSIONS):
                out.append(os.path.join(root, f))
    out.sort(key=natural_sort_key)
    if write_cache:
        try:
            with open(cache, "w") as f:
                f.write("\n".join(out))
        except OSError:
            pass
    return out


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def image_size(path: str, native: bool = True) -> Tuple[int, int]:
    """(width, height) of an image file: with `native`, the codec's probe of
    the file's bytes (a JPEG's frame header can sit behind a large EXIF
    block, so it reads the whole file); else, or where the codec declines,
    Pillow's header parse."""
    if native and codec.available():
        with open(path, "rb") as f:
            size = codec.probe(f.read())
        if size is not None:
            return size
    from PIL import Image

    with Image.open(path) as img:
        return img.size


class PairedImageDataset:
    """Label and image dirs paired by sorted order, with a basename check
    (base_dataset.py:42-85)."""

    label_preprocess_mode: Optional[str] = None  # override for labels

    def __init__(self, exp: Experiment, phase: Optional[str] = None):
        self.exp = exp
        self.cfg: ModelConfig = exp.model
        self.data_cfg: DataConfig = exp.data
        self.phase = phase or exp.data.phase
        self.is_train = self.phase == "train"
        self.rng = _random.Random(0)

        dc = self.data_cfg
        label_paths = list_images(dc.label_dir, dc.cache_filelist_read, dc.cache_filelist_write)
        image_paths = list_images(dc.image_dir, dc.cache_filelist_read, dc.cache_filelist_write)
        n = dc.max_dataset_size
        if n:
            label_paths, image_paths = label_paths[:n], image_paths[:n]
        if not dc.no_pairing_check:
            assert len(label_paths) == len(image_paths), (
                f"#labels ({len(label_paths)}) != #images ({len(image_paths)})")
            for lp, ip in zip(label_paths, image_paths):
                assert _stem(lp) == _stem(ip), f"pair mismatch: {lp} vs {ip}"
        self.label_paths = label_paths
        self.image_paths = image_paths

    def __len__(self) -> int:
        return len(self.label_paths)

    def seed(self, seed: int) -> None:
        self.rng = _random.Random(seed)

    def __getitem__(self, index: int) -> Dict:
        label_path = self.label_paths[index]
        image_path = self.image_paths[index]
        # the label's size seeds get_params (the draws match the JAX package's)
        size = image_size(label_path, native=self.data_cfg.native_codec != "off")
        params = get_params(self.data_cfg, self.cfg, size, self.rng)
        sample = {
            "label": load_label(label_path, self.data_cfg, self.cfg, params, self.is_train,
                                preprocess_mode=self.label_preprocess_mode),
            "image_hr": load_image(image_path, self.data_cfg, self.cfg, params, self.is_train),
            "path": image_path,
        }
        return self.postprocess(sample, params)

    def postprocess(self, sample, params):
        if self.cfg.guiding_style_image:
            gid = self.sample_guiding_id(sample["path"])
            sample["guiding_image_id"] = gid
            gimg = os.path.join(self.data_cfg.image_dir, f"{gid}.jpg")
            glab = os.path.join(self.data_cfg.label_dir, f"{gid}.png")
            sample["guiding_image"] = load_image(gimg, self.data_cfg, self.cfg, params,
                                                 self.is_train)
            sample["guiding_label"] = load_label(glab, self.data_cfg, self.cfg, params,
                                                 self.is_train,
                                                 preprocess_mode=self.label_preprocess_mode)
        return sample

    def sample_guiding_id(self, path: str) -> str:
        raise NotImplementedError


class CelebAMaskHQDataset(PairedImageDataset):
    """CelebAMask-HQ: resize_and_crop; identities from a CSV with columns
    (hq_file_id, identity) (celebamaskhq_dataset.py:17-44)."""

    def __init__(self, exp: Experiment, phase: Optional[str] = None):
        super().__init__(exp, phase)
        self.id2identity: Dict[str, str] = {}
        self.identity2ids: Dict[str, List[str]] = {}
        if self.cfg.guiding_style_image:
            path = self.data_cfg.identities_file
            assert path and os.path.exists(path), (
                f"identities file required for guided model: {path!r}")
            file_ids = {_stem(p) for p in self.image_paths}
            with open(path, newline="") as f:
                for row in csv.DictReader(f):
                    fid, ident = row["hq_file_id"], row["identity"]
                    if fid in file_ids:
                        self.id2identity[fid] = ident
                        self.identity2ids.setdefault(ident, []).append(fid)

    def sample_guiding_id(self, path: str) -> str:
        fid = _stem(path)
        candidates = set(self.identity2ids[self.id2identity[fid]])
        if self.phase != "train":
            candidates.discard(fid)  # never itself off-train (:40-42)
            if not candidates:
                raise SkipSampleException(f"no other image of identity for {fid}")
        return self.rng.sample(sorted(candidates), 1)[0]


class CelebADataset(PairedImageDataset):
    """CelebA: center_crop(178) and resize for images; labels use plain
    'resize' (predicted on square images, celeba_dataset.py:52-55);
    identities from the space-separated identity_CelebA.txt (:19-33)."""

    label_preprocess_mode = "resize"

    def __init__(self, exp: Experiment, phase: Optional[str] = None):
        super().__init__(exp, phase)
        self.id2identity: Dict[str, str] = {}
        self.identity2ids: Dict[str, List[str]] = {}
        if self.cfg.guiding_style_image:
            path = self.data_cfg.identities_file
            assert path and os.path.exists(path), "identities file required"
            with open(path) as f:
                for line in f:
                    filename, ident = line.split()
                    fid = os.path.splitext(filename)[0]
                    self.id2identity[fid] = ident
                    self.identity2ids.setdefault(ident, []).append(fid)

    def sample_guiding_id(self, path: str) -> str:
        fid = _stem(path)
        candidates = set(self.identity2ids[self.id2identity[fid]])
        if self.phase == "test":
            candidates.discard(fid)
            if not candidates:
                raise SkipSampleException(f"no other candidate for {fid}")
        return self.rng.sample(sorted(candidates), 1)[0]


def _pil_bicubic_u8(img: np.ndarray, size: int) -> np.ndarray:
    """PIL's BICUBIC resize of a (h, w, c) uint8 image: horizontal pass, then
    vertical, each rounded and clipped to uint8."""
    h, w = img.shape[:2]
    mw = resize_matrix(w, size, "bicubic_pil", antialias=True).astype(np.float64)
    mh = resize_matrix(h, size, "bicubic_pil", antialias=True).astype(np.float64)
    x = np.clip(np.rint(np.einsum("pw,hwc->hpc", mw, img.astype(np.float64))), 0, 255)
    return np.clip(np.rint(np.einsum("oh,hpc->opc", mh, x)), 0, 255).astype(np.uint8)


class SyntheticDataset:
    """Deterministic random samples with the real pipeline's keys and shapes:
    smooth blobby images, blocky label maps.

    The JAX package upsamples its small random maps with PIL (BICUBIC images,
    NEAREST labels).  This copy does the same with numpy, so that it runs
    where Pillow is not installed: the labels are PIL's exactly (an integer
    upscale), the images PIL's bicubic within one uint8 level (PIL rounds in
    fixed point)."""

    def __init__(self, exp: Experiment, length: int = 64, phase: Optional[str] = None,
                 seed: int = 0):
        self.cfg = exp.model
        self.length = length
        self.seed = seed
        self.guided = exp.model.guiding_style_image

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> Dict:
        cfg = self.cfg
        rng = np.random.RandomState(self.seed * 100003 + index)
        size = cfg.crop_size
        small = max(4, size // 8)

        def smooth(channels):
            base = rng.randn(small, small, channels).astype(np.float32)
            u8 = ((base - base.min()) / (np.ptp(base) + 1e-6) * 255).astype(np.uint8)
            return _pil_bicubic_u8(u8, size).astype(np.float32) / 127.5 - 1.0

        image = smooth(3)
        lab_small = rng.randint(0, cfg.label_nc, (small, small)).astype(np.uint8)
        src = np.minimum(((np.arange(size) + 0.5) * small / size).astype(np.int64), small - 1)
        label = lab_small[src][:, src].astype(np.int32)
        sample = {"label": label, "image_hr": image, "path": f"synthetic_{index}.png"}
        if self.guided:
            sample["guiding_image"] = smooth(3)
            sample["guiding_label"] = label.copy()
        return sample


def create_dataset(exp: Experiment, phase: Optional[str] = None):
    """Dataset factory (data/__init__.py:11-54)."""
    name = exp.data.dataset
    if name == "celeba":
        return CelebADataset(exp, phase)
    if name == "celebamaskhq":
        return CelebAMaskHQDataset(exp, phase)
    if name == "synthetic":
        return SyntheticDataset(exp, phase=phase)
    raise ValueError(f"Unknown dataset {name!r}")
