"""Training data of the port: so far deterministic synthetic samples with
the real pipeline's keys and shapes (the real datasets and the loader
belong to the data-path slice):
an own copy of deepsee_tpu/data/datasets.py::SyntheticDataset (smooth
blobby images, blocky label maps).

The JAX package upsamples its small random maps with PIL (BICUBIC images,
NEAREST labels).  This copy does the same with numpy, so that it runs where
Pillow is not installed (the card's machine): the labels are PIL's exactly
(an integer upscale), the images PIL's bicubic within one uint8 level
(PIL rounds in fixed point).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from deepsee_torch.config import Experiment
from deepsee_torch.ops.resize import resize_matrix


def _pil_bicubic_u8(img: np.ndarray, size: int) -> np.ndarray:
    """PIL's BICUBIC resize of a (h, w, c) uint8 image: horizontal pass, then
    vertical, each rounded and clipped to uint8."""
    h, w = img.shape[:2]
    mw = resize_matrix(w, size, "bicubic_pil", antialias=True).astype(np.float64)
    mh = resize_matrix(h, size, "bicubic_pil", antialias=True).astype(np.float64)
    x = np.clip(np.rint(np.einsum("pw,hwc->hpc", mw, img.astype(np.float64))), 0, 255)
    return np.clip(np.rint(np.einsum("oh,hpc->opc", mh, x)), 0, 255).astype(np.uint8)


class SyntheticDataset:
    def __init__(self, exp: Experiment, length: int = 64, seed: int = 0):
        self.cfg = exp.model
        self.length = length
        self.seed = seed
        self.guided = exp.model.guiding_style_image

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
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


class Batches:
    """Batches of `batch_size` consecutive samples of `dataset` as NHWC
    numpy arrays (string keys dropped), `len(dataset) // batch_size` per
    pass; iterable any number of times."""

    def __init__(self, dataset, batch_size: int):
        self.dataset, self.batch_size = dataset, batch_size

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            samples = [self.dataset[i * self.batch_size + j] for j in range(self.batch_size)]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]
                   if not isinstance(samples[0][k], str)}
