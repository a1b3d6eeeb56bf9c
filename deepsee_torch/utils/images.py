"""Tensor <-> image conversions and IO: an own copy of the PIL path of
deepsee_tpu/utils/images.py (reference: util/util.py:72-158).

Arrays are numpy, NHWC, in the JAX package's conventions: images float32 in
[-1, 1] (u8 / 255 * 2 - 1, BICUBIC resize), label maps int32 with 255
(unknown) -> label_nc (NEAREST resize).  PIL is imported inside the
functions that need it, so the raw-pixel helpers (`tensor2im`, the style
CSV) work where Pillow is not installed.
"""

from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np

from deepsee_torch.regions import colorize_label


def tensor2im(x: np.ndarray) -> np.ndarray:
    """NHWC [-1,1] float -> uint8 (util/util.py:72-103: scale, clip,
    truncate)."""
    x = np.asarray(x)
    y = (x + 1.0) / 2.0 * 255.0
    return np.clip(y, 0, 255).astype(np.uint8)


def image_to_array(img, size: Optional[int] = None) -> np.ndarray:
    """PIL image -> (1, size, size, 3) float32 in [-1, 1]."""
    from PIL import Image

    img = img.convert("RGB")
    if size and img.size != (size, size):
        img = img.resize((size, size), Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0
    return arr[None]


def label_to_array(lab, size: int, label_nc: int) -> np.ndarray:
    """PIL label map -> (1, size, size) int32; NEAREST resize, RGB
    collapsed to one channel, 255 (unknown) -> label_nc."""
    from PIL import Image

    if lab.size != (size, size):
        lab = lab.resize((size, size), Image.NEAREST)
    arr = np.asarray(lab).astype(np.int32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    arr = np.where(arr == 255, label_nc, arr)
    return arr[None]


def image_bytes_to_array(data: bytes, size: Optional[int] = None) -> np.ndarray:
    """Encoded JPEG/PNG bytes -> (1, size, size, 3) float32 in [-1, 1]."""
    from PIL import Image

    return image_to_array(Image.open(io.BytesIO(data)), size)


def label_bytes_to_array(data: bytes, size: int, label_nc: int) -> np.ndarray:
    """Encoded PNG/JPEG label-map bytes -> (1, size, size) int32."""
    from PIL import Image

    return label_to_array(Image.open(io.BytesIO(data)), size, label_nc)


def encode_png_bytes(arr_uint8: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W, 3) -> PNG bytes at zlib `level`."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr_uint8).save(buf, format="PNG", compress_level=level)
    return buf.getvalue()


def image_file_to_array(path: str, size: Optional[int] = None) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return image_to_array(img, size)


def label_file_to_array(path: str, size: int, label_nc: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as lab:
        return label_to_array(lab, size, label_nc)


def label2im(label: np.ndarray, n_label: int = 19) -> np.ndarray:
    """Integer (or one-hot NHWC) label map -> RGB uint8."""
    label = np.asarray(label)
    if label.ndim >= 3 and label.shape[-1] == n_label:  # one-hot
        label = np.argmax(label, axis=-1)
    return colorize_label(label, n_label)


def save_image(arr_uint8: np.ndarray, path: str, create_dir: bool = False) -> None:
    """uint8 (H, W[, 3]) -> PNG (a ".jpg" path is saved as ".png")."""
    from PIL import Image

    if create_dir:
        os.makedirs(os.path.dirname(path), exist_ok=True)
    if arr_uint8.ndim == 2:
        arr_uint8 = np.repeat(arr_uint8[..., None], 3, axis=-1)
    Image.fromarray(arr_uint8).save(path.replace(".jpg", ".png"))


def save_style_matrix(style: np.ndarray, path: str, create_dir: bool = False) -> None:
    """(19, S) style matrix -> CSV (util/util.py:150-158)."""
    style = np.asarray(style)
    if style.ndim != 2:
        raise ValueError(f"expected a 2-D style matrix, got {style.shape}")
    if not path.endswith(".csv"):
        raise ValueError(f"style matrix path must end in .csv: {path!r}")
    if create_dir:
        os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, style, delimiter=",")


def load_style_matrix(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=",").astype(np.float32)
