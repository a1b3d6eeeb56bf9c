"""Image resizing with torch `F.interpolate` and PIL conventions (NCHW).

Port of deepsee_tpu/ops/resize.py.  Every method is the JAX package's dense
(out, in) resampling matrix from `resize_matrix`, applied separably in
float32, except torch-convention nearest: its matrix has one 1 per row, so
it is the gather `F.interpolate(mode="nearest")` computes, done in the
input's dtype.  tests/test_torch_ops.py holds both against the JAX package.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_matrix", "resize2d", "upsample_nearest_2x"]


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


def _linear(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _box(x: np.ndarray) -> np.ndarray:
    return np.where((x >= -0.5) & (x < 0.5), 1.0, 0.0)


_FILTERS = {
    "bilinear": (_linear, 1.0),
    "linear": (_linear, 1.0),
    "bicubic": (functools.partial(_cubic, a=-0.75), 2.0),      # torch
    "bicubic_pil": (functools.partial(_cubic, a=-0.5), 2.0),    # PIL
    "box": (_box, 0.5),
}


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int, method: str = "bicubic",
                  antialias: bool = False) -> np.ndarray:
    """Dense (out_size, in_size) float32 resampling matrix.

    method: nearest (torch, src = floor(dst*s)), nearest_pil
    (src = floor((dst+.5)*s)), bilinear, bicubic (torch, a=-0.75),
    bicubic_pil (a=-0.5), box.  antialias stretches the kernel when
    downscaling and renormalizes over the clipped window (PIL).
    """
    if in_size == out_size and method.startswith(("nearest", "bilinear", "bicubic")):
        return np.eye(out_size, dtype=np.float32)

    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)

    if method in ("nearest", "nearest_pil"):
        offset = 0.5 if method == "nearest_pil" else 0.0
        src = np.minimum(((np.arange(out_size) + offset) * scale).astype(np.int64),
                         in_size - 1)
        mat[np.arange(out_size), src] = 1.0
        return mat.astype(np.float32)

    fn, support = _FILTERS[method]

    if antialias:
        filterscale = max(scale, 1.0)
        supp = support * filterscale
        for o in range(out_size):
            center = (o + 0.5) * scale
            xmin = max(0, int(center - supp + 0.5))
            xmax = min(in_size, int(center + supp + 0.5))
            taps = np.arange(xmin, xmax)
            w = fn((taps - center + 0.5) / filterscale)
            s = w.sum()
            if s != 0.0:
                w = w / s
            mat[o, xmin:xmax] = w
        return mat.astype(np.float32)

    # torch convention: half-pixel centres, border-replicate
    for o in range(out_size):
        center = (o + 0.5) * scale - 0.5
        lo = int(np.floor(center - support)) + 1
        hi = int(np.floor(center + support)) + 1
        taps = np.arange(lo, hi + 1)
        np.add.at(mat[o], np.clip(taps, 0, in_size - 1), fn(taps - center))

    rs = mat.sum(axis=1, keepdims=True)
    mat = mat / np.where(rs == 0.0, 1.0, rs)
    return mat.astype(np.float32)


def resize2d(x: torch.Tensor, out_hw: Tuple[int, int], method: str = "bicubic",
             antialias: bool = False) -> torch.Tensor:
    """Resize (B, C, H, W) to `out_hw`; returns x's dtype and memory format.
    The resampling matrices are applied in float32."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(out_hw):
        return x
    fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    if method == "nearest" and not antialias:
        y = F.interpolate(x, size=tuple(out_hw), mode="nearest")
    else:
        mh = torch.from_numpy(resize_matrix(h, out_hw[0], method, antialias)).to(x.device)
        mw = torch.from_numpy(resize_matrix(w, out_hw[1], method, antialias)).to(x.device)
        y = torch.einsum("oh,bchw,pw->bcop", mh, x.float(), mw).to(x.dtype)
    return y.contiguous(memory_format=fmt)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of (B, C, H, W) between generator blocks; keeps
    channels_last memory."""
    return F.interpolate(x, scale_factor=2, mode="nearest").contiguous(
        memory_format=torch.channels_last)
