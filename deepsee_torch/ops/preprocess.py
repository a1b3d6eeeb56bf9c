"""On-device preprocessing: label one-hot and HR->LR synthesis.

Port of deepsee_tpu/ops/preprocess.py.  Both functions work on the public
NHWC layout; `downsample_image` converts to NCHW channels_last for the
resize and back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deepsee_torch.ops.resize import resize2d

__all__ = ["one_hot_label", "downsample_image"]


def one_hot_label(label: torch.Tensor, num_classes: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W) or (B, H, W, 1) integer map -> (B, H, W, num_classes).

    Out-of-range labels (e.g. 255) give all-zero rows, as in the JAX package.
    """
    if label.ndim == 4:
        label = label[..., 0]
    classes = torch.arange(num_classes, device=label.device)
    return (label.long()[..., None] == classes).to(dtype)


def downsample_image(hr_image: torch.Tensor, out_hw: Tuple[int, int],
                     method: str = "bicubic") -> torch.Tensor:
    """HR image (B, H, W, 3) in [-1, 1] -> LR image (B, h, w, 3) in [-1, 1]:
    torch-convention interpolation, then a clamp against bicubic overshoot."""
    method = {"linear": "bilinear"}.get(method, method)
    lr = resize2d(hr_image.permute(0, 3, 1, 2), out_hw, method=method)
    return lr.clamp(-1.0, 1.0).permute(0, 2, 3, 1)
