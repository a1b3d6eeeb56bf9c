"""Stateless normalization primitives (NCHW), port of deepsee_tpu/ops/norms.py.

These are the plain versions.  On the model path the instance norm runs
inside the `modnorm` kernel (deepsee_torch/ops/modnorm.py), which fuses it
with the modulation and the leaky ReLU that follow it.
"""

from __future__ import annotations

import torch

__all__ = ["instance_norm_2d", "leaky_relu"]


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False): per-sample, per-channel standardization
    over H and W with the biased variance; two-pass float32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=(2, 3), keepdim=True)
    return (d * torch.rsqrt(var + eps)).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """F.leaky_relu with the reference's 0.2 slope: where(x >= 0, x, s*x)."""
    return torch.where(x >= 0, x, negative_slope * x)
