"""Pooling primitives (NCHW), port of deepsee_tpu/ops/pooling.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["avg_pool_3x3_s2"]


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(kernel=3, stride=2, padding=1, count_include_pad=False),
    in float32, returned in x's dtype and channels_last memory: the
    discriminator's input for its next, coarser scale (border windows divide
    by the number of valid taps).

    The pooling itself runs on a contiguous (NCHW) copy: on a channels_last
    CUDA tensor, PyTorch 2.11's backward of this pooling is wrong (relative
    error 1.05 against float64 on an H100, either gradient layout), and on
    a contiguous one it is right (4.8e-8); tests/test_torch_kernels.py holds
    the gradient against float64 on the card."""
    y = F.avg_pool2d(x.float().contiguous(), 3, stride=2, padding=1, count_include_pad=False)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)
