"""Pooling primitives (NCHW), port of deepsee_tpu/ops/pooling.py."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from deepsee_torch.parallel import distributed, spatial

__all__ = ["avg_pool_3x3_s2"]


def avg_pool_3x3_s2(x: torch.Tensor, rows: Optional[spatial.Rows] = None) -> torch.Tensor:
    """F.avg_pool2d(kernel=3, stride=2, padding=1, count_include_pad=False),
    in float32, returned in x's dtype and channels_last memory: the
    discriminator's input for its next, coarser scale (border windows divide
    by the number of valid taps).

    The pooling itself runs on a contiguous (NCHW) copy: on a channels_last
    CUDA tensor, PyTorch 2.11's backward of this pooling is wrong (relative
    error 1.05 against float64 on an H100, either gradient layout), and on
    a contiguous one it is right (4.8e-8); tests/test_torch_kernels.py holds
    the gradient against float64 on the card.

    Where maps are striped, x is this rank's stripe (of layout `rows`, even
    where None) and the result its stripe of the pooled map under the owner
    rule: the window's rows with the neighbours' halo (`spatial.window`),
    pooled as a sum, and divided by the pooled count of the rows that lie
    inside the map, so that only the global top and bottom (and the sides)
    have fewer valid taps; a halo row is data."""
    if not spatial.active():
        y = F.avg_pool2d(x.float().contiguous(), 3, stride=2, padding=1,
                         count_include_pad=False)
        return y.to(x.dtype).contiguous(memory_format=torch.channels_last)
    rows = spatial.rows_of(x) if rows is None else rows
    slab = spatial.window(x.float(), 3, 2, 1, rows).contiguous()
    a, b = rows.reads(3, 2, 1)[distributed.model_rank()]
    r = torch.arange(a, b, device=x.device)
    inside = ((r >= 0) & (r < rows.height)).float()
    ones = inside[None, None, :, None].expand(1, 1, b - a, x.shape[3]).contiguous()
    sums = F.avg_pool2d(slab, 3, stride=2, padding=(0, 1), count_include_pad=True)
    count = F.avg_pool2d(ones, 3, stride=2, padding=(0, 1), count_include_pad=True)
    return (sums / count).to(x.dtype).contiguous(memory_format=torch.channels_last)
