"""DeepSEE super-resolution generator, port of deepsee_tpu/models/generator.py
(variant "deepsee", eval mode).

A constant 16*ngf-channel trunk: initial 3x3 conv on the LR input, a head
block, nearest-2x upsample, two middle blocks, then (n_blocks - 1)
upsample + block stages, and leaky ReLU -> 3x3 conv -> tanh.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deepsee_torch.config import ModelConfig
from deepsee_torch.models.blocks import SPADEResnetBlock
from deepsee_torch.models.layers import Conv2d
from deepsee_torch.ops.norms import leaky_relu
from deepsee_torch.ops.resize import upsample_nearest_2x


class DeepSEEGenerator(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.load_size >= 512 and cfg.n_blocks - 1 >= 4:
            raise NotImplementedError("the PureSEAN tail of >=512px models is "
                                      "not ported yet")
        self.dtype = getattr(torch, cfg.compute_dtype)
        nf16 = 16 * cfg.ngf
        early_style = not cfg.norm_g_spec.late
        self.initial = Conv2d(3, nf16, 3, padding=1)
        self.head_0 = SPADEResnetBlock(nf16, nf16, cfg, style=early_style)
        self.G_middle_0 = SPADEResnetBlock(nf16, nf16, cfg)
        self.G_middle_1 = SPADEResnetBlock(nf16, nf16, cfg)
        self.up_list = nn.ModuleList(SPADEResnetBlock(nf16, nf16, cfg)
                                     for _ in range(cfg.n_blocks - 1))
        self.conv_img = Conv2d(nf16, 3, 3, padding=1)

    def forward(self, lr_image: torch.Tensor, seg: torch.Tensor,
                style: Optional[torch.Tensor]) -> torch.Tensor:
        """lr_image (B, 3, h, w) in [-1, 1]; seg (B, semantic_nc, H, W)
        one-hot; style (B, label_nc, style_size).  NCHW in channels_last
        memory.  Returns (B, 3, H, W) float32."""
        x = self.initial(lr_image.to(self.dtype))
        x = self.head_0(x, seg, style)
        x = upsample_nearest_2x(x)
        x = self.G_middle_0(x, seg, style)
        x = self.G_middle_1(x, seg, style)
        for block in self.up_list:
            x = block(upsample_nearest_2x(x), seg, style)
        return torch.tanh(self.conv_img(leaky_relu(x)).float())
