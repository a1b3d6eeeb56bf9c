"""DeepSEE super-resolution generator, port of deepsee_tpu/models/generator.py
(eval mode).

A constant 16*ngf-channel trunk: initial 3x3 conv on the LR input, a head
block, nearest-2x upsample, two middle blocks, then (n_blocks - 1)
upsample + block stages, and leaky ReLU -> 3x3 conv -> tanh.  For >=512px
outputs, the up blocks from index 3 on are PureSEAN (sr.py:42-52).

`variant` selects the paper's ablation generators (ablation.py:32,125,219):
"deepsee" (the model), "nostyle" (plain SPADE blocks), "nospade"
(pix2pixHD blocks) or "puresean" (PureSEAN blocks throughout).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepsee_torch.config import ModelConfig
from deepsee_torch.models.blocks import SPADEResnetBlock
from deepsee_torch.models.layers import Conv2d, NonSpadeNormConv
from deepsee_torch.ops.norms import leaky_relu
from deepsee_torch.ops.resize import upsample_nearest_2x

VARIANTS = ("deepsee", "nostyle", "nospade", "puresean")


class Pix2PixResnetBlock(nn.Module):
    """Plain pix2pixHD resblock (ablation.py:13-29): reflect pad -> spectral
    3x3 conv -> instance norm -> ReLU, twice, plus the identity.  Its convs
    sit where the reference's Sequential puts them, `conv_block.1.0` and
    `conv_block.4.0`; each instance norm is one `modnorm` launch."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Module()
        for slot in ("1", "4"):
            self.conv_block.add_module(slot, NonSpadeNormConv(dim, dim, 3, 1, 0,
                                                              "spectralinstance"))

    def forward(self, x: torch.Tensor, seg: Optional[torch.Tensor] = None,
                style: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv0, conv1 = self.conv_block._modules["1"], self.conv_block._modules["4"]
        y = torch.relu(conv0(F.pad(x, (1, 1, 1, 1), mode="reflect")))
        return x + conv1(F.pad(y, (1, 1, 1, 1), mode="reflect"))


def _block(cfg: ModelConfig, variant: str, styled: bool, puresean: bool) -> nn.Module:
    nf16 = 16 * cfg.ngf
    if variant == "nospade":
        return Pix2PixResnetBlock(nf16)
    if variant == "nostyle":
        styled = False
    elif variant == "puresean":
        styled, puresean = True, True
    return SPADEResnetBlock(nf16, nf16, cfg, style=styled, puresean=puresean)


class DeepSEEGenerator(nn.Module):
    def __init__(self, cfg: ModelConfig, variant: str = "deepsee"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
        self.dtype = getattr(torch, cfg.compute_dtype)
        nf16 = 16 * cfg.ngf
        self.initial = Conv2d(3, nf16, 3, padding=1)
        self.head_0 = _block(cfg, variant, not cfg.norm_g_spec.late, False)
        self.G_middle_0 = _block(cfg, variant, True, False)
        self.G_middle_1 = _block(cfg, variant, True, False)
        # sr.py:42-52: at most 4 full blocks for >=512px, PureSEAN beyond
        max_full = 4 if cfg.load_size >= 512 else 99
        self.up_list = nn.ModuleList(_block(cfg, variant, True, i + 1 >= max_full)
                                     for i in range(cfg.n_blocks - 1))
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
