"""SPADE residual block, port of deepsee_tpu/models/blocks.py (eval mode).

norm -> leaky ReLU -> conv, twice, plus the identity shortcut.  Each
norm -> leaky ReLU pair is one `modnorm` launch inside the norm module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deepsee_torch.config import ModelConfig
from deepsee_torch.models.layers import Conv2d, NoiseInjection
from deepsee_torch.models.normalization import SEANBlock, SPADE


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin: int, fout: int, cfg: ModelConfig, style: bool = True):
        super().__init__()
        if fin != fout:
            raise NotImplementedError("the learned shortcut (fin != fout) is not "
                                      "ported yet")
        spec = cfg.norm_g_spec
        norm = SEANBlock if style and spec.sean else SPADE
        if cfg.add_noise:  # training-only noise; the weights are carried
            self.noise_in = NoiseInjection(fin)
            self.noise_skip = NoiseInjection(fin)
            self.noise_middle = NoiseInjection(fin)
        self.norm_0 = norm(cfg, fin)
        self.conv_0 = Conv2d(fin, fin, 3, padding=1, spectral=spec.spectral)
        self.norm_1 = norm(cfg, fin)
        self.conv_1 = Conv2d(fin, fout, 3, padding=1, spectral=spec.spectral)

    def forward(self, x: torch.Tensor, seg: torch.Tensor,
                style: Optional[torch.Tensor]) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("the training forward (noise injection) "
                                      "is not ported yet; call .eval()")
        dx = self.conv_0(self.norm_0(x, seg, style, lrelu=True))
        dx = self.conv_1(self.norm_1(dx, seg, style, lrelu=True))
        return x + dx
