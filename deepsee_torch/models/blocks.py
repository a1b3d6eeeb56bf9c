"""SPADE residual block, port of deepsee_tpu/models/blocks.py (eval mode).

norm -> leaky ReLU -> conv, twice, plus the shortcut: the identity, or with
fin != fout the learned one, norm_s -> spectral 1x1 conv_s (no leaky ReLU).
Each norm -> leaky ReLU pair is one `modnorm` launch inside the norm module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deepsee_torch.config import ModelConfig
from deepsee_torch.models.layers import Conv2d, NoiseInjection
from deepsee_torch.models.normalization import PureSEANBlock, SEANBlock, SPADE


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin: int, fout: int, cfg: ModelConfig, style: bool = True,
                 puresean: bool = False):
        super().__init__()
        spec = cfg.norm_g_spec
        # architecture.py:65-71 block selection
        if puresean:
            norm = PureSEANBlock
        elif style and spec.sean:
            norm = SEANBlock
        else:
            norm = SPADE
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        if cfg.add_noise:  # training-only noise; the weights are carried
            self.noise_in = NoiseInjection(fin)
            self.noise_skip = NoiseInjection(fin)
            self.noise_middle = NoiseInjection(fmiddle)
        if self.learned_shortcut:
            self.norm_s = norm(cfg, fin)
            self.conv_s = Conv2d(fin, fout, 1, padding=0, bias=False, spectral=spec.spectral)
        self.norm_0 = norm(cfg, fin)
        self.conv_0 = Conv2d(fin, fmiddle, 3, padding=1, spectral=spec.spectral)
        self.norm_1 = norm(cfg, fmiddle)
        self.conv_1 = Conv2d(fmiddle, fout, 3, padding=1, spectral=spec.spectral)

    def forward(self, x: torch.Tensor, seg: torch.Tensor,
                style: Optional[torch.Tensor]) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("the training forward (noise injection) "
                                      "is not ported yet; call .eval()")
        x_s = self.conv_s(self.norm_s(x, seg, style)) if self.learned_shortcut else x
        dx = self.conv_0(self.norm_0(x, seg, style, lrelu=True))
        dx = self.conv_1(self.norm_1(dx, seg, style, lrelu=True))
        return x_s + dx
