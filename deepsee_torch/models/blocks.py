"""SPADE residual block, port of deepsee_tpu/models/blocks.py.

norm -> leaky ReLU -> conv, twice, plus the shortcut: the identity, or with
fin != fout the learned one, norm_s -> spectral 1x1 conv_s (no leaky ReLU).
Each norm -> leaky ReLU pair is one `modnorm` launch inside the norm module.
Training with add_noise injects noise (blocks.py:49-69): noise_in on the
input, noise_skip on the shortcut's input (the identity's too) and
noise_middle after conv_0, drawn in that order from the caller's generator.

Tensor parallelism (the Megatron pair of deepsee_tpu/parallel/mesh.py:148-156):
the block's input and output are replicated.  norm_0 runs K1 on this
rank's channel block of x with its block of the modulation; its output is
gathered and enters the column-sharded conv_0 through `copy`; noise_middle,
norm_1 and its leaky ReLU stay on conv_0's output block; the row-sharded
conv_1 sums its partial outputs over the model group and adds its bias
once.  conv_s is replicated: norm_s's output is gathered before it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deepsee_torch.config import ModelConfig
from deepsee_torch.models.layers import Conv2d, NoiseInjection
from deepsee_torch.models.normalization import PureSEANBlock, SEANBlock, SPADE
from deepsee_torch.parallel import tensor as tp


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
                style: Optional[torch.Tensor], *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        add_noise = self.training and hasattr(self, "noise_in")
        if add_noise:
            x = self.noise_in(x, generator)
        x_skip = self.noise_skip(x, generator) if add_noise else x
        x_s = x_skip
        if self.learned_shortcut:
            x_s = self.conv_s(self.norm_s(x_skip, seg, style), sharded=self.norm_s.out_sharded)
            x_s = tp.full(x_s, self.conv_s.out_sharded)
        dx = self.conv_0(self.norm_0(x, seg, style, lrelu=True), sharded=self.norm_0.out_sharded)
        sharded = self.conv_0.out_sharded
        if add_noise:
            dx = self.noise_middle(dx, generator, sharded=sharded)
        dx = self.conv_1(self.norm_1(dx, seg, style, lrelu=True, sharded=sharded),
                         sharded=self.norm_1.out_sharded)
        return x_s + tp.full(dx, self.conv_1.out_sharded)
