"""DeepSEE super-resolution generator, port of deepsee_tpu/models/generator.py.

A constant 16*ngf-channel trunk: initial 3x3 conv on the LR input, a head
block, nearest-2x upsample, two middle blocks, then (n_blocks - 1)
upsample + block stages, and leaky ReLU -> 3x3 conv -> tanh.  For >=512px
outputs, the up blocks from index 3 on are PureSEAN (sr.py:42-52).

`variant` selects the paper's ablation generators (ablation.py:32,125,219):
"deepsee" (the model), "nostyle" (plain SPADE blocks), "nospade"
(pix2pixHD blocks) or "puresean" (PureSEAN blocks throughout).

With `remat`, every block (head_0, G_middle_0/1, each up_i) of a training
forward that records a graph is rematerialized by `remat_policy`, "full" or
"convs" (models/remat.py); `initial`, the upsamples and `conv_img` are not.
An eval-mode forward, or one under torch.no_grad (the D step's regenerated
fake), runs the blocks plainly.

Tensor parallelism: `initial` is column-sharded where the plan shards the
trunk (its output gathered before head_0), the blocks take and return
replicated activations (models/blocks.py), and `conv_img` is replicated.

Spatial sharding: every map is this rank's stripe; `initial`, the blocks'
3x3 convs and `conv_img` take their halos (models/layers.py::conv2d), the
1x1 conv_s and the nearest upsamples are local.  The "nospade" variant's
reflection-padded convs take a halo whose rows beyond the global top and
bottom mirror rows 1 and H-2 (`spatial.window`'s "reflect" edge) and pad W
by mirroring locally; stripes of fewer than 2 rows are refused there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deepsee_torch.config import ModelConfig
from deepsee_torch.models import remat as remat_mod
from deepsee_torch.models.blocks import SPADEResnetBlock
from deepsee_torch.models.layers import Conv2d, NonSpadeNormConv
from deepsee_torch.ops.norms import leaky_relu
from deepsee_torch.ops.resize import upsample_nearest_2x
from deepsee_torch.parallel import tensor as tp

VARIANTS = ("deepsee", "nostyle", "nospade", "puresean")


class Pix2PixResnetBlock(nn.Module):
    """Plain pix2pixHD resblock (ablation.py:13-29): reflect pad -> spectral
    3x3 conv -> instance norm -> ReLU, twice, plus the identity.  Its convs
    sit where the reference's Sequential puts them, `conv_block.1.0` and
    `conv_block.4.0`, and pad by reflection (`padding_mode` "reflect": on
    stripes, a reflect halo of one row and W mirrored locally); each
    instance norm is one `modnorm` launch, or K1's instance split over the
    stripes."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Module()
        for slot in ("1", "4"):
            self.conv_block.add_module(slot, NonSpadeNormConv(dim, dim, 3, 1, 1,
                                                              "spectralinstance",
                                                              padding_mode="reflect"))

    def forward(self, x: torch.Tensor, seg: Optional[torch.Tensor] = None,
                style: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        conv0, conv1 = self.conv_block._modules["1"], self.conv_block._modules["4"]
        return x + conv1(torch.relu(conv0(x)))


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
    def __init__(self, cfg: ModelConfig, variant: str = "deepsee", remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
        if remat_policy not in remat_mod.POLICIES:
            raise ValueError(f"remat_policy must be one of {remat_mod.POLICIES}, "
                             f"got {remat_policy!r}")
        self.remat, self.remat_policy = remat, remat_policy
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
                style: Optional[torch.Tensor], *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """lr_image (B, 3, h, w) in [-1, 1]; seg (B, semantic_nc, H, W)
        one-hot; style (B, label_nc, style_size).  NCHW in channels_last
        memory.  Returns (B, 3, H, W) float32.  `generator` feeds the noise
        injection of a train-mode forward with add_noise."""
        x = tp.full(self.initial(lr_image.to(self.dtype)), self.initial.out_sharded)
        x = self._apply_block(self.head_0, x, seg, style, generator)
        x = upsample_nearest_2x(x)
        x = self._apply_block(self.G_middle_0, x, seg, style, generator)
        x = self._apply_block(self.G_middle_1, x, seg, style, generator)
        for block in self.up_list:
            x = self._apply_block(block, upsample_nearest_2x(x), seg, style, generator)
        return torch.tanh(self.conv_img(leaky_relu(x)).float())

    def _apply_block(self, block: nn.Module, x: torch.Tensor, seg: torch.Tensor,
                     style: Optional[torch.Tensor],
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """One block, rematerialized where remat is on and the forward is a
        training one that records a graph."""
        if self.remat and self.training and torch.is_grad_enabled():
            return remat_mod.checkpoint_block(block, self.remat_policy, x, seg, style,
                                              generator)
        return block(x, seg, style, generator=generator)
