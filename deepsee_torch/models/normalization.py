"""Semantic modulation blocks SPADE, SEAN and PureSEAN, port of
deepsee_tpu/models/normalization.py.

Each block computes norm(x) * scale + offset, where scale/offset come from
ONE conv with 2C outputs (SPADE and SEAN fold the +1 of the scale into its
bias; PureSEAN has none), and the whole epilogue -- normalize, modulate and
the leaky ReLU that SPADEResnetBlock applies next -- is one `modnorm` kernel
launch that reads the conv output as it is (`modnorm_train` in training,
with batch statistics and a backward kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepsee_torch.config import ModelConfig
from deepsee_torch.models.layers import (Conv2d, check_training_forward, conv2d, quantizes,
                                         update_running_stats, xavier_normal_)
from deepsee_torch.ops.modnorm import modnorm, modnorm_train, modnorm_train_sync
from deepsee_torch.ops.resize import resize2d
from deepsee_torch.parallel import distributed

_NHIDDEN = 128  # the reference's embedding width (normalization.py:38)


# Per dimension, row s of the 4-tap kernel of `conv_on_nearest_up2` sums the
# 3x3 taps that read the same source pixel (the JAX package's _UP2_FOLD:
# W4[0]=K[0], W4[1]=K[0]+K[1], W4[2]=K[1]+K[2], W4[3]=K[2]), here in the
# reverse order, because a transposed conv applies its kernel flipped.
_UP2_FOLD_FLIPPED = torch.tensor([[0.0, 0.0, 1.0],
                                  [0.0, 1.0, 1.0],
                                  [1.0, 1.0, 0.0],
                                  [1.0, 0.0, 0.0]])


def conv_on_nearest_up2(a: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """conv3x3(nearest_up2(a), weight, padding=1) + bias without the upsample
    (normalization.py:98-144): one stride-2 transposed conv with the composed
    4x4 kernel, so each output pixel reads the 2x2 source pixels its 3x3
    window touched -- 4/9 of the MACs, and the duplicated map is never
    made.  The taps are summed in float32 before the cast to a's dtype.
    weight (Cout, Cin, 3, 3) -> (Cin, Cout, 4, 4) for conv_transpose2d."""
    fold = _UP2_FOLD_FLIPPED.to(weight.device)
    w4 = torch.einsum("su,rv,oiuv->iosr", fold, fold, weight.float())
    y = F.conv_transpose2d(a, w4.to(a.dtype), bias.to(a.dtype), stride=2, padding=1)
    return y.contiguous(memory_format=torch.channels_last)


class ConvParams(nn.Module):
    """Weight and bias of a conv that is folded into another one at forward;
    shaped like the reference's conv so checkpoints map one to one."""

    def __init__(self, cin: int, cout: int, ks: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, ks, ks))
        self.bias = nn.Parameter(torch.zeros(cout))

    def init_params(self, generator: torch.Generator) -> None:
        xavier_normal_(self.weight, generator)
        nn.init.zeros_(self.bias)


def style_to_pixels(segmap: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """One-hot segmap (B, N, H, W) x style matrix (B, N, S) -> style map
    (B, S, H, W) in channels_last memory, as one batched matmul.

    With contain_dontcare_label the segmap has one channel more than the
    style has rows; the dontcare region gets a zero style row.
    """
    b, n, h, w = segmap.shape
    if n == style.shape[1] + 1:
        style = F.pad(style, (0, 0, 0, 1))
    seg = segmap.permute(0, 2, 3, 1).reshape(b, h * w, n)
    return torch.bmm(seg, style.to(seg.dtype)).view(b, h, w, -1).permute(0, 3, 1, 2)


class ParamFreeNorm(nn.Module):
    """The param-free part of SPADE/SEAN -- instance or (sync)batch norm --
    applied together with the modulation and optional leaky ReLU.

    The batch kinds carry `running_mean`/`running_var`: eval mode normalizes
    with them; train mode with the batch's statistics over (N, H, W), which
    the kernel returns, and then updates them (momentum 0.1, unbiased
    variance).  Under a process group of more than one rank the batch is
    the global one (the JAX package's batch norm under jit over a sharded
    batch): the statistics come from every rank's rows (`modnorm_train_sync`)
    and the running variance is unbiased over the world's pixels.
    """

    EPS = 1e-5

    def __init__(self, features: int, kind: str):
        super().__init__()
        self.kind = kind
        if kind != "instance":
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))

    def init_params(self, generator: torch.Generator) -> None:
        if self.kind != "instance":
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, mod: Optional[torch.Tensor] = None, *,
                lrelu: bool = False) -> torch.Tensor:
        if self.training:
            check_training_forward(self)
            stats = "instance" if self.kind == "instance" else "batch"
            world = distributed.world_size() if stats == "batch" else 1
            if world > 1:
                out, mean, rstd = modnorm_train_sync(x, mod, eps=self.EPS, lrelu=lrelu)
            else:
                out, mean, rstd = modnorm_train(x, mod, stats=stats, eps=self.EPS, lrelu=lrelu)
            if stats == "batch":
                b, _, h, w = x.shape
                var = rstd.pow(-2) - self.EPS
                update_running_stats(self.running_mean, self.running_var, mean, var,
                                     world * b * h * w)
            return out
        if self.kind == "instance":
            return modnorm(x, mod, stats="instance", lrelu=lrelu)
        return modnorm(x, mod, stats="affine", mean=self.running_mean,
                       var=self.running_var, eps=self.EPS, lrelu=lrelu)


def _mlp_shared(cfg: ModelConfig) -> nn.Sequential:
    ks = cfg.norm_g_spec.kernel_size
    return nn.Sequential(Conv2d(cfg.semantic_nc, _NHIDDEN, ks, padding=ks // 2),
                         nn.ReLU())


class SPADE(nn.Module):
    """Classic SPADE (normalization.py:179-212): gamma/beta convolved from the
    nearest-resized one-hot segmap."""

    def __init__(self, cfg: ModelConfig, norm_nc: int):
        super().__init__()
        spec = cfg.norm_g_spec
        self.ks = spec.kernel_size
        self.param_free_norm = ParamFreeNorm(norm_nc, spec.param_free_kind)
        self.mlp_shared = _mlp_shared(cfg)
        self.mlp_gamma = ConvParams(_NHIDDEN, norm_nc, self.ks)
        self.mlp_beta = ConvParams(_NHIDDEN, norm_nc, self.ks)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor,
                style: Optional[torch.Tensor] = None, *,
                lrelu: bool = False) -> torch.Tensor:
        seg = resize2d(segmap, x.shape[-2:], method="nearest")
        actv = self.mlp_shared(seg.to(x.dtype))
        weight = torch.cat([self.mlp_gamma.weight, self.mlp_beta.weight])
        bias = torch.cat([self.mlp_gamma.bias + 1.0, self.mlp_beta.bias])
        mod = conv2d(actv, weight, bias, padding=self.ks // 2, training=self.training)
        return self.param_free_norm(x, mod, lrelu=lrelu)


class _SEANCore(nn.Module):
    """What SEAN and PureSEAN blocks share (normalization.py:215-255):
    segmap features and the per-pixel style map at a resolution capped by
    max_fm_size, and the modulation conv on them."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.ks = cfg.norm_g_spec.kernel_size
        self.mlp_shared = _mlp_shared(cfg)

    def _maps(self, x_hw: Tuple[int, int], segmap: torch.Tensor,
              style: torch.Tensor, dtype: torch.dtype):
        """(actv, style_map, up2).  With up2 the maps are at half of x_hw and
        `_mod_conv` computes the conv of their nearest 2x upsample."""
        cfg = self.cfg
        x_hw = tuple(x_hw)
        fm_hw = (min(x_hw[0], cfg.max_fm_size), min(x_hw[1], cfg.max_fm_size))
        seg = resize2d(segmap, fm_hw, method="nearest")
        actv = self.mlp_shared(seg.to(dtype))
        style_map = style_to_pixels(seg, style).to(dtype)
        if fm_hw == x_hw:
            return actv, style_map, False
        up2 = (cfg.fold_upsampled_mod_conv and self.ks == 3
               and x_hw == (2 * fm_hw[0], 2 * fm_hw[1]))
        if not up2:
            actv = resize2d(actv, x_hw, method="nearest")
        if cfg.replicate_fm_resize_quirk:
            # the reference assigns interpolate(actv) to the style map too
            # (normalization.py:188-190); released checkpoints rely on it
            style_map = actv
        elif not up2:
            style_map = resize2d(style_map, x_hw, method="nearest")
        return actv, style_map, up2

    def _mod_conv(self, inp: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  up2: bool) -> torch.Tensor:
        if up2:
            if not quantizes(self.training, weight.shape[1], weight.shape[0]):
                return conv_on_nearest_up2(inp, weight, bias)
            # the int8 conv has no fold: the literal upsample, then the conv
            # (normalization.py:130-137)
            inp = resize2d(inp, (2 * inp.shape[2], 2 * inp.shape[3]), method="nearest")
        return conv2d(inp, weight, bias, padding=self.ks // 2, training=self.training)


class SEANBlock(_SEANCore):
    """SEAN (normalization.py:258-310): segmap- and style-conditioned
    gamma/beta blended by learned sigmoid weights.

    The four convs and the blend fold into one 256 -> 2C conv at forward
    (convolution is linear); the four parameter tensors stay separate.
    """

    def __init__(self, cfg: ModelConfig, norm_nc: int):
        super().__init__(cfg)
        self.param_free_norm = ParamFreeNorm(norm_nc, cfg.norm_g_spec.param_free_kind)
        self.alpha_gamma = nn.Parameter(torch.zeros(1))
        self.alpha_beta = nn.Parameter(torch.zeros(1))
        self.mlp_gamma = ConvParams(_NHIDDEN, norm_nc, self.ks)
        self.mlp_beta = ConvParams(_NHIDDEN, norm_nc, self.ks)
        self.mlp_style_gamma = ConvParams(cfg.regional_style_size, norm_nc, self.ks)
        self.mlp_style_beta = ConvParams(cfg.regional_style_size, norm_nc, self.ks)

    def init_params(self, generator: torch.Generator) -> None:
        # torch init: nn.Parameter(torch.rand(1))
        with torch.no_grad():
            self.alpha_gamma.copy_(torch.rand(1, generator=generator))
            self.alpha_beta.copy_(torch.rand(1, generator=generator))

    def forward(self, x: torch.Tensor, segmap: torch.Tensor, style: torch.Tensor,
                *, lrelu: bool = False) -> torch.Tensor:
        actv, style_map, up2 = self._maps(x.shape[-2:], segmap, style, x.dtype)
        wg = torch.sigmoid(self.alpha_gamma)[0]
        wb = torch.sigmoid(self.alpha_beta)[0]
        g, b = self.mlp_gamma, self.mlp_beta
        gs, bs = self.mlp_style_gamma, self.mlp_style_beta
        weight = torch.cat([
            torch.cat([(1.0 - wg) * g.weight, wg * gs.weight], dim=1),
            torch.cat([(1.0 - wb) * b.weight, wb * bs.weight], dim=1)])
        bias = torch.cat([(1.0 - wg) * g.bias + wg * gs.bias + 1.0,
                          (1.0 - wb) * b.bias + wb * bs.bias])
        inp = torch.cat([actv, style_map], dim=1).contiguous(
            memory_format=torch.channels_last)
        mod = self._mod_conv(inp, weight, bias, up2)
        return self.param_free_norm(x, mod, lrelu=lrelu)


class PureSEANBlock(_SEANCore):
    """Style-only SEAN (normalization.py:313-346): norm(x) * g_s + b_s, the
    top-resolution blocks of >=512px models.  Its scale has no +1: the
    modulation bias is concat(b_gamma_s, b_beta_s) as it is, and `modnorm`
    takes mod[:, :C] as the scale itself."""

    def __init__(self, cfg: ModelConfig, norm_nc: int):
        super().__init__(cfg)
        self.param_free_norm = ParamFreeNorm(norm_nc, cfg.norm_g_spec.param_free_kind)
        self.mlp_style_gamma = ConvParams(cfg.regional_style_size, norm_nc, self.ks)
        self.mlp_style_beta = ConvParams(cfg.regional_style_size, norm_nc, self.ks)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor, style: torch.Tensor,
                *, lrelu: bool = False) -> torch.Tensor:
        _, style_map, up2 = self._maps(x.shape[-2:], segmap, style, x.dtype)
        gs, bs = self.mlp_style_gamma, self.mlp_style_beta
        mod = self._mod_conv(style_map, torch.cat([gs.weight, bs.weight]),
                             torch.cat([gs.bias, bs.bias]), up2)
        return self.param_free_norm(x, mod, lrelu=lrelu)
