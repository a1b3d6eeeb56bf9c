"""Style encoders producing the (B, label_nc, style_size) regional style
matrix, port of deepsee_tpu/models/encoder.py (eval mode):
`CombinedStyleEncoder` for the independent model, `FullStyleEncoder` (the
full trunk on the HR guiding image) for the guided one.

Both add the learned per-region style noise (encoder.py:50-70) unless
no_noise: sigmoid(noise_weights)-gated noise, clipped to [-1, 1].  Every
random draw goes through `draw_noise` with the caller's torch.Generator, so
a test can feed both packages the same numbers.

The module tree follows the reference's nesting so that state_dict keys
match `export_torch_state`: a trunk layer is
Sequential([Upsample,] Sequential(conv, norm), LeakyReLU), whose conv sits
at "<layer>.0.0" (or ".1.0" after an upsample), and the shared head is
Sequential(Sequential(conv, norm), Tanh) at "final.0.0".
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deepsee_torch.config import ModelConfig
from deepsee_torch.models.layers import NonSpadeNormConv
from deepsee_torch.ops.resize import resize2d, upsample_nearest_2x


def draw_noise(shape, dist: str, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """The encoders' one random draw: U[0, 1) ("uniform") or N(0, 1)
    ("normal") float32 of `shape`, from `generator` on `device`."""
    if generator is None:
        raise ValueError("a random draw needs an explicit torch.Generator")
    if dist == "uniform":
        return torch.rand(shape, generator=generator, device=device)
    if dist == "normal":
        return torch.randn(shape, generator=generator, device=device)
    raise ValueError(f"unknown noise distribution {dist!r}")


def style_noise(style: torch.Tensor, noise_weights: torch.Tensor, cfg: ModelConfig,
                generator: torch.Generator) -> torch.Tensor:
    """corrupt_style_matrix with learned region weights (encoder.py:50-70):
    "uniform" adds (rand*2-1)*scale, "normal" the reference's
    (randn*2-1)*scale verbatim; each region's noise is gated by
    sigmoid(noise_weights), then the style is clipped to [-1, 1]."""
    draw = draw_noise(tuple(style.shape), cfg.noisy_style_dist, generator, style.device)
    noise = (draw * 2.0 - 1.0) * cfg.noisy_style_scale
    w = torch.sigmoid(noise_weights.float())[None, :, None]
    return torch.clamp(style + noise * w, -1.0, 1.0)


def extract_style_matrix(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) features x (B, N, Hs, Ws) one-hot -> (B, N, C) float32:
    the masked mean over ALL H*W pixels (not the region's), encoder.py:37-47."""
    b, c, h, w = x.shape
    if tuple(seg.shape[-2:]) != (h, w):
        seg = resize2d(seg, (h, w), method="nearest")
    xf = x.float().permute(0, 2, 3, 1).reshape(b, h * w, c)
    sf = seg.float().permute(0, 2, 3, 1).reshape(b, h * w, -1)
    return torch.bmm(sf.transpose(1, 2), xf) / (h * w)


class _TrunkLayer(nn.Module):
    """[nearest 2x upsample ->] conv -> encoder norm -> leaky ReLU."""

    def __init__(self, cfg: ModelConfig, fin: int, fout: int, stride: int = 1,
                 upsample: bool = False):
        super().__init__()
        self.upsample = upsample
        self.slot = "1" if upsample else "0"
        self.add_module(self.slot, NonSpadeNormConv(fin, fout, 3, stride, 1, cfg.norm_e))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.upsample:
            x = upsample_nearest_2x(x)
        return self._modules[self.slot](x, lrelu=True)


class FullTrunk(nn.Module):
    """HR trunk: initial s1, down0 s2, down1 s2, upsample + conv."""

    def __init__(self, cfg: ModelConfig, in_channels: int = 3):
        super().__init__()
        nf = cfg.nef
        self.initial = _TrunkLayer(cfg, in_channels, nf)
        self.down0 = _TrunkLayer(cfg, nf, nf * 2, stride=2)
        self.down1 = _TrunkLayer(cfg, nf * 2, nf * 4, stride=2)
        self.up_conv = _TrunkLayer(cfg, nf * 4, nf * 8, upsample=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up_conv(self.down1(self.down0(self.initial(x))))


class MiniTrunk(nn.Module):
    """LR trunk: three stride-1 convs, then upsample + conv."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        nf = cfg.nef
        self.initial = _TrunkLayer(cfg, 3, nf)
        self.conv0 = _TrunkLayer(cfg, nf, nf * 2)
        self.conv1 = _TrunkLayer(cfg, nf * 2, nf * 4)
        self.conv2 = _TrunkLayer(cfg, nf * 4, nf * 8, upsample=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(self.conv0(self.initial(x))))


class _FinalHead(nn.Module):
    """Shared head: conv nef*8 -> style_size, encoder norm, tanh (float32)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.add_module("0", NonSpadeNormConv(cfg.nef * 8, cfg.regional_style_size,
                                              3, 1, 1, cfg.norm_e))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self._modules["0"](x).float())


class CombinedStyleEncoder(nn.Module):
    """Both trunks and the shared head (encoder.py:184-233); a static
    `use_full` picks the trunk that runs."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.encoder_full = FullTrunk(cfg)
        self.encoder_mini = MiniTrunk(cfg)
        self.final = _FinalHead(cfg)
        if cfg.noisy_style_scale > 0:  # learned style-noise weights, carried
            self.noise_weights = nn.Parameter(torch.zeros(cfg.label_nc))

    def forward(self, x_full: torch.Tensor, seg_full: torch.Tensor,
                x_mini: torch.Tensor, seg_mini: torch.Tensor, use_full: bool, *,
                no_noise: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if use_full:
            y, seg = self.encoder_full(x_full.to(self.dtype)), seg_full
        else:
            y, seg = self.encoder_mini(x_mini.to(self.dtype)), seg_mini
        style = extract_style_matrix(self.final(y), seg)
        if not no_noise and self.cfg.noisy_style_scale > 0:
            style = style_noise(style, self.noise_weights, self.cfg, generator)
        return style


class FullStyleEncoder(FullTrunk):
    """Standalone HR encoder, the guided model's netE (encoder.py:137-165).

    The full trunk's layers sit at the top level of this module, where the
    reference's standalone encoder has them (`initial.0.0`, ..., `final.0.0`,
    `noise_weights`), so it subclasses FullTrunk instead of holding one.

    With random_style_matrix the trunk reads per-region N(0, 1) maps masked
    by the segmap instead of an image (encoder.py:118-120), so its first
    conv takes semantic_nc channels."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg, cfg.semantic_nc if cfg.random_style_matrix else 3)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.final = _FinalHead(cfg)
        if cfg.noisy_style_scale > 0:  # learned style-noise weights, carried
            self.noise_weights = nn.Parameter(torch.zeros(cfg.label_nc))

    def forward(self, x_full: Optional[torch.Tensor], seg_full: torch.Tensor, *,
                no_noise: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        if cfg.random_style_matrix:
            b, n = seg_full.shape[:2]
            size = (cfg.crop_size, cfg.crop_size)
            draw = draw_noise((b,) + size + (n,), "normal", generator, seg_full.device)
            x_full = draw.permute(0, 3, 1, 2) * resize2d(seg_full, size, method="nearest")
            x_full = x_full.contiguous(memory_format=torch.channels_last)
        y = super().forward(x_full.to(self.dtype))
        style = extract_style_matrix(self.final(y), seg_full)
        if not no_noise and cfg.noisy_style_scale > 0:
            style = style_noise(style, self.noise_weights, cfg, generator)
        return style


def build_encoder(cfg: ModelConfig) -> nn.Module:
    """netE factory (encoder.py:236-242)."""
    if cfg.net_e == "combinedstyle":
        return CombinedStyleEncoder(cfg)
    if cfg.net_e == "fullstyle":
        return FullStyleEncoder(cfg)
    raise ValueError(f"Unknown netE: {cfg.net_e!r}")
