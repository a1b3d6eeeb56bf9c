"""Plain float32 operations of the reference (see the package docstring).

The quantized conv follows the published W8A8 recipe with SmoothQuant at
alpha 0.5, per-output-channel weight scales and one dynamic scale per
activation tensor:

    s_c = sqrt(max|x_c|) / sqrt(max|k_c|)     (ones without smoothing)
    x' = x / s_c;  k' = k * s_c
    s_k = max|k'_o| / L;  s_x = max|x'| / L;  L = 2^(bits-1) - 1
    y = conv(round(x' / s_x), round(k' / s_k)) * s_x * s_k + bias

with every maximum floored at 1e-8 and the levels clipped to [-L, L].  The
integer product runs as a float32 conv of the levels (TF32 off), whose
rounding is some 1e-7 of the result.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FLOOR = 1e-8
LRELU_SLOPE = 0.2
NORM_EPS = 1e-5


@dataclass(frozen=True)
class Quant:
    """Which convs quantize and how: eval-mode convs whose input and output
    channels are both at least `min_ch`, at `bits` (8: W8A8, 4: W4A4)."""
    bits: int = 8
    min_ch: int = 64
    smooth: bool = True

    @property
    def levels(self) -> float:
        return float(2 ** (self.bits - 1) - 1)

    def applies(self, weight: torch.Tensor) -> bool:
        return weight.shape[0] >= self.min_ch and weight.shape[1] >= self.min_ch


@dataclass(frozen=True)
class FP8:
    """Every conv's input and weight rounded to float8 e4m3 under a scale
    per tensor (max|t| / 448), the gradient passed straight through: the
    training step one precision below bf16."""


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(FLOOR) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


class QuantLog:
    """The shapes of the convs a forward quantized, in order:
    [(x shape, weight shape, stride, padding)]."""

    def __init__(self):
        self.convs = []


def quant_conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int,
                 padding: int, q: Quant) -> torch.Tensor:
    levels = q.levels
    if q.smooth:
        mx = x.abs().amax(dim=(0, 2, 3)).clamp_min(FLOOR)
        mk = w.abs().amax(dim=(0, 2, 3)).clamp_min(FLOOR)
        s_c = torch.sqrt(mx) / torch.sqrt(mk)
    else:
        s_c = torch.ones(w.shape[1], device=x.device, dtype=x.dtype)
    xs = x / s_c[:, None, None]
    ws = w * s_c[:, None, None]
    s_k = ws.abs().amax(dim=(1, 2, 3)).clamp_min(FLOOR) / levels
    s_x = xs.abs().amax().clamp_min(FLOOR) / levels
    k_q = torch.clamp(torch.round(ws / s_k[:, None, None, None]), -levels, levels)
    x_q = torch.clamp(torch.round(xs / s_x), -levels, levels)
    y = F.conv2d(x_q, k_q, None, stride, padding) * (s_x * s_k)[:, None, None]
    return y if b is None else y + b[:, None, None]


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int = 1,
           padding: int = 1, q: Optional[Quant] = None,
           log: Optional[QuantLog] = None) -> torch.Tensor:
    """F.conv2d, or the quantized conv where `q` applies to this weight."""
    if isinstance(q, FP8):
        return F.conv2d(fp8_round(x), fp8_round(w), b, stride, padding)
    if q is not None and q.applies(w):
        if log is not None:
            log.convs.append((tuple(x.shape), tuple(w.shape), stride, padding))
        return quant_conv2d(x, w, b, stride, padding, q)
    return F.conv2d(x, w, b, stride, padding)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Per sample and channel over H, W, biased variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + NORM_EPS)


def batch_norm(x: torch.Tensor) -> torch.Tensor:
    """A training-mode batch norm without affine parameters: per channel
    over N, H, W, biased variance."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + NORM_EPS)


def running_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """An eval-mode batch norm without affine parameters."""
    return (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + NORM_EPS)


def nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """torch's nearest resize (source pixel floor(dst * in / out))."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="nearest")


def up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def one_hot(label: torch.Tensor, classes: int) -> torch.Tensor:
    """(B, H, W) integer map -> (B, classes, H, W) float32; labels outside
    [0, classes) give zeros."""
    ar = torch.arange(classes, device=label.device)
    return (label.long()[:, None] == ar[None, :, None, None]).float()


def _cubic(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    return np.where(at <= 1.0, (a + 2.0) * at ** 3 - (a + 3.0) * at ** 2 + 1.0,
                    np.where(at < 2.0, a * at ** 3 - 5.0 * a * at ** 2 + 8.0 * a * at - 4.0 * a,
                             0.0))


@functools.lru_cache(maxsize=None)
def bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix of torch's bicubic resize without antialiasing
    (a = -0.75, half-pixel centres, border taps replicated), rows
    normalized."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size))
    for o in range(out_size):
        centre = (o + 0.5) * scale - 0.5
        lo = int(np.floor(centre - 2.0)) + 1
        taps = np.arange(lo, lo + 4)
        np.add.at(mat[o], np.clip(taps, 0, in_size - 1), _cubic(taps - centre))
    mat /= mat.sum(axis=1, keepdims=True)
    return mat.astype(np.float32)


def downsample(image_hr: torch.Tensor, size: int) -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1] -> (B, 3, size, size) by bicubic, clamped
    to [-1, 1]."""
    h, w = image_hr.shape[-2:]
    mh = torch.from_numpy(bicubic_matrix(h, size)).to(image_hr.device)
    mw = torch.from_numpy(bicubic_matrix(w, size)).to(image_hr.device)
    return torch.einsum("oh,bchw,pw->bcop", mh, image_hr.float(), mw).clamp(-1.0, 1.0)
