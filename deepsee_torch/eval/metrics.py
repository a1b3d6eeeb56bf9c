"""Image-quality metrics with the reference's semantics: port of
deepsee_tpu/eval/metrics.py (reference: evaluator/evaluation.py:88-137).

  * RMSE on [-1, 1] images (per-sample mean square error -> sqrt);
  * PSNR and MATLAB-parity SSIM on uint8-converted images (BasicSR,
    evaluator/calculate_PSNR_SSIM.py:71-122: an 11-tap Gaussian, sigma 1.5,
    over the *valid* window, per channel, then averaged);
  * MS-SSIM on the untruncated [0, 255] floats (evaluator/ssim.py:24-118),
    with the reference's literal output formula
    `prod(mcs[:-1]**w[:-1] * mssim[-1]**w[-1])`, which raises the last
    level's SSIM to w[-1] once per coarser level (a quirk kept because the
    reference's reported numbers use it), and the NaN a negative `mcs`
    raised to a fractional power gives;
  * the uint8 conversion of util/util.py:72-103 tensor2im:
    (x + 1) / 2 * 255, clip, truncate.

Every function takes (B, H, W, C) tensors, as `SRSystem.generate` returns
them, computes in float32 (a bf16 input is cast first) and returns one
float32 value per sample.  The Gaussian filter is float32 shifted
multiply-adds, not a convolution: on the card cuDNN may run a float32
convolution in TF32, whose 10-bit mantissa would cancel catastrophically in
SSIM's E[x^2] - mu^2 on values up to 255.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

__all__ = ["to_uint8_values", "psnr", "ssim_matlab", "ms_ssim", "rmse", "batch_metrics",
           "MetricsAccumulator"]

_DIMS = (1, 2, 3)


def to_uint8_values(x: torch.Tensor) -> torch.Tensor:
    """tensor2im semantics, kept in float: (x + 1) / 2 * 255, clip, truncate."""
    y = (x.float() + 1.0) / 2.0 * 255.0
    return torch.floor(torch.clamp(y, 0.0, 255.0))


def rmse(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Per-sample RMSE on [-1, 1] (evaluation.py:107-111)."""
    return torch.sqrt(torch.mean(torch.square(fake.float() - real.float()), dim=_DIMS))


def psnr(fake_255: torch.Tensor, real_255: torch.Tensor) -> torch.Tensor:
    """Per-sample PSNR on [0, 255] values (calculate_PSNR_SSIM.py:71-78);
    inf where the images are equal."""
    mse = torch.mean(torch.square(fake_255.float() - real_255.float()), dim=_DIMS)
    return torch.where(mse == 0, torch.full_like(mse, float("inf")),
                       20.0 * torch.log10(255.0 / torch.sqrt(mse)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _depthwise_valid_filter(x: torch.Tensor, window1d: np.ndarray) -> torch.Tensor:
    """Separable valid 2-D filtering of (B, H, W, C), per channel: along H,
    then along W, as float32 multiply-adds of shifted views (one kernel
    per tap)."""
    k = len(window1d)
    w = [float(v) for v in window1d]
    ho, wo = x.shape[1] - k + 1, x.shape[2] - k + 1
    y = w[0] * x[:, :ho]
    for i in range(1, k):
        y.add_(x[:, i:i + ho], alpha=w[i])
    z = w[0] * y[:, :, :wo]
    for j in range(1, k):
        z.add_(y[:, :, j:j + wo], alpha=w[j])
    return z


def _ssim_maps(img1: torch.Tensor, img2: torch.Tensor, window1d: np.ndarray,
               c1: float, c2: float):
    """(ssim_map, cs_map) over the valid region, (B, H', W', C)."""
    img1, img2 = img1.float(), img2.float()
    mu1 = _depthwise_valid_filter(img1, window1d)
    mu2 = _depthwise_valid_filter(img2, window1d)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_valid_filter(img1 * img1, window1d) - mu1_sq
    sigma2_sq = _depthwise_valid_filter(img2 * img2, window1d) - mu2_sq
    sigma12 = _depthwise_valid_filter(img1 * img2, window1d) - mu1_mu2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2
    ssim_map = ((2.0 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    return ssim_map, v1 / v2


def ssim_matlab(fake_255: torch.Tensor, real_255: torch.Tensor) -> torch.Tensor:
    """Per-sample MATLAB-parity SSIM on [0, 255] (calculate_PSNR_SSIM.py:
    81-122).  The reference's reflect-padded cv2.filter2D cropped by [5:-5]
    is a valid filter; the map is averaged over space and channels."""
    ssim_map, _ = _ssim_maps(fake_255, real_255, _gaussian_window(),
                             c1=(0.01 * 255) ** 2, c2=(0.03 * 255) ** 2)
    return torch.mean(ssim_map, dim=_DIMS)


_MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333], np.float32)  # ssim.py:90


def _avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(kernel=2) of (B, H, W, C): stride 2, no padding, odd
    sizes floored."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4)) / 4.0


def ms_ssim(fake_255: torch.Tensor, real_255: torch.Tensor, val_range: float = 255.0,
            levels: int = 5) -> torch.Tensor:
    """Per-sample MS-SSIM as evaluator/ssim.py:88-118: per level the valid
    SSIM and the mean contrast term `cs`, 2x average pooling between levels,
    the window shrunk to the image at small levels; the reference's output
    formula (module docstring)."""
    c1 = (0.01 * val_range) ** 2
    c2 = (0.03 * val_range) ** 2
    x, y = fake_255.float(), real_255.float()
    mssim: List[torch.Tensor] = []
    mcs: List[torch.Tensor] = []
    for lvl in range(levels):
        size = min(11, x.shape[1], x.shape[2])
        ssim_map, cs_map = _ssim_maps(x, y, _gaussian_window(size), c1, c2)
        mssim.append(torch.mean(ssim_map, dim=_DIMS))
        mcs.append(torch.mean(cs_map, dim=_DIMS))
        if lvl != levels - 1:
            x, y = _avg_pool_2x2(x), _avg_pool_2x2(y)
    w = [float(v) for v in _MSSSIM_WEIGHTS[:levels]]
    pow1 = torch.stack([torch.pow(v, wi) for v, wi in zip(mcs, w)], dim=-1)   # (B, levels)
    pow2_last = torch.pow(mssim[-1], w[-1])
    # ssim.py:117: torch.prod(pow1[:-1] * pow2[-1])
    return torch.prod(pow1[..., :-1] * pow2_last[:, None], dim=-1)


def batch_metrics(fake: torch.Tensor, real: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The four per-sample metrics of one batch, fake and real (B, H, W, 3)
    in [-1, 1]: PSNR and SSIM on the truncated uint8 values, MS-SSIM on
    the untruncated [0, 255] floats (evaluation.py:114,125), RMSE on
    [-1, 1]."""
    fake, real = fake.float(), real.float()
    f255, r255 = to_uint8_values(fake), to_uint8_values(real)
    return {"rmse": rmse(fake, real), "psnr": psnr(f255, r255),
            "ssim": ssim_matlab(f255, r255),
            "ms_ssim": ms_ssim((fake + 1.0) * 127.5, (real + 1.0) * 127.5)}


class MetricsAccumulator:
    """Collects per-sample metric values; mean and std as evaluation.py:
    139-156."""

    def __init__(self):
        self.buffers: Dict[str, List[float]] = {}

    def add(self, name: str, values) -> None:
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        self.buffers.setdefault(name, []).extend(np.atleast_1d(np.asarray(values)).tolist())

    def add_batch(self, fake: torch.Tensor, real: torch.Tensor) -> None:
        """fake, real: (B, H, W, 3) in [-1, 1]."""
        for name, values in batch_metrics(fake, real).items():
            self.add(name, values)

    @property
    def n_samples(self) -> int:
        return len(next(iter(self.buffers.values()), []))

    def result(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, vals in self.buffers.items():
            out[f"{name}/mean"] = float(np.mean(vals))
            out[f"{name}/std"] = float(np.std(vals))
        out["n_samples"] = self.n_samples
        return out
