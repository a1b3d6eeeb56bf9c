"""LPIPS (net-lin, alex), Learned Perceptual Image Patch Similarity: port of
deepsee_tpu/eval/lpips.py (reference: evaluator/PerceptualSimilarity,
networks_basic.py:24-123, pretrained_networks.py:61-102, ps_util.py:10-12).

The version 0.1 scaling layer, AlexNet feature taps after each of its five
ReLUs, per-channel unit normalisation (eps 1e-10), squared differences,
learned 1x1 "lin" heads, the spatial mean and the sum over the taps.

The modules carry the reference's keys: `AlexNetFeatures` is torchvision's
AlexNet `features` (`features.{0,3,6,8,10}.weight/bias`), so a torchvision
state dict loads strictly; the heads are `lin{i}.model.1.weight`, shape
(1, C, 1, 1), as in the reference's v0.1/alex.pth
(evaluator/PerceptualSimilarity/models/weights/v0.1/alex.pth of the
reference repository).  Without the files `load_lpips` falls back as the JAX
package does: a He-normal AlexNet with zero biases drawn from a seeded
generator and uniform 1/C heads, with exact=False (relative comparisons
only; absolute values differ from the published metric).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from deepsee_torch.weights import reference_state_dict

__all__ = ["AlexNetFeatures", "LPIPS", "load_lpips"]

# (out_ch, kernel, stride, pad); max pool (3, 2) before conv 1 and conv 2
_ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet `features` through the last ReLU; returns the
    five ReLU taps of a (B, 3, H, W) input."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 3
        for i, (cout, k, stride, pad) in enumerate(_ALEX_CONVS):
            if i in (1, 2):
                layers.append(nn.MaxPool2d(3, 2))
            layers += [nn.Conv2d(cin, cout, k, stride, pad), nn.ReLU()]
            cin = cout
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for m in self.features:
            x = m(x)
            if isinstance(m, nn.ReLU):
                taps.append(x)
        return taps


class _Lin(nn.Module):
    """The reference's NetLinLayer: Sequential(Dropout, 1x1 conv without
    bias).  The metric never trains, so index 0 is an identity."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, (cout, _, _, _) in enumerate(_ALEX_CONVS):
            self.add_module(f"lin{i}", _Lin(cout))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def init_params(self, generator: torch.Generator) -> None:
        """The JAX package's fallback: He-normal convs (variance 2 / fan_in)
        with zero biases, uniform 1/C heads.  `generator` is a CPU
        generator; the values do not depend on the device."""
        with torch.no_grad():
            for m in self.net.features:
                if isinstance(m, nn.Conv2d):
                    w = torch.randn(m.weight.shape, generator=generator)
                    m.weight.copy_(w * math.sqrt(2.0 / m.weight[0].numel()))
                    m.bias.zero_()
            for i, (cout, _, _, _) in enumerate(_ALEX_CONVS):
                getattr(self, f"lin{i}").model[1].weight.fill_(1.0 / cout)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """Per-sample LPIPS distance (B,) of two (B, H, W, 3) images in
        [-1, 1], computed in float32."""
        def feats(img):
            x = img.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            return self.net((x - self.shift) / self.scale)

        total = 0.0
        for i, (a, b) in enumerate(zip(feats(img0), feats(img1))):
            na = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)
            nb = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)) + 1e-10)
            d = getattr(self, f"lin{i}").model(torch.square(na - nb))
            total = total + torch.mean(d, dim=(1, 2, 3))
        return total


def load_lpips(lin_path: Optional[str] = None, alexnet_path: Optional[str] = None,
               seed: int = 0, device: str | torch.device = "cuda") -> Tuple[LPIPS, bool]:
    """The LPIPS module in eval mode on `device`, and `exact`: False when
    the AlexNet or the heads fell back to the seeded random or uniform
    weights (module docstring).  `alexnet_path` is a torchvision AlexNet
    state dict (its `classifier.*` keys are not used); `lin_path` holds the
    `lin{i}.model.1.weight` heads."""
    module = LPIPS()
    module.init_params(torch.Generator().manual_seed(seed))
    exact = True
    if alexnet_path and os.path.exists(alexnet_path):
        sd = reference_state_dict(alexnet_path)
        module.net.load_state_dict({k: v for k, v in sd.items() if k.startswith("features.")},
                                   strict=True)
    else:
        exact = False
    if lin_path and os.path.exists(lin_path):
        sd = reference_state_dict(lin_path)
        for i in range(len(_ALEX_CONVS)):
            getattr(module, f"lin{i}").load_state_dict(
                {"model.1.weight": sd[f"lin{i}.model.1.weight"]}, strict=True)
    else:
        exact = False
    return module.to(device).eval().requires_grad_(False), exact
