"""VGG19 features for the perceptual loss, port of deepsee_tpu/models/vgg.py
(reference: networks/architecture.py:151-181, loss.py:105-119).

Returns [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1], the reference's five
torchvision slices.  As in the reference, images go in in [-1, 1] without
ImageNet normalization.  The module is torchvision's `vgg19().features` up
to relu5_1, so its state_dict keys are torchvision's (`features.<N>.weight`)
and a torchvision-format file loads as it is (`load_vgg19_state_dict`).
Without a file the weights are random (he-normal, as flax's init), which the
trainer announces: a valid but weaker perceptual loss.

Tensor parallelism (deepsee_tpu/parallel/mesh.py:163-165, `_vgg_spec`):
conv i's "column", "row" or None is the `tp_shard` that parallel/shard.py
puts on its weight; the weights are frozen, but the fake's gradient flows through, so a
column conv's replicated input goes through `copy`.  Every tap lands after
a row or replicated conv, so the features come out with every channel.

Spatial sharding: each conv takes its 3x3 halo (`spatial.window`); the 2x2
max pools stay local on the even stripes (parallel/spatial.py's check_layout
refuses a model axis that does not divide relu5_1's map).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deepsee_torch.parallel import spatial
from deepsee_torch.parallel import tensor as tp

# channels per conv, "M" a 2x2 stride-2 max pool (VGG19 "E"), through relu5_1
_LAYOUT = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512)
# the tapped features: after these convs (1-indexed)
_TAP_AFTER_CONV = (1, 3, 5, 9, 13)


class VGG19Features(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        layers: List[nn.Module] = []
        cin = 3
        for spec in _LAYOUT:
            if spec == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, spec, 3, padding=1), nn.ReLU()]
                cin = spec
        self.features = nn.Sequential(*layers)

    def init_params(self, generator: torch.Generator) -> None:
        """flax's he_normal: truncated normal (+-2 std) with variance
        2 / fan_in, zero biases."""
        with torch.no_grad():
            for m in self.features:
                if isinstance(m, nn.Conv2d):
                    std = math.sqrt(2.0 / m.weight[0].numel()) / 0.87962566103423978
                    w = torch.empty(m.weight.shape)  # drawn on the CPU, as the generator is
                    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                    m.weight.copy_(w)
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps, convs, sharded = [], 0, False
        y = x.to(self.dtype)
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                shard = getattr(m.weight, "tp_shard", None)
                y = tp.conv_input(y, sharded, shard)
                bias = m.bias.to(y.dtype)
                padding = 1
                if spatial.active():
                    y, padding = spatial.window(y, 3, 1, 1), (0, 1)
                y = F.conv2d(y, m.weight.to(y.dtype), None if shard == tp.ROW else bias,
                             padding=padding)
                if shard == tp.ROW:
                    y = tp.reduce(y) + bias[:, None, None]
                y = y.contiguous(memory_format=torch.channels_last)
                convs, sharded = convs + 1, shard == tp.COLUMN
            elif isinstance(m, nn.ReLU):
                y = torch.relu(y)
                if convs in _TAP_AFTER_CONV:
                    taps.append(tp.full(y, sharded))
            else:
                y = m(y).contiguous(memory_format=torch.channels_last)
        return taps


def load_vgg19_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision-format VGG19 state dict (.pth, or .npz with the same
    `features.N.weight/bias` keys), cut to the convs through relu5_1."""
    if path.endswith(".npz"):
        sd = {k: torch.from_numpy(np.asarray(v)) for k, v in np.load(path).items()}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    keep = set(VGG19Features().state_dict())
    missing = keep - set(sd)
    if missing:
        raise KeyError(f"{path}: not a VGG19 state dict, missing {sorted(missing)[:4]}")
    return {k: sd[k].float() for k in keep}
