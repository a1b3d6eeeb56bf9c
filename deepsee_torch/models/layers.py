"""Foundational layers, port of deepsee_tpu/models/layers.py (eval mode).

Conventions of the port: activations are NCHW tensors held in channels_last
memory; conv weights are OIHW float32 parameters, cast to the activation's
dtype at the call; parameter and buffer names follow the reference torch
modules, so `state_dict()` keys are the layout `export_torch_state` writes.

Parameters are created as zeros; `init_params(generator)` gives each module
the JAX package's initializers from an explicit torch.Generator (see
deepsee_torch/system.py::SRSystem.init).  Training mode (spectral power
iteration, batch statistics) belongs to the training slice and raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepsee_torch.config import parse_nonspade_norm
from deepsee_torch.ops.modnorm import modnorm
from deepsee_torch.ops.norms import leaky_relu


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int = 1, padding: int = 1) -> torch.Tensor:
    """F.conv2d in x's dtype, with a channels_last result."""
    y = F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=padding)
    return y.contiguous(memory_format=torch.channels_last)


def xavier_normal_(w: torch.Tensor, generator: torch.Generator,
                   gain: float = 0.02) -> None:
    """torch.nn.init.xavier_normal_ for an OIHW weight (reference gain 0.02)."""
    cout, cin, kh, kw = w.shape
    std = gain * math.sqrt(2.0 / ((cin + cout) * kh * kw))
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator) * std)


def _unit_normal(n: int, generator: torch.Generator) -> torch.Tensor:
    v = torch.randn(n, generator=generator)
    return v / (v.norm() + 1e-12)


class Conv2d(nn.Module):
    """Conv2d with optional spectral normalization (layers.py:136-211).

    With `spectral`, the weight is `weight_orig` and the buffers `weight_u`
    (out,) and `weight_v` (in*kh*kw, torch's flatten order), as
    torch.nn.utils.spectral_norm stores them; the eval forward divides by
    sigma = u . W v with the stored vectors.
    """

    def __init__(self, fin: int, fout: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, bias: bool = True, spectral: bool = False):
        super().__init__()
        self.stride, self.padding, self.spectral = stride, padding, spectral
        w = nn.Parameter(torch.zeros(fout, fin, kernel_size, kernel_size))
        if spectral:
            self.weight_orig = w
            self.register_buffer("weight_u", torch.zeros(fout))
            self.register_buffer("weight_v", torch.zeros(fin * kernel_size ** 2))
        else:
            self.weight = w
        self.bias = nn.Parameter(torch.zeros(fout)) if bias else None

    def init_params(self, generator: torch.Generator) -> None:
        xavier_normal_(self.weight_orig if self.spectral else self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        if self.spectral:
            self.weight_u.copy_(_unit_normal(self.weight_u.numel(), generator))
            self.weight_v.copy_(_unit_normal(self.weight_v.numel(), generator))

    def effective_weight(self) -> torch.Tensor:
        if not self.spectral:
            return self.weight
        if self.training:
            raise NotImplementedError("spectral-norm power iteration (training) "
                                      "is not ported yet; call .eval()")
        w = self.weight_orig
        sigma = torch.dot(self.weight_u, w.reshape(w.shape[0], -1) @ self.weight_v)
        return w / sigma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.effective_weight(), self.bias, self.stride, self.padding)


class TorchBatchNorm(nn.Module):
    """Eval-mode BatchNorm2d from running statistics (layers.py:214-263).

    With `affine`, `weight` holds the JAX package's `scale` parameter: the
    multiplier applied is weight + 1 (its init N(0, 0.02) mirrors torch's
    N(1, 0.02)).
    """

    def __init__(self, features: int, affine: bool = False, eps: float = 1e-5):
        super().__init__()
        self.affine, self.eps = affine, eps
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        if affine:
            self.weight = nn.Parameter(torch.zeros(features))
            self.bias = nn.Parameter(torch.zeros(features))

    def init_params(self, generator: torch.Generator) -> None:
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        if self.affine:
            with torch.no_grad():
                self.weight.copy_(torch.randn(self.weight.shape, generator=generator) * 0.02)
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("train-mode batch norm is not ported yet; "
                                      "call .eval()")
        inv = torch.rsqrt(self.running_var + self.eps)
        scale, offset = inv, -self.running_mean * inv
        if self.affine:
            w = self.weight + 1.0
            scale, offset = scale * w, offset * w + self.bias
        return (x * scale.to(x.dtype)[:, None, None]
                + offset.to(x.dtype)[:, None, None])


class NoiseInjection(nn.Module):
    """Per-channel StyleGAN2 noise weight (layers.py:266-282).

    Only training with add_noise injects noise; inference carries the weight
    so checkpoints map one to one.
    """

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.weight)


class NonSpadeNormConv(nn.Module):
    """A conv followed by the encoder norm string's norm (layers.py:285-315).

    Children follow the reference's Sequential(conv, norm): the conv is "0"
    and a batch norm "1"; the conv has a bias only when no norm follows.
    The instance norm and the optional leaky ReLU after it run as one
    `modnorm` launch.
    """

    def __init__(self, fin: int, fout: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, norm: str = "spectralinstance"):
        super().__init__()
        spectral, self.sub = parse_nonspade_norm(norm)
        self.add_module("0", Conv2d(fin, fout, kernel_size, stride, padding,
                                    bias=self.sub == "none", spectral=spectral))
        if self.sub in ("batch", "sync_batch"):
            self.add_module("1", TorchBatchNorm(fout, affine=True))

    def forward(self, x: torch.Tensor, *, lrelu: bool = False) -> torch.Tensor:
        y = self._modules["0"](x)
        if self.sub == "instance":
            return modnorm(y, stats="instance", lrelu=lrelu)
        if self.sub != "none":
            y = self._modules["1"](y)
        return leaky_relu(y) if lrelu else y
