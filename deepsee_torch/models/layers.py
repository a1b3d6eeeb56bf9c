"""Foundational layers, port of deepsee_tpu/models/layers.py.

Conventions of the port: activations are NCHW tensors held in channels_last
memory; conv weights are OIHW float32 parameters, cast to the activation's
dtype at the call; parameter and buffer names follow the reference torch
modules, so `state_dict()` keys are the layout `export_torch_state` writes.

Parameters are created as zeros; `init_params(generator)` gives each module
the JAX package's initializers from an explicit torch.Generator (see
deepsee_torch/system.py::SRSystem.init).  In training mode (`.train()`)
spectral convs run one power iteration per forward and batch norms use and
update batch statistics, as torch and the JAX package do on any train-mode
forward, under torch.no_grad too; a training forward refuses to run under
torch.inference_mode, whose tensors autograd cannot save.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepsee_torch.config import parse_nonspade_norm
from deepsee_torch.ops.modnorm import modnorm, modnorm_train
from deepsee_torch.ops.norms import leaky_relu
from deepsee_torch.parallel import distributed

BN_MOMENTUM = 0.1


def check_training_forward(module: nn.Module) -> None:
    """Raise where a train-mode forward runs under torch.inference_mode."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError(f"{type(module).__name__}: a training-mode forward cannot run "
                           "under torch.inference_mode; use torch.no_grad")


def update_running_stats(running_mean: torch.Tensor, running_var: torch.Tensor,
                         mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
    """torch's running-stat update: momentum 0.1, the unbiased variance of
    the n values per channel."""
    with torch.no_grad():
        m = BN_MOMENTUM
        running_mean.copy_((1 - m) * running_mean + m * mean)
        running_var.copy_((1 - m) * running_var + m * (var * (n / max(1, n - 1))))


def draw_injection_noise(shape, generator: Optional[torch.Generator],
                         device: torch.device) -> torch.Tensor:
    """The noise injection's one random draw: N(0, 1) float32 of the NHWC
    `shape` (the JAX package's layout), from `generator` on `device`.

    Under a process group each rank draws the global batch's noise and keeps
    its own rows (`distributed.rank_rows`), so a step over W ranks injects
    the noise one process injects into the same global batch.  It costs each
    rank W times the draw: W times the random numbers generated, and a
    transient buffer W times the injection's activation, freed at once."""
    if generator is None:
        raise ValueError("noise injection needs an explicit torch.Generator")
    return distributed.rank_rows(
        lambda s: torch.randn(s, generator=generator, device=device), shape)


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


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (v.norm() + eps)


def _unit_normal(n: int, generator: torch.Generator) -> torch.Tensor:
    return _l2_normalize(torch.randn(n, generator=generator))


class Conv2d(nn.Module):
    """Conv2d with optional spectral normalization (layers.py:136-211).

    With `spectral`, the weight is `weight_orig` and the buffers `weight_u`
    (out,) and `weight_v` (in*kh*kw, torch's flatten order), as
    torch.nn.utils.spectral_norm stores them; the forward divides by
    sigma = u . W v.  In training, one power iteration on the detached W
    first updates u and v in place; sigma then uses clones of them, as
    torch.nn.utils.spectral_norm does, so the next forward's update does
    not touch tensors autograd saved, and the gradient flows through W only.
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
        w = self.weight_orig
        w_mat = w.reshape(w.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if self.training:
            check_training_forward(self)
            with torch.no_grad():
                v = _l2_normalize(w_mat.t() @ u)
                u = _l2_normalize(w_mat @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
            u, v = self.weight_u.clone(), self.weight_v.clone()
        sigma = torch.dot(u, w_mat @ v)
        return w / sigma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.effective_weight(), self.bias, self.stride, self.padding)


class TorchBatchNorm(nn.Module):
    """BatchNorm2d with torch's train/eval semantics (layers.py:214-263):
    eval normalizes with the running statistics; train with the batch's
    (biased variance, float32) and updates the running ones.  Plain PyTorch:
    only the encoder and discriminator norm strings "batch"/"sync_batch",
    which no preset uses, reach it.

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
        mean, var = self.running_mean, self.running_var
        if self.training:
            check_training_forward(self)
            if distributed.world_size() > 1:
                raise NotImplementedError(
                    "a train-mode encoder or discriminator batch norm (norm_e / norm_d "
                    "'batch' or 'sync_batch') over several ranks belongs to the cross-rank "
                    "encoder and discriminator batch-norm slice of the port, which "
                    "deepsee_torch does not have yet; one process trains it")
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            d = xf - mean[:, None, None]
            var = (d * d).mean((0, 2, 3))
            update_running_stats(self.running_mean, self.running_var, mean, var,
                                 x.shape[0] * x.shape[2] * x.shape[3])
        inv = torch.rsqrt(var + self.eps)
        scale, offset = inv, -mean * inv
        if self.affine:
            w = self.weight + 1.0
            scale, offset = scale * w, offset * w + self.bias
        return (x * scale.to(x.dtype)[:, None, None]
                + offset.to(x.dtype)[:, None, None])


class NoiseInjection(nn.Module):
    """x + w_c * N(0, 1), the per-channel StyleGAN2 noise (layers.py:266-282).

    Only training with add_noise calls it; inference carries the weight so
    checkpoints map one to one.  The noise is drawn in the JAX package's
    NHWC layout by `draw_injection_noise` from the caller's generator.
    """

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.weight)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        b, c, h, w = x.shape
        noise = draw_injection_noise((b, h, w, c), generator, x.device).permute(0, 3, 1, 2)
        y = x + self.weight.to(x.dtype)[:, None, None] * noise.to(x.dtype)
        return y.contiguous(memory_format=torch.channels_last)


class NonSpadeNormConv(nn.Module):
    """A conv followed by the encoder norm string's norm (layers.py:285-315).

    Children follow the reference's Sequential(conv, norm): the conv is "0"
    and a batch norm "1"; the conv has a bias only when no norm follows.
    The instance norm and the optional leaky ReLU after it run as one
    `modnorm` launch (`modnorm_train` in training).
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
            if self.training:
                return modnorm_train(y, stats="instance", lrelu=lrelu)[0]
            return modnorm(y, stats="instance", lrelu=lrelu)
        if self.sub != "none":
            y = self._modules["1"](y)
        return leaky_relu(y) if lrelu else y
