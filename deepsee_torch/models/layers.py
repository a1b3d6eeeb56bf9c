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

Tensor parallelism (deepsee_torch/parallel/): a conv's `shard` is "column"
(this rank holds a block of its output channels and of its bias), "row" (a
block of its input channels; the bias whole, added once after the partial
outputs are summed) or None (replicated): the `tp_shard` that
parallel/shard.py's plan puts on its weight.  Layers take `sharded=True` where their input holds this rank's channel
block and say through `out_sharded` whether their output does; the
collectives in between are parallel/tensor.py's.

Spatial sharding (parallel/spatial.py): where maps are striped over the
model group, every conv takes its halo first (`spatial.window`: the
neighbours' rows, zeros at the global top and bottom only, or mirrored rows
for a reflection-padded conv) and convolves with padding 0 along H; a layer
that may see uneven stripes (the discriminator's) takes their layout as
`rows`.  A conv that quantizes under `int8_inference` takes its maxima over
every stripe (`int8_conv_striped`) and its halo as int8.  The batch norms'
statistics cover every rank, data x model, the instance norms' every stripe
of a sample, and the injected noise is drawn for the whole map and cut to
the stripe, as one process draws it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from deepsee_torch.config import parse_nonspade_norm
from deepsee_torch.models.remat import saving_conv_output
from deepsee_torch.ops.int8conv import int8_conv, int8_conv_sharded, int8_conv_striped
from deepsee_torch.ops.modnorm import (merge_partials, modnorm, modnorm_batch_partials_plain,
                                       modnorm_train)
from deepsee_torch.ops.norms import leaky_relu
from deepsee_torch.parallel import distributed, spatial
from deepsee_torch.parallel import tensor as tp

BN_MOMENTUM = 0.1

# -- int8 quantized inference (serving only) -----------------------------------
# The switch that `conv2d` reads at every forward (layers.py:36-78 of the JAX
# package): eval-mode convs with cin and cout both >= min_ch run the W8A8 op
# `int8_conv` (per-output-channel weight scales, a dynamic per-tensor
# activation scale, SmoothQuant unless smooth=False).  Training forwards never
# quantize, inside the context too.
_INT8_MODE = {"on": False, "min_ch": 64, "smooth": True}


@contextlib.contextmanager
def int8_inference(min_ch: int = 64, smooth: bool = True):
    """Run eval-mode convs with cin, cout >= min_ch as W8A8 int8 convs while
    the context is open.  smooth=False drops the SmoothQuant equalization.

    One-shot and process-global, as in the JAX package: the flag is read at
    forward time by every thread of the process (the evaluator's in-flight
    batches see it), so open it around a whole run, not around calls that
    other threads make at the same time.  PyTorch runs eagerly, so there is
    no traced function to clear on entry or exit; a program exported with
    `torch.export` inside the context keeps its int8 convs after it."""
    prev = dict(_INT8_MODE)
    _INT8_MODE.update(on=True, min_ch=min_ch, smooth=smooth)
    try:
        yield
    finally:
        _INT8_MODE.clear()
        _INT8_MODE.update(prev)


def int8_mode_active() -> bool:
    return _INT8_MODE["on"]


def quantizes(training: bool, cin: int, cout: int, shard=None) -> bool:
    """Whether a conv of cin -> cout channels runs int8 (layers.py:167-169).
    cin and cout are the weight's as this rank holds it: under a tensor
    parallel `shard` ("column": a block of the output channels; "row": of
    the input channels) the decision is the whole layer's, the same on
    every rank and in one process."""
    n = distributed.model_world() if shard is not None else 1
    if shard == tp.ROW:
        cin *= n
    elif shard == tp.COLUMN:
        cout *= n
    return (_INT8_MODE["on"] and not training and cin >= _INT8_MODE["min_ch"]
            and cout >= _INT8_MODE["min_ch"])


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


def _reflect_w(t: torch.Tensor, p: int) -> torch.Tensor:
    """t padded by p columns mirrored at each side of W (F.pad's "reflect"
    along W alone), in any dtype; channels_last."""
    w = t.shape[3]
    cols = list(range(p, 0, -1)) + list(range(w)) + list(range(w - 2, w - 2 - p, -1))
    out = t.index_select(3, torch.tensor(cols, device=t.device))
    return out.contiguous(memory_format=torch.channels_last)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int = 1, padding: int = 1, *, training: bool = True,
           rows: Optional[spatial.Rows] = None, shard=None,
           padding_mode: str = "zeros") -> torch.Tensor:
    """F.conv2d in x's dtype, with a channels_last result; `padding_mode`
    "reflect" pads x by mirroring (F.pad's "reflect") and convolves at 0.
    An eval-mode conv (training=False) that `quantizes` under
    `int8_inference` runs `int8_conv` instead: the float32 weight quantized,
    the result cast to x's dtype and then the bias added in that dtype, in
    the JAX package's order.  Where maps are striped, x is this rank's
    stripe (of layout `rows`, even where None) and the result its output
    stripe under the owner rule; a quantized conv there takes the whole
    map's scales (`int8_conv_striped`, its halo exchanged as int8).
    `shard` is the weight's tensor-parallel role (None: replicated); a
    quantized block takes the whole layer's scales (`int8_conv_sharded`).
    The two layouts exclude each other (MeshConfig.partition)."""
    if padding_mode not in spatial.EDGES:
        raise ValueError(f"padding_mode must be one of {spatial.EDGES}, got {padding_mode!r}")
    reflect = padding_mode == "reflect"
    quantized = quantizes(training, weight.shape[1], weight.shape[0], shard)
    pad = padding
    if spatial.active():
        k = weight.shape[2]

        def halo(t: torch.Tensor) -> torch.Tensor:
            slab = spatial.window(t, k, stride, padding, rows, edge=padding_mode)
            return _reflect_w(slab, padding) if reflect else slab

        pad = (0, 0 if reflect else padding)
        if quantized:
            return int8_conv_striped(x, weight, bias, stride, pad, _INT8_MODE["smooth"], halo,
                                     spatial.all_reduce_max)
        x = halo(x)
    else:
        if reflect:
            x, pad = F.pad(x, (padding,) * 4, mode="reflect"), 0
        if quantized and shard is not None and distributed.model_world() > 1:
            return int8_conv_sharded(x, weight, bias, stride, pad, _INT8_MODE["smooth"],
                                     shard, tp.all_reduce_max)
        if quantized:
            return int8_conv(x, weight, bias, stride, pad, _INT8_MODE["smooth"])
    y = F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=pad)
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


def _power_iteration(w_mat: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     mode) -> tuple:
    """One power iteration (v = W^T u / |.|, u = W v / |.|) of the full
    matrix W, of which this rank holds the rows (column shard) or the
    columns (row shard) `w_mat`; u and v full, equal on every rank."""
    if mode == tp.COLUMN:
        v = _l2_normalize(tp.all_reduce_values(w_mat.t() @ tp.local_slice(u, 0)))
        return _l2_normalize(tp.all_gather_values(w_mat @ v)), v
    if mode == tp.ROW:
        v = _l2_normalize(tp.all_gather_values(w_mat.t() @ u))
        return _l2_normalize(tp.all_reduce_values(w_mat @ tp.local_slice(v, 0))), v
    v = _l2_normalize(w_mat.t() @ u)
    return _l2_normalize(w_mat @ v), v


def _sigma(w_mat: torch.Tensor, u: torch.Tensor, v: torch.Tensor, mode) -> torch.Tensor:
    """u . W v of the full matrix from this rank's block of it: each rank's
    partial dot product summed (`reduce`), and the sum's gradient, which
    each rank takes through its own block of W only, summed back (`copy`)."""
    if mode is None:
        return torch.dot(u, w_mat @ v)
    if mode == tp.COLUMN:
        part = torch.dot(tp.local_slice(u, 0), w_mat @ v)
    else:
        part = torch.dot(u, w_mat @ tp.local_slice(v, 0))
    return tp.copy(tp.reduce(part))


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

    With `padding_mode` "reflect" the input is padded by mirroring, as the
    "nospade" generator's blocks pad it (`conv2d`).

    Under tensor parallelism sigma is the full matrix's: the power
    iteration and u . W v sum their partial products over the model group
    (`_power_iteration`, `_sigma`); weight_u and weight_v stay full and
    equal on every rank (v in torch's (in, kh, kw) flatten order, so a row
    shard's block of v is contiguous).
    """


    def __init__(self, fin: int, fout: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, bias: bool = True, spectral: bool = False,
                 padding_mode: str = "zeros"):
        super().__init__()
        self.stride, self.padding, self.spectral = stride, padding, spectral
        self.padding_mode = padding_mode
        self.kernel_size = kernel_size
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
                u, v = _power_iteration(w_mat, u, v, self.shard)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
            u, v = self.weight_u.clone(), self.weight_v.clone()
        return w / _sigma(w_mat, u, v, self.shard)

    @property
    def shard(self):
        """"column", "row" or None: the role parallel/shard.py gave the weight."""
        return getattr(self.weight_orig if self.spectral else self.weight, "tp_shard", None)

    @property
    def out_sharded(self) -> bool:
        return self.shard == tp.COLUMN

    def forward(self, x: torch.Tensor, sharded: bool = False,
                rows: Optional[spatial.Rows] = None) -> torch.Tensor:
        """x, channel-sharded where `sharded`; the output channel-sharded
        where `out_sharded`.  Where maps are striped, x is this rank's stripe
        of layout `rows` (even where None)."""
        x = tp.conv_input(x, sharded, self.shard)
        weight = self.effective_weight()
        row = self.shard == tp.ROW
        # the conv's output is what remat's "convs" policy saves (the JAX
        # package's checkpoint_name(y, "conv_out")); the power iteration is not
        with saving_conv_output():
            y = conv2d(x, weight, None if row else self.bias, self.stride, self.padding,
                       training=self.training, rows=rows, shard=self.shard,
                       padding_mode=self.padding_mode)
        if row:
            y = tp.reduce(y)
            if self.bias is not None:
                y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class GlobalMoments(torch.autograd.Function):
    """Per-channel mean and biased variance (float32) of x (B, C, H, W) over
    every rank's rows of `group` (the data group; the world where maps are
    striped), equal on every rank, and their count.

    Forward: each rank's (count, mean, centred M2) row in its slot of a
    zeroed [world, 3, C] tensor, an all-reduce (sum), and the rows merged in
    rank order by Chan's formula (`merge_partials`, as K1's split batch
    forward merges them).  Backward: the gradients of the mean and variance,
    which are per-channel sums over this rank's pixels of g and g * x_hat
    terms, all-reduced (sum) so that each holds every rank's loss; then
    d x = (g_mean + 2 g_var (x - mean)) / n, n the merged count (every
    rank's pixels; stripes may hold different counts).  Every rank must call
    it with the same shape, in the same order."""

    @staticmethod
    def forward(ctx, x, group=None):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        partials = x.new_zeros((world, 3, x.shape[1]), dtype=torch.float32)
        partials[rank] = modnorm_batch_partials_plain(x)
        dist.all_reduce(partials, group=group)
        n, mean, m2 = merge_partials(partials)
        ctx.save_for_backward(x, mean, n)
        ctx.group = group
        ctx.mark_non_differentiable(n)
        return mean, m2 / n, n

    @staticmethod
    def backward(ctx, g_mean, g_var, _g_n):
        x, mean, n = ctx.saved_tensors
        sums = torch.stack([torch.zeros_like(mean) if g is None else g
                            for g in (g_mean, g_var)])
        dist.all_reduce(sums, group=ctx.group)
        g_mean, g_var = sums[:, :, None, None]
        dx = (g_mean + 2 * g_var * (x.float() - mean[:, None, None])) / n[:, None, None]
        return dx.to(x.dtype), None


class TorchBatchNorm(nn.Module):
    """BatchNorm2d with torch's train/eval semantics (layers.py:214-263):
    eval normalizes with the running statistics; train with the batch's
    (biased variance, float32) and updates the running ones.  Plain PyTorch:
    only the encoder and discriminator norm strings "batch"/"sync_batch",
    which no preset uses, reach it.  Under a process group of more than one
    data rank both take the statistics of the global batch
    (`GlobalMoments`, over the data group, or the world where maps are
    striped), as the JAX package's do under jit over a sharded batch, and
    the running variance is unbiased over those ranks' pixels.  On a
    channel block (after a column conv) it uses its block of the running
    statistics and of the affine parameters (their gradients summed over
    the model group) and gathers the block's statistics into the full
    running ones.

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

    def forward(self, x: torch.Tensor, sharded: bool = False) -> torch.Tensor:
        block = (lambda t: tp.local_slice(t, 0)) if sharded else (lambda t: t)
        mean, var = block(self.running_mean), block(self.running_var)
        if self.training:
            check_training_forward(self)
            group, world = spatial.batch_group()
            count = world * x.shape[0] * x.shape[2] * x.shape[3]
            if world > 1:
                mean, var, n = GlobalMoments.apply(x, group)
                if spatial.active():  # the stripes' counts may differ
                    count = int(n[0])
            else:
                xf = x.float()
                mean = xf.mean((0, 2, 3))
                d = xf - mean[:, None, None]
                var = (d * d).mean((0, 2, 3))
            full = tp.all_gather_values(torch.stack([mean, var]), 1) if sharded else (mean, var)
            update_running_stats(self.running_mean, self.running_var, full[0], full[1], count)
        inv = torch.rsqrt(var + self.eps)
        scale, offset = inv, -mean * inv
        if self.affine:
            weight, bias = ((tp.local_param(self.weight), tp.local_param(self.bias)) if sharded
                            else (self.weight, self.bias))
            w = weight + 1.0
            scale, offset = scale * w, offset * w + bias
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

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator],
                sharded: bool = False) -> torch.Tensor:
        """On a channel block (`sharded`) the noise is drawn for every
        channel, as one process draws it, and this rank keeps its block; its
        block of the weight takes the gradient summed over the model group.
        On a stripe of the map (spatial sharding) the noise is drawn for the
        whole map and this rank keeps its stripe of H."""
        b, c, h, w = x.shape
        full_c = c * distributed.model_world() if sharded else c
        noise = spatial.full_rows_draw(lambda s: draw_injection_noise(s, generator, x.device),
                                       (b, h, w, full_c)).permute(0, 3, 1, 2)
        weight = self.weight
        if sharded:
            noise, weight = noise.narrow(1, distributed.model_rank() * c, c), tp.local_param(weight)
        y = x + weight.to(x.dtype)[:, None, None] * noise.to(x.dtype)
        return y.contiguous(memory_format=torch.channels_last)


class NonSpadeNormConv(nn.Module):
    """A conv followed by the encoder norm string's norm (layers.py:285-315).

    Children follow the reference's Sequential(conv, norm): the conv is "0"
    and a batch norm "1"; the conv has a bias only when no norm follows.
    The instance norm and the optional leaky ReLU after it run as one
    `modnorm` launch (`modnorm_train` in training).
    """

    def __init__(self, fin: int, fout: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, norm: str = "spectralinstance", padding_mode: str = "zeros"):
        super().__init__()
        spectral, self.sub = parse_nonspade_norm(norm)
        self.add_module("0", Conv2d(fin, fout, kernel_size, stride, padding,
                                    bias=self.sub == "none", spectral=spectral,
                                    padding_mode=padding_mode))
        if self.sub in ("batch", "sync_batch"):
            self.add_module("1", TorchBatchNorm(fout, affine=True))

    @property
    def out_sharded(self) -> bool:
        return self._modules["0"].out_sharded

    def forward(self, x: torch.Tensor, *, lrelu: bool = False, sharded: bool = False,
                rows: Optional[spatial.Rows] = None) -> torch.Tensor:
        """x channel-sharded where `sharded`; the norm and the leaky ReLU are
        per channel, so they run on the conv's output as it comes (this
        rank's channel block after a column conv).  Where maps are striped,
        x is this rank's stripe of layout `rows` (even where None) and the
        instance norm takes each sample's statistics over every stripe."""
        conv = self._modules["0"]
        y = conv(x, sharded=sharded, rows=rows)
        if self.sub == "instance":
            if spatial.active():
                rows = spatial.rows_of(x) if rows is None else rows
                out_rows = rows.window(conv.kernel_size, conv.stride, conv.padding)
                return spatial.instance_modnorm(y, lrelu=lrelu, rows=out_rows)[0]
            if self.training:
                return modnorm_train(y, stats="instance", lrelu=lrelu)[0]
            return modnorm(y, stats="instance", lrelu=lrelu)
        if self.sub != "none":
            y = self._modules["1"](y, sharded=self.out_sharded)
        return leaky_relu(y) if lrelu else y
