"""Semantic modulation blocks SPADE, SEAN and PureSEAN, port of
deepsee_tpu/models/normalization.py.

Each block computes norm(x) * scale + offset, where scale/offset come from
ONE conv with 2C outputs (SPADE and SEAN fold the +1 of the scale into its
bias; PureSEAN has none), and the whole epilogue -- normalize, modulate and
the leaky ReLU that SPADEResnetBlock applies next -- is one `modnorm` kernel
launch that reads the conv output as it is (`modnorm_train` in training,
with batch statistics and a backward kernel).

Tensor parallelism: the modulation convs (mlp_gamma, mlp_beta and their
style twins) are column-sharded wherever the plan shards them (the JAX
package's _COLUMN, deepsee_tpu/parallel/mesh.py:154-155), so each rank
folds its own channel blocks into a local [gamma_l | beta_l] of 2C/n
channels, and K1 runs on the same block of x: a block input (the block's
x, replicated) is scattered to it, and the output stays on the block
(`out_sharded`).  The modulation conv's input, replicated, goes through
`copy`; so do SEAN's alphas, which scale the rank's blocks alone.
`mlp_shared` is replicated, except under norm_1, where the JAX plan makes
every wide-enough kernel column-sharded: there its output is gathered
before the modulation conv.

Spatial sharding (parallel/spatial.py): x, the segmap and the modulation are
this rank's stripes.  The modulation convs and mlp_shared take their halos
(models/layers.py::conv2d), `conv_on_nearest_up2` takes its halo at the
source resolution, the nearest resizes stay local to the stripes (the fm-cap
quirk's too), and K1's statistics span the stripes: the instance mode's each
sample's (spatial.instance_modnorm), the batch mode's the whole world's
(spatial.batch_modnorm).
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
from deepsee_torch.parallel import distributed, spatial
from deepsee_torch.parallel import tensor as tp

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
    weight (Cout, Cin, 3, 3) -> (Cin, Cout, 4, 4) for conv_transpose2d.
    Where maps are striped, `a` takes one halo row above and below (zeros at
    the global edges) and a padding of 3 along H crops the transposed conv's
    output to this rank's rows 2 lo .. 2 hi."""
    fold = _UP2_FOLD_FLIPPED.to(weight.device)
    w4 = torch.einsum("su,rv,oiuv->iosr", fold, fold, weight.float())
    padding = 1
    if spatial.active():
        a, padding = spatial.window(a, 3, 1, 1), (3, 1)
    y = F.conv_transpose2d(a, w4.to(a.dtype), bias.to(a.dtype), stride=2, padding=padding)
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

    @property
    def shard(self):
        """"column" or None: the role parallel/shard.py gave the weight."""
        return getattr(self.weight, "tp_shard", None)


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
    batch): the statistics come from every data rank's rows
    (`modnorm_train_sync` over the data group) and the running variance is
    unbiased over the data world's pixels; where maps are striped, the
    statistics and the count are the whole world's, data x model, and an
    instance norm's statistics span a sample's stripes.  With `sharded`, x
    and mod hold this rank's channel block: K1 runs on the block (its
    statistics are per channel), the eval mode takes the block of the
    running statistics, and training gathers the block's statistics over
    the model group into the full running ones, equal on every rank.
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
                lrelu: bool = False, sharded: bool = False) -> torch.Tensor:
        striped = spatial.active()
        if self.kind == "instance" and striped:
            if self.training:
                check_training_forward(self)
            return spatial.instance_modnorm(x, mod, eps=self.EPS, lrelu=lrelu)[0]
        if self.training:
            check_training_forward(self)
            stats = "instance" if self.kind == "instance" else "batch"
            world = distributed.data_world() if stats == "batch" else 1
            if striped:
                world = distributed.world_size()
                out, mean, rstd = spatial.batch_modnorm(x, mod, eps=self.EPS, lrelu=lrelu)
            elif world > 1:
                out, mean, rstd = modnorm_train_sync(x, mod, eps=self.EPS, lrelu=lrelu,
                                                     group=distributed.data_group())
            else:
                out, mean, rstd = modnorm_train(x, mod, stats=stats, eps=self.EPS, lrelu=lrelu)
            if stats == "batch":
                b, _, h, w = x.shape
                var = rstd.pow(-2) - self.EPS
                if sharded:
                    mean, var = tp.all_gather_values(torch.stack([mean, var]), 1)
                update_running_stats(self.running_mean, self.running_var, mean, var,
                                     world * b * h * w)
            return out
        if self.kind == "instance":
            return modnorm(x, mod, stats="instance", lrelu=lrelu)
        block = (lambda t: tp.local_slice(t, 0)) if sharded else (lambda t: t)
        return modnorm(x, mod, stats="affine", mean=block(self.running_mean),
                       var=block(self.running_var), eps=self.EPS, lrelu=lrelu)


def _mlp_shared(cfg: ModelConfig) -> nn.Sequential:
    ks = cfg.norm_g_spec.kernel_size
    return nn.Sequential(Conv2d(cfg.semantic_nc, _NHIDDEN, ks, padding=ks // 2),
                         nn.ReLU())


class _Modulated(nn.Module):
    """What the three blocks share under tensor parallelism: the shard of
    their modulation convs (`mod_shard`, from the gamma conv; its twins
    have the same output width, so the plan gives them the same spec) and
    the norm applied on the modulation's channels."""

    def _mod_params(self) -> "ConvParams":
        return self.mlp_gamma if hasattr(self, "mlp_gamma") else self.mlp_style_gamma

    @property
    def mod_shard(self):
        return self._mod_params().shard

    @property
    def out_sharded(self) -> bool:
        return self.mod_shard == tp.COLUMN

    def _shared_actv(self, seg: torch.Tensor) -> torch.Tensor:
        """mlp_shared's output, every channel of it."""
        conv = self.mlp_shared[0]
        return tp.full(self.mlp_shared(seg), conv.out_sharded)

    def _normalize(self, x: torch.Tensor, sharded: bool, mod: torch.Tensor,
                   lrelu: bool) -> torch.Tensor:
        """The param-free norm of x (channel-sharded where `sharded`) with
        `mod`, on the modulation's channels."""
        on_block = self.out_sharded
        if on_block and not sharded:
            x = tp.scatter(x)
        elif sharded and not on_block:
            x = tp.gather(x)
        return self.param_free_norm(x, mod, lrelu=lrelu, sharded=on_block)


class SPADE(_Modulated):
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
                lrelu: bool = False, sharded: bool = False) -> torch.Tensor:
        seg = resize2d(segmap, x.shape[-2:], method="nearest")
        actv = self._shared_actv(seg.to(x.dtype))
        weight = torch.cat([self.mlp_gamma.weight, self.mlp_beta.weight])
        bias = torch.cat([self.mlp_gamma.bias + 1.0, self.mlp_beta.bias])
        mod = conv2d(tp.conv_input(actv, False, self.mod_shard), weight, bias,
                     padding=self.ks // 2, training=self.training, shard=self.mod_shard)
        return self._normalize(x, sharded, mod, lrelu)


class _SEANCore(_Modulated):
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
        # the caps compare the whole map's size (every stripe's rows)
        x_hw = (spatial.global_height(x_hw[0]), x_hw[1])
        fm_hw = (min(x_hw[0], cfg.max_fm_size), min(x_hw[1], cfg.max_fm_size))
        seg = resize2d(segmap, (spatial.local_height(fm_hw[0]), fm_hw[1]), method="nearest")
        actv = self._shared_actv(seg.to(dtype))
        style_map = style_to_pixels(seg, style).to(dtype)
        if fm_hw == x_hw:
            return actv, style_map, False
        up2 = (cfg.fold_upsampled_mod_conv and self.ks == 3
               and x_hw == (2 * fm_hw[0], 2 * fm_hw[1]))
        local_hw = (spatial.local_height(x_hw[0]), x_hw[1])
        if not up2:
            actv = resize2d(actv, local_hw, method="nearest")
        if cfg.replicate_fm_resize_quirk:
            # the reference assigns interpolate(actv) to the style map too
            # (normalization.py:188-190); released checkpoints rely on it
            style_map = actv
        elif not up2:
            style_map = resize2d(style_map, local_hw, method="nearest")
        return actv, style_map, up2

    def _mod_conv(self, inp: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  up2: bool) -> torch.Tensor:
        if up2:
            if not quantizes(self.training, weight.shape[1], weight.shape[0], self.mod_shard):
                return conv_on_nearest_up2(inp, weight, bias)
            # the int8 conv has no fold: the literal upsample, then the conv
            # (normalization.py:130-137)
            inp = resize2d(inp, (2 * inp.shape[2], 2 * inp.shape[3]), method="nearest")
        return conv2d(inp, weight, bias, padding=self.ks // 2, training=self.training,
                      shard=self.mod_shard)


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
                *, lrelu: bool = False, sharded: bool = False) -> torch.Tensor:
        actv, style_map, up2 = self._maps(x.shape[-2:], segmap, style, x.dtype)
        alphas = torch.cat([self.alpha_gamma, self.alpha_beta])
        if self.out_sharded:  # each rank's gradient reaches them through its blocks alone
            alphas = tp.copy(alphas)
        wg, wb = torch.sigmoid(alphas).unbind()
        g, b = self.mlp_gamma, self.mlp_beta
        gs, bs = self.mlp_style_gamma, self.mlp_style_beta
        weight = torch.cat([
            torch.cat([(1.0 - wg) * g.weight, wg * gs.weight], dim=1),
            torch.cat([(1.0 - wb) * b.weight, wb * bs.weight], dim=1)])
        bias = torch.cat([(1.0 - wg) * g.bias + wg * gs.bias + 1.0,
                          (1.0 - wb) * b.bias + wb * bs.bias])
        inp = torch.cat([actv, style_map], dim=1).contiguous(
            memory_format=torch.channels_last)
        mod = self._mod_conv(tp.conv_input(inp, False, self.mod_shard), weight, bias, up2)
        return self._normalize(x, sharded, mod, lrelu)


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
                *, lrelu: bool = False, sharded: bool = False) -> torch.Tensor:
        _, style_map, up2 = self._maps(x.shape[-2:], segmap, style, x.dtype)
        gs, bs = self.mlp_style_gamma, self.mlp_style_beta
        mod = self._mod_conv(tp.conv_input(style_map, False, self.mod_shard),
                             torch.cat([gs.weight, bs.weight]),
                             torch.cat([gs.bias, bs.bias]), up2)
        return self._normalize(x, sharded, mod, lrelu)
