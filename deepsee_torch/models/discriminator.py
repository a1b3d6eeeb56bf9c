"""Multiscale PatchGAN discriminator, port of
deepsee_tpu/models/discriminator.py (reference: networks/discriminator.py).

num_d NLayer discriminators; each coarser scale sees the input avg-pooled
(3x3, stride 2, count_include_pad=False).  The input is the one-hot
semantics concatenated with the image (semantic_nc + output_nc channels).
Each NLayer discriminator returns all its activations, the logit last, for
the feature-matching loss.

The module tree follows the reference's nesting, so state_dict keys are the
reference's: `discriminator_<i>.model<n>` is Sequential(layer, LeakyReLU),
whose layer is the first or last raw conv (`model<n>.0.weight`) or a normed
conv Sequential(conv, norm) (`model<n>.0.0.weight_orig`, `model<n>.0.1.*`).
The normed layers' instance norm and leaky ReLU run as one `modnorm` launch
(`modnorm_train` in training).

Tensor parallelism (deepsee_tpu/parallel/mesh.py:160-161): odd model<N>
are column-sharded and even ones row-sharded where wide enough.  Each
layer's output comes as its conv leaves it, so the activations after a
column layer are this rank's channel block (`sharded_outputs` says which):
the feature-matching loss sums them per rank and over the model group.

Spatial sharding: each scale starts on this rank's even stripe of its input
and carries the stripes' layout (`spatial.Rows`) from layer to layer: a 4x4
window at padding 2 keeps the owner rule and makes the stripes uneven (256
-> 129 -> 65 -> 66 -> 67 rows at two ranks, the last rank holding the extra
ones), every conv takes as many halo rows as its window reads, the instance
norms take each sample's statistics over every stripe, and the pool between
scales divides by the valid taps at the global edges only.  `output_rows`
gives each output's layout for the losses' global means.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from deepsee_torch.config import ModelConfig
from deepsee_torch.models.layers import Conv2d, NonSpadeNormConv
from deepsee_torch.ops.norms import leaky_relu
from deepsee_torch.ops.pooling import avg_pool_3x3_s2
from deepsee_torch.parallel import spatial
from deepsee_torch.parallel import tensor as tp


class _Layer(nn.Module):
    """model<n>: a conv (raw, or conv + norm) at slot "0", then a leaky ReLU
    (none after the last conv)."""

    def __init__(self, layer: nn.Module, lrelu: bool):
        super().__init__()
        self.add_module("0", layer)
        self.lrelu = lrelu

    @property
    def out_sharded(self) -> bool:
        return self._modules["0"].out_sharded

    @property
    def conv(self) -> Conv2d:
        layer = self._modules["0"]
        return layer._modules["0"] if isinstance(layer, NonSpadeNormConv) else layer

    def forward(self, x: torch.Tensor, sharded: bool = False,
                rows: Optional[spatial.Rows] = None) -> torch.Tensor:
        layer = self._modules["0"]
        if isinstance(layer, NonSpadeNormConv):
            return layer(x, lrelu=self.lrelu, sharded=sharded, rows=rows)
        y = layer(x, sharded=sharded, rows=rows)
        return leaky_relu(y) if self.lrelu else y


class NLayerDiscriminator(nn.Module):
    """4-layer PatchGAN (discriminator.py:24-53): 4x4 convs with padding 2,
    stride 2 (stride 1 on the last hidden layer), ndf -> min(2x, 512)
    channels, norm_d on the hidden layers, not on the first and last."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dtype = getattr(torch, cfg.compute_dtype)
        nf = cfg.ndf
        self.add_module("model0", _Layer(Conv2d(cfg.semantic_nc + cfg.output_nc, nf, 4, 2, 2),
                                         lrelu=True))
        for n in range(1, cfg.n_layers_d):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == cfg.n_layers_d - 1 else 2
            self.add_module(f"model{n}", _Layer(
                NonSpadeNormConv(nf_prev, nf, 4, stride, 2, cfg.norm_d), lrelu=True))
        self.add_module(f"model{cfg.n_layers_d}", _Layer(Conv2d(nf, 1, 4, 1, 2), lrelu=False))

    def forward(self, x: torch.Tensor, rows: Optional[spatial.Rows] = None
                ) -> List[torch.Tensor]:
        """x, and where maps are striped this rank's stripe of layout `rows`
        (even where None)."""
        results = []
        y, sharded = x.to(self.dtype), False
        if spatial.active() and rows is None:
            rows = spatial.rows_of(x)
        for layer in self.children():
            y, sharded = layer(y, sharded=sharded, rows=rows), layer.out_sharded
            if rows is not None:
                conv = layer.conv
                rows = rows.window(conv.kernel_size, conv.stride, conv.padding)
            results.append(y)
        if sharded:  # the logit, every channel of it
            results[-1] = tp.gather(y)
        return results

    def sharded_outputs(self) -> List[bool]:
        """Per returned activation, whether it holds this rank's channel
        block (the logit never does)."""
        layers = list(self.children())
        return [layer.out_sharded for layer in layers[:-1]] + [False]


class MultiscaleDiscriminator(nn.Module):
    """num_d NLayer discriminators over progressively pooled inputs
    (discriminator.py:56-73).  Returns a list (per scale) of lists (per
    layer) of activations; the last of each inner list is the logit."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        for i in range(cfg.num_d):
            self.add_module(f"discriminator_{i}", NLayerDiscriminator(cfg))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        out = []
        rows = spatial.rows_of(x) if spatial.active() else None
        for i, d in enumerate(self.children()):
            if i:
                x = avg_pool_3x3_s2(x, rows)
                rows = None if rows is None else rows.window(3, 2, 1)
            out.append(d(x, rows))
        return out

    def output_rows(self, height: int) -> List[List[spatial.Rows]]:
        """The stripes' layout of each output (per scale, per layer) for an
        input of `height` rows in even stripes (maps striped only)."""
        layouts = []
        rows = spatial.Rows.even(height)
        for i, d in enumerate(self.children()):
            if i:
                rows = rows.window(3, 2, 1)
            scale, r = [], rows
            for layer in d.children():
                conv = layer.conv
                r = r.window(conv.kernel_size, conv.stride, conv.padding)
                scale.append(r)
            layouts.append(scale)
        return layouts

    def sharded_outputs(self) -> List[List[bool]]:
        return [d.sharded_outputs() for d in self.children()]
