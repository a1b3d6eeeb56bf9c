"""SRSystem, the model facade: port of deepsee_tpu/system.py (preprocess,
encode_style, generate, the eval-time style-noise coin of
generate_coin_jit, and for training the discriminator, the VGG features
and the train-mode forward).

The public functions keep the JAX package's NHWC layout: batch entries are
(B, H, W, C) arrays or tensors, and `generate` returns (B, H, W, 3).
Inside, tensors are NCHW in channels_last memory, so the NHWC <-> NCHW
moves at the boundary are views.

Weights live in the modules.  They are zeros until `init` (the port's own
seeded init) or `load_jax_variables` (the JAX package's trees) fills them.

The system runs on CUDA unless the caller passes device="cpu", where every
kernel is replaced by its plain version; without a card and without
device="cpu" it raises rather than fall back.

With exp.is_train the system also builds the multiscale discriminator and
(unless no_vgg_loss) the VGG19 features, and puts the generator, encoder
and discriminator in train mode (VGG stays in eval mode, frozen).  With
exp.train.remat the generator rematerializes its blocks in training
(exp.train.remat_policy; models/remat.py).  The
inference entry points (`preprocess`, `encode_style`, `generate`) run under
torch.inference_mode, whose tensors autograd cannot save; the training step
calls `train_preprocess`, `train_generate`, `discriminate` and
`vgg_features` instead, under torch.no_grad where no gradient is wanted.

Random draws (style noise, random_style_matrix, the coin) take an explicit
torch.Generator on the system's device; `no_noise=True` draws nothing.

Spatial sharding (`parallel.spatial.use_mesh` with a "spatial" MeshConfig,
every rank of the model group running the same calls): the batch holds this
rank's stripe of H of every image and label map (`spatial.shard_rows`), the
parameters are whole on every rank, and `preprocess` / `encode_style` /
`generate` compute this rank's stripes of what one process computes; the
style matrix is whole on every rank.  `spatial.gather_rows` puts the fakes
back together.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from deepsee_torch.config import Experiment
from deepsee_torch.data.device import tensor_to_device
from deepsee_torch.losses import DiscOut
from deepsee_torch.models.discriminator import MultiscaleDiscriminator
from deepsee_torch.models.encoder import build_encoder
from deepsee_torch.models.generator import DeepSEEGenerator
from deepsee_torch.models.vgg import VGG19Features
from deepsee_torch.ops.preprocess import downsample_image, one_hot_label
from deepsee_torch.parallel import spatial
from deepsee_torch.weights import jax_to_state_dict, vgg_jax_to_state_dict

Batch = Dict[str, torch.Tensor]


def draw_coin(generator: torch.Generator) -> bool:
    """The reference's host coin (sr_model.py:641-644): True (no style noise)
    with probability 1/2, one draw from `generator`."""
    if generator is None:
        raise ValueError("the style-noise coin needs an explicit torch.Generator")
    return bool(torch.rand((), generator=generator, device=generator.device) < 0.5)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) in channels_last memory."""
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class SRSystem:
    def __init__(self, exp: Experiment, device: Optional[str | torch.device] = None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SRSystem runs on CUDA and no CUDA device is "
                               "available; pass device='cpu' for the plain "
                               "CPU versions")
        self.exp = exp
        self.cfg = cfg = exp.model
        train = exp.is_train
        self.generator = DeepSEEGenerator(cfg, remat=exp.train.remat,
                                          remat_policy=exp.train.remat_policy
                                          ).to(self.device).train(train)
        self.encoder = (build_encoder(cfg).to(self.device).train(train)
                        if cfg.use_encoder else None)
        self.discriminator = (MultiscaleDiscriminator(cfg).to(self.device).train()
                              if train else None)
        self.vgg = None
        if train and not exp.train.no_vgg_loss:
            self.vgg = VGG19Features(getattr(torch, cfg.compute_dtype)).to(self.device).eval()
            self.vgg.requires_grad_(False)

    def networks(self) -> Dict[str, torch.nn.Module]:
        nets = {"g": self.generator}
        for name, net in (("e", self.encoder), ("d", self.discriminator), ("vgg", self.vgg)):
            if net is not None:
                nets[name] = net
        return nets

    # -- weights ----------------------------------------------------------

    def init(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: xavier-normal
        (gain 0.02) convs, zero biases, unit-normal spectral u/v, U[0, 1)
        SEAN blend weights, running stats 0/1, he-normal VGG convs.
        `generator` is a CPU torch.Generator; the values do not depend on
        the device."""
        for net in self.networks().values():
            for module in net.modules():
                if hasattr(module, "init_params"):
                    module.init_params(generator)

    def load_jax_variables(self, g_vars: Mapping, e_vars: Optional[Mapping] = None,
                           d_vars: Optional[Mapping] = None,
                           vgg_vars: Optional[Mapping] = None) -> None:
        """Load the JAX package's `{"params", "batch_stats", "spectral"}`
        trees (nested mappings of arrays) with strict key checking; a
        training system takes the discriminator's and the VGG's too."""
        self.generator.load_state_dict(jax_to_state_dict(g_vars), strict=True)
        trees = (("encoder", self.encoder, e_vars, jax_to_state_dict),
                 ("discriminator", self.discriminator, d_vars, jax_to_state_dict),
                 ("vgg", self.vgg, vgg_vars, vgg_jax_to_state_dict))
        for name, net, tree, convert in trees:
            if net is None:
                continue
            if tree is None:
                raise ValueError(f"this system has a {name}: pass its variables")
            net.load_state_dict(convert(tree), strict=True)

    # -- inference --------------------------------------------------------

    def to_device(self, value) -> torch.Tensor:
        """A numpy array or tensor as a tensor on the system's device (to a
        card from pinned memory, without blocking the host)."""
        return tensor_to_device(value, self.device)

    @torch.inference_mode()
    def preprocess(self, batch: Mapping) -> Batch:
        """One-hot the label maps (the guiding label too, unless it is one
        already) and synthesize the LR input from the HR image
        (data/preprocessor.py semantics), on the device."""
        return self._preprocess(batch)

    def train_preprocess(self, batch: Mapping) -> Batch:
        """`preprocess` for the training step: the same tensors, made under
        torch.no_grad instead of inference mode."""
        with torch.no_grad():
            return self._preprocess(batch)

    def _preprocess(self, batch: Mapping) -> Batch:
        cfg = self.cfg
        # the arrays; host lists such as the loader's "path" stay behind
        out = {k: self.to_device(v) for k, v in batch.items()
               if isinstance(v, (np.ndarray, torch.Tensor))}
        if "label" in out and "input_semantics" not in out:
            out["input_semantics"] = one_hot_label(out["label"], cfg.semantic_nc)
        if "guiding_label" in out and out["guiding_label"].dim() <= 3:
            out["guiding_label"] = one_hot_label(out["guiding_label"], cfg.semantic_nc)
        if "image_hr" in out and "image_lr" not in out:
            out["image_lr"] = downsample_image(
                out["image_hr"].float(), (spatial.local_height(cfg.start_size), cfg.start_size),
                method=cfg.downsampling_method)
        return out

    def encoder_inputs(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """The HR style source and its semantics: the guiding image and label
        when the model is guided and the batch has them, else the HR image;
        zeros stand in for a missing HR image (callers then use
        use_full=False)."""
        if self.cfg.guiding_style_image and "guiding_image" in batch:
            return batch["guiding_image"], batch["guiding_label"]
        sem = batch["input_semantics"]
        hr = batch.get("image_hr")
        if hr is None:
            hr = torch.zeros(sem.shape[:3] + (3,), dtype=batch["image_lr"].dtype,
                             device=sem.device)
        return hr, sem

    @torch.inference_mode()
    def encode_style(self, batch: Batch, *, use_full: bool, no_noise: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, label_nc, style_size) float32 style matrix.  The guided model's
        encoder ("fullstyle") always runs the full trunk on the HR source.
        `no_noise` is a host bool (a coin from `draw_coin` where the
        reference flips one); style noise draws from `generator`."""
        return self._encode_style(batch, use_full=use_full, no_noise=no_noise,
                                  generator=generator)

    def _encode_style(self, batch: Batch, *, use_full: bool, no_noise: bool,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        x_full, seg_full = self.encoder_inputs(batch)
        if self.cfg.net_e == "fullstyle":
            return self.encoder(_nchw(x_full), _nchw(seg_full), no_noise=no_noise,
                                generator=generator)
        return self.encoder(_nchw(x_full), _nchw(seg_full),
                            _nchw(batch["image_lr"]), _nchw(batch["input_semantics"]),
                            use_full, no_noise=no_noise, generator=generator)

    @torch.inference_mode()
    def generate(self, batch: Batch, *, style: Optional[torch.Tensor] = None,
                 use_full: bool = True, no_noise: bool = True,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Encode the style (unless given) and run the generator.
        Returns (fake (B, H, W, 3) float32 in [-1, 1], style)."""
        fake, style = self._generate(batch, style, use_full, no_noise, generator)
        return fake.permute(0, 2, 3, 1), style

    def train_generate(self, batch: Batch, *, use_full: bool, no_noise: bool,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """The training forward of the encoder and the generator: the fake
        (B, 3, H, W) float32 in channels_last memory.  Records the graph
        unless the caller runs it under torch.no_grad; updates the batch
        statistics and the spectral u/v either way.  The noise injection
        and the style noise draw from `generator`."""
        return self._generate(batch, None, use_full, no_noise, generator)[0]

    def _generate(self, batch: Batch, style: Optional[torch.Tensor], use_full: bool,
                  no_noise: bool, generator: Optional[torch.Generator]):
        if style is None and self.encoder is not None:
            style = self._encode_style(batch, use_full=use_full, no_noise=no_noise,
                                       generator=generator)
        fake = self.generator(_nchw(batch["image_lr"]), _nchw(batch["input_semantics"]),
                              style, generator=generator)
        return fake, style

    def discriminate(self, input_semantics: torch.Tensor, fake: torch.Tensor,
                     real: torch.Tensor) -> Tuple[DiscOut, DiscOut]:
        """Fake and real through D in one 2B batch, then split
        (system.py:218-232): input_semantics and real (B, H, W, C) as the
        batch holds them, fake (B, 3, H, W) as `train_generate` returns it."""
        sem = _nchw(input_semantics)
        both = torch.cat([torch.cat([sem, fake.to(sem.dtype)], 1),
                          torch.cat([sem, _nchw(real).to(sem.dtype)], 1)], 0)
        preds = self.discriminator(both.contiguous(memory_format=torch.channels_last))
        b = fake.shape[0]
        return ([[t[:b] for t in scale] for scale in preds],
                [[t[b:] for t in scale] for scale in preds])

    def vgg_features(self, x: torch.Tensor):
        """The five VGG19 taps of x (B, 3, H, W) in [-1, 1]."""
        return self.vgg(x)

    def generate_coin(self, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        """generate_coin_jit: the mini-trunk encode with the eval-time 50 %
        style-noise coin, one host draw per call, then the generator.
        Returns the fake (B, H, W, 3)."""
        no_noise = draw_coin(generator)
        fake, _ = self.generate(batch, use_full=False, no_noise=no_noise,
                                generator=generator)
        return fake
