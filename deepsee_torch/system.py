"""SRSystem, the model facade: port of the inference subset of
deepsee_tpu/system.py (preprocess, encode_style, generate, and the
eval-time style-noise coin of generate_coin_jit).

The public functions keep the JAX package's NHWC layout: batch entries are
(B, H, W, C) arrays or tensors, and `generate` returns (B, H, W, 3).
Inside, tensors are NCHW in channels_last memory, so the NHWC <-> NCHW
moves at the boundary are views.

Weights live in the modules.  They are zeros until `init` (the port's own
seeded init) or `load_jax_variables` (the JAX package's trees) fills them.

The system runs on CUDA unless the caller passes device="cpu", where every
kernel is replaced by its plain version; without a card and without
device="cpu" it raises rather than fall back.

Random draws (style noise, random_style_matrix, the coin) take an explicit
torch.Generator on the system's device; `no_noise=True` draws nothing.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from deepsee_torch.config import Experiment
from deepsee_torch.models.encoder import build_encoder
from deepsee_torch.models.generator import DeepSEEGenerator
from deepsee_torch.ops.preprocess import downsample_image, one_hot_label
from deepsee_torch.weights import jax_to_state_dict

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
        if exp.is_train:
            raise NotImplementedError("training is not ported yet; pass "
                                      "exp.replace(is_train=False)")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SRSystem runs on CUDA and no CUDA device is "
                               "available; pass device='cpu' for the plain "
                               "CPU versions")
        self.exp = exp
        self.cfg = cfg = exp.model
        self.generator = DeepSEEGenerator(cfg).to(self.device).eval()
        self.encoder = (build_encoder(cfg).to(self.device).eval()
                        if cfg.use_encoder else None)

    def networks(self) -> Dict[str, torch.nn.Module]:
        nets = {"g": self.generator}
        if self.encoder is not None:
            nets["e"] = self.encoder
        return nets

    # -- weights ----------------------------------------------------------

    def init(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: xavier-normal
        (gain 0.02) convs, zero biases, unit-normal spectral u/v, U[0, 1)
        SEAN blend weights, running stats 0/1.  `generator` is a CPU
        torch.Generator; the values do not depend on the device."""
        for net in self.networks().values():
            for module in net.modules():
                if hasattr(module, "init_params"):
                    module.init_params(generator)

    def load_jax_variables(self, g_vars: Mapping, e_vars: Optional[Mapping] = None) -> None:
        """Load the JAX package's `{"params", "batch_stats", "spectral"}`
        trees (nested mappings of arrays) with strict key checking."""
        self.generator.load_state_dict(jax_to_state_dict(g_vars), strict=True)
        if self.encoder is not None:
            if e_vars is None:
                raise ValueError("this system has an encoder: pass e_vars")
            self.encoder.load_state_dict(jax_to_state_dict(e_vars), strict=True)

    # -- inference --------------------------------------------------------

    def to_device(self, value) -> torch.Tensor:
        """A numpy array or tensor as a tensor on the system's device."""
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        return value.to(self.device)

    @torch.inference_mode()
    def preprocess(self, batch: Mapping) -> Batch:
        """One-hot the label maps (the guiding label too, unless it is one
        already) and synthesize the LR input from the HR image
        (data/preprocessor.py semantics), on the device."""
        cfg = self.cfg
        out = {k: self.to_device(v) for k, v in batch.items()}
        if "label" in out and "input_semantics" not in out:
            out["input_semantics"] = one_hot_label(out["label"], cfg.semantic_nc)
        if "guiding_label" in out and out["guiding_label"].dim() <= 3:
            out["guiding_label"] = one_hot_label(out["guiding_label"], cfg.semantic_nc)
        if "image_hr" in out and "image_lr" not in out:
            out["image_lr"] = downsample_image(
                out["image_hr"].float(), (cfg.start_size, cfg.start_size),
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
        if style is None and self.encoder is not None:
            style = self.encode_style(batch, use_full=use_full, no_noise=no_noise,
                                      generator=generator)
        fake = self.generator(_nchw(batch["image_lr"]),
                              _nchw(batch["input_semantics"]), style)
        return fake.permute(0, 2, 3, 1), style

    def generate_coin(self, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        """generate_coin_jit: the mini-trunk encode with the eval-time 50 %
        style-noise coin, one host draw per call, then the generator.
        Returns the fake (B, H, W, 3)."""
        no_noise = draw_coin(generator)
        fake, _ = self.generate(batch, use_full=False, no_noise=no_noise,
                                generator=generator)
        return fake
