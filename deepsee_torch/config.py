"""Typed configuration for deepsee_torch.

An own copy of the parts of `deepsee_tpu/config.py` that the ported modules
read: the norm-string parsers, the model hyper-parameters, the experiment
bundle with its explorative-inference knobs, and the presets.  Field names
and defaults are those of the JAX package, so one preset name gives the
same model in both packages.  Fields of slices not yet ported (training,
data, mesh, discriminator) are absent.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

__all__ = ["NormGSpec", "parse_nonspade_norm", "ModelConfig", "Experiment",
           "get_preset", "tiny_test_experiment"]


@dataclass(frozen=True)
class NormGSpec:
    """Structured form of the generator norm string, e.g.
    "spectrallateseansyncbatch3x3" (deepsee_tpu/config.py:27-62)."""

    spectral: bool = True       # "spectral": spectral-norm the resblock convs
    late: bool = True           # "late": the head block uses plain SPADE
    sean: bool = True           # "sean": SEAN for styled blocks, else SPADE
    param_free: str = "syncbatch"  # instance | syncbatch | batch
    kernel_size: int = 3

    @staticmethod
    def parse(config_text: str) -> "NormGSpec":
        spectral = config_text.startswith("spectral")
        rest = config_text[len("spectral"):] if spectral else config_text
        late = rest.startswith("late")
        m = re.search(r"(?:late)?(?:sean|spade)(\D+)(\d)x\d", rest)
        if m is None:
            raise ValueError(f"Unparseable norm_G config: {config_text!r}")
        return NormGSpec(spectral=spectral, late=late, sean="sean" in rest,
                         param_free=str(m.group(1)),
                         kernel_size=int(m.group(2)))

    @property
    def param_free_kind(self) -> str:
        if "instance" in self.param_free:
            return "instance"
        if "syncbatch" in self.param_free:
            return "syncbatch"
        if "batch" in self.param_free:
            return "batch"
        raise ValueError(f"Unknown param-free norm: {self.param_free}")


def parse_nonspade_norm(norm_type: str) -> Tuple[bool, str]:
    """Encoder norm string ("spectralinstance", ...) -> (spectral, subnorm)."""
    spectral = norm_type.startswith("spectral")
    sub = norm_type[len("spectral"):] if spectral else norm_type
    if sub not in ("", "none", "batch", "sync_batch", "instance"):
        raise ValueError(f"Unrecognized norm type: {norm_type!r}")
    return spectral, (sub or "none")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (deepsee_tpu/config.py:83-177)."""

    start_size: int = 16
    crop_size: int = 128
    load_size: int = 128

    label_nc: int = 19
    contain_dontcare_label: bool = False
    ngf: int = 32
    nef: int = 32
    regional_style_size: int = 128

    norm_g: str = "spectrallateseansyncbatch3x3"
    norm_e: str = "spectralinstance"

    # encoder variant: "combinedstyle" (independent) | "fullstyle" (guided)
    net_e: str = "combinedstyle"
    guiding_style_image: bool = False   # guided: style from a guiding image
    full_style_image: bool = False      # explorative modes: encode the HR image
    random_style_matrix: bool = False

    # SEAN feature-map cap and the reference's fm-resize quirk
    max_fm_size: int = 256
    replicate_fm_resize_quirk: bool = True
    fold_upsampled_mod_conv: bool = False

    add_noise: bool = False
    noisy_style_scale: float = 0.2
    noisy_style_dist: str = "uniform"

    downsampling_method: str = "bicubic"

    # activation dtype; parameters and norm statistics stay float32
    compute_dtype: str = "bfloat16"

    @property
    def semantic_nc(self) -> int:
        return self.label_nc + (1 if self.contain_dontcare_label else 0)

    @property
    def n_blocks(self) -> int:
        return int(math.log2(self.crop_size) - math.log2(self.start_size))

    @property
    def norm_g_spec(self) -> NormGSpec:
        return NormGSpec.parse(self.norm_g)

    @property
    def use_encoder(self) -> bool:
        return bool(self.net_e) and self.net_e != "none"


@dataclass(frozen=True)
class Experiment:
    name: str = "8x_independent_128x128"
    model: ModelConfig = field(default_factory=ModelConfig)
    is_train: bool = True

    # explorative-inference knobs (deepsee_tpu/config.py:346-351)
    region_idx: Optional[Tuple[int, ...]] = None
    n_interpolation: int = 5
    noise_delta: float = 0.0
    noise_dist: str = "normal"
    manipulate_scale: float = 1.0

    def replace(self, **kw: Any) -> "Experiment":
        return dataclasses.replace(self, **kw)


def _apply_variant(exp: Experiment, name: str) -> Experiment:
    if "independent" in name:
        return exp.replace(model=dataclasses.replace(
            exp.model, net_e="combinedstyle", noisy_style_scale=0.2))
    if "guided" in name:
        return exp.replace(model=dataclasses.replace(
            exp.model, net_e="fullstyle", noisy_style_scale=0.05,
            guiding_style_image=True))
    raise ValueError(f"Preset name must contain 'independent' or 'guided': {name}")


def get_preset(name: str, **overrides: Any) -> Experiment:
    """Named presets of deepsee_tpu/config.py:394-421 (model fields only)."""
    m = ModelConfig()
    if "128x128" in name and "8x_" in name:
        m = dataclasses.replace(m, start_size=16, crop_size=128, load_size=128,
                                add_noise=True)
    elif "256x256" in name and "8x_" in name:
        m = dataclasses.replace(m, start_size=32, crop_size=256, load_size=256,
                                add_noise=True, max_fm_size=256)
    elif "32x_" in name:
        m = dataclasses.replace(m, start_size=16, crop_size=512, load_size=512,
                                add_noise=False, max_fm_size=256)
    else:
        raise ValueError(f"Invalid preset name: {name!r}")
    exp = _apply_variant(Experiment(name=name, model=m), name)
    return exp.replace(**overrides) if overrides else exp


def tiny_test_experiment(**overrides: Any) -> Experiment:
    """The JAX package's tiny test configuration (config.py:425-434)."""
    exp = Experiment(
        name="tiny_test",
        model=ModelConfig(start_size=8, crop_size=32, load_size=32,
                          ngf=4, nef=4, regional_style_size=16,
                          max_fm_size=32, add_noise=True,
                          compute_dtype="float32"),
    )
    return exp.replace(**overrides) if overrides else exp
