"""Typed configuration for deepsee_torch.

An own copy of the parts of `deepsee_tpu/config.py` that the ported modules
read: the norm-string parsers, the model hyper-parameters (the
discriminator's included), the training hyper-parameters, the experiment
bundle with its explorative-inference knobs, the device-mesh layout, and
the presets.  Field names and defaults are those of the JAX package, so one
preset name gives the same model in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

__all__ = ["NormGSpec", "parse_nonspade_norm", "ModelConfig", "TrainConfig", "DataConfig",
           "MeshConfig", "Experiment", "get_preset", "tiny_test_experiment"]


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
    aspect_ratio: float = 1.0       # the "fixed" preprocess mode's width / height

    label_nc: int = 19
    contain_dontcare_label: bool = False
    output_nc: int = 3
    ngf: int = 32
    nef: int = 32
    ndf: int = 32
    regional_style_size: int = 128

    norm_g: str = "spectrallateseansyncbatch3x3"
    norm_d: str = "spectralinstance"
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

    # discriminator: scales, and layers per scale
    num_d: int = 2
    n_layers_d: int = 4

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

    @property
    def model_variant(self) -> str:
        return "guided" if "full" in self.net_e else "independent"


@dataclass(frozen=True)
class TrainConfig:
    """Optimization hyper-parameters (deepsee_tpu/config.py:184-254)."""

    batch_size: int = 4
    lr: float = 2e-4
    beta1: float = 0.0
    beta2: float = 0.9
    no_ttur: bool = False             # TTUR: G at lr/2, D at 2 lr
    d_steps_per_g: int = 1
    niter: int = 50
    niter_decay: int = 25
    lambda_feat: float = 10.0
    lambda_vgg: float = 10.0
    no_ganfeat_loss: bool = False
    no_vgg_loss: bool = False
    gan_mode: str = "hinge"
    gradient_clip: float = -1.0       # clip-by-value before Adam; -1 = off
    remat: bool = False               # per-block rematerialization of G (models/remat.py)
    # "full" recomputes each block whole in its backward; "convs" saves the
    # Conv2d outputs and recomputes the rest (norms, K1, activations, noise,
    # the folded modulation convs)
    remat_policy: str = "full"
    # train D on the G step's fake instead of regenerating it with the
    # updated G (an opt-in deviation from the reference's schedule)
    reuse_fake: bool = False
    vgg_weights: str = ""             # torchvision-format VGG19 .pth or .npz
    # the in-training evaluation's networks: pt_inception-2015-12-05 (FID)
    # and torchvision AlexNet (LPIPS) .pth files; random weights without
    inception_weights: str = ""
    alexnet_weights: str = ""

    display_freq: int = 20000
    print_freq: int = 1000
    save_latest_freq: int = 3000
    save_epoch_freq: int = 1
    evaluation_freq: int = 100000
    evaluation_start_epoch: int = 0
    num_evaluation_samples: int = 1000
    evaluate_val_set: bool = False    # also evaluate the *_val dirs at each evaluation

    seed: int = 0

    def g_lr(self) -> float:
        return self.lr if self.no_ttur else self.lr / 2

    def d_lr(self) -> float:
        return self.lr if self.no_ttur else self.lr * 2

    def epoch_lr_scale(self, epoch: int) -> float:
        """Linear decay to zero over niter_decay epochs after niter epochs."""
        if epoch <= self.niter:
            return 1.0
        total = self.niter + self.niter_decay
        return max(0.0, (total - epoch) / max(1, self.niter_decay))


@dataclass(frozen=True)
class DataConfig:
    """Dataset and host-side transform configuration
    (deepsee_tpu/config.py:262-289)."""

    dataset: str = "celebamaskhq"   # celeba | celebamaskhq | synthetic
    image_dir: str = ""
    label_dir: str = ""
    image_dir_val: str = ""
    label_dir_val: str = ""
    identities_file: str = ""       # CelebAMask-HQ CSV or CelebA identity_CelebA.txt
    preprocess_mode: str = "resize_and_crop"
    center_crop_size: Optional[int] = None     # 178 for CelebA
    no_flip: bool = False
    serial_batches: bool = False
    max_dataset_size: Optional[int] = None
    no_pairing_check: bool = False
    cache_filelist_read: bool = False   # the files.list cache of list_images
    cache_filelist_write: bool = False
    phase: str = "train"
    # the native host codec (data/codec.py): "auto" uses it where it builds
    # and the preprocess mode is in its bit-exact envelope, Pillow otherwise;
    # "on" requires it; "off" decodes with Pillow
    native_codec: str = "auto"
    # approximate JPEG fast path: DCT-scaled decode near the target size
    # (not bit-exact with Pillow)
    native_scaled_decode: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """The device-mesh layout (deepsee_tpu/config.py:296-328) over
    processes (deepsee_torch/parallel/): "data" and "dcn" both count
    data-parallel ranks, data_axis * dcn_axis of them; "model" counts the
    tensor-parallel ranks of each data index, which hold column/row shards
    of the wide convs (parallel/shard.py), or with partition "spatial"
    horizontal stripes of every map (parallel/spatial.py)."""

    data_axis: int = 1
    model_axis: int = 1
    partition: str = "tensor"     # how the model axis is used: "tensor" | "spatial"
    dcn_axis: int = 1

    @property
    def n_devices(self) -> int:
        return self.dcn_axis * self.data_axis * self.model_axis

    @property
    def spatial(self) -> bool:
        return self.partition == "spatial"

    def check_ported(self, model: Optional["ModelConfig"] = None) -> None:
        """Raise ValueError, naming the constraint, unless the port runs this
        layout: data and tensor parallelism, and spatial sharding whose model
        axis stripes every map of `model` evenly (parallel/spatial.py::
        check_layout; unchecked without a model)."""
        if self.partition not in ("tensor", "spatial"):
            raise ValueError(f"unknown partition {self.partition!r}")
        if self.spatial and model is not None:
            from deepsee_torch.parallel.spatial import check_layout

            check_layout(model, self)


@dataclass(frozen=True)
class Experiment:
    name: str = "8x_independent_128x128"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoints_dir: str = "./checkpoints"
    is_train: bool = True

    # explorative-inference knobs (deepsee_tpu/config.py:346-351)
    region_idx: Optional[Tuple[int, ...]] = None
    n_interpolation: int = 5
    noise_delta: float = 0.0
    noise_dist: str = "normal"
    manipulate_scale: float = 1.0

    def replace(self, **kw: Any) -> "Experiment":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)


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
    """Named presets of deepsee_tpu/config.py:394-421."""
    m, d = ModelConfig(), DataConfig()
    if "128x128" in name and "8x_" in name:
        m = dataclasses.replace(m, start_size=16, crop_size=128, load_size=128,
                                add_noise=True)
        # CelebA: a 178-px face crop before the resize (labels use plain
        # "resize", data/datasets.py)
        d = dataclasses.replace(d, dataset="celeba", preprocess_mode="center_crop_and_resize",
                                center_crop_size=178)
    elif "256x256" in name and "8x_" in name:
        m = dataclasses.replace(m, start_size=32, crop_size=256, load_size=256,
                                add_noise=True, max_fm_size=256)
    elif "32x_" in name:
        m = dataclasses.replace(m, start_size=16, crop_size=512, load_size=512,
                                add_noise=False, max_fm_size=256)
    else:
        raise ValueError(f"Invalid preset name: {name!r}")
    exp = _apply_variant(Experiment(name=name, model=m, data=d), name)
    return exp.replace(**overrides) if overrides else exp


def tiny_test_experiment(**overrides: Any) -> Experiment:
    """The JAX package's tiny test configuration (config.py:425-434)."""
    exp = Experiment(
        name="tiny_test",
        model=ModelConfig(start_size=8, crop_size=32, load_size=32,
                          ngf=4, nef=4, ndf=4, regional_style_size=16,
                          max_fm_size=32, add_noise=True,
                          compute_dtype="float32"),
        train=TrainConfig(batch_size=2, num_evaluation_samples=4),
    )
    return exp.replace(**overrides) if overrides else exp
