"""Explorative inference toolbox: port of deepsee_tpu/inference/modes.py.

The reference exposes these as modes of SRModel.forward (sr_model.py:64-446);
here each is a function over (system, preprocessed batch[, torch.Generator]).
They are all data-space manipulations of the (B, 19, S) style matrix around
one generator call:

  inference_noise                  random style variants        (:116-129)
  inference_multi_modal            per-region random perturbation (:130-167)
  inference_replace_semantics      relabel region 10 -> 12       (:168-197)
  inference_reference_semantics    swap semantic maps in batch   (:198-218)
  inference_interpolation          +/- delta walk on style rows  (:219-261)
  inference_interpolation_style    lerp between two styles       (:262-297)
  inference_particular_combined    mini-encoder styles (+noise)  (:298-346)
  inference_particular_full        HR-encoder styles             (:347-380)
  inference_reference              cross-batch style transplant  (:381-410)
  inference_reference_interpolation lerp toward scaled reference (:411-444)
  baseline_upscale                 bicubic baseline              (:109-115)
  encode_only / generate_with_style                              (:92-108)

As in the JAX package, every mode builds its whole style stack with
batched tensor ops and makes ONE generator call over a (B*n)-batch
(`generate_with_styles`) instead of the reference's n eager calls; the
reference's fixes (`inference_replace_semantics`) are kept.  Batches are
`SRSystem.preprocess` output (NHWC tensors, or numpy arrays, which move to
the system's device); outputs are NHWC tensors on that device.  Random
draws come from the caller's torch.Generator on the system's device.

Region symmetry: CONSISTENT_REGIONS (left eye/brow/ear, upper lip) are tied
to their partner region when perturbing (sr_model.py:134,153).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from deepsee_torch.ops.resize import resize2d
from deepsee_torch.regions import CONSISTENT_REGIONS
from deepsee_torch.system import SRSystem

# batch keys the generator / encoder consume (everything else stays put)
_GEN_KEYS = ("image_lr", "input_semantics")
_ENC_KEYS = _GEN_KEYS + ("image_hr", "guiding_image", "guiding_label")

Batch = Dict[str, torch.Tensor]


def _region_indices(system: SRSystem, region_idx) -> torch.Tensor:
    if region_idx is None:
        region_idx = system.exp.region_idx
    if region_idx is None:
        region_idx = range(system.cfg.semantic_nc)
    return torch.tensor(list(region_idx), dtype=torch.long, device=system.device)


def _tensors(system: SRSystem, batch, keys=_ENC_KEYS) -> Batch:
    # duck-typed: numpy arrays must not be dropped silently (a missing
    # image_hr would send the encoder to its zeros-HR stand-in)
    return {k: system.to_device(v) for k, v in batch.items()
            if k in keys and hasattr(v, "shape")}


def get_noise(generator: torch.Generator, shape, delta: float,
              dist: str = "normal") -> torch.Tensor:
    """sr_model.py:448-457: clamp(draw, -1, 1) * delta."""
    if dist == "normal":
        draw = torch.randn(shape, generator=generator, device=generator.device)
    elif dist == "uniform":
        draw = torch.rand(shape, generator=generator, device=generator.device)
    else:
        raise ValueError(f"Invalid noise distribution: {dist}")
    return torch.clamp(draw, -1, 1) * delta


def corrupt_style(generator: torch.Generator, style: torch.Tensor, eps: float = 0.05,
                  dist: str = "gaussian") -> torch.Tensor:
    """sr_model.py:459-467: additive style corruption with variance eps."""
    scale = eps ** 0.5
    if dist == "gaussian":
        return torch.randn(style.shape, generator=generator,
                           device=generator.device) * scale + style
    if dist == "uniform":
        draw = torch.rand(style.shape, generator=generator, device=generator.device)
        return (draw * 2 - 1) * scale * 1.4 + style
    raise ValueError(dist)


def _tie_consistent(style: torch.Tensor) -> torch.Tensor:
    """style[..., r, :] = style[..., r+1, :] for the symmetric regions."""
    idx = torch.tensor(CONSISTENT_REGIONS, dtype=torch.long, device=style.device)
    out = style.clone()
    out[..., idx, :] = style[..., idx + 1, :]
    return out


def _with_rows(style: torch.Tensor, n: int, ridx: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """(B, nc, S) style -> (B, n, nc, S) copies whose `ridx` rows are `rows`."""
    b, nc, s = style.shape
    styles = style[:, None].expand(b, n, nc, s).clone()
    styles[:, :, ridx] = rows.expand(b, n, len(ridx), s)
    return styles


@torch.inference_mode()
def encode_only(system: SRSystem, batch, *,
                encode_full: Optional[bool] = None) -> torch.Tensor:
    """sr_model.py:92-99: the style matrix alone; no noise."""
    if encode_full is None:
        encode_full = system.cfg.full_style_image
    return system.encode_style(_tensors(system, batch), use_full=encode_full,
                               no_noise=True)


@torch.inference_mode()
def generate_with_style(system: SRSystem, batch, style: torch.Tensor) -> torch.Tensor:
    """'demo' mode (sr_model.py:100-108): the generator alone on a given style."""
    style = system.to_device(style)
    fake, _ = system.generate(_tensors(system, batch, _GEN_KEYS), style=style)
    return fake


@torch.inference_mode()
def generate_with_styles(system: SRSystem, batch, styles: torch.Tensor) -> torch.Tensor:
    """styles (B, n, 19, S) -> fakes (B, n, H, W, 3) in ONE generator call.

    The (B, n) grid flattens to a (B*n)-batch: inputs repeat n-consecutive
    (repeat_interleave), so flat index i*n+j is (sample i, style j),
    matching the row-major styles reshape."""
    b, n = styles.shape[:2]
    rep = {k: torch.repeat_interleave(v, n, dim=0)
           for k, v in _tensors(system, batch, _GEN_KEYS).items()}
    flat = styles.reshape((b * n,) + tuple(styles.shape[2:]))
    fake, _ = system.generate(rep, style=flat)
    return fake.reshape((b, n) + tuple(fake.shape[1:]))


@torch.inference_mode()
def baseline_upscale(system: SRSystem, batch) -> torch.Tensor:
    """Bicubic baseline (sr_model.py:109-115)."""
    cfg = system.cfg
    lr = system.to_device(batch["image_lr"]).permute(0, 3, 1, 2)
    up = resize2d(lr, (cfg.crop_size, cfg.crop_size), method="bicubic")
    return torch.clamp(up, -1.0, 1.0).permute(0, 2, 3, 1)


@torch.inference_mode()
def inference_noise(system: SRSystem, batch, generator: torch.Generator,
                    n: Optional[int] = None) -> torch.Tensor:
    """sr_model.py:116-129: n random-style variants per input.

    Returns (B, n, H, W, 3).  The reference's eval-time encode takes the
    mini path with a 50% style-noise coin per call (sr_model.py:641-644).
    One call over the (B*n)-batch; encoder noise differs per variant
    because each repeat draws its own noise."""
    arrays = _tensors(system, batch)
    b = arrays["image_lr"].shape[0]
    n = n or b
    rep = {k: torch.repeat_interleave(v, n, dim=0) for k, v in arrays.items()}
    fake = system.generate_coin(rep, generator)
    return fake.reshape((b, n) + tuple(fake.shape[1:]))


@torch.inference_mode()
def inference_multi_modal(system: SRSystem, batch, generator: torch.Generator,
                          n: Optional[int] = None,
                          region_idx: Optional[Sequence[int]] = None,
                          delta: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sr_model.py:130-167: n per-region random perturbations of the encoded
    style, symmetric regions tied.  Returns (fakes (B,n,H,W,3), styles)."""
    exp = system.exp
    n = n or exp.n_interpolation
    delta = exp.noise_delta if delta is None else delta
    ridx = _region_indices(system, region_idx)

    style = encode_only(system, batch)
    b, _, s = style.shape
    noise = get_noise(generator, (b, n, len(ridx), s), delta, exp.noise_dist)
    styles = _with_rows(style, n, ridx,
                        torch.clamp(style[:, None, ridx] + noise, -1.0, 1.0))
    styles = _tie_consistent(styles)
    return generate_with_styles(system, batch, styles), styles


@torch.inference_mode()
def inference_replace_semantics(system: SRSystem, batch,
                                regions_replace: Sequence[int] = (10,),
                                new_region_idx: int = 12
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sr_model.py:168-197 (fixed, as in the JAX package -- the reference's
    version calls an undefined method): generate, relabel regions,
    regenerate.  Both passes run as ONE 2B-batch call."""
    label = system.to_device(batch["label"])
    relabeled = label
    for rp in regions_replace:
        relabeled = torch.where(relabeled == rp, new_region_idx, relabeled)

    big = {k: torch.cat([v, v], dim=0)
           for k, v in _tensors(system, batch).items() if k != "input_semantics"}
    big["label"] = torch.cat([label, relabeled], dim=0)
    big = system.preprocess(big)
    fake, _ = system.generate(_tensors(system, big),
                              use_full=system.cfg.full_style_image)
    b = label.shape[0]
    return fake[:b], fake[b:]


@torch.inference_mode()
def inference_reference_semantics(system: SRSystem, batch) -> torch.Tensor:
    """sr_model.py:198-218: each output uses another sample's semantics.
    Returns (B, B, H, W, 3), the full (image i, semantics j) grid, in one
    B*B-batch call."""
    arrays = _tensors(system, batch)
    sem = arrays.pop("input_semantics")
    b = sem.shape[0]
    rep = {k: torch.repeat_interleave(v, b, dim=0) for k, v in arrays.items()}
    rep["input_semantics"] = sem.repeat((b,) + (1,) * (sem.dim() - 1))
    fake, _ = system.generate(rep, use_full=system.cfg.full_style_image)
    return fake.reshape((b, b) + tuple(fake.shape[1:]))


@torch.inference_mode()
def inference_interpolation(system: SRSystem, batch,
                            style: Optional[torch.Tensor] = None,
                            n: Optional[int] = None,
                            delta: Optional[float] = None,
                            region_idx: Optional[Sequence[int]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sr_model.py:219-261: walk style rows by linspace(-delta, +delta)."""
    exp = system.exp
    n = n or exp.n_interpolation
    if n % 2 != 1:
        raise ValueError("n must be odd so the middle image has delta=0 "
                         "(sr_model.py:228)")
    delta = exp.noise_delta if delta is None else delta
    ridx = _region_indices(system, region_idx)

    style = encode_only(system, batch) if style is None else system.to_device(style)
    steps = torch.linspace(-delta, delta, n, device=style.device)
    styles = _with_rows(style, n, ridx, torch.clamp(
        style[:, None, ridx] + steps[None, :, None, None], -1.0, 1.0))
    return generate_with_styles(system, batch, styles), styles


@torch.inference_mode()
def inference_interpolation_style(system: SRSystem, batch,
                                  style_from: torch.Tensor, style_to: torch.Tensor,
                                  n: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sr_model.py:262-297: lerp between two style matrices."""
    n = n or system.exp.n_interpolation
    if n % 2 != 1:
        raise ValueError("n must be odd (sr_model.py:228)")
    style_from, style_to = system.to_device(style_from), system.to_device(style_to)
    ts = torch.linspace(0.0, 1.0, n, device=style_from.device)[None, :, None, None]
    styles = (1.0 - ts) * style_from[:, None] + ts * style_to[:, None]
    return generate_with_styles(system, batch, styles), styles


@torch.inference_mode()
def inference_particular_combined(system: SRSystem, batch, generator: torch.Generator,
                                  region_idx: Optional[Sequence[int]] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sr_model.py:298-346: mini-encoded style, optionally noise-perturbed
    on selected regions with symmetric regions tied."""
    exp = system.exp
    style = system.encode_style(_tensors(system, batch), use_full=False, no_noise=True)
    if exp.noise_delta > 0:
        ridx = _region_indices(system, region_idx)
        noise = get_noise(generator, (style.shape[0], len(ridx), style.shape[-1]),
                          exp.noise_delta, exp.noise_dist)
        style = style.clone()
        style[:, ridx] = torch.clamp(style[:, ridx] + noise, -1.0, 1.0)
        style = _tie_consistent(style)
    return generate_with_style(system, batch, style), style


@torch.inference_mode()
def inference_particular_full(system: SRSystem, batch) -> Dict[str, torch.Tensor]:
    """sr_model.py:347-380: HR-encoded style; plus the guiding-image variant
    when configured.  Returns a dict of images."""
    out = {}
    arrays = _tensors(system, batch)
    # "original" = style from the GT HR image: without the guiding keys the
    # encoder picks image_hr, not the guiding image
    base = {k: v for k, v in arrays.items()
            if k not in ("guiding_image", "guiding_label")}
    style_full = system.encode_style(base, use_full=True, no_noise=True)
    out["fake_image_original"] = generate_with_style(system, batch, style_full)
    if system.cfg.guiding_style_image and "guiding_image" in batch:
        out["fake_image_guiding"] = generate_with_style(
            system, batch, system.encode_style(arrays, use_full=True, no_noise=True))
    return out


@torch.inference_mode()
def inference_reference(system: SRSystem, batch,
                        region_idx: Optional[Sequence[int]] = None) -> torch.Tensor:
    """sr_model.py:381-410: for each sample, splice every other sample's
    style rows (selected regions) into its style.  Returns (B,B,H,W,3):
    grid[i, j] = recipient i with donor j's rows, in one call."""
    ridx = _region_indices(system, region_idx)
    style_full = system.encode_style(_tensors(system, batch), use_full=True,
                                     no_noise=True)
    b = style_full.shape[0]
    donors = torch.clamp(style_full[:, ridx], -1.0, 1.0)       # (B_donor, R, S)
    styles = _with_rows(style_full, b, ridx, donors[None])
    return generate_with_styles(system, batch, styles)


@torch.inference_mode()
def inference_reference_interpolation(system: SRSystem, batch,
                                      n: Optional[int] = None,
                                      region_idx: Optional[Sequence[int]] = None,
                                      manipulate_scale: Optional[float] = None
                                      ) -> torch.Tensor:
    """sr_model.py:411-444: lerp each sample's style toward the next
    sample's (scaled) style.  Returns (B, n, H, W, 3)."""
    exp = system.exp
    n = n or exp.n_interpolation
    scale = exp.manipulate_scale if manipulate_scale is None else manipulate_scale
    ridx = _region_indices(system, region_idx)

    style_full = system.encode_style(_tensors(system, batch), use_full=True,
                                     no_noise=True)
    target = torch.roll(style_full, shifts=-1, dims=0) * scale
    ts = torch.linspace(0.0, 1.0, n, device=style_full.device)[None, :, None, None]
    walk = torch.clamp((1.0 - ts) * style_full[:, None, ridx]
                       + ts * target[:, None, ridx], -1.0, 1.0)
    styles = _with_rows(style_full, n, ridx, walk)
    return generate_with_styles(system, batch, styles)
