"""Weights and inputs made from the run's seed, on the run's device.

Weights: every tensor that `reference.nets.param_spec` lists, drawn from
two draws over all of them at once (one normal, one uniform) by a
torch.Generator on the device, then scaled per tensor by its role:

  conv weights (4-D)        N(0, 1) / sqrt(fan_in)  (He, gain 1)
  spectral u, v             the weight's top singular vectors, from 30 power
                            iterations started at N(0, 1) draws (as a trained
                            model's converged u, v)
  biases, noise weights     N(0, 0.05)
  running means             N(0, 0.1)
  running variances         U(0.5, 1.5)
  SEAN blend weights        U(0, 1)
  style-noise weights       N(0, 1)

so that the modulations, the biases and the running statistics all carry
values that a wrong index or a dropped term would change.  Inputs: label
maps that are piecewise regions (a seeded Voronoi of the 19 labels), and
images that are a colour per region plus noise, through tanh.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

Spec = Mapping[str, Tuple[int, ...]]


def _role(name: str, shape: Tuple[int, ...]) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("weight_u", "weight_v"):
        return "unit"
    if leaf == "running_mean":
        return "mean"
    if leaf == "running_var":
        return "var"
    if leaf in ("alpha_gamma", "alpha_beta"):
        return "blend"
    if leaf == "noise_weights":
        return "normal"
    if len(shape) == 4:
        return "conv"
    return "small"


def make_weights(spec: Mapping[str, Spec], seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{network: {name: float32 tensor}} from `seed`, on `device`."""
    names = [(net, name, tuple(shape)) for net in sorted(spec)
             for name, shape in sorted(spec[net].items())]
    total = sum(math.prod(shape) for _, _, shape in names)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {net: {} for net in spec}
    at = 0
    for net, name, shape in names:
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        role = _role(name, shape)
        if role == "conv":
            t = z / math.sqrt(math.prod(shape[1:]))
        elif role == "unit":
            t = z / z.norm()
        elif role == "mean":
            t = 0.1 * z
        elif role == "var":
            t = 0.5 + u
        elif role == "blend":
            t = u
        elif role == "normal":
            t = z
        else:
            t = 0.05 * z
        out[net][name] = t.clone()
    for nets in out.values():
        for name in [n for n in nets if n.endswith(".weight_orig")]:
            _converge(nets[name], nets[name[:-5] + "_u"], nets[name[:-5] + "_v"])
    return out


def _converge(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor, steps: int = 30) -> None:
    """u, v in place: power iterations of the (out, in * kh * kw) matrix."""
    m = w.reshape(w.shape[0], -1)
    for _ in range(steps):
        v.copy_(m.t() @ u)
        v.div_(v.norm())
        u.copy_(m @ v)
        u.div_(u.norm())


def _regions(b: int, size: int, labels: int, points: int, gen: torch.Generator,
             device) -> torch.Tensor:
    """(b, size, size) int32: each pixel takes the label of its nearest of
    `points` seeded sites (a Voronoi map), every label drawn uniformly."""
    sites = torch.rand(b, points, 2, generator=gen, device=device) * size
    site_labels = torch.randint(0, labels, (b, points), generator=gen, device=device)
    ax = torch.arange(size, device=device, dtype=torch.float32) + 0.5
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    d = ((yy.reshape(1, -1, 1) - sites[:, None, :, 0]) ** 2
         + (xx.reshape(1, -1, 1) - sites[:, None, :, 1]) ** 2)
    nearest = d.argmin(dim=2)
    return torch.gather(site_labels, 1, nearest).view(b, size, size).to(torch.int32)


def _image(label: torch.Tensor, labels: int, gen: torch.Generator) -> torch.Tensor:
    """(b, H, W, 3) float32 in (-1, 1): a colour per region and sample plus
    pixel noise, through tanh."""
    b = label.shape[0]
    colours = torch.randn(b, labels, 3, generator=gen, device=label.device)
    base = torch.gather(colours, 1, label.reshape(b, -1, 1).long().expand(-1, -1, 3))
    noise = torch.randn(base.shape, generator=gen, device=label.device)
    return torch.tanh(base + 0.3 * noise).view(*label.shape, 3)


def make_batch(b: int, size: int, labels: int, guided: bool, gen: torch.Generator,
               points: int = 24) -> Dict[str, torch.Tensor]:
    """One batch in the port's public layout: image_hr (b, H, W, 3), label
    (b, H, W) int32, and for a guided model a guiding image and label map
    of their own."""
    device = gen.device
    out = {}
    keys = (("image_hr", "label"),) + ((("guiding_image", "guiding_label"),) if guided else ())
    for image_key, label_key in keys:
        label = _regions(b, size, labels, points, gen, device)
        out[label_key] = label
        out[image_key] = _image(label, labels, gen)
    return out
