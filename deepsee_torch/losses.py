"""GAN, feature-matching and perceptual losses, port of deepsee_tpu/losses.py
(reference: networks/loss.py, sr_model.py:518-564).

Discriminator outputs are list[scale] of list[layer] tensors with the logit
last (the MultiscaleDiscriminator contract).  Loss arithmetic is float32;
the real side of the feature-matching and VGG losses is detached.

Spatial sharding: every mean over a striped map is this rank's sum, summed
over the model group, over the whole map's count (`spatial.mean`; `rows`
the discriminator's output layouts, `MultiscaleDiscriminator.output_rows`),
so each rank's loss is the whole loss and its gradient reaches each rank's
own rows.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from deepsee_torch.parallel import distributed, spatial
from deepsee_torch.parallel import tensor as tp

DiscOut = List[List[torch.Tensor]]
Layouts = Optional[List[List[spatial.Rows]]]


def _logit_loss(logit: torch.Tensor, target_is_real: bool, for_discriminator: bool,
                mode: str, rows: Optional[spatial.Rows] = None) -> torch.Tensor:
    """One scale's loss on its final logit (loss.py:60-85)."""
    x = logit.float()
    if mode == "hinge":
        if for_discriminator:
            hinge = torch.relu(1.0 - x) if target_is_real else torch.relu(1.0 + x)
            return spatial.mean(hinge, rows)
        if not target_is_real:
            raise ValueError("the generator's hinge loss aims for real")
        return -spatial.mean(x, rows)
    if mode == "ls":
        return spatial.mean(torch.square(x - (1.0 if target_is_real else 0.0)), rows)
    if mode == "original":
        target = 1.0 if target_is_real else 0.0
        return spatial.mean(torch.clamp(x, min=0) - x * target
                            + torch.log1p(torch.exp(-x.abs())), rows)
    if mode == "w":
        return -spatial.mean(x, rows) if target_is_real else spatial.mean(x, rows)
    raise ValueError(f"Unexpected gan_mode {mode}")


def gan_loss(pred: DiscOut, target_is_real: bool, *, mode: str = "hinge",
             for_discriminator: bool = True, rows: Layouts = None) -> torch.Tensor:
    """Multiscale GAN loss: each scale's loss on its logit, summed, / num_D.
    `rows`: the outputs' stripes where maps are striped."""
    per_scale = [_logit_loss(scale[-1], target_is_real, for_discriminator, mode,
                             None if rows is None else rows[s][-1])
                 for s, scale in enumerate(pred)]
    return torch.stack(per_scale).sum() / len(pred)


def feature_matching_loss(pred_fake: DiscOut, pred_real: DiscOut,
                          lambda_feat: float = 10.0,
                          sharded: Optional[List[List[bool]]] = None,
                          rows: Layouts = None) -> torch.Tensor:
    """L1 between fake and detached real D features, every layer but the
    logit, each * lambda / num_D (sr_model.py:529-539).  `sharded` (the
    discriminator's `sharded_outputs`) marks the features that hold this
    rank's channel block under tensor parallelism: their mean is this
    rank's sum, summed over the model group, over every channel's count."""
    num_d = len(pred_fake)
    total = torch.zeros((), device=pred_fake[0][0].device)
    for s, (fake_scale, real_scale) in enumerate(zip(pred_fake, pred_real)):
        for i, (f, r) in enumerate(zip(fake_scale[:-1], real_scale[:-1])):
            diff = (f.float() - r.detach().float()).abs()
            if sharded is not None and sharded[s][i]:
                l1 = tp.reduce(diff.sum()) / (diff.numel() * distributed.model_world())
            else:
                l1 = spatial.mean(diff, None if rows is None else rows[s][i])
            total = total + l1 * (lambda_feat / num_d)
    return total


_VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)  # loss.py:112


def vgg_loss(feats_x: Sequence[torch.Tensor], feats_y: Sequence[torch.Tensor],
             lambda_vgg: float = 10.0) -> torch.Tensor:
    """Weighted L1 over the five VGG19 taps, y detached (loss.py:114-119)."""
    total = torch.zeros((), device=feats_x[0].device)
    for w, fx, fy in zip(_VGG_WEIGHTS, feats_x, feats_y):
        total = total + w * spatial.mean((fx.float() - fy.detach().float()).abs())
    return total * lambda_vgg
