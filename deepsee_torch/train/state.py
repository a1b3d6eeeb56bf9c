"""Train state and optimizers, port of deepsee_tpu/train/state.py
(reference: SRModel.create_optimizers, sr_model.py:469-495):

  * one Adam over generator + encoder parameters, TTUR lr = lr/2; the
    parameters under a module whose name contains "mini" form a parameter
    group at a quarter of that lr (the JAX package scales their Adam update
    by 0.25, which is the same thing);
  * one Adam over the discriminator parameters, TTUR lr = 2 lr;
  * Adam(beta1, beta2, eps=1e-8), with an optional clip-by-value of every
    gradient first (trainer_manager.py:38-42);
  * linear per-epoch lr decay after `niter` epochs (`set_epoch_lr`).

The state holds the system (its networks carry the weights, running
statistics and spectral u/v), both optimizers, the step and epoch counts,
and the two explicit random generators of the step: a CPU one for the
host coins and one on the device for the noise.  Under a process group
every rank seeds both alike and takes G's, E's and D's parameters and
buffers from data rank 0 of its data group (`broadcast_networks`) after
creation and after a restore.  Under tensor parallelism (exp.mesh's
model_axis > 1) every rank makes the full weights alike, keeps its shards
(parallel/shard.py) and builds both optimizers over them, so the Adam
moments shard as their parameters do.  Under spatial sharding (partition
"spatial") the parameters, and so the Adam moments, stay whole on every
rank.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List

import torch

from deepsee_torch.config import TrainConfig
from deepsee_torch.models.vgg import load_vgg19_state_dict
from deepsee_torch.parallel import distributed, shard, spatial
from deepsee_torch.system import SRSystem

MINI_LR_SCALE = 0.25


class ClippedAdam(torch.optim.Adam):
    """torch.optim.Adam (eps 1e-8) that first clips every gradient to
    [-clip, clip] where clip > 0 (optax.clip before scale_by_adam)."""

    def __init__(self, params, *, lr: float, betas, clip: float):
        super().__init__(params, lr=lr, betas=betas, eps=1e-8)
        self.clip = clip

    def step(self, closure=None):
        if self.clip > 0:
            grads = [p for group in self.param_groups for p in group["params"]
                     if p.grad is not None]
            torch.nn.utils.clip_grad_value_(grads, self.clip)
        return super().step(closure)


def g_param_groups(system: SRSystem, lr: float) -> List[Dict]:
    """The G optimizer's parameters: generator + encoder at `lr`, the
    encoder's "mini" parameters at MINI_LR_SCALE * lr.  Each group keeps its
    `lr_scale` for the epoch decay."""
    named = [("g." + n, p) for n, p in system.generator.named_parameters()]
    if system.encoder is not None:
        named += [("e." + n, p) for n, p in system.encoder.named_parameters()]
    groups = [{"params": [p for n, p in named if "mini" not in n], "lr": lr, "lr_scale": 1.0}]
    mini = [p for n, p in named if "mini" in n]
    if mini:
        groups.append({"params": mini, "lr": MINI_LR_SCALE * lr, "lr_scale": MINI_LR_SCALE})
    return groups


def g_params(system: SRSystem) -> List[torch.nn.Parameter]:
    return [p for group in g_param_groups(system, 0.0) for p in group["params"]]


def make_g_optimizer(system: SRSystem, tc: TrainConfig) -> torch.optim.Optimizer:
    return ClippedAdam(g_param_groups(system, tc.g_lr()), lr=tc.g_lr(),
                       betas=(tc.beta1, tc.beta2), clip=tc.gradient_clip)


def make_d_optimizer(system: SRSystem, tc: TrainConfig) -> torch.optim.Optimizer:
    groups = [{"params": list(system.discriminator.parameters()), "lr": tc.d_lr(),
               "lr_scale": 1.0}]
    return ClippedAdam(groups, lr=tc.d_lr(), betas=(tc.beta1, tc.beta2), clip=tc.gradient_clip)


@dataclasses.dataclass
class TrainState:
    system: SRSystem
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    coin_rng: torch.Generator      # CPU: the host coins of each encode
    noise_rng: torch.Generator     # the device's: noise injection, style noise
    step: int = 0
    epoch: int = 1

    def generators_state(self) -> Dict[str, torch.Tensor]:
        return {"coin_rng": self.coin_rng.get_state(), "noise_rng": self.noise_rng.get_state()}

    def load_generators_state(self, states: Dict[str, torch.Tensor]) -> None:
        self.coin_rng.set_state(states["coin_rng"])
        self.noise_rng.set_state(states["noise_rng"])


def load_vgg_weights(system: SRSystem, path: str) -> None:
    """The perceptual net's weights from a torchvision-format file, or a
    warning that the loss runs on random features (loss.py:105-119)."""
    if system.vgg is None:
        return
    if not path:
        warnings.warn("training with RANDOM VGG19 features for the perceptual loss: pass "
                      "--vgg_weights <torchvision vgg19 .pth> for reference-equivalent "
                      "training (loss.py:105-119)", stacklevel=2)
        return
    system.vgg.load_state_dict(load_vgg19_state_dict(path), strict=True)


def broadcast_networks(system: SRSystem) -> None:
    """G's, E's and D's parameters and buffers (running statistics, spectral
    u/v) set to data rank 0's on every rank of each data group (its own
    shards under tensor parallelism); nothing in one process."""
    for net in (system.generator, system.encoder, system.discriminator):
        if net is not None:
            distributed.broadcast_module_state(net)


def create_train_state(system: SRSystem, *, init: bool = True) -> TrainState:
    """Seeded weights (unless init=False: the caller loads them), the VGG
    weights, the layout of exp.mesh (its model groups made and the networks
    sharded over them where model_axis > 1), both optimizers and the step's
    generators, all from exp.train.seed; under a process group, the
    networks then data rank 0's.  A spatial layout stripes the maps over the
    model group (`spatial.use_mesh`) and keeps the networks whole."""
    tc = system.exp.train
    if init:
        system.init(torch.Generator().manual_seed(tc.seed))
    load_vgg_weights(system, tc.vgg_weights)
    spatial.use_mesh(system.exp.mesh)
    if distributed.model_world() > 1:
        shard.shard_system(system, system.exp.mesh)
    broadcast_networks(system)
    return TrainState(system=system, opt_g=make_g_optimizer(system, tc),
                      opt_d=make_d_optimizer(system, tc),
                      coin_rng=torch.Generator().manual_seed(tc.seed + 1),
                      noise_rng=torch.Generator(device=system.device).manual_seed(tc.seed + 2))


def set_epoch_lr(state: TrainState, epoch: int) -> None:
    """The per-epoch linear decay of both optimizers' lr."""
    tc = state.system.exp.train
    scale = tc.epoch_lr_scale(epoch)
    for opt, lr in ((state.opt_g, tc.g_lr()), (state.opt_d, tc.d_lr())):
        for group in opt.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0) * scale
