"""The GAN training step, port of deepsee_tpu/train/steps.py.

One step is a generator update, then a discriminator update (the reference's
loop order, train.py:40-44):

  * G step: encode + generate in train mode, D on fake and real in one 2B
    batch, the GAN, feature-matching and VGG losses; the gradient is taken
    with respect to the generator and encoder parameters only, so nothing
    accumulates in D (whose spectral u/v still advance in this forward);
  * D step: the fake regenerated under torch.no_grad with fresh coins by the
    just-updated G (sr_model.py:550-553), which still updates the batch
    statistics and spectral u/v, or with `reuse_fake` the G step's fake;
    the hinge (or other) losses on both halves.
  * Coins: (use_full, no_noise), each Bernoulli(0.5), for the independent
    model (sr_model.py:616,643); (True, False) for the guided one.  They are
    host coins from the state's CPU generator; the noise comes from its
    device generator.

Preprocessing (one-hot, HR -> LR) runs inside the step, under torch.no_grad.

Data parallelism (under a process group of W ranks, each holding its rows of
the global batch): the generator's batch norms take their statistics from
every rank's rows (models/normalization.py), each optimizer's gradients are
averaged over the ranks between `torch.autograd.grad` and the optimizer
step (`distributed.all_reduce_grads`), and the logs returned are the ranks'
means, as the JAX package's are over the global batch.  The step takes its
gradients with torch.autograd.grad over chosen parameters, and D runs twice
per G step (in the G step's loss and its own), so DistributedDataParallel's
hooks on .backward() do not fit it.  The coins come from the state's CPU
generator, seeded alike on every rank, so every rank draws the same coins
and runs the same launches, collectives included, in the same order.

Tensor parallelism (exp.mesh.model_axis > 1): the networks' wide convs are
sharded over each data index's model group (parallel/shard.py) and their
collectives run inside the forward and backward (parallel/tensor.py); the
data group is the data-parallel world above.  The feature-matching loss
sums D's channel-sharded features over the model group, and before the data
group's all-reduce the replicated parameters' gradients are averaged over
the model group (`tensor.mean_replicated_grads`), which keeps them bit for
bit equal on every model rank.

Spatial sharding (exp.mesh.partition "spatial"): each model rank keeps its
stripe of H of the batch (`spatial.shard_rows`), every loss is the whole
map's mean on every rank (the discriminator's outputs by their layouts,
`MultiscaleDiscriminator.output_rows`), and each rank's gradient of a
parameter, a partial sum over its stripe, is summed over the model group
(`spatial.sum_replicated_grads`) before the data group's mean.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from deepsee_torch.losses import feature_matching_loss, gan_loss, vgg_loss
from deepsee_torch.parallel import distributed, spatial
from deepsee_torch.parallel import tensor as tp
from deepsee_torch.system import SRSystem, _nchw
from deepsee_torch.train.state import TrainState, g_params

Logs = Dict[str, torch.Tensor]


def draw_coins(system: SRSystem, generator: torch.Generator) -> Tuple[bool, bool]:
    """(use_full, no_noise) for one encode: two host Bernoulli(0.5) draws
    from `generator` for the independent model, (True, False) for the
    guided one."""
    if system.cfg.model_variant != "independent":
        return True, False
    draws = torch.rand(2, generator=generator)
    return bool(draws[0] < 0.5), bool(draws[1] < 0.5)


def _step_optimizer(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                    loss: torch.Tensor) -> None:
    """The gradient of `loss` with respect to `params` alone, zeros where a
    parameter took no part (as jax.grad gives), the replicated ones'
    averaged over the model group (tensor parallelism) or each rank's share
    summed over it (spatial sharding), all averaged over the data group,
    then one optimizer step."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    if spatial.active():
        spatial.sum_replicated_grads(params)
    else:
        tp.mean_replicated_grads(params)
    distributed.all_reduce_grads(params)
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_train_step(system: SRSystem, *, do_g: bool = True
                    ) -> Callable[[TrainState, Dict], Logs]:
    """step(state, batch) -> logs: one G update (unless do_g=False, the
    D-only steps of d_steps_per_g > 1) and one D update.  `batch` holds the
    NHWC arrays or tensors of a data batch; logs are 0-dim float32 tensors
    on the device."""
    tc = system.exp.train

    def d_rows(pre: Dict):
        """The layouts of D's outputs where maps are striped, else None."""
        if not spatial.active():
            return None
        return system.discriminator.output_rows(spatial.global_height(pre["image_hr"].shape[1]))

    def g_update(state: TrainState, pre: Dict) -> Tuple[Logs, torch.Tensor]:
        use_full, no_noise = draw_coins(system, state.coin_rng)
        fake = system.train_generate(pre, use_full=use_full, no_noise=no_noise,
                                     generator=state.noise_rng)
        pred_fake, pred_real = system.discriminate(pre["input_semantics"], fake,
                                                   pre["image_hr"])
        rows = d_rows(pre)
        losses = {"GAN": gan_loss(pred_fake, True, mode=tc.gan_mode, for_discriminator=False,
                                  rows=rows)}
        if not tc.no_ganfeat_loss:
            losses["GAN_Feat"] = feature_matching_loss(
                pred_fake, pred_real, tc.lambda_feat, system.discriminator.sharded_outputs(),
                rows)
        if system.vgg is not None:
            with torch.no_grad():
                real_feats = system.vgg_features(_nchw(pre["image_hr"]))
            losses["VGG"] = vgg_loss(system.vgg_features(fake), real_feats, tc.lambda_vgg)
        _step_optimizer(state.opt_g, g_params(system), sum(losses.values()))
        return losses, fake

    def d_update(state: TrainState, pre: Dict, fake: Optional[torch.Tensor]) -> Logs:
        if fake is None:
            use_full, no_noise = draw_coins(system, state.coin_rng)
            with torch.no_grad():
                fake = system.train_generate(pre, use_full=use_full, no_noise=no_noise,
                                             generator=state.noise_rng)
        pred_fake, pred_real = system.discriminate(pre["input_semantics"], fake.detach(),
                                                   pre["image_hr"])
        rows = d_rows(pre)
        losses = {"D_Fake": gan_loss(pred_fake, False, mode=tc.gan_mode, rows=rows),
                  "D_real": gan_loss(pred_real, True, mode=tc.gan_mode, rows=rows)}
        params: List[torch.Tensor] = list(system.discriminator.parameters())
        _step_optimizer(state.opt_d, params, sum(losses.values()))
        return losses

    def step(state: TrainState, batch: Dict) -> Logs:
        pre = system.train_preprocess(spatial.shard_rows(batch))
        logs: Logs = {}
        fake = None
        if do_g:
            g_losses, g_fake = g_update(state, pre)
            logs.update(g_losses)
            if tc.reuse_fake:
                fake = g_fake
        logs.update(d_update(state, pre, fake))
        state.step += 1
        return distributed.all_reduce_mean({k: v.detach() for k, v in logs.items()})

    return step
