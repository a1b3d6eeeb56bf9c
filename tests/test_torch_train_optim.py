"""The port's optimizers against deepsee_tpu's optax chains
(train/state.py:51-70), on identical gradients over three updates: the G
Adam over generator + encoder with the "mini" parameters at a quarter of
the lr, the D Adam, clip-by-value before Adam, the per-epoch decay past
niter, no_ttur and other betas.

Tolerance: each parameter's total change within 1e-4 of the largest change
of its tensor plus 2 float32 ulps of the parameter (the same float32 Adam
arithmetic in another order, each update rounded into the parameter; a
change is ~lr per update).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_tpu.train import state as jstate
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.system import SRSystem
from deepsee_torch.train import state as tstate
from deepsee_torch.weights import jax_to_state_dict
from test_torch_layers import realistic_variables


@functools.cache
def _variables():
    v = JaxSystem(jax_tiny()).init(jax.random.PRNGKey(0))
    return (realistic_variables(v.g, 1), realistic_variables(v.e, 2),
            realistic_variables(v.d, 3), jax.device_get(v.vgg))


def _grads(tree, seed, scale):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (scale * rng.randn(*np.shape(p))).astype(np.float32), tree)


CASES = {"default": {}, "clip": dict(gradient_clip=0.5), "past niter": {},
         "no_ttur": dict(no_ttur=True), "betas": dict(beta1=0.5, beta2=0.999)}
EPOCH = {"past niter": 60}  # niter 50 + niter_decay 25: the lr at 0.6


@pytest.mark.parametrize("net", ["g", "d"])
@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(net, case):
    g, e, d, vgg = _variables()
    jexp, texp = jax_tiny(), torch_tiny()
    jtc = dataclasses.replace(jexp.train, **CASES[case])
    ttc = dataclasses.replace(texp.train, no_vgg_loss=True, **CASES[case])  # no VGG to init
    epoch = EPOCH.get(case, 1)
    port = SRSystem(texp.replace(train=ttc), device="cpu")
    port.load_jax_variables(g, e, d, vgg)
    state = tstate.create_train_state(port, init=False)
    tstate.set_epoch_lr(state, epoch)
    if net == "g":
        tx, params = jstate.make_g_optimizer(jtc), {"g": g["params"], "e": e["params"]}
        opt, lr = state.opt_g, jtc.g_lr()
        modules = {"g": (port.generator, g), "e": (port.encoder, e)}
    else:
        tx, params = jstate.make_d_optimizer(jtc), d["params"]
        opt, lr = state.opt_d, jtc.d_lr()
        modules = {"d": (port.discriminator, d)}
    opt_state = tx.init(params)
    opt_state.hyperparams["lr"] = jnp.asarray(lr * jtc.epoch_lr_scale(epoch), jnp.float32)
    start = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
             for k, (m, _) in modules.items()}
    for i in range(3):
        grads = _grads(params, 10 + i, scale=0.8)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, (module, tree) in modules.items():
            sub = grads[k] if net == "g" else grads
            sd = jax_to_state_dict({"params": sub, "spectral": tree["spectral"]})
            for n, p in module.named_parameters():
                p.grad = sd[n].clone()
        opt.step()
        opt.zero_grad(set_to_none=True)
    for k, (module, tree) in modules.items():
        final = params[k] if net == "g" else params
        want = jax_to_state_dict({"params": jax.device_get(final), "spectral": tree["spectral"]})
        for n, p in module.named_parameters():
            step_want = (want[n] - start[k][n]).numpy()
            step_got = (p.detach() - start[k][n]).numpy()
            slack = (1e-4 * float(np.abs(step_want).max())
                     + 2 * np.spacing(np.abs(p.detach().numpy())))
            assert (np.abs(step_got - step_want) <= slack).all(), f"{k} {n}"


def test_g_optimizer_groups():
    """The "mini" parameters, and only they, at a quarter of the G lr; the
    decay keeps the ratio."""
    exp = torch_tiny()
    port = SRSystem(exp.replace(train=dataclasses.replace(exp.train, no_vgg_loss=True)),
                    device="cpu")
    state = tstate.create_train_state(port, init=False)
    tc = port.exp.train
    mini = {id(p) for n, p in port.encoder.named_parameters() if "mini" in n}
    groups = state.opt_g.param_groups
    assert [g["lr"] for g in groups] == [tc.g_lr(), 0.25 * tc.g_lr()]
    assert {id(p) for p in groups[1]["params"]} == mini and mini
    tstate.set_epoch_lr(state, 70)
    scale = tc.epoch_lr_scale(70)
    assert [g["lr"] for g in groups] == [tc.g_lr() * scale, 0.25 * tc.g_lr() * scale]
    assert state.opt_d.param_groups[0]["lr"] == tc.d_lr() * scale
