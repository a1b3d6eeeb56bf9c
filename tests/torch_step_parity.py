"""Shared by the tests/test_torch_train*.py files: the port's GAN train step
against deepsee_tpu's, float32 on the CPU, tiny test configuration.

Both packages' optimizers are replaced by plain SGD at SGD_LR
(deepsee_tpu.train.{state,steps}.make_{g,d}_optimizer -> optax.sgd, the
port's deepsee_torch.train.state.make_{g,d}_optimizer -> torch.optim.SGD),
so a stepped parameter shows its gradient: p1 = p0 - lr * grad.  Both get
the same weights (the JAX init made nontrivial by
test_torch_layers.realistic_variables, bridged to the port) and the same
batch.  Where the step draws random numbers, both get the same numbers:
coins through `jax.random.bernoulli` and the port's `steps.draw_coins`,
noise through `jax.random.normal` / `jax.random.uniform` and the port's
`layers.draw_injection_noise` / `encoder.draw_noise`, each a function of
the draw's shape.  Nothing in either package changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_tpu.system import SystemVariables
from deepsee_tpu.train import state as jstate
from deepsee_tpu.train import steps as jsteps
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.models import encoder as tenc
from deepsee_torch.models import layers as tlayers
from deepsee_torch.system import SRSystem
from deepsee_torch.train import state as tstate
from deepsee_torch.train import steps as tsteps
from deepsee_torch.weights import jax_to_state_dict
from test_torch_layers import realistic_variables
from torch_seeded import COINS, SGD_LR, batch_for, normal_for, uniform_for  # noqa: F401

GUIDED = dict(net_e="fullstyle", guiding_style_image=True, noisy_style_scale=0.0,
              add_noise=False)
# The independent model without the noise injection: jitted, the JAX step's
# gradients with injected noise differ from the same function's eager
# gradients by ~0.2 % (tiny model, the same noise fed in); the port agrees
# with the eager ones.  test_torch_train_layers.py holds the noise injection
# and a train-mode resblock against eager JAX instead.
INDEPENDENT = dict(add_noise=False)


def experiments(model=(), train=()):
    out = []
    for tiny in (jax_tiny, torch_tiny):
        exp = tiny()
        out.append(exp.replace(model=dataclasses.replace(exp.model, **dict(model)),
                               train=dataclasses.replace(exp.train, **dict(train))))
    return out


@contextlib.contextmanager
def patched(independent: bool):
    """SGD in both packages; with `independent`, COINS and shape-keyed
    noise in both."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jstate, jsteps):
            mp.setattr(mod, "make_g_optimizer", lambda tc: optax.sgd(SGD_LR))
            mp.setattr(mod, "make_d_optimizer", lambda tc: optax.sgd(SGD_LR))
        mp.setattr(tstate, "make_g_optimizer",
                   lambda system, tc: torch.optim.SGD(tstate.g_params(system), lr=SGD_LR))
        mp.setattr(tstate, "make_d_optimizer",
                   lambda system, tc: torch.optim.SGD(system.discriminator.parameters(),
                                                      lr=SGD_LR))
        if independent:
            flat = itertools.cycle([c for pair in COINS for c in pair])
            pairs = itertools.cycle(COINS)
            mp.setattr(jax.random, "bernoulli",
                       lambda key, p=0.5, shape=None: jnp.asarray(next(flat)))
            mp.setattr(tsteps, "draw_coins", lambda system, generator: next(pairs))
            mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                       jnp.asarray(normal_for(shape), dtype))
            mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32, *a, **k:
                       jnp.asarray(uniform_for(shape), dtype))
            mp.setattr(tlayers, "draw_injection_noise", lambda shape, generator, device:
                       torch.from_numpy(normal_for(shape)).to(device))
            mp.setattr(tenc, "draw_noise", lambda shape, dist, generator, device:
                       torch.from_numpy(uniform_for(shape) if dist == "uniform"
                                        else normal_for(shape)).to(device))
        yield


@functools.cache
def initial_variables(jexp):
    """The JAX init made nontrivial, once per configuration (the trees are
    read, never written, by their users).  Drawn without remat, whatever jexp
    says: flax's nn.remat draws other initial values for the same tree, so
    a step with remat starts from the weights of the step without.  At the
    remat draw the steps without remat part by 2.1e-5 in a running variance
    after two guided steps, over BUFFER_ATOL; that is rounding: a one-ulp
    nudge of the weights moves the same statistic by 6e-4 in the JAX
    package and 5e-3 in the port (see BUFFER_ATOL;
    scripts/step_parity_rounding.py prints both inits)."""
    plain = jexp.replace(train=dataclasses.replace(jexp.train, remat=False))
    variables = JaxSystem(plain).init(jax.random.PRNGKey(0))
    return SystemVariables(g=realistic_variables(variables.g, 1),
                           e=realistic_variables(variables.e, 2),
                           d=realistic_variables(variables.d, 3),
                           vgg=jax.device_get(variables.vgg))


def _snapshot_jax(state):
    trees = {"g": state.g_vars, "e": state.e_vars, "d": state.d_vars}
    return {net: jax_to_state_dict(jax.device_get(tree)) for net, tree in trees.items()}


def _snapshot_port(system):
    nets = {"g": system.generator, "e": system.encoder, "d": system.discriminator}
    return {net: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for net, m in nets.items()}


def run_both(model=(), train=(), pattern=(True, True), independent=False, batch_size=2):
    """Both packages from the same weights over len(pattern) steps (True: a
    G and D step, False: a D-only step) on one batch of `batch_size`.
    Returns per step (the (jax, port) snapshots it started from, jax logs,
    port logs, jax snapshot, port snapshot)."""
    jexp, texp = experiments(model, train)
    variables = initial_variables(jexp)
    guided = dict(model).get("guiding_style_image", False)
    batch = batch_for(jexp.model, guided, batch=batch_size)
    out = []
    with patched(independent):
        jsys = JaxSystem(jexp)
        jst = jstate.create_train_state(jsys, jax.random.PRNGKey(1), variables=variables)
        jfns = {do_g: jsteps.make_train_step(jsys, do_g=do_g, donate=False)
                for do_g in set(pattern)}
        port = SRSystem(texp, device="cpu")
        port.load_jax_variables(variables.g, variables.e, variables.d, variables.vgg)
        tst = tstate.create_train_state(port, init=False)
        tfns = {do_g: tsteps.make_train_step(port, do_g=do_g) for do_g in set(pattern)}
        before = (_snapshot_jax(jst), _snapshot_port(port))
        for do_g in pattern:
            jst, jlogs = jfns[do_g](jst, {k: jnp.asarray(v) for k, v in batch.items()})
            tlogs = tfns[do_g](tst, batch)
            after = (_snapshot_jax(jst), _snapshot_port(port))
            out.append((before, {k: float(v) for k, v in jax.device_get(jlogs).items()},
                        {k: float(v) for k, v in tlogs.items()}) + after)
            before = after
    return out


# Tolerances, float32 on the CPU.  Losses: 1e-4 relative (summation order
# through ~30 convs and the losses' means).  A parameter tensor's SGD step
# (its gradient times SGD_LR): the L2 norm of the difference within
# STEP_RTOL of the L2 norm of JAX's step, plus STEP_FLOOR per element for
# tensors whose step is ~0 (a conv bias ahead of a batch norm has a true
# gradient of 0; both packages return float noise of ~1e-5 there, a step of
# ~5e-7).  The norm, not each
# element: after a step the two packages' weights differ by float noise,
# and a pre-activation at a ReLU or an L1 term at its kink may then fall on
# the other side for a few elements.  1e-2: the largest seen on the tiny
# models is 3.4e-3, on SEAN's scalar blend weights and the biases above,
# whose gradients are sums over every pixel that mostly cancel.  Buffers
# (batch statistics, spectral u/v): 1e-5 absolute (seen: 1.1e-6).  That
# holds at these initial weights, not at every start: from weights one ulp
# away, either package's running statistics of up_list.0 after one or two
# steps move by 1e-4 to 5e-3 (scripts/step_parity_rounding.py), likely
# where a ReLU or an L1 term falls on the other side of its kink.
LOSS_RTOL = 1e-4
STEP_RTOL = 1e-2
STEP_FLOOR = 1e-6
BUFFER_ATOL = 1e-5


def step_error(step_got: np.ndarray, step_want: np.ndarray) -> float:
    """||got - want|| / (||want|| + STEP_FLOOR sqrt(n)): the step's relative
    error."""
    return float(np.linalg.norm(step_got - step_want)
                 / (np.linalg.norm(step_want) + STEP_FLOOR * np.sqrt(step_want.size)))


def check_step(before, jlogs, tlogs, jsnap, tsnap):
    """One step against JAX's; `before` is the (jax, port) snapshot pair
    the step started from: each package's step is taken from its own."""
    jbefore, tbefore = before
    assert set(jlogs) == set(tlogs)
    for name in jlogs:
        np.testing.assert_allclose(tlogs[name], jlogs[name], rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=name)
    for net in ("g", "e", "d"):
        for key, want in jsnap[net].items():
            got = tsnap[net][key]
            if key.endswith(("weight_u", "weight_v", "running_mean", "running_var")):
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                           atol=BUFFER_ATOL, err_msg=f"{net} {key}")
                continue
            err = step_error((got - tbefore[net][key]).numpy(),
                             (want - jbefore[net][key]).numpy())
            assert err <= STEP_RTOL, f"{net} {key}: step differs by {err:.2e} (relative L2)"
