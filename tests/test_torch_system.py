"""The whole slice -- preprocess, style encode, generate -- in deepsee_torch
against deepsee_tpu on the tiny test configuration, float32 on the CPU.

Both packages get the same weights: the JAX package's SRSystem.init, made
nontrivial by test_torch_layers.realistic_variables, handed to the port as
numpy trees through SRSystem.load_jax_variables.  Tolerance on the image:
1e-4 absolute (float32 summation order through ~12 convs); on the style
matrix 1e-6 (values of order 1e-2).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.config import get_preset as jax_get_preset
from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_tpu.utils.torch_import import export_torch_state
from deepsee_torch.config import get_preset
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.system import SRSystem
from deepsee_torch.weights import jax_to_state_dict
from test_torch_layers import realistic_variables

NORMS = ["spectrallateseansyncbatch3x3", "spectrallateseaninstance3x3"]


def _exp(tiny, norm_g):
    exp = tiny().replace(is_train=False)
    return exp.replace(model=dataclasses.replace(exp.model, norm_g=norm_g))


@functools.cache
def _systems(norm_g):
    jsys = JaxSystem(_exp(jax_tiny, norm_g))
    variables = jsys.init(jax.random.PRNGKey(0))
    g = realistic_variables(variables.g, 1)
    e = realistic_variables(variables.e, 2)
    port = SRSystem(_exp(torch_tiny, norm_g), device="cpu")
    port.load_jax_variables(g, e)
    return jsys, variables, g, e, port


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {"image_hr": np.tanh(1.5 * rng.randn(2, cfg.crop_size, cfg.crop_size, 3)
                                ).astype(np.float32),
            "label": rng.randint(0, cfg.label_nc, (2, cfg.crop_size, cfg.crop_size)
                                 ).astype(np.int32)}


@pytest.mark.parametrize("norm_g", NORMS)
@pytest.mark.parametrize("use_full", [False, True])
def test_slice_matches_jax(norm_g, use_full):
    jsys, _, g, e, port = _systems(norm_g)
    batch = _batch(jsys.cfg)
    jpre = jsys.preprocess({k: jnp.asarray(v) for k, v in batch.items()})
    want_fake, want_style, _ = jsys.generate(g, e, jpre, use_full=use_full,
                                             no_noise=True, train=False)
    pre = port.preprocess(batch)
    np.testing.assert_array_equal(pre["input_semantics"].numpy(),
                                  np.asarray(jpre["input_semantics"]))
    np.testing.assert_allclose(pre["image_lr"].numpy(), np.asarray(jpre["image_lr"]),
                               rtol=0, atol=1e-6)
    fake, style = port.generate(pre, use_full=use_full)
    assert fake.shape == (2, 32, 32, 3) and fake.dtype == torch.float32
    assert 0.1 < float(fake.std()) < 0.9  # neither flat nor saturated
    np.testing.assert_allclose(style.numpy(), np.asarray(want_style), rtol=0, atol=1e-6)
    np.testing.assert_allclose(fake.numpy(), np.asarray(want_fake), rtol=0, atol=1e-4)


def _preset_layout(name, net):
    """A preset's export_torch_state keys and the port's module for it.  The
    key set does not depend on the widths, so ngf and nef are narrowed to 4;
    the JAX tree's shapes come from jax.eval_shape and its values are zeros."""
    def narrow(get):
        exp = get(name).replace(is_train=False)
        return exp.replace(model=dataclasses.replace(exp.model, ngf=4, nef=4))

    shapes = jax.eval_shape(JaxSystem(narrow(jax_get_preset)).init, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  {"g": shapes.g, "e": shapes.e}[net])
    port = SRSystem(narrow(get_preset), device="cpu")
    return export_torch_state(tree), {"g": port.generator, "e": port.encoder}[net]


@pytest.mark.parametrize("preset,net", [
    pytest.param("tiny", "g", id="g"), pytest.param("tiny", "e", id="e")] + [
    pytest.param(name, net, id=f"{name}-{net}")
    for name in ("8x_guided_256x256", "32x_guided_512x512") for net in ("g", "e")])
def test_state_dict_is_the_export_layout(preset, net):
    """The port's keys are exactly export_torch_state's, so an exported (or
    released) state dict loads with strict=True and equals the bridge's; for
    the guided presets, the standalone HR encoder and the PureSEAN tail."""
    if preset != "tiny":
        exported, module = _preset_layout(preset, net)
        assert set(module.state_dict()) == set(exported)
        module.load_state_dict(exported, strict=True)
        return
    _, variables, g, e, port = _systems(NORMS[0])
    module = {"g": port.generator, "e": port.encoder}[net]
    tree = {"g": variables.g, "e": variables.e}[net]
    exported = export_torch_state(tree)
    assert set(module.state_dict()) == set(exported)
    bridged = jax_to_state_dict({"g": g, "e": e}[net])
    assert set(bridged) == set(exported)
    for key, value in jax_to_state_dict(tree).items():
        torch.testing.assert_close(value, exported[key], rtol=0, atol=0)
    fresh = SRSystem(_exp(torch_tiny, NORMS[0]), device="cpu")
    {"g": fresh.generator, "e": fresh.encoder}[net].load_state_dict(exported, strict=True)


def test_port_init_is_seeded():
    cfg = torch_tiny().model
    states = []
    for _ in range(2):
        system = SRSystem(torch_tiny().replace(is_train=False), device="cpu")
        system.init(torch.Generator().manual_seed(7))
        states.append(system.generator.state_dict())
    for key, value in states[0].items():
        torch.testing.assert_close(value, states[1][key], rtol=0, atol=0)
    w = states[0]["G_middle_0.conv_0.weight_orig"]  # 64 x 64 x 3 x 3, xavier 0.02
    nf = 16 * cfg.ngf
    assert abs(float(w.std()) / (0.02 * (2.0 / (18 * nf)) ** 0.5) - 1) < 0.05
    assert abs(float(states[0]["G_middle_0.conv_0.weight_u"].norm()) - 1) < 1e-5
    alpha = float(states[0]["G_middle_0.norm_0.alpha_gamma"])
    assert 0.0 <= alpha < 1.0
    assert float(states[0]["G_middle_0.norm_0.mlp_gamma.bias"].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["8x_independent_256x256", "8x_independent_128x128",
                                  "32x_guided_512x512", "8x_guided_256x256", "tiny"])
def test_config_copy_matches_jax(name):
    """The port's own config copy gives the JAX package's values for every
    field it keeps (the model's and the experiment's explorative knobs),
    and the same derived properties."""
    if name == "tiny":
        port_exp, ref_exp = torch_tiny(), jax_tiny()
    else:
        port_exp, ref_exp = get_preset(name), jax_get_preset(name)
    for f in dataclasses.fields(port_exp):
        if f.name != "model":
            assert getattr(port_exp, f.name) == getattr(ref_exp, f.name), f.name
    port, ref = port_exp.model, ref_exp.model
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (port.semantic_nc, port.n_blocks, port.use_encoder) == (
        ref.semantic_nc, ref.n_blocks, ref.use_encoder)
    assert dataclasses.asdict(port.norm_g_spec) == dataclasses.asdict(ref.norm_g_spec)
