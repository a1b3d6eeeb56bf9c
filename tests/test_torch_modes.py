"""The explorative inference modes and the style noise of deepsee_torch
against deepsee_tpu, float32 on the CPU, tiny test configuration.

Both packages get the same weights (the JAX init made nontrivial by
test_torch_layers.realistic_variables, bridged to the port) and the same
batch.  Where a mode or the encoder draws random numbers, both sides get
the same numbers: on the JAX side the test monkeypatches `get_noise` of
deepsee_tpu.inference.modes or `jax.random.*`, on the port's side its one
draw function (`modes.get_noise`, `encoder.draw_noise`, `system.draw_coin`);
nothing in either package changes.  A fresh JAX system per noisy case
keeps its jitted functions from reusing a trace made under another patch.

Tolerances: images 1e-4 absolute (float32 summation order through ~12
convs, outputs in [-1, 1]); style matrices 1e-6 (values of order 1e-2 to
1, one masked mean and elementwise ops).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.inference import modes as jmodes
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_tpu.system import SystemVariables
from deepsee_torch import system as tsystem
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.inference import modes as tmodes
from deepsee_torch.models import encoder as tenc
from deepsee_torch.regions import CONSISTENT_REGIONS
from deepsee_torch.system import SRSystem
from test_torch_layers import realistic_variables
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

IMAGE_ATOL = 1e-4
STYLE_ATOL = 1e-6
KNOBS = dict(noise_delta=0.3, n_interpolation=3, region_idx=(1, 4, 5, 10, 13))
GUIDED = dict(net_e="fullstyle", guiding_style_image=True, noisy_style_scale=0.05)


def _exp(tiny, knobs=(), **model):
    exp = tiny().replace(is_train=False, **dict(KNOBS, **dict(knobs)))
    return exp.replace(model=dataclasses.replace(exp.model, **model))


@functools.cache
def _weights(guided: bool, random_style: bool = False):
    model = dict(GUIDED, random_style_matrix=random_style) if guided else {}
    variables = JaxSystem(_exp(jax_tiny, **model)).init(jax.random.PRNGKey(0))
    return realistic_variables(variables.g, 1), realistic_variables(variables.e, 2)


def _systems(guided: bool = False, knobs=(), **model):
    """A fresh JAX system, its variables, and the port with the same weights."""
    if guided:
        model = dict(GUIDED, **model)
    g, e = _weights(guided, model.get("random_style_matrix", False))
    jsys = JaxSystem(_exp(jax_tiny, knobs, **model))
    port = SRSystem(_exp(torch_tiny, knobs, **model), device="cpu")
    port.load_jax_variables(g, e)
    return jsys, SystemVariables(g=g, e=e, d=None, vgg=None), port


@functools.cache
def _shared():
    return _systems()


def _raw_batch(cfg, guided=False, seed=0):
    rng = np.random.RandomState(seed)
    size = (2, cfg.crop_size, cfg.crop_size)
    batch = {"image_hr": np.tanh(1.5 * rng.randn(*size, 3)).astype(np.float32),
             "label": rng.randint(0, cfg.label_nc, size).astype(np.int32)}
    if guided:
        batch["guiding_image"] = np.tanh(1.5 * rng.randn(*size, 3) + 0.3).astype(np.float32)
        batch["guiding_label"] = rng.randint(0, cfg.label_nc, size).astype(np.int32)
    return batch


def _batches(jsys, port, guided=False):
    raw = _raw_batch(jsys.cfg, guided)
    return (jsys.preprocess({k: jnp.asarray(v) for k, v in raw.items()}),
            port.preprocess(raw))


def _close(got, want, atol=IMAGE_ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _style(seed, cfg, lead=(2,)):
    rng = np.random.RandomState(seed)
    return np.tanh(rng.randn(*lead, cfg.label_nc, cfg.regional_style_size)).astype(np.float32)


# -- deterministic modes --------------------------------------------------

@pytest.mark.parametrize("encode_full", [False, True])
def test_encode_only_matches_jax(encode_full):
    jsys, jvars, port = _shared()
    jb, tb = _batches(jsys, port)
    want = jmodes.encode_only(jsys, jvars, jb, encode_full=encode_full)
    _close(tmodes.encode_only(port, tb, encode_full=encode_full), want, STYLE_ATOL)


def test_generate_with_style_matches_jax():
    jsys, jvars, port = _shared()
    jb, tb = _batches(jsys, port)
    style = _style(3, jsys.cfg)
    want = jmodes.generate_with_style(jsys, jvars, jb, jnp.asarray(style))
    _close(tmodes.generate_with_style(port, tb, torch.from_numpy(style)), want)


def test_generate_with_styles_matches_jax():
    jsys, jvars, port = _shared()
    jb, tb = _batches(jsys, port)
    styles = _style(4, jsys.cfg, lead=(2, 3))
    want = jmodes.generate_with_styles(jsys, jvars, jb, jnp.asarray(styles))
    got = tmodes.generate_with_styles(port, tb, torch.from_numpy(styles))
    assert got.shape == (2, 3, 32, 32, 3)
    _close(got, want)


def test_baseline_upscale_matches_jax():
    jsys, _, port = _shared()
    jb, tb = _batches(jsys, port)
    _close(tmodes.baseline_upscale(port, tb), jmodes.baseline_upscale(jsys, jb), 1e-5)


def test_replace_semantics_matches_jax():
    jsys, jvars, port = _shared()
    jb, tb = _batches(jsys, port)
    want = jmodes.inference_replace_semantics(jsys, jvars, jb)
    got = tmodes.inference_replace_semantics(port, tb)
    for g, w in zip(got, want):
        _close(g, w)
    assert float((got[0] - got[1]).abs().max()) > 1e-3  # the relabel shows


def test_reference_semantics_matches_jax():
    jsys, jvars, port = _shared()
    jb, tb = _batches(jsys, port)
    got = tmodes.inference_reference_semantics(port, tb)
    assert got.shape == (2, 2, 32, 32, 3)
    _close(got, jmodes.inference_reference_semantics(jsys, jvars, jb))


@pytest.mark.parametrize("given_style", [False, True])
def test_interpolation_matches_jax(given_style):
    jsys, jvars, port = _shared()
    jb, tb = _batches(jsys, port)
    style = _style(5, jsys.cfg) if given_style else None
    want_fake, want_styles = jmodes.inference_interpolation(
        jsys, jvars, jb, style=None if style is None else jnp.asarray(style))
    got_fake, got_styles = tmodes.inference_interpolation(
        port, tb, style=None if style is None else torch.from_numpy(style))
    _close(got_styles, want_styles, STYLE_ATOL)
    _close(got_fake, want_fake)


def test_interpolation_refuses_even_n():
    _, _, port = _shared()
    with pytest.raises(ValueError, match="odd"):
        tmodes.inference_interpolation(port, {}, style=torch.zeros(2, 19, 16), n=4)


def test_interpolation_style_matches_jax():
    jsys, jvars, port = _shared()
    jb, tb = _batches(jsys, port)
    a, b = _style(6, jsys.cfg), _style(7, jsys.cfg)
    want_fake, want_styles = jmodes.inference_interpolation_style(
        jsys, jvars, jb, jnp.asarray(a), jnp.asarray(b))
    got_fake, got_styles = tmodes.inference_interpolation_style(
        port, tb, torch.from_numpy(a), torch.from_numpy(b))
    _close(got_styles, want_styles, STYLE_ATOL)
    _close(got_fake, want_fake)


def test_reference_matches_jax():
    jsys, jvars, port = _shared()
    jb, tb = _batches(jsys, port)
    got = tmodes.inference_reference(port, tb)
    assert got.shape == (2, 2, 32, 32, 3)
    _close(got, jmodes.inference_reference(jsys, jvars, jb))


@pytest.mark.parametrize("scale", [None, 0.5])
def test_reference_interpolation_matches_jax(scale):
    jsys, jvars, port = _shared()
    jb, tb = _batches(jsys, port)
    want = jmodes.inference_reference_interpolation(jsys, jvars, jb, manipulate_scale=scale)
    _close(tmodes.inference_reference_interpolation(port, tb, manipulate_scale=scale), want)


@pytest.mark.parametrize("guided", [False, True])
def test_particular_full_matches_jax(guided):
    jsys, jvars, port = _systems(guided) if guided else _shared()
    jb, tb = _batches(jsys, port, guided)
    want = jmodes.inference_particular_full(jsys, jvars, jb)
    got = tmodes.inference_particular_full(port, tb)
    assert sorted(got) == sorted(want)
    assert len(got) == (2 if guided else 1)
    for key in want:
        _close(got[key], want[key])


def test_particular_combined_without_noise_matches_jax():
    jsys, jvars, port = _systems(knobs={"noise_delta": 0.0})
    jb, tb = _batches(jsys, port)
    want_fake, want_style = jmodes.inference_particular_combined(
        jsys, jvars, jb, jax.random.PRNGKey(0))
    got_fake, got_style = tmodes.inference_particular_combined(
        port, tb, torch.Generator().manual_seed(0))
    _close(got_style, want_style, STYLE_ATOL)
    _close(got_fake, want_fake)


# -- modes with noise: the same numbers fed to both sides -----------------

def _feed_mode_noise(monkeypatch, noise):
    """Both packages' `get_noise` return `noise` (already scaled)."""
    def jax_noise(key, shape, delta, dist="normal"):
        assert tuple(shape) == noise.shape
        return jnp.asarray(noise)

    def torch_noise(generator, shape, delta, dist="normal"):
        assert tuple(shape) == noise.shape
        return torch.from_numpy(noise)

    monkeypatch.setattr(jmodes, "get_noise", jax_noise)
    monkeypatch.setattr(tmodes, "get_noise", torch_noise)


def test_multi_modal_matches_jax(monkeypatch):
    jsys, jvars, port = _systems()
    jb, tb = _batches(jsys, port)
    r = len(KNOBS["region_idx"])
    noise = 0.3 * np.clip(np.random.RandomState(8).randn(2, 3, r, 16), -1, 1).astype(np.float32)
    _feed_mode_noise(monkeypatch, noise)
    want_fake, want_styles = jmodes.inference_multi_modal(jsys, jvars, jb, jax.random.PRNGKey(0))
    got_fake, got_styles = tmodes.inference_multi_modal(port, tb, torch.Generator().manual_seed(0))
    _close(got_styles, want_styles, STYLE_ATOL)
    _close(got_fake, want_fake)
    idx = np.asarray(CONSISTENT_REGIONS)
    np.testing.assert_array_equal(got_styles[:, :, idx].numpy(), got_styles[:, :, idx + 1].numpy())


def test_particular_combined_with_noise_matches_jax(monkeypatch):
    jsys, jvars, port = _systems()
    jb, tb = _batches(jsys, port)
    noise = 0.3 * np.clip(np.random.RandomState(9).randn(2, 5, 16), -1, 1).astype(np.float32)
    _feed_mode_noise(monkeypatch, noise)
    want_fake, want_style = jmodes.inference_particular_combined(
        jsys, jvars, jb, jax.random.PRNGKey(0))
    got_fake, got_style = tmodes.inference_particular_combined(
        port, tb, torch.Generator().manual_seed(0))
    _close(got_style, want_style, STYLE_ATOL)
    _close(got_fake, want_fake)


def _patch_jax_draw(monkeypatch, name, value):
    """jax.random.<name> returns `value` for draws of its shape.  Other
    shapes go to the real function: flax traces each parameter's
    initializer to check the stored parameter's shape."""
    real = getattr(jax.random, name)

    def draw(key, shape=(), *args, **kwargs):
        if tuple(shape) == value.shape:
            return jnp.asarray(value)
        return real(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, name, draw)


def _feed_draws(monkeypatch, draws):
    """Both packages draw `draws[dist]` where they would draw uniform or
    normal numbers: jax.random.uniform / normal, and the port's
    encoder.draw_noise."""

    def torch_draw(shape, dist, generator, device):
        assert tuple(shape) == draws[dist].shape
        return torch.from_numpy(draws[dist])

    for dist, value in draws.items():
        _patch_jax_draw(monkeypatch, dist, value)
    monkeypatch.setattr(tenc, "draw_noise", torch_draw)


def _draws(seed, shape):
    rng = np.random.RandomState(seed)
    return {"uniform": rng.uniform(size=shape).astype(np.float32),
            "normal": rng.randn(*shape).astype(np.float32)}


@pytest.mark.parametrize("dist", ["uniform", "normal"])
@pytest.mark.parametrize("coin", [True, False])
def test_inference_noise_matches_jax(monkeypatch, dist, coin):
    """The 50 % coin (True: no style noise) fixed on both sides, and the
    encoder's noise in both distributions."""
    jsys, jvars, port = _systems(noisy_style_dist=dist)
    jb, tb = _batches(jsys, port)
    n = 3
    _feed_draws(monkeypatch, _draws(10, (2 * n, 19, 16)))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None: jnp.asarray(coin))
    monkeypatch.setattr(tsystem, "draw_coin", lambda generator: coin)
    want = jmodes.inference_noise(jsys, jvars, jb, jax.random.PRNGKey(0), n)
    got = tmodes.inference_noise(port, tb, torch.Generator().manual_seed(0), n)
    assert got.shape == (2, n, 32, 32, 3)
    _close(got, want)


@pytest.mark.parametrize("dist", ["uniform", "normal"])
@pytest.mark.parametrize("guided", [False, True])
def test_style_noise_matches_jax(monkeypatch, dist, guided):
    """encode_style with no_noise=False: sigmoid-gated noise, the "normal"
    (randn*2-1) quirk, the clip to [-1, 1]; the combined and the guided
    encoder."""
    jsys, jvars, port = _systems(guided, noisy_style_dist=dist)
    jb, tb = _batches(jsys, port, guided)
    _feed_draws(monkeypatch, _draws(11, (2, 19, 16)))
    want = jsys.encode_style(jvars.e, jb, use_full=True, no_noise=False, train=False,
                             rngs={"noise": jax.random.PRNGKey(0)})
    got = port.encode_style(tb, use_full=True, no_noise=False,
                            generator=torch.Generator().manual_seed(0))
    clean = port.encode_style(tb, use_full=True)
    assert float((got - clean).abs().max()) > 1e-3  # the noise shows
    assert float(got.abs().max()) <= 1.0
    _close(got, want, STYLE_ATOL)


def test_random_style_matrix_matches_jax(monkeypatch):
    """The guided encoder with random_style_matrix: per-region N(0, 1) maps
    masked by the segmap replace the guiding image."""
    jsys, jvars, port = _systems(True, random_style_matrix=True)
    jb, tb = _batches(jsys, port, True)
    _feed_draws(monkeypatch, _draws(12, (2, 32, 32, 19)))
    want = jsys.encode_style(jvars.e, jb, use_full=True, no_noise=True, train=False,
                             rngs={"noise": jax.random.PRNGKey(0)})
    got = port.encode_style(tb, use_full=True, generator=torch.Generator().manual_seed(0))
    _close(got, want, STYLE_ATOL)
    want_fake, _, _ = jsys.generate(jvars.g, jvars.e, jb, use_full=True, no_noise=True,
                                    rngs={"noise": jax.random.PRNGKey(0)})
    got_fake, _ = port.generate(tb, generator=torch.Generator().manual_seed(0))
    _close(got_fake, want_fake)


# -- the port's own draws ---------------------------------------------------

@pytest.mark.parametrize("dist", ["normal", "uniform"])
def test_get_noise_formula_matches_jax(monkeypatch, dist):
    """clamp(draw, -1, 1) * delta on both sides, from the draw the port's
    generator makes."""
    shape, delta = (2, 3, 5, 16), 0.3
    got = tmodes.get_noise(torch.Generator().manual_seed(13), shape, delta, dist)
    gen = torch.Generator().manual_seed(13)
    draw = (torch.randn if dist == "normal" else torch.rand)(shape, generator=gen).numpy()
    _patch_jax_draw(monkeypatch, dist, draw)
    _close(got, jmodes.get_noise(jax.random.PRNGKey(0), shape, delta, dist), 1e-7)
    assert float(got.abs().max()) <= np.float32(delta)


@pytest.mark.parametrize("dist", ["gaussian", "uniform"])
def test_corrupt_style_formula_matches_jax(monkeypatch, dist):
    style = _style(14, torch_tiny().model)
    got = tmodes.corrupt_style(torch.Generator().manual_seed(15), torch.from_numpy(style),
                               0.05, dist)
    gen = torch.Generator().manual_seed(15)
    draw = (torch.randn if dist == "gaussian" else torch.rand)(style.shape, generator=gen)
    name = "normal" if dist == "gaussian" else "uniform"
    _patch_jax_draw(monkeypatch, name, draw.numpy())
    want = jmodes.corrupt_style(jax.random.PRNGKey(0), jnp.asarray(style), 0.05, dist)
    _close(got, want, 1e-6)


def test_noisy_modes_follow_the_generator():
    """The same seed gives the same variants; another seed others."""
    _, _, port = _shared()
    tb = port.preprocess(_raw_batch(port.cfg))

    def run(seed):
        return tmodes.inference_multi_modal(port, tb, torch.Generator().manual_seed(seed))[0]

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert float((run(1) - run(2)).abs().max()) > 1e-3


def test_coin_and_noise_need_a_generator():
    _, _, port = _shared()
    tb = port.preprocess(_raw_batch(port.cfg))
    with pytest.raises(ValueError, match="Generator"):
        port.encode_style(tb, use_full=False, no_noise=False)
    with pytest.raises(ValueError, match="Generator"):
        tsystem.draw_coin(None)
    coins = [tsystem.draw_coin(torch.Generator().manual_seed(s)) for s in range(64)]
    assert 16 < sum(coins) < 48  # a fair coin
