"""SPADE, SEANBlock, PureSEANBlock, the folded up-2 modulation conv and
SPADEResnetBlock of deepsee_torch against deepsee_tpu, loaded through the
weight bridge from JAX-initialized (and perturbed, see
test_torch_layers.realistic_variables) variables.

Tolerance: 1e-5 of max(1, max|out|) (float32 conv summation order on
XLA:CPU vs torch's CPU convs; outputs reach about 5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.models import blocks as jblocks
from deepsee_tpu.models import normalization as jnorm
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.models import blocks as tblocks
from deepsee_torch.models import normalization as tnorm
from deepsee_torch.models.layers import conv2d
from deepsee_torch.ops.resize import upsample_nearest_2x
from test_torch_layers import load, nchw, nhwc, realistic_variables

SYNCBATCH = "spectrallateseansyncbatch3x3"
INSTANCE = "spectrallateseaninstance3x3"


def _configs(**model):
    return (dataclasses.replace(jax_tiny().model, **model),
            dataclasses.replace(torch_tiny().model, **model))


def _inputs(cfg, c: int, hw: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    x = (0.5 + 1.5 * rng.randn(2, hw, hw, c)).astype(np.float32)
    seg = np.eye(cfg.semantic_nc, dtype=np.float32)[
        rng.randint(0, cfg.semantic_nc, (2, cfg.crop_size, cfg.crop_size))]
    style = np.tanh(rng.randn(2, cfg.label_nc, cfg.regional_style_size)).astype(np.float32)
    return x, seg, style


def _compare(jmod, port_cls, port_args, x, seg, style, seed, rngs=None, **jax_init_kw):
    args = (jnp.asarray(x), jnp.asarray(seg), jnp.asarray(style))
    init = jmod.init(rngs or jax.random.PRNGKey(0), *args, **jax_init_kw)
    v = realistic_variables(init, seed)
    want = np.asarray(jmod.apply(v, *args, train=False))
    port = load(port_cls(*port_args), v)
    got = port(nchw(x), nchw(seg), torch.from_numpy(style))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got.detach()), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
    return port, got


@pytest.mark.parametrize("norm_g", [SYNCBATCH, INSTANCE])
@pytest.mark.parametrize("hw", [8, 32])
def test_spade_matches_jax(norm_g, hw):
    jcfg, tcfg = _configs(norm_g=norm_g)
    x, seg, style = _inputs(jcfg, 16, hw)
    _compare(jnorm.SPADE(jcfg, 16), tnorm.SPADE, (tcfg, 16), x, seg, style, 1,
             train=False)


@pytest.mark.parametrize("norm_g", [SYNCBATCH, INSTANCE])
@pytest.mark.parametrize("hw", [8, 32])
def test_sean_block_matches_jax(norm_g, hw):
    jcfg, tcfg = _configs(norm_g=norm_g)
    x, seg, style = _inputs(jcfg, 16, hw)
    _compare(jnorm.SEANBlock(jcfg, 16), tnorm.SEANBlock, (tcfg, 16), x, seg, style, 2,
             train=False)


@pytest.mark.parametrize("quirk", [True, False])
def test_sean_block_fm_cap_matches_jax(quirk):
    """max_fm_size=16 under 32^2 activations: the maps are made at 16^2 and
    nearest-upsampled; with the quirk the style map IS the upsampled
    segmap features (needs regional_style_size == 128)."""
    jcfg, tcfg = _configs(max_fm_size=16, regional_style_size=128,
                          replicate_fm_resize_quirk=quirk)
    x, seg, style = _inputs(jcfg, 16, 32)
    _compare(jnorm.SEANBlock(jcfg, 16), tnorm.SEANBlock, (tcfg, 16), x, seg, style, 3,
             train=False)


@pytest.mark.parametrize("quirk", [True, False])
def test_sean_block_fold_matches_jax(quirk):
    """fold_upsampled_mod_conv with the maps at half the activations'
    size: both packages run the modulation conv as the folded up-2 conv."""
    jcfg, tcfg = _configs(max_fm_size=16, regional_style_size=128,
                          replicate_fm_resize_quirk=quirk, fold_upsampled_mod_conv=True)
    x, seg, style = _inputs(jcfg, 16, 32)
    _compare(jnorm.SEANBlock(jcfg, 16), tnorm.SEANBlock, (tcfg, 16), x, seg, style, 3,
             train=False)


# (max_fm_size, quirk, fold) at 32^2 activations: uncapped, then capped at
# 16^2 with the quirk on and off, literal and folded
PURE_SEAN_CASES = [(32, True, False), (16, True, False), (16, False, False),
                   (16, True, True), (16, False, True)]


@pytest.mark.parametrize("norm_g", [SYNCBATCH, INSTANCE])
@pytest.mark.parametrize("fm,quirk,fold", PURE_SEAN_CASES)
def test_pure_sean_block_matches_jax(norm_g, fm, quirk, fold):
    """PureSEAN: norm(x) * g_s + b_s with no +1 on the scale; with the
    quirk the style map is the upsampled segmap features (128 wide)."""
    jcfg, tcfg = _configs(norm_g=norm_g, max_fm_size=fm, regional_style_size=128,
                          replicate_fm_resize_quirk=quirk, fold_upsampled_mod_conv=fold)
    x, seg, style = _inputs(jcfg, 16, 32)
    _compare(jnorm.PureSEANBlock(jcfg, 16), tnorm.PureSEANBlock, (tcfg, 16), x, seg,
             style, 6, train=False)


@pytest.mark.parametrize("shape", [(2, 8, 6, 5), (1, 6, 4, 4), (2, 16, 7, 9)])
def test_folded_conv_matches_upsample_then_conv(shape):
    """conv_on_nearest_up2 against conv3x3(nearest_up2(a)) in the port and
    against the JAX package's _conv_on_nearest_up2, odd sizes included:
    1e-5 (float32 summation order; outputs of order 1)."""
    rng = np.random.RandomState(sum(shape))
    b, cin, h, w = shape
    a = rng.randn(b, h, w, cin).astype(np.float32)
    k = (0.1 * rng.randn(3, 3, cin, 12)).astype(np.float32)  # HWIO
    bias = rng.randn(12).astype(np.float32)
    weight = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    got = tnorm.conv_on_nearest_up2(nchw(a), weight, torch.from_numpy(bias))
    assert got.shape == (b, 12, 2 * h, 2 * w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    literal = conv2d(upsample_nearest_2x(nchw(a)), weight, torch.from_numpy(bias))
    torch.testing.assert_close(got, literal, rtol=0, atol=1e-5)
    want = jnorm._conv_on_nearest_up2(jnp.asarray(a), jnp.asarray(k), jnp.asarray(bias),
                                      jnp.float32)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm_g", [SYNCBATCH, INSTANCE])
@pytest.mark.parametrize("styled", [False, True])
def test_resnet_block_matches_jax(norm_g, styled):
    jcfg, tcfg = _configs(norm_g=norm_g)
    c = 16 * jcfg.ngf
    x, seg, style = _inputs(jcfg, c, 16)
    # train=True at init materializes the noise weights, as SRSystem.init does
    port, _ = _compare(jblocks.SPADEResnetBlock(c, c, jcfg, style=styled),
                       tblocks.SPADEResnetBlock, (c, c, tcfg, styled), x, seg, style, 4,
                       train=True, rngs={"params": jax.random.PRNGKey(0),
                                         "noise": jax.random.PRNGKey(1)})
    assert hasattr(port, "noise_in")
    assert isinstance(port.norm_0, tnorm.SEANBlock if styled else tnorm.SPADE)


@pytest.mark.parametrize("kind", ["sean", "spade", "puresean"])
def test_learned_shortcut_matches_jax(kind):
    """fin != fout (16 -> 8): norm_s without the leaky ReLU, then the
    spectral 1x1 conv_s without bias; the middle has min(fin, fout)
    channels, noise_middle too.  The configuration of the JAX package's
    tests/test_edge_paths.py."""
    jcfg, tcfg = _configs(start_size=16, crop_size=64, load_size=64, ngf=4, nef=4,
                          regional_style_size=16, max_fm_size=64,
                          norm_g="spectralseansyncbatch3x3")
    x, seg, style = _inputs(jcfg, 16, 16)
    styled, puresean = kind != "spade", kind == "puresean"
    port, got = _compare(
        jblocks.SPADEResnetBlock(16, 8, jcfg, style=styled, puresean=puresean),
        tblocks.SPADEResnetBlock, (16, 8, tcfg, styled, puresean), x, seg, style, 7,
        train=True, rngs={"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)})
    assert got.shape[1] == 8 and port.noise_middle.weight.shape == (8,)
    norm_cls = {"sean": tnorm.SEANBlock, "spade": tnorm.SPADE,
                "puresean": tnorm.PureSEANBlock}[kind]
    assert all(isinstance(n, norm_cls) for n in (port.norm_s, port.norm_0, port.norm_1))
