"""SPADE, SEANBlock and SPADEResnetBlock of deepsee_torch against
deepsee_tpu, loaded through the weight bridge from JAX-initialized (and
perturbed, see test_torch_layers.realistic_variables) variables.

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


def test_sean_fold_option_is_refused():
    _, tcfg = _configs(fold_upsampled_mod_conv=True)
    with pytest.raises(NotImplementedError):
        tnorm.SEANBlock(tcfg, 16)


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


def test_learned_shortcut_is_refused():
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError):
        tblocks.SPADEResnetBlock(16, 32, tcfg)
