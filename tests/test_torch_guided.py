"""The guided model and the rest of the eval-mode generator in deepsee_torch
against deepsee_tpu, float32 on the CPU:

- the guided system (FullStyleEncoder on a guiding image, preprocess ->
  encode_style -> generate) on the tiny test configuration;
- the 32x generator at 512^2 (the PureSEAN tail, capped feature maps and
  the fm-resize quirk), with fold_upsampled_mod_conv off and on;
- the ablation generators ("nostyle", "nospade", "puresean") and the
  pix2pixHD block.

Both packages get the same weights: the JAX package's init, made
nontrivial by test_torch_layers.realistic_variables, handed to the port as
numpy trees through the weight bridge.  Tolerances: the image 1e-4 absolute
(float32 summation order through 12-30 convs; outputs in [-1, 1]), the
style matrix 1e-6 (values of order 1e-2), a single block 1e-5 of
max(1, max|out|).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.config import ModelConfig as JaxModelConfig
from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.models import generator as jgen
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_torch.config import ModelConfig
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.models import generator as tgen
from deepsee_torch.models.encoder import FullStyleEncoder
from deepsee_torch.system import SRSystem
from test_torch_layers import load, nchw, nhwc, realistic_variables
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

NORMS = ["spectrallateseansyncbatch3x3", "spectrallateseaninstance3x3"]
GUIDED = dict(net_e="fullstyle", guiding_style_image=True, noisy_style_scale=0.05)


def _guided_exp(tiny, norm_g):
    exp = tiny().replace(is_train=False)
    return exp.replace(model=dataclasses.replace(exp.model, norm_g=norm_g, **GUIDED))


@functools.cache
def _guided_systems(norm_g):
    jsys = JaxSystem(_guided_exp(jax_tiny, norm_g))
    variables = jsys.init(jax.random.PRNGKey(0))
    g = realistic_variables(variables.g, 1)
    e = realistic_variables(variables.e, 2)
    port = SRSystem(_guided_exp(torch_tiny, norm_g), device="cpu")
    port.load_jax_variables(g, e)
    return jsys, g, e, port


def _guided_batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    size = (2, cfg.crop_size, cfg.crop_size)
    return {"image_hr": np.tanh(1.5 * rng.randn(*size, 3)).astype(np.float32),
            "label": rng.randint(0, cfg.label_nc, size).astype(np.int32),
            "guiding_image": np.tanh(1.5 * rng.randn(*size, 3) + 0.3).astype(np.float32),
            "guiding_label": rng.randint(0, cfg.label_nc, size).astype(np.int32)}


@pytest.mark.parametrize("norm_g", NORMS)
@pytest.mark.parametrize("source", ["guide", "image_hr"])
def test_guided_system_matches_jax(norm_g, source):
    """preprocess -> encode_style -> generate; with source="image_hr" the
    batch has no guiding image and both packages fall back to the HR image."""
    jsys, g, e, port = _guided_systems(norm_g)
    assert isinstance(port.encoder, FullStyleEncoder)
    batch = _guided_batch(jsys.cfg)
    if source == "image_hr":
        batch = {k: v for k, v in batch.items() if not k.startswith("guiding")}
    jpre = jsys.preprocess({k: jnp.asarray(v) for k, v in batch.items()})
    want_fake, want_style, _ = jsys.generate(g, e, jpre, use_full=True, no_noise=True,
                                             train=False)
    pre = port.preprocess(batch)
    for key in ("input_semantics", "guiding_label"):
        if key in jpre:
            np.testing.assert_array_equal(pre[key].numpy(), np.asarray(jpre[key]))
    fake, style = port.generate(pre)
    assert fake.shape == (2, 32, 32, 3) and style.shape == (2, 19, 16)
    assert 0.1 < float(fake.std()) < 0.9  # neither flat nor saturated
    np.testing.assert_allclose(style.numpy(), np.asarray(want_style), rtol=0, atol=1e-6)
    np.testing.assert_allclose(fake.numpy(), np.asarray(want_fake), rtol=0, atol=1e-4)
    if source == "guide":  # the style really comes from the guiding image
        hr_only = {k: v for k, v in pre.items() if not k.startswith("guiding")}
        assert float((port.encode_style(hr_only, use_full=True) - style).abs().max()) > 1e-3


# 16 -> 512 in five blocks: up_3 at 512^2 is PureSEAN; with max_fm_size=64
# the SEAN blocks at 128^2 and 256^2 and the PureSEAN block take the capped
# maps and the quirk (regional_style_size == 128); max_fm_size=256 is the
# presets' cap, where the PureSEAN block is the one at twice the cap (the
# folded conv's case).  The configuration of the JAX package's
# tests/test_512_path.py.
GEN_512 = dict(start_size=16, crop_size=512, load_size=512, ngf=1, nef=1,
               regional_style_size=128, add_noise=False, compute_dtype="float32")


@pytest.mark.parametrize("max_fm,fold", [(64, False), (64, True), (256, False), (256, True)])
def test_32x_generator_matches_jax(max_fm, fold):
    kw = dict(GEN_512, max_fm_size=max_fm, fold_upsampled_mod_conv=fold)
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.RandomState(0)
    lr = np.tanh(rng.randn(1, 16, 16, 3)).astype(np.float32)
    seg = np.eye(19, dtype=np.float32)[rng.randint(0, 19, (1, 512, 512))]
    style = np.tanh(rng.randn(1, 19, 128)).astype(np.float32)
    args = (jnp.asarray(lr), jnp.asarray(seg), jnp.asarray(style))
    jmod = jgen.DeepSEEGenerator(jcfg)
    v = realistic_variables(jmod.init(jax.random.PRNGKey(0), *args, train=False), 8)
    want = np.asarray(jmod.apply(v, *args, train=False))
    port = load(tgen.DeepSEEGenerator(tcfg), v)
    kinds = [type(b.norm_0).__name__ for b in port.up_list]
    assert kinds == ["SEANBlock"] * 3 + ["PureSEANBlock"]
    got = port(nchw(lr), nchw(seg), torch.from_numpy(style)).detach()
    assert got.shape == (1, 3, 512, 512)
    assert float(got.std()) > 0.1
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-4)


def _tiny_generator_inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    lr = np.tanh(rng.randn(1, cfg.start_size, cfg.start_size, 3)).astype(np.float32)
    seg = np.eye(cfg.semantic_nc, dtype=np.float32)[
        rng.randint(0, cfg.semantic_nc, (1, cfg.crop_size, cfg.crop_size))]
    style = np.tanh(rng.randn(1, cfg.label_nc, cfg.regional_style_size)).astype(np.float32)
    return lr, seg, style


@pytest.mark.parametrize("variant", ["nostyle", "nospade", "puresean"])
def test_ablation_generator_matches_jax(variant):
    jcfg, tcfg = jax_tiny().model, torch_tiny().model
    lr, seg, style = _tiny_generator_inputs(jcfg)
    args = (jnp.asarray(lr), jnp.asarray(seg), jnp.asarray(style))
    jmod = jgen.DeepSEEGenerator(jcfg, variant=variant)
    init = jmod.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                     *args, train=True)
    v = realistic_variables(init, 9)
    want = np.asarray(jmod.apply(v, *args, train=False))
    port = load(tgen.DeepSEEGenerator(tcfg, variant=variant), v)
    if variant == "nospade":
        assert not any("mlp" in k for k in port.state_dict())
    got = port(nchw(lr), nchw(seg), torch.from_numpy(style)).detach()
    assert float(got.std()) > 0.05
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-4)


def test_unknown_variant_is_refused():
    with pytest.raises(ValueError, match="variant"):
        tgen.DeepSEEGenerator(torch_tiny().model, variant="pix2pix")


def test_pix2pix_block_matches_jax():
    """Reflect pad -> spectral conv -> instance norm -> ReLU, twice, plus
    the identity; the bridge maps conv_block_0/1.conv to the reference's
    conv_block.1.0 / conv_block.4.0."""
    x = np.random.RandomState(0).randn(2, 8, 8, 8).astype(np.float32)
    jmod = jgen.Pix2PixResnetBlock(8, jax_tiny().model)
    v = realistic_variables(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 10)
    want = np.asarray(jmod.apply(v, jnp.asarray(x), train=False))
    port = load(tgen.Pix2PixResnetBlock(8), v)
    assert set(port.state_dict()) == {f"conv_block.{i}.0.weight_{s}" for i in (1, 4)
                                      for s in ("orig", "u", "v")}
    got = port(nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got.detach()), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
