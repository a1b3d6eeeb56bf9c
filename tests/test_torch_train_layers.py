"""The training-mode layers and the training networks of deepsee_torch
against deepsee_tpu, float32 on the CPU (eager JAX), tiny widths: spectral
power iteration, train-mode batch norm, noise injection and a train-mode
resblock with the same noise fed to both sides, the multiscale
discriminator at every layer and scale, the VGG19 taps, and every loss.

Tolerances: activations 1e-5 absolute on values of order 1; spectral u/v
and running statistics 1e-6; gradients 1e-5 of their largest value
(float32 summation order); losses 1e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.losses import feature_matching_loss as jfm
from deepsee_tpu.losses import gan_loss as jgan
from deepsee_tpu.losses import vgg_loss as jvgg
from deepsee_tpu.models import blocks as jblocks
from deepsee_tpu.models import discriminator as jdisc
from deepsee_tpu.models import layers as jlayers
from deepsee_tpu.models import vgg as jvggmod
from deepsee_tpu.utils.torch_import import export_torch_state
from deepsee_torch import losses as tlosses
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.models import blocks as tblocks
from deepsee_torch.models import discriminator as tdisc
from deepsee_torch.models import layers as tlayers
from deepsee_torch.models import vgg as tvgg
from deepsee_torch.weights import jax_to_state_dict, vgg_jax_to_state_dict
from test_torch_layers import nchw, nhwc, realistic_variables
from torch_step_parity import normal_for

GRAD_RTOL = 1e-5


def _close_grad(got: torch.Tensor, want, what: str):
    """Within GRAD_RTOL of the largest gradient; a scalar parameter's (SEAN's
    blend weights) within 1e-4 of itself: a sum over every pixel of terms
    that mostly cancel."""
    want = np.asarray(want)
    rtol = 1e-4 if want.size == 1 else GRAD_RTOL
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("stride,ks", [(1, 3), (2, 3), (1, 1)])
def test_spectral_conv_train_matches_jax(stride, ks):
    """Two train-mode forwards from random (unconverged) u/v: after each,
    u, v, the output and the weight's gradient."""
    x = np.random.RandomState(0).randn(2, 8, 8, 6).astype(np.float32)
    r = np.random.RandomState(1).randn(2, 8 // stride, 8 // stride, 16).astype(np.float32)
    pad = ks // 2
    jmod = jlayers.Conv2d(16, (ks, ks), (stride, stride), (pad, pad), spectral=True)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = tlayers.Conv2d(6, 16, ks, stride, pad, spectral=True)
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    port.train()
    spectral = variables["spectral"]
    for _ in range(2):
        def loss(kernel, spectral=spectral):
            out, mut = jmod.apply({"params": dict(variables["params"], kernel=kernel),
                                   "spectral": spectral},
                                  jnp.asarray(x), train=True, mutable=["spectral"])
            return jnp.sum(out * r), (out, mut)
        (_, (want, mut)), jgrad = jax.value_and_grad(loss, has_aux=True)(
            variables["params"]["kernel"])
        spectral = jax.device_get(mut["spectral"])
        weight = port.weight_orig
        got = port(nchw(x))
        (grad,) = torch.autograd.grad((got * nchw(r)).sum(), [weight])
        np.testing.assert_allclose(nhwc(got.detach()), np.asarray(want), rtol=0, atol=1e-5)
        sd = jax_to_state_dict({"params": variables["params"], "spectral": spectral})
        for key in ("weight_u", "weight_v"):
            np.testing.assert_allclose(getattr(port, key).numpy(), sd[key].numpy(), rtol=0,
                                       atol=1e-6, err_msg=key)
        _close_grad(grad, np.asarray(jgrad).transpose(3, 2, 0, 1), "weight grad")


@pytest.mark.parametrize("affine", [False, True])
def test_torch_batch_norm_train_matches_jax(affine):
    x = (1.0 + np.random.RandomState(2).randn(2, 5, 7, 8)).astype(np.float32)
    r = np.random.RandomState(3).randn(2, 5, 7, 8).astype(np.float32)
    jmod = jlayers.TorchBatchNorm(8, affine=affine)
    v = realistic_variables(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 3)

    def loss(xx):
        out, mut = jmod.apply(v, xx, train=True, mutable=["batch_stats"])
        return jnp.sum(out * r), (out, mut)

    (_, (want, mut)), jgx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    port = tlayers.TorchBatchNorm(8, affine=affine)
    port.load_state_dict(jax_to_state_dict(v), strict=True)
    xt = nchw(x).requires_grad_()
    got = port.train()(xt)
    (gx,) = torch.autograd.grad((got * nchw(r)).sum(), [xt])
    np.testing.assert_allclose(nhwc(got.detach()), np.asarray(want), rtol=0, atol=1e-5)
    _close_grad(gx.permute(0, 2, 3, 1), jgx, "grad x")
    for key, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(mut["batch_stats"][key]), rtol=0, atol=1e-6)


def test_noise_injection_matches_jax(monkeypatch):
    rng = np.random.RandomState(4)
    x, noise = rng.randn(2, 5, 6, 8).astype(np.float32), rng.randn(2, 5, 6, 8).astype(np.float32)
    w = rng.randn(8).astype(np.float32)
    r = rng.randn(2, 5, 6, 8).astype(np.float32)
    jmod = jlayers.NoiseInjection(8)

    def loss(weight, xx):
        return jnp.sum(jmod.apply({"params": {"weight": weight}}, xx, noise) * r)

    want = jmod.apply({"params": {"weight": w}}, jnp.asarray(x), noise)
    jgw, jgx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    with pytest.raises(ValueError, match="Generator"):
        tlayers.NoiseInjection(8)(nchw(x), None)
    shapes = []
    monkeypatch.setattr(tlayers, "draw_injection_noise",
                        lambda shape, generator, device: shapes.append(shape)
                        or torch.from_numpy(noise))
    port = tlayers.NoiseInjection(8)
    port.weight.data.copy_(torch.from_numpy(w))
    xt = nchw(x).requires_grad_()
    got = port(xt, torch.Generator())
    assert shapes == [(2, 5, 6, 8)]  # drawn in the JAX package's NHWC layout
    gw, gx = torch.autograd.grad((got * nchw(r)).sum(), [port.weight, xt])
    np.testing.assert_allclose(nhwc(got.detach()), np.asarray(want), rtol=0, atol=1e-6)
    _close_grad(gw, jgw, "grad weight")
    _close_grad(gx.permute(0, 2, 3, 1), jgx, "grad x")


@pytest.mark.parametrize("fin,fout", [(16, 16), (16, 8)])
def test_resblock_train_matches_jax(monkeypatch, fin, fout):
    """A SEAN resblock in train mode with add_noise (the identity or the
    learned shortcut): output, batch statistics, spectral u/v and the
    gradients of every parameter and of x, with the same noise (a function
    of its shape) on both sides."""
    cfg_j, cfg_t = jax_tiny().model, torch_tiny().model
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, fin).astype(np.float32)
    seg = np.eye(19, dtype=np.float32)[rng.randint(0, 19, (2, 32, 32))]
    style = np.tanh(rng.randn(2, 19, cfg_j.regional_style_size)).astype(np.float32)
    r = rng.randn(2, 8, 8, fout).astype(np.float32)
    jmod = jblocks.SPADEResnetBlock(fin, fout, cfg_j)
    v = realistic_variables(jax.device_get(jmod.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jnp.asarray(x),
        jnp.asarray(seg), jnp.asarray(style), train=True)), 6)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(normal_for(shape), dtype))
    monkeypatch.setattr(tlayers, "draw_injection_noise", lambda shape, generator, device:
                        torch.from_numpy(normal_for(shape)))

    def loss(params, xx):
        out, mut = jmod.apply(dict(v, params=params), xx, jnp.asarray(seg), jnp.asarray(style),
                              train=True, rngs={"noise": jax.random.PRNGKey(2)},
                              mutable=["batch_stats", "spectral"])
        return jnp.sum(out * r), (out, mut)

    (_, (want, mut)), (jgp, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    port = tblocks.SPADEResnetBlock(fin, fout, cfg_t)
    port.load_state_dict(jax_to_state_dict(v), strict=True)
    port.train()
    xt = nchw(x).requires_grad_()
    got = port(xt, nchw(seg), torch.from_numpy(style), generator=torch.Generator())
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad((got * nchw(r)).sum(), [xt] + list(port.parameters()),
                                allow_unused=True)
    np.testing.assert_allclose(nhwc(got.detach()), np.asarray(want), rtol=0, atol=1e-5)
    _close_grad(grads[0].permute(0, 2, 3, 1), jgx, "grad x")
    after = jax_to_state_dict({**v, **jax.device_get(mut)})
    for key, value in port.state_dict().items():
        if key.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
            np.testing.assert_allclose(value.numpy(), after[key].numpy(), rtol=0, atol=1e-6,
                                       err_msg=key)
    want_grads = jax_to_state_dict({"params": jax.device_get(jgp), "spectral": v["spectral"]})
    for name, g in zip(names, grads[1:]):
        if name.endswith("conv_0.bias"):
            continue  # ahead of a batch norm: its true gradient is 0, both give float noise
        _close_grad(g, want_grads[name], name)


def _disc_input(cfg, seed=7):
    rng = np.random.RandomState(seed)
    return rng.randn(4, cfg.crop_size, cfg.crop_size, cfg.semantic_nc + 3).astype(np.float32)


@pytest.mark.parametrize("norm_d", ["spectralinstance", "spectralbatch"])
@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_jax(norm_d, train):
    """Every layer's activation at both scales (the odd sizes 17^2 and 18^2
    among them), and in train mode the spectral u/v and batch statistics
    after the forward."""
    cfg_j = dataclasses.replace(jax_tiny().model, norm_d=norm_d)
    cfg_t = dataclasses.replace(torch_tiny().model, norm_d=norm_d)
    x = _disc_input(cfg_j)
    jmod = jdisc.MultiscaleDiscriminator(cfg_j)
    v = realistic_variables(jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), 8)
    want, mut = jmod.apply(v, jnp.asarray(x), train=train,
                           mutable=["batch_stats", "spectral"])
    port = tdisc.MultiscaleDiscriminator(cfg_t)
    port.load_state_dict(jax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = port.train(train)(nchw(x))
    assert len(got) == cfg_t.num_d and all(len(s) == cfg_t.n_layers_d + 1 for s in got)
    for scale_got, scale_want in zip(got, want):
        for g, w in zip(scale_got, scale_want):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-5)
    after = jax_to_state_dict({**v, **jax.device_get(mut)})
    for key, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(), after[key].numpy(), rtol=0, atol=1e-6,
                                   err_msg=key)
    if norm_d == "spectralinstance":  # the reference layout, as the JAX exporter writes it
        assert set(port.state_dict()) == set(export_torch_state(v))


def test_vgg_taps_match_jax():
    x = np.tanh(np.random.RandomState(9).randn(2, 32, 32, 3)).astype(np.float32)
    jmod = jvggmod.VGG19Features()
    v = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jmod.apply(v, jnp.asarray(x))
    port = tvgg.VGG19Features()
    port.load_state_dict(vgg_jax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = port(nchw(x))
    assert [t.shape[1] for t in got] == [64, 128, 256, 512, 512]
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())))


def test_vgg_weight_file_loads_as_jax_reads_it(tmp_path):
    """A torchvision-layout .npz: the port's load_vgg19_state_dict and the
    JAX package's load_vgg19_params read the same weights."""
    v = jax.device_get(jvggmod.VGG19Features().init(jax.random.PRNGKey(3),
                                                   jnp.zeros((1, 32, 32, 3))))
    sd = vgg_jax_to_state_dict(v)
    path = str(tmp_path / "vgg19.npz")
    np.savez(path, **{k: t.numpy() for k, t in sd.items()},
             **{"classifier.0.weight": np.zeros((2, 2), np.float32)})
    loaded = tvgg.load_vgg19_state_dict(path)
    jax_params = jvggmod.load_vgg19_params(path)
    for key, value in vgg_jax_to_state_dict({"params": jax_params}).items():
        torch.testing.assert_close(loaded[key], value, rtol=0, atol=0)
    assert set(loaded) == set(sd)


def _preds(seed):
    rng = np.random.RandomState(seed)
    return [[rng.randn(2, 9, 9, 8).astype(np.float32), rng.randn(2, 5, 5, 16).astype(np.float32),
             rng.randn(2, 4, 4, 1).astype(np.float32)] for _ in range(2)]


def _torch_preds(preds, requires_grad=False):
    return [[nchw(t).requires_grad_(requires_grad) for t in scale] for scale in preds]


LOSS_CASES = [("hinge", True, True), ("hinge", True, False), ("hinge", False, True)] + [
    (mode, for_d, real) for mode in ("ls", "original", "w")
    for for_d in (True, False) for real in (True, False)]


@pytest.mark.parametrize("mode,for_discriminator,target_is_real", LOSS_CASES)
def test_gan_loss_matches_jax(mode, for_discriminator, target_is_real):
    preds = _preds(10)
    want = jgan(jax.tree_util.tree_map(jnp.asarray, preds), target_is_real, mode=mode,
                for_discriminator=for_discriminator)
    got = tlosses.gan_loss(_torch_preds(preds), target_is_real, mode=mode,
                           for_discriminator=for_discriminator)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


def test_generator_hinge_loss_refuses_a_fake_target():
    with pytest.raises(ValueError, match="real"):
        tlosses.gan_loss(_torch_preds(_preds(11)), False, mode="hinge", for_discriminator=False)
    with pytest.raises(ValueError, match="gan_mode"):
        tlosses.gan_loss(_torch_preds(_preds(11)), True, mode="other")


def test_feature_matching_and_vgg_losses_match_jax():
    """Values, and the gradient reaches the fake side only."""
    fake, real = _preds(12), _preds(13)
    jf = jax.tree_util.tree_map(jnp.asarray, fake)
    jr = jax.tree_util.tree_map(jnp.asarray, real)
    want, jgrad = jax.value_and_grad(lambda f: jfm(f, jr, 10.0))(jf)
    tf, tr = _torch_preds(fake, True), _torch_preds(real, True)
    got = tlosses.feature_matching_loss(tf, tr, 10.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    leaves = [t for scale in tf for t in scale[:-1]]
    grads = torch.autograd.grad(got, leaves + [tr[0][0]], allow_unused=True)
    assert grads[-1] is None  # the real side is detached
    want_leaves = [t for scale in jgrad for t in scale[:-1]]
    for g, w in zip(grads[:-1], want_leaves):
        _close_grad(g.permute(0, 2, 3, 1), w, "feature matching grad")
    fx = [t[0] for t in fake] + [t[1] for t in fake] + [fake[0][2]]
    fy = [t[0] for t in real] + [t[1] for t in real] + [real[0][2]]
    want = jvgg([jnp.asarray(a) for a in fx], [jnp.asarray(a) for a in fy], 10.0)
    got = tlosses.vgg_loss([nchw(a) for a in fx], [nchw(a) for a in fy], 10.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
