"""The training ops of deepsee_torch against deepsee_tpu, float32 on the CPU:
the batch- and instance-statistics forward of `modnorm_train` (plain
version) against the JAX package's TorchBatchNorm(train=True) /
instance_norm_2d followed by the modulation and leaky ReLU, the running-stat
update against JAX's mutated batch_stats, the backward's plain version
against jax.grad of that composition and against torch.autograd of the
plain forward, the discriminator's pooling, and the launch plan of the
training reductions (pure Python; the kernels run on the card only).

Tolerances: outputs 1e-5 absolute on values of order 1; statistics 1e-6;
gradients 1e-5 of their largest value (float32 sums in other orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.models import layers as jlayers
from deepsee_tpu.ops.norms import instance_norm_2d, leaky_relu
from deepsee_tpu.ops.pooling import avg_pool_3x3_s2 as jax_pool
from deepsee_torch.models.normalization import ParamFreeNorm
from deepsee_torch.ops import modnorm as mn
from deepsee_torch.ops.pooling import avg_pool_3x3_s2
from test_torch_layers import nchw, nhwc

SHAPES = [(2, 16, 17, 17), (3, 8, 33, 33)]  # (B, C, H, W): odd sizes, as D's


def _inputs(shape, seed=0):
    b, c, h, w = shape
    rng = np.random.RandomState(seed)
    x = (1.5 * rng.randn(b, h, w, c) + 0.5).astype(np.float32)
    mod = rng.randn(b, h, w, 2 * c).astype(np.float32)
    gout = rng.randn(b, h, w, c).astype(np.float32)
    return x, mod, gout


def _jax_forward(x, mod, stats, lrelu):
    """The JAX package's composition, NHWC: the param-free norm (train-mode
    batch statistics or instance), then norm * mod[:C] + mod[C:], leaky ReLU."""
    c = x.shape[-1]
    if stats == "batch":
        y, _ = jlayers.TorchBatchNorm(c).apply(
            {"batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}, x, train=True,
            mutable=["batch_stats"])
    else:
        y = instance_norm_2d(x)
    if mod is not None:
        y = y * mod[..., :c] + mod[..., c:]
    return leaky_relu(y) if lrelu else y


CASES = [pytest.param(stats, with_mod, lrelu, shape,
                      id=f"{stats}-{'mod' if with_mod else 'nomod'}-"
                         f"{'lrelu' if lrelu else 'linear'}-{shape[2]}x{shape[3]}")
         for stats in ("batch", "instance") for with_mod in (False, True)
         for lrelu in (False, True) for shape in SHAPES]


@pytest.mark.parametrize("stats,with_mod,lrelu,shape", CASES)
def test_modnorm_train_plain_matches_jax(stats, with_mod, lrelu, shape):
    """Forward output and statistics, and the backward plain version
    against jax.grad of sum(out * gout)."""
    x, mod, gout = _inputs(shape)
    m = mod if with_mod else None
    out, mean, rstd = mn.modnorm_train(nchw(x), None if m is None else nchw(m), stats=stats,
                                       lrelu=lrelu)
    assert out.is_contiguous(memory_format=torch.channels_last)
    want = _jax_forward(jnp.asarray(x), None if m is None else jnp.asarray(m), stats, lrelu)
    np.testing.assert_allclose(nhwc(out), np.asarray(want), rtol=0, atol=1e-5)
    axes = (0, 1, 2) if stats == "batch" else (1, 2)
    np.testing.assert_allclose(mean.numpy(), x.mean(axes), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(x.var(axes) + 1e-5), rtol=1e-5)

    def loss(xx, mm):
        return jnp.sum(_jax_forward(xx, mm if with_mod else None, stats, lrelu) * gout)

    jgx, jgm = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(mod))
    gx, gmod = mn.modnorm_backward(nchw(x), None if m is None else nchw(m), nchw(gout),
                                   mean, rstd, stats=stats, lrelu=lrelu)
    scale = float(np.abs(jgx).max())
    np.testing.assert_allclose(nhwc(gx), np.asarray(jgx), rtol=0, atol=1e-5 * scale)
    if with_mod:
        np.testing.assert_allclose(nhwc(gmod), np.asarray(jgm), rtol=0,
                                   atol=1e-5 * float(np.abs(jgm).max()))
    else:
        assert gmod is None


@pytest.mark.parametrize("stats,with_mod,lrelu,shape", CASES)
def test_modnorm_train_autograd_matches_torch_autograd(stats, with_mod, lrelu, shape):
    """torch.autograd through the registered op (its backward is the
    backward op) against torch.autograd of the same function written in
    float64 eager torch; the statistics are not differentiable."""
    x, mod, gout = _inputs(shape, seed=1)
    xt = nchw(x).requires_grad_()
    mt = nchw(mod).requires_grad_() if with_mod else None
    out, mean, rstd = mn.modnorm_train(xt, mt, stats=stats, lrelu=lrelu)
    assert not mean.requires_grad and not rstd.requires_grad
    inputs = [xt] + ([mt] if with_mod else [])
    got = torch.autograd.grad(out, inputs, nchw(gout))

    xd = torch.from_numpy(x).double().permute(0, 3, 1, 2).requires_grad_()
    md = torch.from_numpy(mod).double().permute(0, 3, 1, 2).requires_grad_()
    dims = (0, 2, 3) if stats == "batch" else (2, 3)
    mu = xd.mean(dims, keepdim=True)
    y = (xd - mu) / torch.sqrt(((xd - mu) ** 2).mean(dims, keepdim=True) + 1e-5)
    c = shape[1]
    if with_mod:
        y = y * md[:, :c] + md[:, c:]
    if lrelu:
        y = torch.where(y >= 0, y, 0.2 * y)
    want = torch.autograd.grad(y, [xd] + ([md] if with_mod else []),
                               torch.from_numpy(gout).double().permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert float((g.double() - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("shape", SHAPES)
def test_running_stat_update_matches_jax(shape):
    """ParamFreeNorm's batch kind in train mode: the output and the running
    statistics after one forward (momentum 0.1, unbiased variance) against
    the JAX package's mutated batch_stats."""
    x, mod, _ = _inputs(shape, seed=2)
    c = shape[1]
    init = {"batch_stats": {"mean": 0.3 * np.ones(c, np.float32),
                            "var": 1.7 * np.ones(c, np.float32)}}
    want, mutated = jlayers.TorchBatchNorm(c).apply(init, jnp.asarray(x), train=True,
                                                    mutable=["batch_stats"])
    norm = ParamFreeNorm(c, "syncbatch").train()
    norm.running_mean.fill_(0.3)
    norm.running_var.fill_(1.7)
    with torch.no_grad():
        out = norm(nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(norm.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(norm.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 22, 32, 32), (2, 22, 33, 33), (1, 5, 17, 18)])
def test_avg_pool_3x3_s2_matches_jax(shape):
    b, c, h, w = shape
    x = np.random.RandomState(3).randn(b, h, w, c).astype(np.float32)
    got = avg_pool_3x3_s2(nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got), np.asarray(jax_pool(jnp.asarray(x))), rtol=0,
                               atol=1e-6)


# the batch backward's (N*H*W, C): the generator's shapes of the 8x 256^2
# step at b4 and b16, and edges (one pixel, an 8-channel tile, odd sizes,
# many pixels of few channels)
PLAN_SHAPES = [(4 * 32 * 32, 512), (4 * 64 * 64, 512), (4 * 128 * 128, 512),
               (4 * 256 * 256, 512), (16 * 256 * 256, 512), (1, 8), (3 * 20 * 20, 24),
               (8 * 17 * 17, 128), (7, 64), (65535 * 4, 8)]


@pytest.mark.parametrize("p,c", PLAN_SHAPES)
def test_reduce_plan_covers_every_pixel(p, c):
    """The chunks tile the pixels with none empty; the channel tile is 8,
    16, 32 or 64 channels dividing C; the grid is what the C entry computes
    and within CUDA's limits."""
    plan = mn.reduce_plan(p, c)
    assert plan.lanes in (1, 2, 4, 8) and c % (8 * plan.lanes) == 0
    assert plan.chunks * plan.chunk >= p > (plan.chunks - 1) * plan.chunk
    assert plan.grid == (plan.chunks, c // (8 * plan.lanes))
    assert plan.grid[1] <= 65535
    assert math.prod(plan.grid) <= max(mn.REDUCE_BLOCKS, plan.grid[1])


def test_reduce_plan_refuses_what_the_kernels_do_not_take():
    for args in ((16, 12), (0, 8), (16, 0), (4, -8)):
        with pytest.raises(ValueError):
            mn.reduce_plan(*args)
