"""K1's batch modes split around a cross-rank collective, without processes:
the plain versions of the split (deepsee_torch.ops.modnorm) against the
whole batch's plain version and against the JAX package's global batch norm
with the modulation and leaky ReLU, forward and backward; float32 on the CPU.

A seeded NHWC batch of 6 is cut into 2 or 3 shards (the ranks), also with
shards whose means lie 10 standard deviations apart.  Each shard's launch A
(the registered op on CPU tensors: its plain version) fills its row of a
zero [world, 3, C] buffer; the buffers summed stand for the all-reduce;
launch B merges and applies on each shard.  The backward likewise: each
shard's sums, added, then each shard's elementwise pass over the world's
pixel count.  Then SyncModnormTrain itself over a gloo group of one process,
against modnorm_train and its autograd backward.

Tolerance: 1e-5 of the largest value compared, the statistics 1e-5
relative (float32 sums in other orders: per shard, then merged).
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from deepsee_tpu.models.normalization import ParamFreeNorm as JaxParamFreeNorm
from deepsee_tpu.ops.norms import leaky_relu
from deepsee_torch.ops import modnorm as mn
from test_torch_layers import nchw, nhwc

SHAPE = (6, 16, 9, 11)  # (B, C, H, W)
TOL = 1e-5


def _inputs(spread: bool, seed: int = 0):
    b, c, h, w = SHAPE
    rng = np.random.RandomState(seed)
    x = (1.5 * rng.randn(b, h, w, c) + 0.5).astype(np.float32)
    if spread:  # sample i shifted by 15 i (10 sigma): the shards' means 20-30 sigma apart
        x += (15.0 * (np.arange(b) * 6 // b))[:, None, None, None].astype(np.float32)
    mod = rng.randn(b, h, w, 2 * c).astype(np.float32)
    gout = rng.randn(b, h, w, c).astype(np.float32)
    return x, mod, gout


def _jax_global(x, mod, lrelu):
    """The JAX package's syncbatch param-free norm over the whole batch in
    train mode, then norm * mod[:C] + mod[C:] and the leaky ReLU (NHWC)."""
    c = x.shape[-1]
    norm = JaxParamFreeNorm(c, "syncbatch")
    variables = norm.init(jax.random.PRNGKey(0), x, train=False)
    y, _ = norm.apply(variables, x, train=True, mutable=["batch_stats"])
    y = y * mod[..., :c] + mod[..., c:]
    return leaky_relu(y) if lrelu else y


def _shards(t: torch.Tensor, world: int):
    return list(t.chunk(world, dim=0))


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=what)


def _split_forward(x, mod, world, lrelu):
    xs, ms = _shards(x, world), _shards(mod, world) if mod is not None else [None] * world
    partials = sum(mn.modnorm_batch_partials(s, r, world) for r, s in enumerate(xs))
    outs = [mn.modnorm_batch_apply(s, m, partials, lrelu=lrelu) for s, m in zip(xs, ms)]
    for _, mean, rstd in outs[1:]:  # every rank merges the same rows alike
        assert torch.equal(mean, outs[0][1]) and torch.equal(rstd, outs[0][2])
    return torch.cat([o for o, _, _ in outs]), outs[0][1], outs[0][2], partials


CASES = [pytest.param(world, spread, with_mod, lrelu,
                      id=f"{world}ranks-{'spread' if spread else 'near'}-"
                         f"{'mod' if with_mod else 'nomod'}-{'lrelu' if lrelu else 'linear'}")
         for world in (2, 3) for spread in (False, True)
         for with_mod, lrelu in ((True, True), (False, False))]


@pytest.mark.parametrize("world,spread,with_mod,lrelu", CASES)
def test_split_forward_matches_the_whole_batch(world, spread, with_mod, lrelu):
    x_np, mod_np, _ = _inputs(spread)
    x, mod = nchw(x_np), nchw(mod_np) if with_mod else None
    out, mean, rstd, partials = _split_forward(x, mod, world, lrelu)
    assert tuple(partials.shape) == (world, 3, SHAPE[1])
    want, wmean, wrstd = mn.modnorm_train_plain(x, mod, stats="batch", lrelu=lrelu)
    _close(out, want, "out vs the whole batch")
    np.testing.assert_allclose(mean, wmean, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rstd, wrstd, rtol=TOL)
    jmod = mod_np if with_mod else np.concatenate(
        [np.ones_like(x_np), np.zeros_like(x_np)], axis=-1)
    _close(nhwc(out), _jax_global(jnp.asarray(x_np), jnp.asarray(jmod), lrelu), "out vs JAX")


def test_merge_keeps_the_statistics_of_far_apart_shards():
    """Shards 10 sigma apart: the merged variance is the whole batch's
    (float64) within 1e-6 relative, where E[x^2] - E[x]^2 in float32 loses
    digits."""
    x = nchw(_inputs(True)[0])
    partials = sum(mn.modnorm_batch_partials(s, r, 3) for r, s in enumerate(_shards(x, 3)))
    n, mean, m2 = mn.merge_partials(partials)
    xd = x.double()
    want_var = xd.var((0, 2, 3), unbiased=False)
    np.testing.assert_allclose((m2 / n).double(), want_var, rtol=1e-6)
    np.testing.assert_allclose(mean.double(), xd.mean((0, 2, 3)), rtol=1e-6, atol=1e-6)
    assert float(n[0]) == x.numel() / x.shape[1]


@pytest.mark.parametrize("world,spread,with_mod,lrelu", CASES)
def test_split_backward_matches_the_whole_batch(world, spread, with_mod, lrelu):
    x_np, mod_np, g_np = _inputs(spread)
    x, gout = nchw(x_np), nchw(g_np)
    mod = nchw(mod_np) if with_mod else None
    _, mean, rstd, _ = _split_forward(x, mod, world, lrelu)
    xs, gs = _shards(x, world), _shards(gout, world)
    ms = _shards(mod, world) if with_mod else [None] * world
    sums = sum(mn.modnorm_backward_sums(s, m, g, mean, rstd, lrelu=lrelu)
               for s, m, g in zip(xs, ms, gs))
    count = x.numel() // x.shape[1]
    parts = [mn.modnorm_backward_apply(s, m, g, mean, rstd, sums, count, lrelu=lrelu)
             for s, m, g in zip(xs, ms, gs)]
    gx = torch.cat([p[0] for p in parts])
    wgx, wgmod = mn.modnorm_backward_plain(x, mod, gout, mean, rstd, stats="batch", lrelu=lrelu)
    _close(gx, wgx, "grad_x vs the whole batch")
    if with_mod:
        _close(torch.cat([p[1] for p in parts]), wgmod, "grad_mod vs the whole batch")
    else:
        assert all(p[1] is None for p in parts)
    jmod = jnp.asarray(mod_np if with_mod else np.concatenate(
        [np.ones_like(x_np), np.zeros_like(x_np)], axis=-1))
    _, vjp = jax.vjp(lambda a, m: _jax_global(a, m, lrelu), jnp.asarray(x_np), jmod)
    jgx, jgmod = vjp(jnp.asarray(g_np))
    _close(nhwc(gx), jgx, "grad_x vs jax.vjp")
    if with_mod:
        _close(nhwc(torch.cat([p[1] for p in parts])), jgmod, "grad_mod vs jax.vjp")


@pytest.fixture
def group_of_one():
    """A gloo process group of this process alone, torn down after."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("with_mod,lrelu", [(True, True), (False, False)])
def test_sync_modnorm_train_in_a_group_of_one(group_of_one, with_mod, lrelu):
    """SyncModnormTrain's forward and autograd backward equal modnorm_train's
    where the world is one rank."""
    x_np, mod_np, g_np = _inputs(False)
    inputs = [nchw(x_np).requires_grad_()]
    inputs.append(nchw(mod_np).requires_grad_() if with_mod else None)
    got = mn.modnorm_train_sync(*inputs, lrelu=lrelu)
    got[0].backward(nchw(g_np))
    grads = [t.grad.clone() for t in inputs if t is not None]
    for t in inputs:
        if t is not None:
            t.grad = None
    want = mn.modnorm_train(*inputs, stats="batch", lrelu=lrelu)
    want[0].backward(nchw(g_np))
    for a, b in zip(got, want):
        _close(a.detach(), b.detach(), "forward")
    for a, t in zip(grads, [t for t in inputs if t is not None]):
        _close(a, t.grad, "gradient")
