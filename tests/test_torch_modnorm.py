"""The modnorm epilogue: its plain version against the JAX package's norm +
modulation line, and the CPU routing of the wrapper.  The kernel itself is
held against the plain version on the card by tests/test_torch_kernels.py,
which imports no JAX package so that it runs where flax is not installed.

JAX side: ParamFreeNorm (normalization.py:163-176) with random running
stats or instance_norm_2d, then `normalized * mod[..., :C] + mod[..., C:]`
(normalization.py:212,310) and leaky_relu (blocks.py:67,72).
Tolerance on CPU: 1e-5 absolute, float32 summation order (instance stats).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.models.normalization import ParamFreeNorm as JaxParamFreeNorm
from deepsee_tpu.ops.norms import leaky_relu as jax_leaky_relu
from deepsee_torch.ops import modnorm as mn

B, C, H, W = 2, 16, 8, 8


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _inputs(seed: int = 0):
    rng = np.random.RandomState(seed)
    x = (0.7 + 1.5 * rng.randn(B, H, W, C)).astype(np.float32)
    mod = rng.randn(B, H, W, 2 * C).astype(np.float32)
    mean = (0.5 * rng.randn(C)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, C).astype(np.float32)
    return x, mod, mean, var


def _jax_reference(x, mod, mean, var, stats, lrelu):
    kind = "syncbatch" if stats == "affine" else "instance"
    pfn = JaxParamFreeNorm(C, kind)
    variables = ({"batch_stats": {"param_free_norm": {"mean": mean, "var": var}}}
                 if stats == "affine" else {})
    y = pfn.apply(variables, jnp.asarray(x), train=False)
    if mod is not None:
        y = y * mod[..., :C] + mod[..., C:]
    return np.asarray(jax_leaky_relu(y) if lrelu else y)


@pytest.mark.parametrize("stats", ["affine", "instance"])
@pytest.mark.parametrize("with_mod", [False, True])
@pytest.mark.parametrize("lrelu", [False, True])
def test_modnorm_plain_matches_jax(stats, with_mod, lrelu):
    x, mod, mean, var = _inputs()
    mod = mod if with_mod else None
    got = mn.modnorm_plain(_nchw(x), None if mod is None else _nchw(mod), stats=stats,
                           mean=torch.from_numpy(mean), var=torch.from_numpy(var),
                           lrelu=lrelu)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = _jax_reference(x, mod, mean, var, stats, lrelu)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("stats", ["affine", "instance"])
def test_wrapper_takes_plain_version_on_cpu(stats):
    x, mod, mean, var = _inputs(1)
    kw = dict(stats=stats, mean=torch.from_numpy(mean), var=torch.from_numpy(var),
              lrelu=True)
    before = dict(mn.launches)
    got = mn.modnorm(_nchw(x), _nchw(mod), **kw)
    assert mn.launches == before  # nothing launched
    torch.testing.assert_close(got, mn.modnorm_plain(_nchw(x), _nchw(mod), **kw),
                               rtol=0, atol=0)


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(1, 8, 2, 2)
    with pytest.raises(ValueError):
        mn.modnorm(x, stats="batch")
    with pytest.raises(ValueError):
        mn.modnorm(x, stats="affine")  # running stats missing
