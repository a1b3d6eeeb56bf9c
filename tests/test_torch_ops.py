"""deepsee_torch.ops against deepsee_tpu.ops on the same numpy inputs.

Tolerances: resampling matrices are the same numpy code (exact); nearest
resizes and one-hot are gathers (exact); the matrix resizes and the float32
norms sum in another order than XLA (1e-6 absolute on values of order 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.ops import norms as jnorms
from deepsee_tpu.ops import preprocess as jpre
from deepsee_tpu.ops import resize as jresize
from deepsee_torch.ops import norms as tnorms
from deepsee_torch.ops import preprocess as tpre
from deepsee_torch.ops import resize as tresize


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("method,antialias", [
    ("nearest", False), ("nearest_pil", False), ("bilinear", False),
    ("bicubic", False), ("bicubic_pil", True), ("box", True)])
@pytest.mark.parametrize("sizes", [(256, 32), (32, 64), (37, 16)])
def test_resize_matrix_equals_jax(method, antialias, sizes):
    got = tresize.resize_matrix(*sizes, method, antialias)
    want = jresize.resize_matrix(*sizes, method, antialias)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_hw,out_hw", [((32, 32), (8, 8)), ((16, 16), (64, 64)),
                                          ((32, 32), (32, 16))])
def test_nearest_resize_is_exact(in_hw, out_hw):
    rng = np.random.RandomState(0)
    seg = np.eye(19, dtype=np.float32)[rng.randint(0, 19, (2,) + in_hw)]
    got = tresize.resize2d(_nchw(seg), out_hw, method="nearest")
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = jresize.resize2d(jnp.asarray(seg), out_hw, method="nearest")
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("method,antialias,out_hw", [
    ("bicubic", False, (8, 8)), ("bicubic", False, (48, 40)),
    ("bicubic_pil", True, (8, 8)), ("bilinear", False, (12, 20))])
def test_resize2d_matches_jax(method, antialias, out_hw):
    x = np.random.RandomState(1).randn(2, 32, 24, 3).astype(np.float32)
    got = tresize.resize2d(_nchw(x), out_hw, method=method, antialias=antialias)
    want = jresize.resize2d(jnp.asarray(x), out_hw, method=method, antialias=antialias)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-6)


def test_upsample_nearest_2x_is_exact():
    x = np.random.RandomState(2).randn(2, 5, 7, 8).astype(np.float32)
    got = tresize.upsample_nearest_2x(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got),
                                  np.asarray(jresize.upsample_nearest_2x(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(2, 16, 16), (2, 16, 16, 1)])
def test_one_hot_label_matches_jax(shape):
    label = np.random.RandomState(3).randint(0, 19, shape).astype(np.int32)
    label.reshape(-1)[:5] = 255  # out of range -> all-zero rows
    got = tpre.one_hot_label(torch.from_numpy(label), 19)
    want = jpre.one_hot_label(jnp.asarray(label), 19)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hr,lr", [(256, 32), (64, 8), (32, 16)])
def test_downsample_image_matches_jax(hr, lr):
    img = np.tanh(1.5 * np.random.RandomState(4).randn(2, hr, hr, 3)).astype(np.float32)
    got = tpre.downsample_image(torch.from_numpy(img), (lr, lr)).numpy()
    want = np.asarray(jpre.downsample_image(jnp.asarray(img), (lr, lr)))
    assert got.shape == (2, lr, lr, 3) and got.min() >= -1.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_instance_norm_matches_jax():
    x = (3.0 + 2.0 * np.random.RandomState(5).randn(2, 8, 8, 16)).astype(np.float32)
    got = tnorms.instance_norm_2d(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(jnorms.instance_norm_2d(jnp.asarray(x))),
                               rtol=0, atol=1e-5)


def test_leaky_relu_matches_jax():
    x = np.random.RandomState(6).randn(4, 33).astype(np.float32)
    np.testing.assert_array_equal(tnorms.leaky_relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnorms.leaky_relu(jnp.asarray(x))))
