"""deepsee_torch.eval.metrics against deepsee_tpu.eval.metrics on the CPU:
the same seeded numpy images through both packages' RMSE, PSNR, MATLAB
SSIM, MS-SSIM, the uint8 conversion and MetricsAccumulator.

Sizes: 64^2 (MS-SSIM's window 11, 11, 11, 8, 4 over its five levels),
32^2 (11, 11, 8, 4, 2) and 33x45 (odd sizes, floored by the pooling).
Tolerances: 1e-5 relative on RMSE, SSIM and MS-SSIM, 1e-4 dB on PSNR (float32 summation order: the port filters by
shifted multiply-adds, JAX by a depthwise convolution); the uint8 values
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.eval import metrics as jm
from deepsee_torch.eval import metrics as tm

SHAPES = [(2, 64, 64, 3), (2, 32, 32, 3), (2, 33, 45, 3)]
RTOL = {"rmse": 1e-5, "ssim": 1e-5, "ms_ssim": 1e-5}
PSNR_ATOL_DB = 1e-4


def _pair(shape, seed=0):
    """A real image and a fake near it (so SSIM and MS-SSIM are well above 0
    and every MS-SSIM contrast term positive), in [-1, 1]."""
    rng = np.random.RandomState(seed)
    real = np.tanh(rng.randn(*shape)).astype(np.float32)
    fake = np.clip(real + 0.15 * rng.randn(*shape), -1, 1).astype(np.float32)
    return fake, real


def _jax_metrics(fake, real):
    f255, r255 = jm.to_uint8_values(fake), jm.to_uint8_values(real)
    return {"rmse": jm.rmse(fake, real), "psnr": jm.psnr(f255, r255),
            "ssim": jm.ssim_matlab(f255, r255),
            "ms_ssim": jm.ms_ssim((fake.astype(jnp.float32) + 1.0) * 127.5,
                                  (real.astype(jnp.float32) + 1.0) * 127.5)}


def _check(got, want):
    for name, value in want.items():
        value = np.asarray(value)
        g = got[name].numpy()
        assert g.dtype == np.float32 and g.shape == value.shape, name
        if name == "psnr":
            np.testing.assert_allclose(g, value, rtol=0, atol=PSNR_ATOL_DB, err_msg=name)
        else:
            np.testing.assert_allclose(g, value, rtol=RTOL[name], atol=0, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_metrics_match_jax(shape):
    fake, real = _pair(shape)
    got = tm.batch_metrics(torch.from_numpy(fake), torch.from_numpy(real))
    _check(got, _jax_metrics(jnp.asarray(fake), jnp.asarray(real)))
    assert np.isfinite(got["ms_ssim"].numpy()).all()
    np.testing.assert_array_equal(tm.to_uint8_values(torch.from_numpy(fake)).numpy(),
                                  np.asarray(jm.to_uint8_values(jnp.asarray(fake))))


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_bf16_fake_is_cast_to_float32_first(shape):
    """Both packages round the same float32 values to bf16 (nearest even)
    and compute in float32 from there."""
    fake, real = _pair(shape, seed=1)
    tfake = torch.from_numpy(fake).bfloat16()
    jfake = jnp.asarray(fake, jnp.bfloat16)
    np.testing.assert_array_equal(tfake.float().numpy(), np.asarray(jfake, np.float32))
    got = tm.batch_metrics(tfake, torch.from_numpy(real))
    _check(got, _jax_metrics(jfake, jnp.asarray(real)))


def test_identical_images():
    """PSNR inf, SSIM and MS-SSIM 1, RMSE 0, in both packages."""
    _, real = _pair(SHAPES[0])
    t = torch.from_numpy(real)
    got = tm.batch_metrics(t, t)
    want = _jax_metrics(jnp.asarray(real), jnp.asarray(real))
    assert np.isinf(got["psnr"].numpy()).all() and np.isinf(np.asarray(want["psnr"])).all()
    for name in ("ssim", "ms_ssim"):
        np.testing.assert_allclose(got[name].numpy(), 1.0, rtol=1e-6)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-6)
    assert (got["rmse"].numpy() == 0).all()


def test_the_two_255_maps_differ():
    """PSNR and SSIM read the truncated uint8 levels, MS-SSIM the untruncated
    (x + 1) * 127.5: on a dark image, a fake 0.8 levels above the real one
    has the same levels (PSNR inf, SSIM 1) but an MS-SSIM clearly below 1."""
    levels = np.random.RandomState(0).randint(0, 6, SHAPES[0]).astype(np.float32)
    real = ((levels + 0.1) / 127.5 - 1.0).astype(np.float32)
    fake = ((levels + 0.9) / 127.5 - 1.0).astype(np.float32)
    got = tm.batch_metrics(torch.from_numpy(fake), torch.from_numpy(real))
    want = _jax_metrics(jnp.asarray(fake), jnp.asarray(real))
    assert np.isinf(got["psnr"].numpy()).all()
    np.testing.assert_allclose(got["ssim"].numpy(), 1.0, rtol=1e-6)
    assert (got["ms_ssim"].numpy() < 0.99).all()
    _check(got, want)


def test_negative_contrast_gives_nan_as_the_reference():
    """An anti-correlated fake makes an MS-SSIM contrast term negative; a
    negative base to a fractional power is NaN in both packages."""
    _, real = _pair(SHAPES[0])
    fake = -real
    got = tm.batch_metrics(torch.from_numpy(fake), torch.from_numpy(real))["ms_ssim"].numpy()
    want = np.asarray(_jax_metrics(jnp.asarray(fake), jnp.asarray(real))["ms_ssim"])
    assert np.isnan(want).all() and np.isnan(got).all()


def test_accumulator_matches_jax():
    jacc, tacc = jm.MetricsAccumulator(), tm.MetricsAccumulator()
    for seed, shape in enumerate(SHAPES[:2]):
        fake, real = _pair(shape, seed)
        jacc.add_batch(jnp.asarray(fake), jnp.asarray(real))
        tacc.add_batch(torch.from_numpy(fake), torch.from_numpy(real))
    tacc.add("lpips", torch.tensor([0.5, 0.25]))
    jacc.add("lpips", np.array([0.5, 0.25], np.float32))
    got, want = tacc.result(), jacc.result()
    assert list(got) == list(want) and got["n_samples"] == want["n_samples"] == 4
    for key, value in want.items():
        name = key.split("/")[0]
        # a std's error is bounded by the samples' errors, 1e-5 of the mean
        tol = PSNR_ATOL_DB if name == "psnr" else 1e-5 * abs(want.get(f"{name}/mean", value))
        assert abs(got[key] - value) <= tol, (key, got[key], value)
