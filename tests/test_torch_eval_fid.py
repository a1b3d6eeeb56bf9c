"""deepsee_torch.eval.fid against deepsee_tpu.eval.fid on the CPU.

* The Inception: random parameters (batch norms included), written by the
  test as a pt_inception-format state dict (with its `fc` head and torch's
  `num_batches_tracked`), read by both loaders (strictly in the port) and
  carried by weights.inception_jax_to_state_dict; pool3 of two 32^2 images
  (resized to 299 inside) within 1e-4 relative L2.
* The state-dict keys are pt_inception's for every entry of `_conv_specs`.
* The FID statistics: the port's copies against the JAX module's on the
  same activations at D = 64, both routes (n < D: the Gram route; n > D:
  the covariance route) and method="scipy", within 1e-9 relative (the same
  float64 numpy and scipy calls).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.eval import fid as jf
from deepsee_torch.eval import fid as tf
from deepsee_torch.weights import inception_jax_to_state_dict

_BN = ("weight", "bias", "running_mean", "running_var")


def _jax_params(seed=0):
    """Random JAX-layout Inception parameters with nontrivial batch norms."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, cin, cout, k, _, _ in jf._conv_specs():
        params[name] = {
            "kernel": (rng.randn(k[0], k[1], cin, cout) * np.sqrt(2.0 / (cin * k[0] * k[1]))
                       ).astype(np.float32),
            "bn_scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
            "bn_bias": (0.1 * rng.randn(cout)).astype(np.float32),
            "bn_mean": (0.1 * rng.randn(cout)).astype(np.float32),
            "bn_var": rng.uniform(0.5, 2.0, cout).astype(np.float32),
        }
    return params


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    """The random parameters as a pt_inception-2015-12-05-format file."""
    params = _jax_params()
    sd = dict(inception_jax_to_state_dict(params))
    for name in params:
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    path = str(tmp_path_factory.mktemp("inception") / "pt_inception.pth")
    torch.save(sd, path)
    return path, params


def test_state_dict_keys_are_pt_inceptions():
    want = {f"{name}.{part}" for name, *_ in jf._conv_specs()
            for part in ["conv.weight"] + [f"bn.{k}" for k in _BN]}
    assert set(tf.FIDInception().state_dict()) == want
    assert [s[:4] for s in tf._conv_specs()] == [s[:4] for s in jf._conv_specs()]


def test_pool3_matches_jax(weights_file):
    path, params = weights_file
    jparams, jexact = jf.load_inception_params(path)
    module, exact = tf.load_inception(path, device="cpu")
    assert exact and jexact and not module.training
    carried = tf.FIDInception()
    carried.load_state_dict(inception_jax_to_state_dict(params), strict=True)
    for key, value in carried.state_dict().items():
        torch.testing.assert_close(module.state_dict()[key], value, rtol=0, atol=0)
    x = np.tanh(np.random.RandomState(1).randn(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jf.inception_pool3(jparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = tf.inception_pool3(module, torch.from_numpy(x)).numpy()
    assert got.shape == (2, tf.POOL3_DIM) and got.dtype == np.float32
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    assert float(want.std()) > 0.01  # not a degenerate comparison


def test_port_fallback_is_seeded():
    m0, exact = tf.load_inception(seed=0, device="cpu")
    m1, _ = tf.load_inception(seed=0, device="cpu")
    assert not exact
    for key, value in m0.state_dict().items():
        torch.testing.assert_close(m1.state_dict()[key], value, rtol=0, atol=0)
    w = m0.Mixed_7c.branch_pool.conv.weight
    assert abs(float(w.std()) - (2.0 / 2048) ** 0.5) < 0.002
    assert float(m0.Mixed_7c.branch_pool.bn.running_var.min()) == 1.0


def _acts(n, seed, dim=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, dim) @ rng.randn(dim, dim) / 8.0 + rng.randn(dim)).astype(np.float32)


@pytest.mark.parametrize("n_fake,n_real", [(20, 24), (100, 120), (20, 120)])
@pytest.mark.parametrize("method", ["fast", "scipy"])
def test_fid_statistics_match_jax(n_fake, n_real, method):
    a, b = _acts(n_fake, 0), _acts(n_real, 1)
    got = tf.fid_from_activations(a, b, method=method)
    want = jf.fid_from_activations(a, b, method=method)
    assert got == pytest.approx(want, rel=1e-9) and got > 0
    for x in (a, b):
        for g, w in zip(tf.calculate_statistics(x), jf.calculate_statistics(x)):
            np.testing.assert_array_equal(g, w)
    mu1, s1 = tf.calculate_statistics(a)
    mu2, s2 = tf.calculate_statistics(b)
    assert tf.frechet_distance(mu1, s1, mu2, s2, method=method) == pytest.approx(
        jf.frechet_distance(mu1, s1, mu2, s2, method=method), rel=1e-9)
