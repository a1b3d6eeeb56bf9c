"""deepsee_torch.eval.lpips against deepsee_tpu.eval.lpips on the CPU, at
64^2: the JAX package's random fallback parameters carried across by
weights.lpips_jax_to_state_dict, and torchvision-format AlexNet and
v0.1-format lin files written by the test, read by both packages' loaders
(strict in the port), with the `exact` flag of each case.  Tolerance: 1e-5
relative on the per-sample distance (float32 convs, summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.eval import lpips as jl
from deepsee_torch.eval import lpips as tl
from deepsee_torch.weights import lpips_jax_to_state_dict

RTOL = 1e-5


def _images(seed=0, shape=(2, 64, 64, 3)):
    rng = np.random.RandomState(seed)
    a = np.tanh(rng.randn(*shape)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(*shape), -1, 1).astype(np.float32)
    return a, b


def _port(img0, img1, module):
    with torch.inference_mode():
        return module(torch.from_numpy(img0), torch.from_numpy(img1)).numpy()


def test_lpips_matches_jax_with_carried_params():
    params, exact = jl.load_lpips_params(seed=3)
    assert not exact
    module = tl.LPIPS().eval()
    module.load_state_dict(lpips_jax_to_state_dict(params), strict=True)
    a, b = _images()
    want = np.asarray(jl.lpips(params, jnp.asarray(a), jnp.asarray(b)))
    got = _port(a, b, module)
    assert got.dtype == np.float32 and got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(_port(a, a, module), 0.0, atol=1e-7)


def _write_files(tmp_path):
    """A torchvision AlexNet state dict (features and classifier) and the
    reference's lin heads, random."""
    gen = torch.Generator().manual_seed(7)
    alex = {}
    cin = 3
    for n, (cout, k, _, _) in zip((0, 3, 6, 8, 10), tl._ALEX_CONVS):
        alex[f"features.{n}.weight"] = 0.1 * torch.randn(cout, cin, k, k, generator=gen)
        alex[f"features.{n}.bias"] = 0.1 * torch.randn(cout, generator=gen)
        cin = cout
    alex["classifier.1.weight"] = torch.randn(8, 9216, generator=gen)
    alex["classifier.1.bias"] = torch.randn(8, generator=gen)
    lin = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=gen) / c
           for i, (c, _, _, _) in enumerate(tl._ALEX_CONVS)}
    paths = {"alex": str(tmp_path / "alexnet.pth"), "lin": str(tmp_path / "alex_lin.pth")}
    torch.save(alex, paths["alex"])
    torch.save(lin, paths["lin"])
    return paths


@pytest.mark.parametrize("alex,lin", [(False, False), (True, False), (False, True),
                                      (True, True)])
def test_loaders_read_the_same_files(tmp_path, alex, lin):
    paths = _write_files(tmp_path)
    alexnet_path = paths["alex"] if alex else None
    lin_path = paths["lin"] if lin else str(tmp_path / "absent.pth")
    params, jexact = jl.load_lpips_params(lin_path, alexnet_path)
    module, exact = tl.load_lpips(lin_path, alexnet_path, device="cpu")
    assert exact == jexact == (alex and lin)
    assert not module.training and not any(p.requires_grad for p in module.parameters())
    if alex:  # the file's values, strictly loaded
        sd = torch.load(paths["alex"], weights_only=True)
        torch.testing.assert_close(module.net.features[0].weight, sd["features.0.weight"],
                                   rtol=0, atol=0)
    if not alex:  # the random backbones differ between the packages: carry JAX's
        module.load_state_dict(lpips_jax_to_state_dict(params), strict=True)
    a, b = _images(seed=1)
    np.testing.assert_allclose(_port(a, b, module),
                               np.asarray(jl.lpips(params, jnp.asarray(a), jnp.asarray(b))),
                               rtol=RTOL, atol=0)


def test_port_fallback_is_seeded():
    """He-normal convs with zero biases and uniform 1/C heads, the same for
    the same seed."""
    m0, exact = tl.load_lpips(seed=0, device="cpu")
    m1, _ = tl.load_lpips(seed=0, device="cpu")
    m2, _ = tl.load_lpips(seed=1, device="cpu")
    assert not exact
    w0 = m0.net.features[0].weight
    torch.testing.assert_close(m1.net.features[0].weight, w0, rtol=0, atol=0)
    assert not torch.equal(m2.net.features[0].weight, w0)
    assert abs(float(w0.std()) - (2.0 / (3 * 11 * 11)) ** 0.5) < 0.02
    assert float(m0.net.features[0].bias.abs().max()) == 0.0
    torch.testing.assert_close(m0.lin4.model[1].weight, torch.full((1, 256, 1, 1), 1 / 256))
    assert set(m0.state_dict()) == set(lpips_jax_to_state_dict(jl.load_lpips_params()[0]))
