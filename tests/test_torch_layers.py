"""deepsee_torch.models.layers and the encoder trunks against deepsee_tpu,
each loaded through the weight bridge from JAX-initialized variables.

`realistic_variables` (also used by the other test_torch_* files) makes the
JAX init nontrivial: it perturbs every parameter, draws random running
statistics, and sets each spectral u/v to the weight's top singular pair
(as training would leave them), so sigma is the true spectral norm and the
activations stay of order 1 instead of saturating.

Tolerances are float32 summation-order differences between XLA:CPU and
torch's CPU convs: 1e-5 absolute on outputs of order 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.models import encoder as jenc
from deepsee_tpu.models import layers as jlayers
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.models import encoder as tenc
from deepsee_torch.models import layers as tlayers
from deepsee_torch.weights import jax_to_state_dict


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat):
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def realistic_variables(variables, seed: int, scale: float = 0.05) -> dict:
    """JAX variables -> numpy trees with perturbed params, random running
    stats and spectral u/v set to the top singular pair of each kernel."""
    rng = np.random.RandomState(seed)
    params = {p: np.asarray(v) + scale * rng.randn(*np.shape(v))
              for p, v in _flatten(dict(variables.get("params", {}))).items()}
    out = {"params": _unflatten({p: v.astype(np.float32) for p, v in params.items()})}
    if "batch_stats" in variables:
        out["batch_stats"] = _unflatten({
            p: (0.5 * rng.randn(*np.shape(v)) if p[-1] == "mean"
                else rng.uniform(0.5, 2.0, np.shape(v))).astype(np.float32)
            for p, v in _flatten(dict(variables["batch_stats"])).items()})
    if "spectral" in variables:
        spectral = {}
        for p in _flatten(dict(variables["spectral"])):
            kernel = params[p[:-1] + ("kernel",)]
            u, _, vt = np.linalg.svd(kernel.reshape(-1, kernel.shape[-1]).T)
            spectral[p] = (u[:, 0] if p[-1] == "u" else vt[0]).astype(np.float32)
        out["spectral"] = _unflatten(spectral)
    return out


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def load(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    module.load_state_dict(jax_to_state_dict(variables), strict=True)
    return module.eval()


@pytest.mark.parametrize("spectral", [False, True])
@pytest.mark.parametrize("stride,ks", [(1, 3), (2, 3), (1, 1)])
def test_conv2d_matches_jax(spectral, stride, ks):
    x = np.random.RandomState(0).randn(2, 8, 8, 6).astype(np.float32)
    pad = ks // 2
    jmod = jlayers.Conv2d(16, (ks, ks), (stride, stride), (pad, pad), spectral=spectral)
    v = realistic_variables(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = jmod.apply(v, jnp.asarray(x), train=False)
    port = load(tlayers.Conv2d(6, 16, ks, stride, pad, spectral=spectral), v)
    got = port(nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got.detach()), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("affine", [False, True])
def test_torch_batch_norm_eval_matches_jax(affine):
    x = (1.0 + np.random.RandomState(2).randn(2, 4, 4, 8)).astype(np.float32)
    jmod = jlayers.TorchBatchNorm(8, affine=affine)
    v = realistic_variables(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 3)
    want = jmod.apply(v, jnp.asarray(x), train=False)
    port = load(tlayers.TorchBatchNorm(8, affine=affine), v)
    np.testing.assert_allclose(nhwc(port(nchw(x)).detach()), np.asarray(want),
                               rtol=0, atol=1e-5)
    # eval mode leaves the running statistics as they are
    np.testing.assert_array_equal(port.running_mean.numpy(),
                                  np.asarray(v["batch_stats"]["mean"]))


def test_spectral_conv_refuses_training_mode():
    """A training-mode forward (power iteration, batch statistics) refuses
    to run under torch.inference_mode, whose tensors autograd cannot save;
    under torch.no_grad it runs and updates u and v."""
    conv = tlayers.Conv2d(4, 4, spectral=True)
    conv.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(1, 4, 4, 4).contiguous(memory_format=torch.channels_last)
    u = conv.weight_u.clone()
    with torch.inference_mode(), pytest.raises(RuntimeError, match="inference_mode"):
        conv(x)
    torch.testing.assert_close(conv.weight_u, u, rtol=0, atol=0)
    with torch.no_grad():
        conv(x)
    assert not torch.equal(conv.weight_u, u)


@pytest.mark.parametrize("trunk", ["mini", "full"])
@pytest.mark.parametrize("norm_e", ["spectralinstance", "spectralbatch", "none"])
def test_encoder_trunk_matches_jax(trunk, norm_e):
    """NonSpadeNormConv inside the trunks, so the keys run through the
    bridge's trunk rules; instance norm goes through modnorm's plain path."""
    jexp, texp = jax_tiny(), torch_tiny()
    jcfg = dataclasses.replace(jexp.model, norm_e=norm_e)
    tcfg = dataclasses.replace(texp.model, norm_e=norm_e)
    x = np.random.RandomState(4).randn(2, 16, 16, 3).astype(np.float32)
    jmod = {"mini": jenc.MiniTrunk, "full": jenc.FullTrunk}[trunk](jcfg)
    v = realistic_variables(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 5)
    want = jmod.apply(v, jnp.asarray(x), train=False)
    port = load({"mini": tenc.MiniTrunk, "full": tenc.FullTrunk}[trunk](tcfg), v)
    got = port(nchw(x))
    assert got.shape == (2, 8 * tcfg.nef) + tuple(want.shape[1:3])
    np.testing.assert_allclose(nhwc(got.detach()), np.asarray(want), rtol=0, atol=1e-5)
