"""Spatial sharding at inference against the JAX package on one device,
float32 on the CPU: the port's preprocess -> style encode (mini trunk) ->
generate, no noise, on gloo ranks in processes of their own
(tests/_torch_dist_worker.py, task "sp_infer"), laid out 1 x 2 and 2 x 2
(data x model, "spatial"): each data rank its rows of the batch, each model
rank its stripe of H, the fakes gathered.  Held against the JAX package's
single-device jit at its own spatial tests' tolerances (rtol 1e-4, atol
1e-5): the tiny configuration of tests/test_spatial_sharding.py (batch 4)
and the 32x PureSEAN tail with the fm-cap quirk of
tests/test_512_spatial.py (crop 128, max_fm_size 32, batch 2), with the
JAX init made nontrivial (test_torch_layers.realistic_variables: the bare
init saturates every pixel at +-1, which any layout matches).  The style
matrix, whole on every rank, within 1e-6.  Each planted fault (zero halos,
statistics per stripe) breaks the tiny configuration's match.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from deepsee_tpu.config import DataConfig, Experiment, ModelConfig, TrainConfig
from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_torch.system import SRSystem
from test_torch_layers import realistic_variables
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = {"1x2": 2, "2x2": 4}
RTOL, ATOL = 1e-4, 1e-5


def _jax_exp(name):
    if name == "tiny":
        return jax_tiny().replace(is_train=False)
    cfg = ModelConfig(start_size=8, crop_size=128, load_size=512, ngf=2, nef=2,
                      regional_style_size=128, max_fm_size=32, add_noise=False,
                      compute_dtype="float32")
    return Experiment(name="t512sp", model=cfg, train=TrainConfig(batch_size=2),
                      data=DataConfig(), is_train=False)


def _batch(cfg, b):
    rng = np.random.RandomState(0)
    return {"image_hr": np.tanh(rng.randn(b, cfg.crop_size, cfg.crop_size, 3)).astype(np.float32),
            "label": rng.randint(0, cfg.label_nc, (b, cfg.crop_size, cfg.crop_size)
                                 ).astype(np.int32)}


def _reference(name, tmp):
    """The JAX package's fake and style; the weights and batch for the ranks."""
    exp = _jax_exp(name)
    system = JaxSystem(exp)
    variables = system.init(jax.random.PRNGKey(0))
    g, e = realistic_variables(variables.g, 1), realistic_variables(variables.e, 2)
    batch = _batch(exp.model, 4 if name == "tiny" else 2)

    @jax.jit
    def infer(g, e, bt):
        pre = system.preprocess(bt)
        return system.generate(g, e, pre, use_full=False, no_noise=True, train=False)

    fake, style, _ = infer(g, e, {k: jnp.asarray(v) for k, v in batch.items()})
    port = SRSystem(worker.sp_infer_exp(name), device="cpu")
    port.load_jax_variables(g, e)
    weights = {net: m.state_dict() for net, m in port.networks().items()}
    for layout in LAYOUTS:
        torch.save({"weights": weights, "batch": batch}, f"{tmp}/{layout}/infer_{name}.pt")
    return np.asarray(fake), np.asarray(style), weights, batch


@functools.cache
def _runs(tmp):
    for layout in LAYOUTS:
        os.makedirs(f"{tmp}/{layout}")
    want = {name: _reference(name, tmp) for name in worker.SP_INFER_CONFIGS}
    spawned = {layout: worker.Spawned(f"{tmp}/{layout}", ["sp_infer"], world=world)
               for layout, world in LAYOUTS.items()}
    one = {name: worker.sp_infer_run(name, w, b) for name, (_, _, w, b) in want.items()}
    return want, one, {layout: [r["sp_infer"] for r in s.results(timeout=240.0)[0]]
                       for layout, s in spawned.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("sp_infer")))


def _fakes(ranks, key):
    """The data ranks' fakes in row order (the first model rank of each)."""
    return np.concatenate([r[key]["fake"].numpy() for r in ranks[::2]])


@pytest.mark.parametrize("name", worker.SP_INFER_CONFIGS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_striped_inference_matches_jax(runs, layout, name):
    want, _, ranks = runs
    fake, style = want[name][:2]
    np.testing.assert_allclose(_fakes(ranks[layout], name), fake, rtol=RTOL, atol=ATOL)
    for r, rank in enumerate(ranks[layout]):
        n = rank[name]["style"].shape[0]
        np.testing.assert_allclose(rank[name]["style"].numpy(), style[r // 2 * n:(r // 2 + 1) * n],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", worker.SP_INFER_CONFIGS)
def test_one_process_port_matches_jax(runs, name):
    want, one, _ = runs
    np.testing.assert_allclose(one[name]["fake"].numpy(), want[name][0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_model_ranks_hold_the_same_whole_image(runs, layout):
    _, _, ranks = runs
    for a, b in zip(ranks[layout][::2], ranks[layout][1::2]):
        assert torch.equal(a["tiny"]["fake"], b["tiny"]["fake"])
        assert torch.equal(a["tiny"]["style"], b["tiny"]["style"])


@pytest.mark.parametrize("fault", worker.SP_PLANTED)
def test_planted_faults_break_the_match(runs, fault):
    want, _, ranks = runs
    got = _fakes(ranks["1x2"], f"tiny_{fault}")
    assert np.abs(got - want["tiny"][0]).max() > 10 * (ATOL + RTOL * np.abs(want["tiny"][0]).max())
