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

int8 inference on stripes (the JAX package runs `_int8_conv` under its
spatial mesh and holds it to one device, tests/test_int8_inference.py:191-243):
the tiny system under int8_inference(min_ch=8), smooth and not, against one
process on each data rank's rows (mean |error| < 5e-3, max < 0.08, or twice
one process's own spread under a one-ulp nudge, whichever is larger; the
model ranks bit for bit alike), and at 1 x 2 against the JAX package's
one-device int8 fake of the same weights and batch (5e-3 / 0.08).  Every
striped conv's s_c, s_k, s_x and k_q, teacher-forced, are one process's
quantization of the conv's gathered input bit for bit: a MAX all-reduce
makes the stripes' maxima the whole map's.  Without it (the planted fault),
they are not.  The "nospade" generator (reflection-padded blocks) in eval
mode on stripes against the JAX package's on one device.
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
from deepsee_tpu.models import generator as jgen
from deepsee_tpu.models import layers as jl
from deepsee_tpu.system import SRSystem as JaxSystem
from deepsee_torch.models import generator as tgen
from deepsee_torch.system import SRSystem
from test_torch_layers import load, realistic_variables
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = {"1x2": 2, "2x2": 4}
RTOL, ATOL = 1e-4, 1e-5
# int8 against one device: the JAX package's mesh test's tolerances
INT8_MEAN_ABS, INT8_MAX_ABS = 5e-3, 0.08
INT8_NOISE = 2.0        # times one process's own spread under a one-ulp nudge
NOSPADE_BATCH = 2


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

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    fake, style, _ = infer(g, e, jbatch)
    int8_fake = None
    if name == "tiny":
        with jl.int8_inference(min_ch=worker.SP_INT8_MIN_CH):
            int8_fake = np.asarray(jax.jit(lambda g, e, bt: system.generate(
                g, e, system.preprocess(bt), use_full=False, no_noise=True, train=False)[0])(
                    g, e, jbatch))
    port = SRSystem(worker.sp_infer_exp(name), device="cpu")
    port.load_jax_variables(g, e)
    weights = {net: m.state_dict() for net, m in port.networks().items()}
    for layout in LAYOUTS:
        torch.save({"weights": weights, "batch": batch}, f"{tmp}/{layout}/infer_{name}.pt")
    return np.asarray(fake), np.asarray(style), weights, batch, int8_fake


def _nospade_reference(tmp):
    """The JAX package's tiny "nospade" generator on one device (eval mode,
    realistic weights) and its inputs; the port's weights and the inputs
    for the ranks."""
    cfg = jax_tiny().model
    rng = np.random.RandomState(5)
    b, s, c = NOSPADE_BATCH, cfg.start_size, cfg.crop_size
    inputs = {"lr": np.tanh(rng.randn(b, s, s, 3)).astype(np.float32),
              "seg": np.eye(cfg.semantic_nc, dtype=np.float32)[
                  rng.randint(0, cfg.semantic_nc, (b, c, c))],
              "style": np.tanh(rng.randn(b, cfg.label_nc, cfg.regional_style_size)
                               ).astype(np.float32)}
    args = tuple(jnp.asarray(inputs[k]) for k in ("lr", "seg", "style"))
    jmod = jgen.DeepSEEGenerator(cfg, variant="nospade")
    init = jmod.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                     *args, train=True)
    v = realistic_variables(init, 9)
    want = np.asarray(jmod.apply(v, *args, train=False))
    weights = load(tgen.DeepSEEGenerator(worker.tiny_test_experiment().model,
                                         variant="nospade"), v).state_dict()
    for layout in LAYOUTS:
        torch.save({"weights": weights, "inputs": inputs}, f"{tmp}/{layout}/nospade.pt")
    return want


@functools.cache
def _runs(tmp):
    for layout in LAYOUTS:
        os.makedirs(f"{tmp}/{layout}")
    want = {name: _reference(name, tmp) for name in worker.SP_INFER_CONFIGS}
    want["nospade"] = _nospade_reference(tmp)
    spawned = {layout: worker.Spawned(f"{tmp}/{layout}", ["sp_infer"], world=world)
               for layout, world in LAYOUTS.items()}
    one = {name: worker.sp_infer_run(name, *want[name][2:4]) for name in worker.SP_INFER_CONFIGS}
    one["int8"] = _int8_one_process(*want["tiny"][2:4])
    return want, one, {layout: [r["sp_infer"] for r in s.results(timeout=240.0)[0]]
                       for layout, s in spawned.items()}


def _int8_one_process(weights, batch):
    """(layout, mode) -> one process's int8 fake on each data rank's rows of
    the layout, put together, and the same with the weights nudged by one
    ulp."""
    out = {}
    for layout, world in LAYOUTS.items():
        data = world // 2
        for mode in worker.SP_INT8_MODES:
            out[(layout, mode)] = [torch.cat([worker.sp_int8_run(
                weights, worker.rows(batch, d, data), mode, nudge_seed=seed)["fake"]
                for d in range(data)]) for seed in (None, 31)]
    return out


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


def _int8_limits(one, nudged):
    spread = (nudged - one).abs()
    return (max(INT8_MEAN_ABS, INT8_NOISE * float(spread.mean())),
            max(INT8_MAX_ABS, INT8_NOISE * float(spread.max())))


@pytest.mark.parametrize("mode", worker.SP_INT8_MODES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_striped_int8_matches_one_process(runs, layout, mode):
    """The fakes of the model ranks of each data rank bit for bit alike, and
    within the int8 limits of one process on the data rank's rows; one MAX
    all-reduce per quantized conv, as many quantized convs as one process
    runs, and int8 halos."""
    _, one, ranks = runs
    want, nudged = one["int8"][(layout, mode)]
    got = [r[f"int8_{mode}"] for r in ranks[layout]]
    for a, b in zip(got[::2], got[1::2]):
        assert torch.equal(a["fake"], b["fake"])
    fake = torch.cat([g["fake"] for g in got[::2]])
    err = (fake - want).abs()
    mean_limit, max_limit = _int8_limits(want, nudged)
    assert float(err.mean()) < mean_limit and float(err.max()) < max_limit, \
        (float(err.mean()), float(err.max()), mean_limit, max_limit)
    n = worker.sp_int8_run(*runs[0]["tiny"][2:4], mode)["quantized_convs"]
    for g in got:
        assert g["quantized_convs"] == n > 0
        assert g["collectives"]["max"]["calls"] == n
        assert g["collectives"]["halo"]["calls"] > 0


def test_striped_int8_matches_jax(runs):
    """1 x 2 on the JAX package's variables against its one-device int8
    fake of the same batch, at the JAX mesh test's tolerances."""
    want, _, ranks = runs
    got = ranks["1x2"][0]["int8_smooth"]["fake"].numpy()
    jax_fake = want["tiny"][4]
    assert got.shape == jax_fake.shape
    err = np.abs(got - jax_fake)
    assert float(err.mean()) < INT8_MEAN_ABS and float(err.max()) < INT8_MAX_ABS, \
        (float(err.mean()), float(err.max()))


def _scales_equal(call):
    return {k: bool(torch.equal(call["got"][k], call["want"][k]))
            for k in ("s_c", "s_k", "s_x", "k_q")}


@pytest.mark.parametrize("mode", worker.SP_INT8_MODES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_striped_int8_scales_are_one_process(runs, layout, mode):
    """Teacher-forced: every striped conv's s_c, s_k, s_x and k_q on every
    rank, bit for bit one process's quantization of the conv's input
    gathered over the model group."""
    _, _, ranks = runs
    for r, rank in enumerate(ranks[layout]):
        calls = rank[f"int8_{mode}"]["scales"]
        assert calls and len(calls) == rank[f"int8_{mode}"]["quantized_convs"]
        for i, call in enumerate(calls):
            assert all(_scales_equal(call).values()), (r, i, _scales_equal(call))


def test_planted_stripe_maxima_break_the_scales(runs):
    """Without the MAX all-reduce each stripe quantizes with its own maxima:
    the check above fails on most convs."""
    _, _, ranks = runs
    calls = ranks["1x2"][0][f"int8_{worker.SP_INT8_PLANTED}"]["scales"]
    wrong = sum(not all(_scales_equal(c).values()) for c in calls)
    assert wrong > len(calls) // 2, (wrong, len(calls))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_nospade_generator_on_stripes_matches_jax(runs, layout):
    """The "nospade" generator in eval mode on stripes (reflect halos, K1's
    instance split) against the JAX package's on one device."""
    want, _, ranks = runs
    got = np.concatenate([r["nospade"]["fake"].numpy() for r in ranks[layout][::2]])
    assert float(np.std(want["nospade"])) > 0.05
    np.testing.assert_allclose(got, want["nospade"], rtol=RTOL, atol=ATOL)
    for a, b in zip(ranks[layout][::2], ranks[layout][1::2]):
        assert torch.equal(a["nospade"]["fake"], b["nospade"]["fake"])
