"""Tensor parallelism's pieces on 2 gloo ranks of the port alone
(tests/_torch_dist_worker.py, one torch thread each), float32 on the CPU,
against the same functions in one process:

  * a spectral conv pair, column- then row-sharded (the Megatron pair of
    deepsee_tpu/parallel/mesh.py:148-156): the output, the gradients of x,
    of both weights and biases (gathered), and sigma's power iteration: u
    and v full and equal on every rank;
  * a train-mode SEANBlock (batch statistics) with its four modulation
    convs column-sharded, each rank folding its own [gamma_l | beta_l],
    on the block input as norm_0 takes it (replicated) and on a channel
    block with mlp_shared column-sharded too, as norm_1 takes it: the
    output, the gradients of x, the style and every parameter (the alphas
    summed over the model group), the running statistics;
  * the eval-mode generator and encoder of the tiny model laid out 1 x 2
    (K1's affine and instance modes on channel blocks): the fake and the
    style;
  * int8 inference under that layout (below): the tiny system against one
    process and, holding the JAX package's weights, against the JAX
    package's one-device int8 output; a column- and a row-sharded int8 conv.

Tolerance: 1e-5 relative L2 (the sums run in another order); the ranks
bit for bit alike.
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.models import layers as jl
from deepsee_tpu.system import SRSystem as JaxSystem
from test_torch_layers import realistic_variables
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)
from torch_seeded import batch_for

REL_L2 = 1e-5
RUNS = {"conv_pair": worker.conv_pair_run,
        "sean_norm_0": functools.partial(worker.sean_run, False),
        "sean_norm_1": functools.partial(worker.sean_run, True),
        "eval_generator": worker.eval_generator_run}


@functools.cache
def _jax_system():
    """The JAX package's tiny eval system and its variables: realistic
    values in the init's shapes (`jax.eval_shape`, no JAX init runs)."""
    jsys = JaxSystem(jax_tiny().replace(is_train=False))
    shapes = jax.eval_shape(jsys.init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return jsys, realistic_variables(zeros.g, 1), realistic_variables(zeros.e, 2)


@functools.cache
def _runs(tmp):
    with open(os.path.join(tmp, worker.JAX_VARIABLES), "wb") as f:
        pickle.dump(_jax_system()[1:], f)
    spawned = worker.Spawned(tmp, ["tp_ops"])
    one = {name: run() for name, run in RUNS.items()}
    ranks, _ = spawned.results()
    return [r["tp_ops"] for r in ranks], one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("tp_ops")))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("name", list(RUNS))
def test_shards_match_one_process(runs, name):
    ranks, one = runs
    got, want = dict(_leaves(ranks[0][name])), dict(_leaves(one[name]))
    assert set(got) == set(want)
    for path, value in want.items():
        err = float((got[path].double() - value.double()).norm()
                    / value.double().norm().clamp_min(1e-30))
        assert err <= REL_L2, f"{name}{path}: {err:.2e}"


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_are_bit_identical(runs, name):
    ranks, _ = runs
    for (path, a), (_, b) in zip(_leaves(ranks[0][name]), _leaves(ranks[1][name])):
        assert torch.equal(a, b), f"{name}{path}"


def test_spectral_vectors_moved_and_are_full(runs):
    """u and v after the power iteration: the full vectors (out and
    in * kh * kw), moved from their initial values, equal on both ranks."""
    ranks, one = runs
    assert bool((ranks[0]["conv_pair"]["uv_moved"] > 1e-3).all())
    for (u, v), (u1, v1) in zip(ranks[0]["conv_pair"]["uv"], one["conv_pair"]["uv"]):
        assert u.shape == u1.shape and v.shape == v1.shape
        torch.testing.assert_close(u.norm(), torch.tensor(1.0))
        torch.testing.assert_close(v.norm(), torch.tensor(1.0))


# -- int8 inference under tensor parallelism ------------------------------------
#
# The JAX package holds int8 inference under its mesh to one device
# (tests/test_int8_inference.py:191-243: mean |error| < 5e-3, atol 0.08): the
# dynamic scales are global max-reduces, so sharding must not change which
# scale is picked.  The port's blocks take the whole layer's maxima through
# a MAX all-reduce over the model group (ops/int8conv.py::int8_conv_sharded).
INT8_RUNS = {"int8_generator": worker.int8_generator_run,
             **{f"int8_convs_{m}": functools.partial(worker.int8_convs_run, m)
                for m in worker.INT8_CONV_MODES}}
INT8_MEAN_ABS = 5e-3
INT8_MAX_ABS = 0.08
# the sharded int8 runs against one process's, relative L2: the scales are
# the whole layer's, so only the row convs' sum order differs (4.95e-8 on
# the tiny system; whole-block scales, the fault this holds off, 1e-2)
INT8_CONV_REL_L2 = 1e-6


@functools.cache
def _int8_one_process():
    return {name: run() for name, run in INT8_RUNS.items()}


def _rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


def test_int8_generator_matches_one_process(runs):
    """The tiny system 1 x 2 under int8_inference(min_ch=8) against one
    process under int8: at the JAX mesh test's tolerances, and within
    INT8_CONV_REL_L2; the same convs quantized on each rank as in one
    process."""
    ranks, _ = runs
    want = _int8_one_process()["int8_generator"]
    for rank in ranks:
        got = rank["int8_generator"]
        err = (got["fake"] - want["fake"]).abs()
        assert float(err.mean()) < INT8_MEAN_ABS and float(err.max()) < INT8_MAX_ABS, \
            (float(err.mean()), float(err.max()))
        assert _rel_l2(got["fake"], want["fake"]) <= INT8_CONV_REL_L2
        assert int(got["quantized_convs"]) == int(want["quantized_convs"]) > 0
        assert int(got["max_calls"]) > 0
        assert torch.equal(got["fake"], ranks[0]["int8_generator"]["fake"])


def test_int8_generator_matches_jax(runs):
    """The tiny system 1 x 2 under int8_inference(min_ch=8), holding the
    JAX package's variables (`load_jax_variables`), against the JAX
    package's one-device int8 fake of the same weights and batch, at the
    JAX mesh test's tolerances (the port's float32 is JAX's within 1e-4,
    and the int8 levels that differences of roundoff move stay within
    them)."""
    ranks, _ = runs
    jsys, g, e = _jax_system()

    def fwd(gv, ev, b):
        pre = jsys.preprocess(b)
        return jsys.generate(gv, ev, pre, use_full=False, no_noise=True, train=False)[0]

    batch = batch_for(worker.tiny_test_experiment().model, False, batch=2)
    with jl.int8_inference(min_ch=worker.TP_INT8_MIN_CH):
        want = np.asarray(jax.jit(fwd)(g, e, {k: jnp.asarray(v) for k, v in batch.items()}))
    for rank in ranks:
        got = rank["int8_jax_weights"]["fake"].numpy()
        assert got.shape == want.shape
        assert np.array_equal(got, ranks[0]["int8_jax_weights"]["fake"].numpy())
        err = np.abs(got - want)
        assert float(err.mean()) < INT8_MEAN_ABS and float(err.max()) < INT8_MAX_ABS, \
            (float(err.mean()), float(err.max()))


@pytest.mark.parametrize("mode", worker.INT8_CONV_MODES)
@pytest.mark.parametrize("conv", ["column", "row"])
def test_int8_sharded_conv_scales_are_one_process(runs, conv, mode):
    """A column- and a row-sharded int8 conv: the gathered s_c, s_x, s_k,
    k_q and x_q bit for bit one process's for the whole layer, on both
    ranks."""
    ranks, _ = runs
    want = _int8_one_process()[f"int8_convs_{mode}"][conv]
    for rank in ranks:
        got = rank[f"int8_convs_{mode}"][conv]
        for key in ("s_c", "s_x", "s_k", "k_q", "x_q"):
            assert got[key].shape == want[key].shape, key
            assert torch.equal(got[key], want[key]), f"{conv} {mode} {key}"


@pytest.mark.parametrize("mode", worker.INT8_CONV_MODES)
def test_int8_sharded_convs_match_one_process(runs, mode):
    """Their outputs within 1e-6 relative L2 of one process's (the row
    conv's ranks dequantize their partial products, then sum them), the
    ranks bit for bit alike, and the MAX all-reduces each needs: smoothing,
    the column block's column maxima and the row block's maxima; without
    it, the row block's alone."""
    ranks, _ = runs
    want = _int8_one_process()[f"int8_convs_{mode}"]
    for rank in ranks:
        got = rank[f"int8_convs_{mode}"]
        for key in ("h", "y"):
            err = _rel_l2(got[key], want[key])
            assert err <= INT8_CONV_REL_L2, f"{key}: {err:.2e}"
            assert torch.equal(got[key], ranks[0][f"int8_convs_{mode}"][key])
        assert int(got["max_calls"]) == (2 if mode == "smooth" else 1)


# (quantizes(cin, cout) at each rank's block, the whole layer's shape) per
# (shard, world): one process decides from the whole layer's 64 -> 128
QUANTIZES_CASES = [
    (None, 1, 64, 128, True), (None, 2, 64, 128, True), (None, 2, 32, 128, False),
    ("column", 2, 64, 64, True), ("column", 2, 64, 16, False), ("column", 4, 64, 16, True),
    ("row", 2, 32, 128, True), ("row", 2, 16, 128, False), ("row", 4, 16, 128, True),
    ("column", 2, 32, 64, False),  # the input channels are whole: 32 < 64
]


@pytest.mark.parametrize("shard_, world, cin, cout, want", QUANTIZES_CASES)
def test_quantizes_decides_from_the_whole_layer(monkeypatch, shard_, world, cin, cout, want):
    """`quantizes` at min_ch 64 on a rank's block: a column block's cout and
    a row block's cin count every model rank's, as one process counts them
    (deepsee_tpu/models/layers.py:168-170); a replicated conv its own."""
    from deepsee_torch.models import layers
    from deepsee_torch.parallel import distributed

    monkeypatch.setattr(distributed, "model_world", lambda: world)
    with layers.int8_inference(min_ch=64):
        assert layers.quantizes(False, cin, cout, shard_) is want
        assert layers.quantizes(True, cin, cout, shard_) is False
    assert layers.quantizes(False, cin, cout, shard_) is False
