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
    package's one-device int8 output; a column- and a row-sharded int8 conv;
  * int8 inference laid out 2 x 2 (4 ranks, tasks "tp_int8"): every
    quantized conv's scales, k_q and x_q the global batch's, teacher-forced,
    which a planted fault (the maxima over the model group only) breaks; the
    fake against one process on the whole batch and against the JAX
    package's own mesh program on MeshConfig(2, 2);
  * the evaluator on 2 data ranks under int8 (as `evaluate --multihost
    --int8`, task "eval_int8"): each rank's activation scales its own
    batch's, as the JAX evaluator's processes take them.

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
from torch_jax_mesh import int8_mesh_fake
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
    os.makedirs(os.path.join(tmp, "2x2"))
    for out in (tmp, os.path.join(tmp, "2x2")):
        with open(os.path.join(out, worker.JAX_VARIABLES), "wb") as f:
            pickle.dump(_jax_system()[1:], f)
    spawned = worker.Spawned(tmp, ["eval_int8", "tp_ops"])
    spawned_2x2 = worker.Spawned(os.path.join(tmp, "2x2"), ["tp_int8"], world=4)
    one = {name: run() for name, run in RUNS.items()}
    ranks, _ = spawned.results()
    return [r["tp_ops"] for r in ranks], one, [r["eval_int8"] for r in ranks], spawned_2x2


@functools.cache
def _runs_2x2(tmp):
    """The 2 x 2 ranks' "tp_int8" results, the JAX mesh program's int8 fake
    (compiled while the ranks run) and one process's int8 runs on the whole
    batch."""
    spawned = _runs(tmp)[3]
    jsys, g, e = _jax_system()
    mesh = int8_mesh_fake(jsys, g, e, batch_for(worker.tiny_test_experiment().model, False,
                                                 batch=worker.TP_INT8_BATCH),
                          spatial=False, min_ch=worker.TP_INT8_MIN_CH)
    one = {mode: worker.tp_int8_run(mode) for mode in worker.INT8_CONV_MODES}
    return [r["tp_int8"] for r in spawned.results(timeout=240.0)[0]], mesh, one


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_ops"))


@pytest.fixture(scope="module")
def runs(tmp):
    return _runs(tmp)[:2]


@pytest.fixture(scope="module")
def runs_2x2(tmp):
    return _runs_2x2(tmp)


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


def test_int8_collectives_at_one_data_rank(runs):
    """1 x 2: one MAX all-reduce over the model group per sharded conv (the
    column and row blocks smooth), none over the data group: no collective
    beyond the model group's where the data group is one rank."""
    ranks, _ = runs
    for rank in ranks:
        got = rank["int8_generator"]
        assert int(got["max_calls"]) == int(got["sharded_convs"]) > 0
        assert got["collectives"]["batch_max"] == {"calls": 0, "bytes": 0}


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


# -- int8 over data x model ranks (2 x 2) and over data ranks alone ---------------
#
# The JAX mesh program's scales are global max-reduces over the whole batch:
# under a layout with a model axis the port's data ranks take (a)'s maxima
# over the data group too (`tensor.all_reduce_batch_max`), so every scale is
# one process's on the global batch, bit for bit.  The evaluator, jitted
# per process in the JAX package, keeps each process's batch's scales.


def _equal_calls(rank, key):
    return [all(call["equal"].values()) for call in rank[key]["scales"]]


@pytest.mark.parametrize("mode", worker.INT8_CONV_MODES)
def test_int8_2x2_scales_are_the_global_batch(runs_2x2, mode):
    """Teacher-forced: every quantized conv (column, row and replicated) on
    every rank, its s_c, s_k, s_x, k_q and x_q this rank's part of one
    process's quantization of the whole layer on the global batch, bit for
    bit; one MAX all-reduce over the data group per quantized conv."""
    ranks, _, _ = runs_2x2
    for r, rank in enumerate(ranks):
        got = rank[f"int8_{mode}"]
        calls = got["scales"]
        assert len(calls) == got["quantized_convs"] > 0
        assert {c["shard"] for c in calls} == {"column", "row", None}
        assert all(_equal_calls(rank, f"int8_{mode}")), (r, [c for c in calls
                                                            if not all(c["equal"].values())])
        assert got["collectives"]["batch_max"]["calls"] == len(calls)


def test_int8_2x2_planted_model_group_maxima_break_the_scales(runs_2x2):
    """With the activation maxima over the model group only (each data rank
    its own rows'), the check above fails on most convs of every rank."""
    ranks, _, _ = runs_2x2
    for rank in ranks:
        equal = _equal_calls(rank, f"int8_{worker.INT8_PLANTED_BATCH}")
        assert sum(not e for e in equal) > len(equal) // 2, equal


@pytest.mark.parametrize("mode", worker.INT8_CONV_MODES)
def test_int8_2x2_matches_one_process_on_the_whole_batch(runs_2x2, mode):
    """The data ranks' fakes put together against one process on the whole
    batch: at the JAX mesh test's tolerances and within INT8_CONV_REL_L2
    (only the row convs' sums run in another order); the model ranks of a
    data rank bit for bit alike."""
    ranks, _, one = runs_2x2
    got = [rank[f"int8_{mode}"]["fake"] for rank in ranks]
    for a, b in zip(got[::2], got[1::2]):
        assert torch.equal(a, b)
    fake, want = torch.cat(got[::2]), one[mode]["fake"]
    err = (fake - want).abs()
    assert float(err.mean()) < INT8_MEAN_ABS and float(err.max()) < INT8_MAX_ABS, \
        (float(err.mean()), float(err.max()))
    assert _rel_l2(fake, want) <= INT8_CONV_REL_L2


def test_int8_2x2_matches_the_jax_mesh_program(runs_2x2):
    """2 x 2 holding the JAX package's variables against its own mesh
    program on MeshConfig(2, 2) (4 of the 8 CPU devices, tensor shards at
    min_shard_ch 8) on the same batch, at its mesh test's tolerances."""
    ranks, mesh, _ = runs_2x2
    got = np.concatenate([rank["int8_jax_weights"]["fake"].numpy() for rank in ranks[::2]])
    assert got.shape == mesh.shape
    err = np.abs(got - mesh)
    assert float(err.mean()) < INT8_MEAN_ABS and float(err.max()) < INT8_MAX_ABS, \
        (float(err.mean()), float(err.max()))


def test_multihost_int8_evaluator_keeps_each_rank_scales(tmp):
    """The evaluator on 2 data ranks under int8 (`evaluate --multihost
    --int8`'s path): each rank's activation scales, conv by conv, are one
    process's on that rank's own batches, not shared between the ranks, and
    the gathered result is what one process gives on the same batches."""
    ranks = _runs(tmp)[2]
    stripes = [list(range(r, worker.EVAL_SAMPLES, 2)) for r in range(2)]
    for rank, stripe in zip(ranks, stripes):
        assert torch.equal(rank["s_x"], worker.eval_int8_run(stripe)["s_x"])
    assert not torch.equal(ranks[0]["s_x"], ranks[1]["s_x"])
    want = worker.eval_int8_run(stripes[0] + stripes[1])["result"]
    for rank in ranks:  # a NaN (MS-SSIM at 32^2) equal to a NaN
        assert set(rank["result"]) == set(want)
        assert all(rank["result"][k] == v or (np.isnan(v) and np.isnan(rank["result"][k]))
                   for k, v in want.items())
