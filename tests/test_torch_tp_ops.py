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
    style.

Tolerance: 1e-5 relative L2 (the sums run in another order); the ranks
bit for bit alike.
"""

import functools

import pytest
import torch

import _torch_dist_worker as worker
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 1e-5
RUNS = {"conv_pair": worker.conv_pair_run,
        "sean_norm_0": functools.partial(worker.sean_run, False),
        "sean_norm_1": functools.partial(worker.sean_run, True),
        "eval_generator": worker.eval_generator_run}


@functools.cache
def _runs(tmp):
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
