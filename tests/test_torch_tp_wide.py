"""The port's GAN train step under tensor parallelism at the JAX package's
multichip width and layout (tests/test_train_step.py:51-99: the tiny
configuration with ngf=8, min_shard_ch 8, a (2, 4) data x model mesh),
gloo ranks in processes of their own (tests/_torch_dist_worker.py, one
torch thread each), against one process at the same global batch of 4,
float32 on the CPU.

The layout 2 x 4: eight processes, the data ranks 2 rows each, the four
model ranks of a data index the same rows, each a quarter of every sharded
conv (test_torch_tp_step.py runs 1 x 2 and 2 x 2, and there also the
seeded draws and remat).  The "noise" run: 2 faithful SGD steps, the
state's own generators, from seeded weights shaped like a trained model's
(`weights.randomize_weights`).

Tolerances, as tests/test_torch_tp_step.py's: the ranks bit for bit over
both steps, and the first step within 1e-5 relative L2 of one process or
twice the one-ulp nudge spread.  The second step at this width takes
discrete turns: from the JAX package's initial weights at this width,
one-ulp nudges of one process's weights land D from ~1e-6 to ~1e-3 away
from the run itself, in clusters (scripts/wide_step_parity.py prints them
beside the two ranks' reading), more than two nudges can bound.
The JAX leg stays at the tiny width in test_torch_tp_step.py: at ngf=8 the
port's own one-process step parts from the JAX step by more than
torch_step_parity's STEP_RTOL on SEAN's blend weights, whose gradients are
sums that mostly cancel (scripts/wide_step_parity.py; ROADMAP.md §3).
"""

import dataclasses
import functools
import json

import pytest
import torch

import _torch_dist_worker as worker
from deepsee_torch.config import tiny_test_experiment
from deepsee_torch.system import SRSystem
from deepsee_torch.weights import randomize_weights
from test_torch_dist_step import NUDGES, ranks_are_bit_identical, step_matches_one_process
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

DATA, MODEL = 2, 4


@functools.cache
def _runs(tmp):
    """The ranks' results; the one-process first step and its nudged
    twins'.  The ranks run while this process computes the rest."""
    exp = tiny_test_experiment()
    port = SRSystem(exp.replace(model=dataclasses.replace(exp.model, **worker.TP_WIDE)),
                    device="cpu")
    port.init(torch.Generator().manual_seed(0))
    randomize_weights(port.networks().values(), torch.Generator().manual_seed(1))
    torch.save({net: m.state_dict() for net, m in port.networks().items()}, f"{tmp}/weights.pt")
    weights = torch.load(f"{tmp}/weights.pt", weights_only=True)
    with open(f"{tmp}/wide.json", "w") as f:
        json.dump({"model_axis": MODEL}, f)
    spawned = worker.Spawned(tmp, ["tp_wide"], world=DATA * MODEL)
    kw = dict(weights=weights, model=worker.TP_WIDE, steps=1)
    one = [worker.step_run(**kw)] + [worker.step_run(**kw, nudge_seed=seed) for seed in NUDGES]
    return [r["tp_wide"] for r in spawned.results(timeout=240.0)[0]], one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("tp_wide")))


def test_wide_ranks_are_bit_identical(runs):
    ranks, _ = runs
    for a in range(1, len(ranks)):
        ranks_are_bit_identical([ranks[0], ranks[a]])


def test_wide_first_step_matches_one_process(runs):
    ranks, one = runs
    for rank in ranks:
        step_matches_one_process(rank["steps"][0], [run["steps"][0] for run in one])


def test_wide_batch_statistics_take_the_data_group(runs):
    """K1's batch statistics on this rank's quarter of the channels, split
    around the data group's all-reduce (two ranks); as many calls per step
    as one process makes."""
    ranks, one = runs
    want = one[0]["norm_calls"]
    assert want and all(call[0] == "one" for call in want)
    for rank in ranks:
        calls = rank["norm_calls"]
        assert len(calls) == 2 * len(want)   # two steps against one
        for got, (_, channels) in zip(calls, want + want):
            assert got == ("split", channels // MODEL, DATA), got
