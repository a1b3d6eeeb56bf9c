"""The port's GAN train step under tensor parallelism, gloo ranks in
processes of their own (tests/_torch_dist_worker.py, one torch thread
each), against one process at the same global batch of 4, float32 on the
CPU: the tiny configuration with the JAX package's multichip min_shard_ch
of 8 (tests/test_train_step.py:51-99), so that the generator trunk (64
wide), the encoder trunks, D and the VGG19 all shard.  That test widens
the trunk to ngf=8, where the port's own one-process step parts from the
JAX step by more than torch_step_parity's STEP_RTOL on a SEAN blend weight
whose gradient is a sum that mostly cancels (scripts/wide_step_parity.py,
ROADMAP.md §3), so the JAX leg runs here at the tiny default width;
test_torch_tp_wide.py holds the ranks against one process at ngf=8 in the
JAX test's own 2 x 4 layout, and test_torch_tp_plan.py the plan at ngf=8
and at full width.

Two layouts: 1 x 2 (data x model, two processes: both ranks hold the 4
rows, each half of every sharded conv) and 2 x 2 (four processes: the data
ranks 2 rows each, the model ranks of a data index the same rows).  Runs of
2 faithful SGD steps from the weights of tests/torch_step_parity.py:
"noise" (injection and style noise on, the state's own generators, each
data rank its rows of the global batch's draws) in both layouts, and at
1 x 2 "seeded" (coins fixed, noise fed as numpy functions of the draw's
shape, noise injection off: the run held against JAX) and "noise_remat"
(the generator's blocks rematerialized, "full": the recompute reissues
the collectives).

Tolerances, as tests/test_torch_dist_step.py's: the ranks bit for bit
(every parameter and buffer, gathered: the replicated ones are each rank's
own, the logs, the coins); one process, per network, within 1e-5 relative
L2 or twice the spread of the same one-process run under one-ulp nudges of
the weights, whichever is larger; the remat run's buffers and logs bit
for bit the run without remat, its parameters within 1e-6; the first seeded
step against the JAX package's single-device step by torch_step_parity's
tolerances.  Also: the generator's batch statistics take the one-launch K1
on C/2 channels at 1 x 2 and the split K1 over the data group of 2 at 2 x 2.
"""

import functools
import os
import shutil

import pytest
import torch

import _torch_dist_worker as worker
import torch_step_parity as tsp
from deepsee_torch.system import SRSystem
from test_torch_dist_step import (BUFFERS, NUDGES, REMAT_REL_L2, first_step_matches_jax,
                                  ranks_are_bit_identical, step_matches_one_process)
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = {"1x2": 2, "2x2": 4}   # data x model -> processes
MODEL = tsp.INDEPENDENT


@functools.cache
def _runs(tmp):
    """The JAX-vs-port steps at batch 4; per layout the ranks' results; per
    mode the one-process run and its nudged twins.  The ranks run while
    this process computes the rest."""
    jexp, texp = tsp.experiments(MODEL)
    variables = tsp.initial_variables(jexp)
    port = SRSystem(texp, device="cpu")
    port.load_jax_variables(variables.g, variables.e, variables.d, variables.vgg)
    torch.save({net: m.state_dict() for net, m in port.networks().items()}, f"{tmp}/weights.pt")
    weights = torch.load(f"{tmp}/weights.pt", weights_only=True)
    spawned = {}
    for layout, world in LAYOUTS.items():
        out = f"{tmp}/{layout}"
        os.makedirs(out)
        shutil.copy(f"{tmp}/weights.pt", out)
        spawned[layout] = worker.Spawned(out, ["tp_step"], world=world)
    parity = tsp.run_both(model=MODEL, independent=True, batch_size=4)
    kw = {"seeded": dict(weights=weights, model=MODEL, seeded_draws=True),
          "noise": dict(weights=weights)}
    one = {mode: [worker.step_run(**kw[mode])]
           + [worker.step_run(**kw[mode], nudge_seed=seed) for seed in NUDGES]
           for mode in kw}
    ranks = {layout: [r["tp_step"] for r in s.results(timeout=240.0)[0]]
             for layout, s in spawned.items()}
    return parity, ranks, one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("tp_step")))


@pytest.mark.parametrize("layout,mode", [("1x2", "seeded"), ("1x2", "noise"),
                                         ("1x2", "noise_remat"), ("2x2", "noise")])
def test_ranks_are_bit_identical(runs, layout, mode):
    _, ranks, _ = runs
    for a in range(1, len(ranks[layout])):
        ranks_are_bit_identical([ranks[layout][0][mode], ranks[layout][a][mode]])


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("layout,mode", [("1x2", "seeded"), ("1x2", "noise"),
                                         ("2x2", "noise")])
def test_steps_match_one_process(runs, layout, mode, step):
    _, ranks, one = runs
    for rank in ranks[layout]:
        step_matches_one_process(rank[mode]["steps"][step],
                                 [run["steps"][step] for run in one[mode]])


@pytest.mark.parametrize("step", [0, 1])
def test_remat_ranks_match_the_ranks_without_remat(runs, step):
    _, ranks, _ = runs
    logs, snap = ranks["1x2"][0]["noise_remat"]["steps"][step]
    want_logs, want = ranks["1x2"][0]["noise"]["steps"][step]
    assert logs == want_logs
    for net in want:
        for key, value in want[net].items():
            if key.endswith(BUFFERS):
                assert torch.equal(snap[net][key], value), f"{net} {key}"
            else:
                err = float((snap[net][key] - value).norm() / value.norm().clamp_min(1e-30))
                assert err <= REMAT_REL_L2, f"{net} {key}: {err:.2e}"


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_coins_are_equal_on_every_rank(runs, layout):
    _, ranks, one = runs
    assert all(r["noise"]["coins"] == one["noise"][0]["coins"] for r in ranks[layout])


def test_first_seeded_step_matches_jax(runs):
    parity, ranks, _ = runs
    for rank in ranks["1x2"]:
        first_step_matches_jax(parity[0], rank["seeded"]["steps"][0])


def test_batch_statistics_take_the_data_group(runs):
    """K1's batch statistics run on this rank's half of the channels: one
    launch at 1 x 2 (a data group of one), the split around the data
    group's all-reduce at 2 x 2; as many calls as one process makes."""
    _, ranks, one = runs
    want = one["noise"][0]["norm_calls"]
    assert want and all(call[0] == "one" for call in want)
    for layout, data in (("1x2", 1), ("2x2", 2)):
        for rank in ranks[layout]:
            calls = rank["noise"]["norm_calls"]
            assert len(calls) == len(want)
            for got, (_, channels) in zip(calls, want):
                assert got == (("one", channels // 2) if data == 1
                               else ("split", channels // 2, data)), (layout, got)


def test_collectives_ran_and_are_alike(runs):
    _, ranks, _ = runs
    for layout in LAYOUTS:
        counts = [r["counts"] for r in ranks[layout]]
        assert all(c == counts[0] for c in counts)
        assert all(counts[0][kind]["calls"] > 0 for kind in ("copy", "reduce", "gather",
                                                             "scatter")), counts[0]
