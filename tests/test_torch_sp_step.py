"""The port's GAN train step under spatial sharding, gloo ranks in processes
of their own (tests/_torch_dist_worker.py, task "sp_step", one torch thread
each), against one process at the same global batch of 4, float32 on the
CPU, the tiny configuration: every map of G, E, D and the VGG19 cut into
horizontal stripes over the model ranks, the parameters whole on every
rank.

Two layouts: 1 x 2 (data x model, two processes: both ranks hold the 4 rows,
each half of every map's rows) and 2 x 2 (four processes: the data ranks 2
rows each).  Runs of 2 faithful SGD steps from the weights of
tests/torch_step_parity.py: "noise" (injection and style noise from the
state's own generators) in both layouts; at 1 x 2 also "seeded" (coins
fixed, noise fed as numpy functions of the whole draw's shape, noise
injection off: the run held against JAX), "noise_remat" (the generator's
blocks rematerialized, "full": the recompute reissues the halo exchanges and
K1's statistics collectives) and the first "noise" step under each planted
fault (zero halos; K1's statistics per stripe).

Tolerances, as tests/test_torch_tp_step.py's: the ranks bit for bit (every
parameter and buffer, the logs, the coins); one process, per network,
within 1e-5 relative L2 or twice the spread of the same one-process run
under one-ulp nudges of the weights; the remat run's buffers and logs bit for
bit the run without remat, its parameters within 1e-6; the first seeded step
against the JAX package's single-device step by torch_step_parity's
tolerances.  Each planted fault moves some network by ten times its bound
or more.
"""

import functools
import os
import shutil

import pytest
import torch

import _torch_dist_worker as worker
import torch_step_parity as tsp
from deepsee_torch.system import SRSystem
from test_torch_dist_step import (NUDGES, REL_L2, _flat, first_step_matches_jax,
                                  ranks_are_bit_identical, step_matches_one_process)
from test_torch_tp_step import test_remat_ranks_match_the_ranks_without_remat as _remat_check
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = {"1x2": 2, "2x2": 4}
MODEL = tsp.INDEPENDENT


@functools.cache
def _runs(tmp):
    """The JAX-vs-port step at batch 4; per layout the ranks' results; per
    mode the one-process run and its nudged twins."""
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
        spawned[layout] = worker.Spawned(out, ["sp_step"], world=world)
    parity = tsp.run_both(model=MODEL, independent=True, batch_size=4, pattern=(True,))
    kw = {"seeded": dict(weights=weights, model=MODEL, seeded_draws=True),
          "noise": dict(weights=weights)}
    one = {mode: [worker.step_run(**kw[mode])]
           + [worker.step_run(**kw[mode], nudge_seed=seed) for seed in NUDGES]
           for mode in kw}
    ranks = {layout: [r["sp_step"] for r in s.results(timeout=300.0)[0]]
             for layout, s in spawned.items()}
    return parity, ranks, one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("sp_step")))


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


def test_first_seeded_step_matches_jax(runs):
    parity, ranks, _ = runs
    for rank in ranks["1x2"]:
        first_step_matches_jax(parity[0], rank["seeded"]["steps"][0])


@pytest.mark.parametrize("step", [0, 1])
def test_remat_ranks_match_the_ranks_without_remat(runs, step):
    parity, ranks, one = runs
    _remat_check((parity, {"1x2": ranks["1x2"]}, one), step)


def test_remat_replays_the_collectives(runs):
    """With remat the recompute issues each block's halo exchanges and K1's
    statistics again: more calls than without it, the extra ones counted as
    replayed, alike on both ranks."""
    _, ranks, _ = runs
    plain, remat = ranks["1x2"][0]["counts"], ranks["1x2"][0]["remat_counts"]
    replayed = ranks["1x2"][0]["replayed"]
    assert replayed == ranks["1x2"][1]["replayed"] and replayed["calls"] > 0
    extra = sum(remat[k]["calls"] - plain[k]["calls"] for k in plain)
    assert extra == replayed["calls"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_coins_are_equal_on_every_rank(runs, layout):
    _, ranks, one = runs
    assert all(r["noise"]["coins"] == one["noise"][0]["coins"] for r in ranks[layout])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collectives_ran_and_are_alike(runs, layout):
    _, ranks, _ = runs
    counts = [r["counts"] for r in ranks[layout]]
    assert all(c == counts[0] for c in counts)
    for kind in ("halo", "halo_grad", "reduce", "shared", "stats", "stats_grad", "grads"):
        assert counts[0][kind]["calls"] > 0, (kind, counts[0])


@pytest.mark.parametrize("fault", worker.SP_PLANTED)
def test_planted_faults_break_the_step(runs, fault):
    _, ranks, one = runs
    (_, snap), = ranks["1x2"][0][fault]["steps"]
    (_, want), *nudged = [run["steps"][0] for run in one["noise"]]
    worst = 0.0
    for net in want:
        ref = _flat(want, net)
        err = float((_flat(snap, net) - ref).norm() / ref.norm())
        spread = max(float((_flat(n, net) - ref).norm() / ref.norm()) for _, n in nudged)
        worst = max(worst, err / max(REL_L2, 2 * spread))
    assert worst > 10, worst
