"""The port's GAN train step over 2 gloo ranks, in processes of their own
(tests/_torch_dist_worker.py, one torch thread each), against one process
at the same global batch of 4, float32 on the CPU, tiny configuration.

Each rank holds 2 of the 4 rows.  The generator's batch norms take their
statistics from both ranks (K1's batch modes split around an all-reduce),
the gradients are averaged before each SGD step, and the noise is drawn for
the global batch on each rank, which keeps its rows.  Two runs of 2
faithful steps:

  * "seeded": the weights of tests/torch_step_parity.py (the JAX init made
    nontrivial), coins fixed and noise fed as numpy functions of the draw's
    shape, noise injection off (torch_step_parity.INDEPENDENT); also held
    against the JAX package's single-device step at batch 4
    (torch_step_parity.run_both);
  * "noise": the same weights (noise-injection weights drawn from a seed)
    with noise injection and style noise on, the coins and noise from the
    train state's own generators; and "noise_remat" / "noise_remat_convs",
    the same with the generator's blocks rematerialized ("full" / "convs"),
    which must leave what "noise" leaves: buffers and logs bit for bit,
    parameters within 1e-6 relative L2 (the recompute issues K1's
    all-reduces again on both ranks; under "convs" they run inside the
    selective-checkpoint contexts, which do not save them: they run in the
    forward and again in the recompute).

Tolerances.  The two ranks: bit for bit (every parameter and buffer, the
logs, the coins).  One process, per network (its parameters and buffers
concatenated): relative L2 within 1e-5, or within twice the spread of the
same one-process run with every weight nudged by one float32 ulp (the
largest of NUDGES seeds), whichever is larger.  This tiny step is not well
conditioned at batch 4: one ulp moves D by up to 3e-4 after one step and
2.5e-3 after two (the D step amplifies float32 noise in the regenerated
fake, and elements at leaky-ReLU kinks flip), and the ranks, whose sums run
in another order, land inside that spread.  The JAX step: the first step
only, by torch_step_parity's parameter and loss tolerances; its buffers
within torch_step_parity's BUFFER_ATOL of the one-process port's own
distance to JAX (at batch 4 itself 1.3e-5: the port's one-process step, not
the ranks, sets it).  After the first step the one-process port and JAX
part by up to 20 % on D's step, for the same conditioning.
"""

import functools

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
import torch_step_parity as tsp
from deepsee_torch.system import SRSystem
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 1e-5
REMAT_REL_L2 = 1e-6
NUDGES = (0, 1)   # seeds of the one-ulp nudges
BUFFERS = ("weight_u", "weight_v", "running_mean", "running_var")


@functools.cache
def _runs(tmp):
    """The JAX-vs-port steps at batch 4; the ranks' results; per mode the
    one-process run and its nudged twins.  The ranks run while this
    process computes the rest."""
    jexp, texp = tsp.experiments(tsp.INDEPENDENT)
    variables = tsp.initial_variables(jexp)
    port = SRSystem(texp, device="cpu")
    port.load_jax_variables(variables.g, variables.e, variables.d, variables.vgg)
    weights = {net: m.state_dict() for net, m in port.networks().items()}
    torch.save(weights, f"{tmp}/weights.pt")
    spawned = worker.Spawned(tmp, ["step"])
    parity = tsp.run_both(model=tsp.INDEPENDENT, independent=True, batch_size=4)
    kw = {"seeded": dict(weights=weights, model=tsp.INDEPENDENT, seeded_draws=True),
          "noise": dict(weights=weights)}
    one = {mode: [worker.step_run(**kw[mode])]
           + [worker.step_run(**kw[mode], nudge_seed=seed) for seed in NUDGES]
           for mode in kw}
    ranks, _ = spawned.results()
    return parity, [r["step"] for r in ranks], one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("dist_step")))


def _flat(snap, net):
    return torch.cat([v.double().reshape(-1) for _, v in sorted(snap[net].items())])


def _same(a, b) -> bool:
    return all(torch.equal(a[net][k], b[net][k]) for net in a for k in a[net])


def ranks_are_bit_identical(rank_runs):
    for (logs0, snap0), (logs1, snap1) in zip(rank_runs[0]["steps"], rank_runs[1]["steps"]):
        assert logs0 == logs1
        assert _same(snap0, snap1)


@pytest.mark.parametrize("mode", ["seeded", "noise", "noise_remat", "noise_remat_convs"])
def test_ranks_are_bit_identical(runs, mode):
    _, ranks, _ = runs
    ranks_are_bit_identical([r[mode] for r in ranks])


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("mode", ["noise_remat", "noise_remat_convs"])
def test_remat_ranks_match_the_ranks_without_remat(runs, mode, step):
    _, ranks, _ = runs
    logs, snap = ranks[0][mode]["steps"][step]
    want_logs, want = ranks[0]["noise"]["steps"][step]
    assert logs == want_logs
    for net in want:
        for key, value in want[net].items():
            if key.endswith(BUFFERS):
                assert torch.equal(snap[net][key], value), f"{net} {key}"
            else:
                err = float((snap[net][key] - value).norm() / value.norm().clamp_min(1e-30))
                assert err <= REMAT_REL_L2, f"{net} {key}: {err:.2e}"


def test_coins_are_equal_on_both_ranks(runs):
    _, ranks, one = runs
    assert len(ranks[0]["noise"]["coins"]) == 2 * worker.STEPS
    assert ranks[0]["noise"]["coins"] == ranks[1]["noise"]["coins"] == one["noise"][0]["coins"]


@pytest.mark.parametrize("mode,step", [("seeded", 0), ("seeded", 1), ("noise", 0), ("noise", 1)])
def test_steps_match_one_process(runs, mode, step):
    _, ranks, one = runs
    step_matches_one_process(ranks[0][mode]["steps"][step], [run["steps"][step]
                                                            for run in one[mode]])


def step_matches_one_process(rank_step, one_steps):
    """A rank's (logs, snapshot) after a step against the one-process run's
    and its nudged twins' (the first of `one_steps` is the run itself)."""
    logs, snap = rank_step
    (want_logs, want), *nudged = one_steps
    for net in want:
        ref = _flat(want, net)
        err = float((_flat(snap, net) - ref).norm() / ref.norm())
        spread = max(float((_flat(n, net) - ref).norm() / ref.norm()) for _, n in nudged)
        assert err <= max(REL_L2, 2 * spread), f"{net}: {err:.3e} (one-ulp spread {spread:.3e})"
    for name in want_logs:
        spread = max(abs(n_logs[name] - want_logs[name]) for n_logs, _ in nudged)
        assert abs(logs[name] - want_logs[name]) <= max(REL_L2 * abs(want_logs[name]),
                                                        2 * spread), name


def test_first_seeded_step_matches_jax(runs):
    parity, ranks, _ = runs
    first_step_matches_jax(parity[0], ranks[0]["seeded"]["steps"][0])


def first_step_matches_jax(parity_step, rank_step):
    """A rank's first step against the JAX package's single-device step at
    the global batch (one step of torch_step_parity.run_both)."""
    before, jlogs, one_logs, jsnap, one_snap = parity_step
    logs, snap = rank_step
    for name in jlogs:
        np.testing.assert_allclose(logs[name], jlogs[name], rtol=tsp.LOSS_RTOL, atol=1e-6,
                                   err_msg=name)
    for net in jsnap:
        for key, want in jsnap[net].items():
            got = snap[net][key]
            if key.endswith(BUFFERS):
                port_gap = float((one_snap[net][key] - want).abs().max())
                gap = float((got - want).abs().max())
                assert gap <= port_gap + tsp.BUFFER_ATOL, f"{net} {key}: {gap:.2e}"
                continue
            err = tsp.step_error((got - before[1][net][key]).numpy(),
                                 (want - before[0][net][key]).numpy())
            assert err <= tsp.STEP_RTOL, f"{net} {key}: step differs by {err:.2e}"
