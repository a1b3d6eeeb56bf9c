"""The encoder's and the discriminator's batch norms across 2 gloo ranks
(deepsee_torch/models/layers.py::GlobalMoments), in processes of their own
(tests/_torch_dist_worker.py), against one process at the same global batch
of 4, float32 on the CPU, tiny independent configuration without noise
injection.  Two configurations (`_torch_dist_worker.NORM_CONFIGS`): norm_e
"batch" and norm_d "spectralbatch"; norm_e "spectralsync_batch" and norm_d
"spectralbatch".  Weights: the JAX package's init made nontrivial
(torch_step_parity); coins fixed and noise fed as numpy functions of the
draw's shape.

Each norm's statistics and running statistics are the global batch's, so
the ranks must be bit for bit alike and within test_torch_dist_step.py's
tolerances of one process (1e-5 relative L2 per network, or twice the
one-ulp spread); the first step also within torch_step_parity's tolerances
of the JAX package's single-device step at batch 4."""

import functools

import pytest
import torch

import _torch_dist_worker as worker
import torch_step_parity as tsp
from deepsee_torch.models.layers import TorchBatchNorm
from deepsee_torch.system import SRSystem
from test_torch_dist_step import (NUDGES, first_step_matches_jax, ranks_are_bit_identical,
                                  step_matches_one_process)
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)


@functools.cache
def _runs(tmp):
    weights = {}
    for name, model in worker.NORM_CONFIGS.items():
        jexp, texp = tsp.experiments(model)
        variables = tsp.initial_variables(jexp)
        port = SRSystem(texp, device="cpu")
        port.load_jax_variables(variables.g, variables.e, variables.d, variables.vgg)
        weights[name] = {net: m.state_dict() for net, m in port.networks().items()}
        torch.save(weights[name], f"{tmp}/weights_{name}.pt")
    spawned = worker.Spawned(tmp, ["norms"])
    parity, one = {}, {}
    for name, model in worker.NORM_CONFIGS.items():
        parity[name] = tsp.run_both(model=model, independent=True, batch_size=4)
        kw = dict(weights=weights[name], model=model, seeded_draws=True)
        one[name] = [worker.step_run(**kw)] + [worker.step_run(**kw, nudge_seed=seed)
                                               for seed in NUDGES]
    ranks, _ = spawned.results()
    return parity, [r["norms"] for r in ranks], one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("dist_norms")))


@pytest.mark.parametrize("config", list(worker.NORM_CONFIGS))
def test_configuration_has_encoder_and_discriminator_batch_norms(config):
    exp = tsp.experiments(worker.NORM_CONFIGS[config])[1]
    system = SRSystem(exp, device="cpu")
    for net in (system.encoder, system.discriminator):
        assert any(isinstance(m, TorchBatchNorm) for m in net.modules())


@pytest.mark.parametrize("config", list(worker.NORM_CONFIGS))
def test_batch_norm_ranks_are_bit_identical(runs, config):
    _, ranks, _ = runs
    ranks_are_bit_identical([r[config] for r in ranks])


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("config", list(worker.NORM_CONFIGS))
def test_batch_norm_steps_match_one_process(runs, config, step):
    _, ranks, one = runs
    step_matches_one_process(ranks[0][config]["steps"][step],
                             [run["steps"][step] for run in one[config]])


@pytest.mark.parametrize("config", list(worker.NORM_CONFIGS))
def test_first_batch_norm_step_matches_jax(runs, config):
    parity, ranks, _ = runs
    first_step_matches_jax(parity[config][0], ranks[0][config]["steps"][0])
