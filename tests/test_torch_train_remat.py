"""The port's GAN train step with remat against deepsee_tpu's step with
remat: both policies ("full", "convs"), on the independent tiny model (coins
fixed, noise fed to both packages as functions of the draw's shape, noise
injection off: torch_step_parity.INDEPENDENT), the guided one and the guided
one with reuse_fake; two faithful steps each.  SGD in both packages;
helpers and tolerances in tests/torch_step_parity.py, as for the steps
without remat (test_torch_train_step.py, test_torch_train_indep.py)."""

import functools

import pytest

from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)
from torch_step_parity import GUIDED, INDEPENDENT, check_step, run_both

CONFIGS = {"independent": (INDEPENDENT, (), True), "guided": (GUIDED, (), False),
           "reuse_fake": (GUIDED, (("reuse_fake", True),), False)}


@functools.cache
def _run(config: str, policy: str):
    model, train, independent = CONFIGS[config]
    return run_both(model=model, train=train + (("remat", True), ("remat_policy", policy)),
                    independent=independent)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("policy", ["full", "convs"])
def test_remat_step_matches_jax(policy, config, step):
    check_step(*_run(config, policy)[step])
