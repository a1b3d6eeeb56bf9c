"""The port's GAN train step against deepsee_tpu's: the guided tiny model
(its coins are fixed by the code; add_noise and style noise off), one and
two faithful steps, and d_steps_per_g = 2 (a G + D step, then a D-only
step).  SGD in both packages, so the stepped parameters show the gradients;
helpers and tolerances in tests/torch_step_parity.py."""

import functools

import pytest

from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)
from torch_step_parity import GUIDED, check_step, run_both


@functools.cache
def _faithful():
    return run_both(model=GUIDED)


@functools.cache
def _d_steps():
    return run_both(model=GUIDED, train=dict(d_steps_per_g=2), pattern=(True, False))


@pytest.mark.parametrize("step", [0, 1])
def test_guided_step_matches_jax(step):
    check_step(*_faithful()[step])


@pytest.mark.parametrize("step", [0, 1])
def test_d_steps_per_g_matches_jax(step):
    tlogs = _d_steps()[step][2]
    assert set(tlogs) == ({"GAN", "GAN_Feat", "VGG", "D_Fake", "D_real"} if step == 0
                          else {"D_Fake", "D_real"})
    check_step(*_d_steps()[step])
