"""The port's GAN train step against deepsee_tpu's on the independent tiny
model (combined encoder, both trunks in training, style noise on; noise
injection off, see torch_step_parity.INDEPENDENT): coins fixed and noise
fed to both packages as functions of the draw's shape (the G step encodes
with the full trunk and style noise, the D step's regeneration with the
mini trunk and none); one and two steps.
Then `reuse_fake` (D on the G step's fake) on the guided model.  SGD in
both packages; helpers and tolerances in tests/torch_step_parity.py."""

import functools

import pytest

from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)
from torch_step_parity import GUIDED, INDEPENDENT, check_step, run_both


@functools.cache
def _independent():
    return run_both(model=INDEPENDENT, independent=True)


@functools.cache
def _reuse_fake():
    return run_both(model=GUIDED, train=dict(reuse_fake=True))


@pytest.mark.parametrize("step", [0, 1])
def test_independent_step_matches_jax(step):
    check_step(*_independent()[step])


@pytest.mark.parametrize("step", [0, 1])
def test_reuse_fake_step_matches_jax(step):
    check_step(*_reuse_fake()[step])
