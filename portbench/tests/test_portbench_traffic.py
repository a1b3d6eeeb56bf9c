"""The seed alone makes the weights and the inputs."""

from __future__ import annotations

import dataclasses

import torch

from portbench import seeded
from portbench.reference import nets

CFG = None


def _cfg():
    from deepsee_torch.config import tiny_test_experiment

    return dataclasses.asdict(tiny_test_experiment().model)


def test_weights_follow_the_seed():
    spec = nets.param_spec(_cfg(), train=True)
    a = seeded.make_weights(spec, 2 ** 31 + 11, "cpu")
    b = seeded.make_weights(spec, 2 ** 31 + 11, "cpu")
    c = seeded.make_weights(spec, 2 ** 31 + 12, "cpu")
    for net in spec:
        assert set(a[net]) == set(spec[net])
        for name in spec[net]:
            assert tuple(a[net][name].shape) == spec[net][name]
            assert torch.equal(a[net][name], b[net][name])
    assert not torch.equal(a["g"]["initial.weight"], c["g"]["initial.weight"])


def test_spectral_vectors_are_converged():
    """u and v are the weight's top singular vectors, so sigma = u . W v is
    its largest singular value."""
    w = seeded.make_weights(nets.param_spec(_cfg()), 7, "cpu")["g"]
    m = w["head_0.conv_0.weight_orig"].reshape(w["head_0.conv_0.weight_orig"].shape[0], -1)
    sigma = torch.dot(w["head_0.conv_0.weight_u"], m @ w["head_0.conv_0.weight_v"])
    assert torch.allclose(sigma, torch.linalg.matrix_norm(m, 2), rtol=1e-3)


def test_batches_follow_the_seed_and_are_piecewise():
    def batch(seed):
        return seeded.make_batch(4, 64, 19, True, torch.Generator().manual_seed(seed))

    a, b, c = batch(2 ** 33 + 1), batch(2 ** 33 + 1), batch(2 ** 33 + 2)
    assert set(a) == {"image_hr", "label", "guiding_image", "guiding_label"}
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["label"], c["label"])
    label = a["label"]
    assert label.dtype == torch.int32 and int(label.min()) >= 0 and int(label.max()) < 19
    same = (label[:, :, 1:] == label[:, :, :-1]).float().mean()
    assert same > 0.85          # regions, not a label per pixel
    assert a["image_hr"].abs().max() < 1.0
