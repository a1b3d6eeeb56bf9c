"""The plain reference against the port's plain CPU path, float32, at the
tiny test configuration: inference (independent, guided, int8) and the
training step; and its parameter names against the port's at every
benchmark configuration."""

from __future__ import annotations

import dataclasses
import json
import warnings

import pytest
import torch

from portbench import seeded, spec
from portbench.reference import nets
from portbench.reference import train as ref_train
from portbench.reference.ops import Quant

BENCH = json.loads((spec.REPO / "BENCHMARK.json").read_text())


def _exp(guided=False, **model):
    from deepsee_torch.config import tiny_test_experiment

    exp = tiny_test_experiment()
    changes = dict(model)
    if guided:
        changes.update(net_e="fullstyle", guiding_style_image=True, noisy_style_scale=0.05)
    return exp.replace(model=dataclasses.replace(exp.model, **changes),
                       train=dataclasses.replace(exp.train, seed=1234, batch_size=3))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_parameter_names_are_the_ports(config):
    from deepsee_torch.system import SRSystem
    from portbench import harness

    data = json.loads((spec.REPO / config["file"]).read_text())
    exp = harness.experiment(data, train=True)
    system = SRSystem(exp, device="meta")
    want = nets.param_spec(dataclasses.asdict(exp.model), train=True)
    for name, net in system.networks().items():
        assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == want[name]


@pytest.mark.parametrize("guided", [False, True])
def test_inference_matches_the_port(guided):
    from deepsee_torch.system import SRSystem

    exp = _exp(guided).replace(is_train=False)
    cfg = dataclasses.asdict(exp.model)
    weights = seeded.make_weights(nets.param_spec(cfg), 3, "cpu")
    system = SRSystem(exp, device="cpu")
    for name, net in system.networks().items():
        net.load_state_dict(weights[name], strict=True)
    batch = seeded.make_batch(3, cfg["crop_size"], cfg["label_nc"], guided,
                              torch.Generator().manual_seed(4))
    with torch.inference_mode():
        pre = system.preprocess(batch)
        style = system.encode_style(pre, use_full=guided, no_noise=True)
        fake, _ = system.generate(pre, style=style)
    with torch.no_grad():
        ref = nets.infer(weights, cfg, batch)
    assert ref.abs().mean() > 0.05 and (ref.abs() > 0.999).float().mean() < 0.01
    assert torch.allclose(fake, ref, atol=2e-5, rtol=0)


def test_int8_inference_matches_the_ports_plain_int8():
    """The port's plain int8 path against the reference's W8A8 recipe: the
    same up to level flips of float32 rounding; W4A4 far off both."""
    from deepsee_torch.models.layers import int8_inference
    from deepsee_torch.system import SRSystem

    exp = _exp().replace(is_train=False)
    cfg = dataclasses.asdict(exp.model)
    weights = seeded.make_weights(nets.param_spec(cfg), 5, "cpu")
    system = SRSystem(exp, device="cpu")
    for name, net in system.networks().items():
        net.load_state_dict(weights[name], strict=True)
    batch = seeded.make_batch(3, cfg["crop_size"], cfg["label_nc"], False,
                              torch.Generator().manual_seed(6))
    with int8_inference(min_ch=16), torch.inference_mode():
        pre = system.preprocess(batch)
        fake, _ = system.generate(pre, style=system.encode_style(pre, use_full=False))
    with torch.no_grad():
        ref8 = nets.infer(weights, cfg, batch, Quant(8, 16, True))
        ref4 = nets.infer(weights, cfg, batch, Quant(4, 16, True))
        ref32 = nets.infer(weights, cfg, batch)
    mse = lambda a, b: float(((a - b) ** 2).mean())   # noqa: E731
    assert mse(fake, ref8) < 1e-4
    assert mse(ref4, ref8) > 30 * mse(fake, ref8)
    assert mse(ref32, ref8) > mse(fake, ref8)


@pytest.mark.parametrize("guided", [False, True])
def test_train_steps_match_the_port(guided):
    """Three steps of the port's step (plain CPU versions) and of the
    reference from the same weights, batches and seeds: the losses, the
    first gradients (from the port's Adam state) and the parameters."""
    from deepsee_torch.system import SRSystem
    from deepsee_torch.train.state import create_train_state
    from deepsee_torch.train.steps import make_train_step

    exp = _exp(guided)
    cfg = dataclasses.asdict(exp.model)
    weights = seeded.make_weights(nets.param_spec(cfg, train=True), 8, "cpu")
    system = SRSystem(exp, device="cpu")
    for name, net in system.networks().items():
        net.load_state_dict(weights[name], strict=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state = create_train_state(system, init=False)
    step = make_train_step(system)
    ref = ref_train.TrainReference(cfg, vars(exp.train), weights, "cpu", exp.train.seed)
    gen = torch.Generator().manual_seed(9)
    train_steps = spec.load_module(spec.HERE / "traffic" / "train_steps.py")
    keys = train_steps.leaf_keys(system)
    for i in range(3):
        batch = seeded.make_batch(3, cfg["crop_size"], cfg["label_nc"], guided, gen)
        logs = step(state, batch)
        want, grads = ref.step(batch)
        for k in ref_train.LOSSES:
            assert float(logs[k]) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6)
        if i == 0:
            got = train_steps.first_grad_norms(state, keys)
            norms = {k: float(g.norm()) for k, g in grads.items()}
            assert ref_train.norm_gap(got, norms)[0] < 1e-4
    # Adam moves a leaf by about lr whatever its gradient's size, so float32
    # rounding reaches the parameters most where gradients are smallest
    changes = train_steps.change_norms(system, weights, keys)
    ref_changes = {k: float((v - weights[k[0]][k[1]]).norm()) for k, v in ref.leaves().items()}
    assert ref_train.norm_gap(changes, ref_changes, ref_train.moving_leaves(norms))[0] < 0.02
