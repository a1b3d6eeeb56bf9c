"""Remat in the port against the port without it (models/remat.py), float32
on the CPU, tiny configuration.

The step: two faithful steps of the tiny independent model with the train
state's own generators (the coins, the noise injection and the style noise
all drawn as in training), noise-injection weights that let the noise reach
the output, and SGD that keeps each step's gradients.  With either policy
the step leaves every buffer (spectral u/v, running statistics), both
generators' states and the logs bit for bit as the step without remat, and
its parameters and gradients within 1e-6 relative L2 (bit for bit here; the
order in which a gradient's terms accumulate may change under remat).  A
recompute without the replay must break that comparison.

Then the generator alone (every variant, the folded modulation conv), where
remat applies, what "convs" saves, and K1's calls under remat.
"""

import contextlib
import dataclasses
import functools
import warnings

import pytest
import torch

from deepsee_torch.config import tiny_test_experiment
from deepsee_torch.models import remat
from deepsee_torch.models.generator import VARIANTS, DeepSEEGenerator
from deepsee_torch.models.layers import Conv2d, NoiseInjection
from deepsee_torch.ops import modnorm as mn
from deepsee_torch.system import SRSystem
from deepsee_torch.train import state as tstate
from deepsee_torch.train import steps as tsteps
from deepsee_torch.weights import randomize_weights
from torch_data_corpus import one_torch_thread  # noqa: F401 (autouse)
from torch_seeded import SGD_LR, batch_for

POLICIES = ("full", "convs")
STEPS = 2
GRAD_REL = 1e-6


class _RecordingSGD(torch.optim.SGD):
    """SGD that keeps the gradients of each step, in parameter order."""

    def __init__(self, params, lr):
        super().__init__(list(params), lr=lr)
        self.grads = []

    def step(self, closure=None):
        self.grads.append([p.grad.clone() for g in self.param_groups for p in g["params"]])
        return super().step(closure)


def _system(remat_policy=None, model=()):
    exp = tiny_test_experiment()
    exp = exp.replace(model=dataclasses.replace(exp.model, **dict(model)),
                      train=dataclasses.replace(exp.train, remat=remat_policy is not None,
                                                remat_policy=remat_policy or "full"))
    system = SRSystem(exp, device="cpu")
    system.init(torch.Generator().manual_seed(0))
    randomize_weights(system.networks().values(), torch.Generator().manual_seed(1))
    noise = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in system.generator.modules():
            if isinstance(m, NoiseInjection):
                m.weight.copy_(0.1 * torch.randn(m.weight.shape, generator=noise))
    return system


def run_steps(remat_policy=None, steps=STEPS):
    """`steps` faithful steps; per step the logs, the networks' state dicts,
    both generators' states and both optimizers' gradients."""
    system = _system(remat_policy)
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        mp.setattr(tstate, "make_g_optimizer",
                   lambda s, tc: _RecordingSGD(tstate.g_params(s), SGD_LR))
        mp.setattr(tstate, "make_d_optimizer",
                   lambda s, tc: _RecordingSGD(s.discriminator.parameters(), SGD_LR))
        state = tstate.create_train_state(system, init=False)
    step = tsteps.make_train_step(system)
    batch = batch_for(system.cfg, False)
    out = []
    for i in range(steps):
        logs = {k: float(v) for k, v in step(state, batch).items()}
        out.append({"logs": logs,
                    "state": {net: {k: v.clone() for k, v in m.state_dict().items()}
                              for net, m in system.networks().items()},
                    "rng": (state.coin_rng.get_state(), state.noise_rng.get_state()),
                    "grads": state.opt_g.grads[i] + state.opt_d.grads[i]})
    return out


@functools.cache
def _runs(remat_policy):
    return run_steps(remat_policy)


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _differences(got, want):
    """What differs between two runs' step: the buffers, logs and generator
    states not bit for bit, the parameters and gradients beyond GRAD_REL."""
    out = []
    for net in want["state"]:
        for key, value in want["state"][net].items():
            other = got["state"][net][key]
            buffer = key.endswith(remat.REPLAYED_BUFFERS)
            if (not torch.equal(other, value)) if buffer else _rel(other, value) > GRAD_REL:
                out.append(f"{net}.{key}")
    if got["logs"] != want["logs"]:
        out.append("logs")
    out += [name for name, a, b in zip(("coin_rng", "noise_rng"), got["rng"], want["rng"])
            if not torch.equal(a, b)]
    out += [f"grad {i}" for i, (a, b) in enumerate(zip(got["grads"], want["grads"]))
            if _rel(a, b) > GRAD_REL]
    return out


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_buffers_are_bit_for_bit(policy, step):
    got, want = _runs(policy)[step]["state"], _runs(None)[step]["state"]
    keys = [(net, k) for net in want for k in want[net] if k.endswith(remat.REPLAYED_BUFFERS)]
    assert any(k.endswith("weight_u") for _, k in keys)
    assert any(k.endswith("running_mean") for _, k in keys)
    assert [(net, k) for net, k in keys if not torch.equal(got[net][k], want[net][k])] == []


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_generators_and_logs_are_bit_for_bit(policy, step):
    got, want = _runs(policy)[step], _runs(None)[step]
    assert got["logs"] == want["logs"]
    assert all(torch.equal(a, b) for a, b in zip(got["rng"], want["rng"]))


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_parameters_and_gradients_match(policy, step):
    got, want = _runs(policy)[step], _runs(None)[step]
    assert _differences(got, want) == []
    assert len(got["grads"]) == len(want["grads"]) > 0


def test_injected_noise_reaches_the_step():
    """The step's noise counts: another noise seed moves the G step's
    losses, so a recompute with other noise would show in the comparison."""
    system = _system()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state = tstate.create_train_state(system, init=False)
    state.noise_rng.manual_seed(1234)
    logs = tsteps.make_train_step(system)(state, batch_for(system.cfg, False))
    assert float(logs["GAN"]) != _runs(None)[0]["logs"]["GAN"]


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_without_replay_breaks_the_comparison(monkeypatch, policy):
    """The planted fault: the recompute starts from the post-forward u, v,
    running statistics and noise generator and leaves them advanced twice."""
    monkeypatch.setattr(remat._Replay, "recompute", lambda self: contextlib.nullcontext())
    got, want = run_steps(policy, steps=1)[0], _runs(None)[0]
    broken = _differences(got, want)
    assert any(k.endswith(("weight_u", "weight_v")) for k in broken), broken
    assert any(k.endswith(("running_mean", "running_var")) for k in broken), broken
    assert "noise_rng" in broken and "logs" in broken


def _generator_grads(variant, policy, model=()):
    """One training forward and backward of the generator alone; returns the
    output, the input and parameter gradients and the buffers after it."""
    exp = tiny_test_experiment()
    cfg = dataclasses.replace(exp.model, **dict(model))
    gen = DeepSEEGenerator(cfg, variant=variant, remat=policy is not None,
                           remat_policy=policy or "full").train()
    for m in gen.modules():
        if hasattr(m, "init_params"):
            m.init_params(torch.Generator().manual_seed(0))
    randomize_weights([gen], torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    s = cfg.start_size
    lr = torch.randn(2, 3, s, s, generator=g).contiguous(memory_format=torch.channels_last)
    labels = torch.randint(0, cfg.semantic_nc, (2, cfg.crop_size, cfg.crop_size), generator=g)
    seg = torch.nn.functional.one_hot(labels, cfg.semantic_nc).permute(0, 3, 1, 2).float()
    seg = seg.contiguous(memory_format=torch.channels_last)
    style = torch.randn(2, cfg.label_nc, cfg.regional_style_size, generator=g)
    lr.requires_grad_(True)
    style.requires_grad_(True)
    noise = torch.Generator().manual_seed(3)
    out = gen(lr, seg, style, generator=noise)
    weights = torch.randn(out.shape, generator=g)
    grads = torch.autograd.grad((out * weights).sum(), [lr, style] + list(gen.parameters()),
                                allow_unused=True)
    buffers = {k: v.clone() for k, v in gen.state_dict().items()
               if k.endswith(remat.REPLAYED_BUFFERS)}
    return out.detach(), grads, buffers, noise.get_state()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("variant", VARIANTS + ("fold",))
def test_generator_remat_matches_plain(variant, policy):
    """Each variant's blocks (SEAN, SPADE, pix2pixHD, PureSEAN) and the
    folded modulation conv (fold_upsampled_mod_conv with the feature maps
    capped below the top block; the fm-resize quirk, which needs a style
    width of 128, off)."""
    model = ((("fold_upsampled_mod_conv", True), ("max_fm_size", 16),
              ("replicate_fm_resize_quirk", False)) if variant == "fold" else ())
    variant = "deepsee" if variant == "fold" else variant
    want = _generator_grads(variant, None, model)
    got = _generator_grads(variant, policy, model)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a, b) <= GRAD_REL
    assert got[2].keys() == want[2].keys() and all(torch.equal(got[2][k], want[2][k])
                                                   for k in want[2])
    assert torch.equal(got[3], want[3])


def test_remat_applies_to_training_forwards_that_record_a_graph(monkeypatch):
    """Every block (head_0, G_middle_0/1, each up_i) of a training forward
    with grad; not under torch.no_grad, not in eval mode, not without
    remat."""
    calls = []
    real = remat.checkpoint_block
    monkeypatch.setattr(remat, "checkpoint_block",
                        lambda block, *a, **k: calls.append(block) or real(block, *a, **k))
    system = _system("full")
    gen, cfg = system.generator, system.cfg
    blocks = [gen.head_0, gen.G_middle_0, gen.G_middle_1] + list(gen.up_list)
    assert len(blocks) == 3 + cfg.n_blocks - 1
    noise = torch.Generator().manual_seed(0)
    args = (torch.zeros(1, 3, cfg.start_size, cfg.start_size),
            torch.zeros(1, cfg.semantic_nc, cfg.crop_size, cfg.crop_size),
            torch.zeros(1, cfg.label_nc, cfg.regional_style_size))
    args = tuple(a.contiguous(memory_format=torch.channels_last) if a.dim() == 4 else a
                 for a in args)
    gen(*args, generator=noise)
    assert calls == blocks
    calls.clear()
    with torch.no_grad():
        gen(*args, generator=noise)
    gen.eval()
    gen(*args)
    gen.train().remat = False
    gen(*args, generator=noise)
    assert calls == []


def test_convs_policy_saves_the_conv2d_outputs(monkeypatch):
    """Under "convs" the ops saved are those run inside Conv2d's conv: one
    convolution per Conv2d module of the block (trunk and mlp_shared convs),
    none for the folded modulation convs."""
    saved, real = [], remat._save_conv_outputs

    def recording(ctx, op, *args, **kwargs):
        policy = real(ctx, op, *args, **kwargs)
        if policy == remat.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return policy

    monkeypatch.setattr(remat, "_save_conv_outputs", recording)
    gen = _system("convs").generator
    block = gen.G_middle_0
    cfg = gen.up_list[0].norm_0.cfg
    hw = 2 * cfg.start_size
    x = torch.randn(1, 16 * cfg.ngf, hw, hw, requires_grad=True).contiguous(
        memory_format=torch.channels_last)
    seg = torch.zeros(1, cfg.semantic_nc, cfg.crop_size, cfg.crop_size).contiguous(
        memory_format=torch.channels_last)
    style = torch.zeros(1, cfg.label_nc, cfg.regional_style_size)
    remat.checkpoint_block(block, "convs", x, seg, style, torch.Generator().manual_seed(0))
    convs = [m for m in block.modules() if isinstance(m, Conv2d)]
    assert len(convs) == 4  # conv_0, conv_1 and each norm's mlp_shared
    assert saved.count(torch.ops.aten.convolution.default) == len(convs)
    assert set(saved) <= {torch.ops.aten.convolution.default, torch.ops.aten.clone.default}


@pytest.mark.parametrize("policy", POLICIES)
def test_k1_runs_again_in_each_recompute(monkeypatch, policy):
    """Under remat a step runs K1's training forward once more for each
    norm of the generator's blocks (two per block), in the G step's
    backward; its backward runs as often as without remat."""
    counts = {"forward": 0, "backward": 0}
    for name, key in (("modnorm_train_plain", "forward"), ("modnorm_backward_plain", "backward")):
        real = getattr(mn, name)
        monkeypatch.setattr(mn, name, functools.partial(
            lambda real, key, *a, **k: counts.__setitem__(key, counts[key] + 1) or real(*a, **k),
            real, key))
    per_step = {}
    for p in (None, policy):
        counts.update(forward=0, backward=0)
        run_steps(p, steps=1)
        per_step[p] = dict(counts)
    blocks = 3 + tiny_test_experiment().model.n_blocks - 1
    assert per_step[policy]["forward"] == per_step[None]["forward"] + 2 * blocks
    assert per_step[policy]["backward"] == per_step[None]["backward"]


def test_unknown_policy_is_refused():
    with pytest.raises(ValueError, match="remat_policy"):
        DeepSEEGenerator(tiny_test_experiment().model, remat=True, remat_policy="dots")
