"""The port's tensor-parallel plan (deepsee_torch/parallel/shard.py::
shard_plan) against the JAX package's (deepsee_tpu/parallel/mesh.py::
system_sharding, as train_state_shardings applies it), parameter for
parameter through the weight bridge's key map, for G, E (both trunks, or
the guided model's full one), D and the VGG19.

The JAX variables come from jax.eval_shape of the system's init on the
conftest's 8 CPU devices (shapes only, as mesh.py:315-317's AOT path uses
them); the port's networks are built on the meta device.  Both at n_model
2 and 4, at the tiny width with min_shard_ch 8 (tests/test_train_step.py's
multichip configuration: ngf=8) and at full width with the default 128.
"""

import dataclasses

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepsee_torch.config import get_preset as torch_preset
from deepsee_torch.config import tiny_test_experiment as torch_tiny
from deepsee_torch.models.discriminator import MultiscaleDiscriminator
from deepsee_torch.models.encoder import build_encoder
from deepsee_torch.models.generator import DeepSEEGenerator
from deepsee_torch.models.vgg import VGG19Features
from deepsee_torch.parallel.shard import shard_plan
from deepsee_torch.weights import _flatten, _torch_key
from deepsee_tpu.config import MeshConfig
from deepsee_tpu.config import get_preset as jax_preset
from deepsee_tpu.config import tiny_test_experiment as jax_tiny
from deepsee_tpu.parallel.mesh import make_mesh, system_sharding
from deepsee_tpu.system import SRSystem as JaxSystem

CONFIGS = {"tiny_ngf8": 8, "8x_independent_256x256": 128, "32x_guided_512x512": 128,
           "8x_guided_256x256": 128}


def _experiments(name):
    if name == "tiny_ngf8":
        exps = [jax_tiny(), torch_tiny()]
        return [e.replace(model=dataclasses.replace(e.model, ngf=8)) for e in exps]
    return [jax_preset(name), torch_preset(name)]


def _spec_name(spec: P):
    spec = tuple(spec)
    if not any(spec):
        return None
    if spec in (("model",), (None, None, None, "model")):
        return "column"
    assert spec == (None, None, "model", None), spec
    return "row"


def _jax_plans(jexp, n_model, min_shard_ch):
    """Per network, the port's key -> the JAX spec of its parameter."""
    variables = jax.eval_shape(JaxSystem(jexp).init, jax.random.PRNGKey(0))
    mesh = make_mesh(MeshConfig(1, n_model))
    vgg_index = [int(k.split(".")[1]) for k in VGG19Features().state_dict()
                 if k.endswith("weight")]
    plans = {}
    for net in ("g", "e", "d", "vgg"):
        tree = getattr(variables, net)
        shardings = _flatten(system_sharding(tree, mesh, min_shard_ch=min_shard_ch))
        # everything but the parameters (batch stats, spectral u/v) replicates
        assert all(_spec_name(s.spec) is None for path, s in shardings.items()
                   if path[0] != "params"), net
        spectral = {p[:-1] for p in _flatten(tree.get("spectral", {}))}
        plan = {}
        for path, sharding in shardings.items():
            if path[0] != "params":
                continue
            if net == "vgg":
                i, leaf = path[1].removeprefix("conv").split("_")
                key = f"features.{vgg_index[int(i)]}.{'weight' if leaf == 'kernel' else 'bias'}"
            else:
                key = _torch_key(path[1:])
                if path[-1] == "kernel" and path[1:-1] in spectral:
                    key = key[:-len("weight")] + "weight_orig"
            plan[key] = _spec_name(sharding.spec)
        plans[net] = plan
    return plans


def _port_nets(texp):
    cfg = texp.model
    with torch.device("meta"):
        return {"g": DeepSEEGenerator(cfg), "e": build_encoder(cfg),
                "d": MultiscaleDiscriminator(cfg), "vgg": VGG19Features()}


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plan_is_the_jax_packages(name, n_model):
    min_shard_ch = CONFIGS[name]
    jexp, texp = _experiments(name)
    want = _jax_plans(jexp, n_model, min_shard_ch)
    for net, module in _port_nets(texp).items():
        got = shard_plan(module, n_model, min_shard_ch)
        assert set(got) == set(want[net]), (net, sorted(set(got) ^ set(want[net]))[:6])
        diff = {k: (got[k], want[net][k]) for k in got if got[k] != want[net][k]}
        assert not diff, (net, diff)
        assert any(got.values()), f"{net}: nothing sharded"


def test_plan_edge_cases():
    """The rules' corners, at the tiny width: norm_1's mlp_shared takes the
    column spec of its modulation convs, norm_0's stays replicated; a raw
    discriminator conv (model0, 22 input channels) is a row shard only
    where 22 >= min_shard_ch, and a layer too narrow for its spec stays
    replicated; conv_s, conv_img and the encoders' first
    layers and heads stay replicated; a bias follows a column kernel only."""
    _, texp = _experiments("tiny_ngf8")
    nets = _port_nets(texp)
    g = shard_plan(nets["g"], 2, 8)
    assert g["head_0.norm_1.mlp_shared.0.weight"] == "column"
    assert g["head_0.norm_1.mlp_shared.0.bias"] == "column"
    assert g["G_middle_0.norm_0.mlp_shared.0.weight"] is None
    assert g["G_middle_0.conv_1.weight_orig"] == "row"
    assert g["G_middle_0.conv_1.bias"] is None
    assert g["initial.weight"] == g["initial.bias"] == "column"
    assert g["conv_img.weight"] is None and g["G_middle_0.norm_0.alpha_gamma"] is None
    e = shard_plan(nets["e"], 2, 8)
    assert e["encoder_full.initial.0.0.weight_orig"] is None
    assert e["encoder_mini.conv1.0.0.weight_orig"] == "column"
    assert e["encoder_mini.conv2.1.0.weight_orig"] == "row"
    assert e["final.0.0.weight_orig"] is None
    d8, d128 = shard_plan(nets["d"], 2, 8), shard_plan(nets["d"], 2, 128)
    assert d8["discriminator_0.model0.0.weight"] == "row"
    assert d128["discriminator_0.model0.0.weight"] is None
    assert d8["discriminator_1.model3.0.0.weight_orig"] == "column"
    # full width (ndf 32): 22 -> 32 -> 64 -> 128 -> 256 -> 1, the pair model3 -> model4
    _, full = _experiments("8x_independent_256x256")
    d = shard_plan(_port_nets(full)["d"], 2, 128)
    assert [d[f"discriminator_0.model{i}.0.weight" if i in (0, 4) else
              f"discriminator_0.model{i}.0.0.weight_orig"] for i in range(5)] == [
        None, None, None, "column", "row"]
