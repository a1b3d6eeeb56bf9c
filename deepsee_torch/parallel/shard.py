"""Tensor parallelism's plan and state, port of the parameter half of
deepsee_tpu/parallel/mesh.py (`_spec_for`, `_vgg_spec`, `_bias_spec_for`,
`system_sharding`, `shard_system_variables`, `train_state_shardings`,
`shard_train_state`, `host_local_variables`).

`shard_plan(net, n_model, min_shard_ch)` gives every parameter of G, E, D
or the VGG19 one of "column" (a block of the OIHW weight's output
channels, axis 0), "row" (a block of its input channels, axis 1) or None
(replicated), the JAX package's spec for the same parameter: Megatron
column -> row pairs, a bias following a column kernel, narrow kernels
replicated.  The rules work on the JAX package's names, which the port's
module names map onto one to one (deepsee_torch/weights.py's key map):
a conv's name is the module holding it, "conv" for the conv inside a
normed encoder or discriminator layer, and the Sequential that holds a
raw conv ("mlp_shared", "model0").  Spectral u/v and running statistics
stay replicated, full and equal on every rank (mesh.py:225-227).

`shard_system` keeps, on each rank, its block of every sharded parameter
(in place, before the optimizers are made: their Adam moments then shard
exactly as their parameters, which is what train_state_shardings's
_map_like does), each parameter's spec in its `tp_shard`, which is
where the layers read their role (`Conv2d.shard`, `ConvParams.shard`).  `gather_state_dict` and
`gather_optimizer_state` put the blocks of every model rank back together
(for the checkpoint, the in-training evaluation and the display, as
host_local_variables does); `local_state_dict` and `local_optimizer_state`
cut a full state down to this rank's blocks (a restore).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from deepsee_torch.config import MeshConfig
from deepsee_torch.models.layers import Conv2d, NonSpadeNormConv
from deepsee_torch.models.normalization import ConvParams
from deepsee_torch.models.vgg import VGG19Features
from deepsee_torch.parallel import distributed
from deepsee_torch.parallel import tensor as tp

# deepsee_tpu/parallel/mesh.py:154-172
_COLUMN = re.compile(r"(conv_0|initial|mlp_gamma|mlp_beta|mlp_style_gamma|mlp_style_beta)$")
_ROW = re.compile(r"(conv_1)$")
_AUX_COLUMN = re.compile(r"(down1|conv1|model\d*[13579])$")
_AUX_ROW = re.compile(r"(up_conv|conv2|model\d*[02468])$")
# don't shard narrow kernels (mesh.py's _MIN_SHARD_CH); `shard_system` reads
# it at each call (the tests' tiny networks shard at 8, as the JAX package's
# multichip test passes min_shard_ch=8 to shard_train_state)
MIN_SHARD_CH = 128

_AXIS = {tp.COLUMN: 0, tp.ROW: 1}


def _conv_spec(path, name: str, shape, n_model: int, min_shard_ch: int) -> Optional[str]:
    """_spec_for on an OIHW weight: `path` the module names down to the
    conv, `name` the JAX package's name of the module holding the kernel."""
    if len(shape) != 4 or n_model <= 1:
        return None
    cout, cin = shape[0], shape[1]
    col_ok = cout % n_model == 0 and cout >= min_shard_ch
    row_ok = cin % n_model == 0 and cin >= min_shard_ch
    if _ROW.search(name) and row_ok:
        return tp.ROW
    # norm_1 modulates conv_1's input side: keep it with the column
    if (_COLUMN.search(name) or "norm_1" in path) and col_ok:
        return tp.COLUMN
    for comp in path:
        if _AUX_COLUMN.search(comp):
            return tp.COLUMN if col_ok else None
        if _AUX_ROW.search(comp):
            return tp.ROW if row_ok else None
    return None


def _vgg_spec(idx: int, shape, n_model: int, min_shard_ch: int) -> Optional[str]:
    """_vgg_spec: odd conv column, even conv row, where wide enough."""
    if n_model <= 1:
        return None
    cout, cin = shape[0], shape[1]
    if idx % 2 == 1 and cout % n_model == 0 and cout >= min_shard_ch:
        return tp.COLUMN
    if idx % 2 == 0 and cin % n_model == 0 and cin >= min_shard_ch:
        return tp.ROW
    return None


def _jax_name(modules: Mapping[str, nn.Module], qualified: str) -> str:
    """The name the JAX package gives the module that holds this conv's
    kernel."""
    parent, _, attr = qualified.rpartition(".")
    if isinstance(modules.get(parent), NonSpadeNormConv):
        return "conv"
    if attr.isdigit():  # a Sequential slot: mlp_shared.0, model<N>.0
        return parent.rpartition(".")[2]
    return attr


def shard_plan(net: nn.Module, n_model: int,
               min_shard_ch: int = MIN_SHARD_CH) -> Dict[str, Optional[str]]:
    """Every parameter name of `net` -> "column", "row" or None (the JAX
    package's system_sharding for the same variable)."""
    plan: Dict[str, Optional[str]] = {name: None for name, _ in net.named_parameters()}
    if isinstance(net, VGG19Features):
        convs = [(q, m) for q, m in net.named_modules() if isinstance(m, nn.Conv2d)]
        for i, (q, m) in enumerate(convs):
            spec = _vgg_spec(i, m.weight.shape, n_model, min_shard_ch)
            plan[_key(q, "weight")] = spec
            if spec == tp.COLUMN:
                plan[_key(q, "bias")] = spec
        return plan
    modules = dict(net.named_modules())
    for q, m in modules.items():
        if not isinstance(m, (Conv2d, ConvParams)):
            continue
        weight = "weight_orig" if getattr(m, "spectral", False) else "weight"
        spec = _conv_spec(q.split("."), _jax_name(modules, q), getattr(m, weight).shape,
                          n_model, min_shard_ch)
        plan[_key(q, weight)] = spec
        if spec == tp.COLUMN and m.bias is not None:
            plan[_key(q, "bias")] = spec
    return plan


def _key(module_name: str, leaf: str) -> str:
    return f"{module_name}.{leaf}" if module_name else leaf


def _block(t: torch.Tensor, spec: str) -> torch.Tensor:
    """This rank's block of a weight, bias or moment, contiguous."""
    axis, n = _AXIS[spec], distributed.model_world()
    c = t.shape[axis] // n
    return t.narrow(axis, distributed.model_rank() * c, c).contiguous().clone()


def shard_module(net: nn.Module, plan: Mapping[str, Optional[str]]) -> None:
    """This rank's block of every parameter the plan shards, in place, and
    each parameter's spec in its `tp_shard` (the layers read their role
    there)."""
    params = dict(net.named_parameters())
    with torch.no_grad():
        for name, spec in plan.items():
            params[name].tp_shard = spec
            if spec is not None:
                params[name].data = _block(params[name].data, spec)


def _spec(p: torch.Tensor) -> Optional[str]:
    return getattr(p, "tp_shard", None)


def shard_system(system, mesh: MeshConfig) -> None:
    """Shard G, E, D and the VGG19 of `system` over this rank's model group
    (model_axis ranks, as `distributed.set_model_axis` laid them out), from
    the full weights every rank holds alike, kernels narrower than
    MIN_SHARD_CH replicated.  Under a spatial layout, which stripes the
    activations (parallel/spatial.py), every parameter stays whole: nothing
    is cut."""
    n = distributed.model_world()
    if mesh.model_axis != n:
        raise ValueError(f"model_axis {mesh.model_axis}, but the model group has {n} rank(s)")
    if mesh.spatial:
        return
    for net in system.networks().values():
        shard_module(net, shard_plan(net, n, MIN_SHARD_CH))


def gathered(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t, shaped as this rank's block of parameter p (its value, its
    gradient), whole: the blocks of the model ranks concatenated where p is
    sharded, t itself where not.  Every rank of the model group calls it."""
    return tp.all_gather_values(t, _AXIS[_spec(p)]) if _spec(p) else t


def gather_state_dict(net: nn.Module) -> Dict[str, torch.Tensor]:
    """`net`'s state_dict with every sharded parameter whole (the blocks of
    the model ranks concatenated).  Every rank of the model group calls it."""
    sd = net.state_dict()
    for name, p in net.named_parameters():
        sd[name] = gathered(p, sd[name])
    return sd


def local_state_dict(net: nn.Module, full: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full state_dict of `net` cut to this rank's blocks."""
    specs = {name: _spec(p) for name, p in net.named_parameters()}
    return {k: (_block(v, specs[k]) if specs.get(k) else v) for k, v in full.items()}


def _map_moments(opt: torch.optim.Optimizer, state: Dict, fn) -> Dict:
    """`state` (an optimizer state_dict) with fn(tensor, spec) applied to
    each per-element state tensor (Adam's moments) of a sharded parameter."""
    params = [p for group in opt.param_groups for p in group["params"]]
    out = dict(state, state={})
    for idx, entry in state["state"].items():
        spec = _spec(params[int(idx)])
        out["state"][idx] = {k: (fn(v, spec) if spec and torch.is_tensor(v) and v.dim() else v)
                             for k, v in entry.items()}
    return out


def gather_optimizer_state(opt: torch.optim.Optimizer) -> Dict:
    """opt.state_dict() with the moments of sharded parameters whole."""
    return _map_moments(opt, opt.state_dict(),
                        lambda v, spec: tp.all_gather_values(v, _AXIS[spec]))


def local_optimizer_state(opt: torch.optim.Optimizer, full: Dict) -> Dict:
    """A full optimizer state_dict cut to this rank's blocks."""
    return _map_moments(opt, full, _block)
