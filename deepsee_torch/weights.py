"""Weight bridge: the JAX package's variable trees -> the port's state_dict,
and the reference's `<epoch>_net_{SR,E,D}.pth` files <-> the port.

Takes one network's `{"params", "batch_stats", "spectral"}` tree as nested
mappings of arrays (numpy, or anything `np.asarray` accepts) and returns a
state_dict in the reference torch layout, which is the port's own module
layout, so `module.load_state_dict(sd, strict=True)` is the check.  The key
rules are an own copy of deepsee_tpu/utils/torch_import.py:35-75:

  flax module path -> torch module path (the _RULES rewrites)
  HWIO kernels      -> OIHW weights, `weight_orig` under spectral norm
  spectral v        -> torch's (I, KH, KW) flatten order
  batch_stats       -> running_mean / running_var
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepsee_torch.models.layers import Conv2d
from deepsee_torch.models.normalization import ConvParams, ParamFreeNorm
from deepsee_torch.parallel.shard import local_state_dict

__all__ = ["jax_to_state_dict", "vgg_jax_to_state_dict", "lpips_jax_to_state_dict",
           "inception_jax_to_state_dict", "randomize_weights",
           "load_reference_checkpoint", "reference_state_dict", "complete_for_reference",
           "save_reference_checkpoint"]

_RULES = (
    # generator: up_<i> modules live in an nn.ModuleList named up_list
    (re.compile(r"^up_(\d+)(\.|$)"), r"up_list.\1\2"),
    (re.compile(r"(^|\.)pfn\.param_free_norm"), r"\1param_free_norm"),
    # standalone encoders place their trunk layers at the top level
    (re.compile(r"^trunk\."), ""),
    (re.compile(r"(^|\.)core\.mlp_shared"), r"\1mlp_shared"),
    # SPADE/SEAN mlp_shared is Sequential(conv, relu)
    (re.compile(r"(^|\.)mlp_shared$"), r"\1mlp_shared.0"),
    # encoder trunk layers: Sequential(Sequential(conv, norm), lrelu) ...
    (re.compile(r"(^|\.)(initial|down0|down1|conv0|conv1)\.conv$"), r"\1\2.0.0"),
    (re.compile(r"(^|\.)(initial|down0|down1|conv0|conv1)\.norm$"), r"\1\2.0.1"),
    # ... with a leading Upsample: Sequential(Upsample, Seq(conv, norm), lrelu)
    (re.compile(r"(^|\.)(up_conv|conv2)\.conv$"), r"\1\2.1.0"),
    (re.compile(r"(^|\.)(up_conv|conv2)\.norm$"), r"\1\2.1.1"),
    # shared final head: Sequential(Seq(conv, norm), tanh)
    (re.compile(r"(^|\.)final\.conv\.conv$"), r"\1final.0.0"),
    (re.compile(r"(^|\.)final\.conv\.norm$"), r"\1final.0.1"),
    # the style-noise wrapper is flattened into the encoder
    (re.compile(r"(^|\.)style_noise$"), r"\1"),
    # pix2pixHD block: Sequential(pad, Seq(conv, norm), relu, pad, Seq(conv, norm))
    (re.compile(r"(^|\.)conv_block_0\.conv$"), r"\1conv_block.1.0"),
    (re.compile(r"(^|\.)conv_block_1\.conv$"), r"\1conv_block.4.0"),
    # discriminator: Sequential(layer, LeakyReLU), the hidden layers'
    # layer itself Sequential(conv, norm)
    (re.compile(r"(^|\.)(model\d+)\.conv$"), r"\1\2.0.0"),
    (re.compile(r"(^|\.)(model\d+)\.norm$"), r"\1\2.0.1"),
    (re.compile(r"(^|\.)(model\d+)$"), r"\1\2.0"),
)

_LEAF = {"kernel": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var", "scale": "weight", "u": "weight_u",
         "v": "weight_v"}


def _torch_key(path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    name = ".".join(mods)
    for pat, rep in _RULES:
        name = pat.sub(rep, name)
    name = name.strip(".")
    mapped = _LEAF.get(leaf, leaf)
    return f"{name}.{mapped}" if name else mapped


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def jax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """One network's JAX variables -> float32 CPU state_dict."""
    params = _flatten(variables.get("params", {}))
    spectral_mods = {p[:-1] for p in _flatten(variables.get("spectral", {}))
                     if p[-1] == "u"}
    sd: Dict[str, torch.Tensor] = {}
    for coll, tree in variables.items():
        for path, val in _flatten(tree).items():
            key = _torch_key(path)
            arr = np.array(val, dtype=np.float32)  # a writable copy
            if coll == "params" and path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                if path[:-1] in spectral_mods:
                    key = key[: -len("weight")] + "weight_orig"
            elif coll == "spectral" and path[-1] == "v":
                kh, kw, cin, _ = params[path[:-1] + ("kernel",)].shape
                arr = arr.reshape(kh, kw, cin).transpose(2, 0, 1).reshape(-1)
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def vgg_jax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's VGG19 tree ({"params": {"conv<i>_kernel" (HWIO),
    "conv<i>_bias"}}) -> the port's torchvision-layout state_dict
    (`features.<N>.weight` OIHW, `features.<N>.bias`)."""
    from deepsee_torch.models.vgg import VGG19Features

    params = variables.get("params", variables)
    index = [int(k.split(".")[1]) for k in VGG19Features().state_dict() if k.endswith("weight")]
    sd = {}
    for i, n in enumerate(index):
        kernel = np.array(params[f"conv{i}_kernel"], dtype=np.float32)
        sd[f"features.{n}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        sd[f"features.{n}.bias"] = torch.from_numpy(
            np.array(params[f"conv{i}_bias"], dtype=np.float32))
    return sd


def _oihw(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.array(kernel, dtype=np.float32).transpose(3, 2, 0, 1)))


def _f32(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))


def lpips_jax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS parameters ({"conv<i>_kernel" (HWIO),
    "conv<i>_bias", "lin<i>" (C,)}) -> the state_dict of the port's
    `eval.lpips.LPIPS` (`net.features.<N>.weight` OIHW and `.bias` at
    torchvision's indices, `lin<i>.model.1.weight` (1, C, 1, 1))."""
    sd = {}
    for i, n in enumerate((0, 3, 6, 8, 10)):
        sd[f"net.features.{n}.weight"] = _oihw(params[f"conv{i}_kernel"])
        sd[f"net.features.{n}.bias"] = _f32(params[f"conv{i}_bias"])
        sd[f"lin{i}.model.1.weight"] = _f32(params[f"lin{i}"]).reshape(1, -1, 1, 1)
    return sd


def inception_jax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's Inception parameters ({name: {"kernel" (HWIO),
    "bn_scale", "bn_bias", "bn_mean", "bn_var"}}) -> the state_dict of the
    port's `eval.fid.FIDInception`, in pt_inception's keys."""
    sd = {}
    for name, p in params.items():
        sd[f"{name}.conv.weight"] = _oihw(p["kernel"])
        for jax_key, key in (("bn_scale", "weight"), ("bn_bias", "bias"),
                             ("bn_mean", "running_mean"), ("bn_var", "running_var")):
            sd[f"{name}.bn.{key}"] = _f32(p[jax_key])
    return sd


def randomize_weights(nets: Iterable[torch.nn.Module], generator: torch.Generator) -> None:
    """Seeded random weights shaped like a trained model's, for runs without
    a checkpoint: conv weights N(0, 1/fan_in), biases N(0, 0.1^2), spectral
    u/v converged by power iteration (so sigma is the spectral norm, not a
    random projection that blows the activations up), running means
    N(0, 0.5^2) and variances U[0.5, 2).  `generator` is a CPU generator."""
    with torch.no_grad():
        for net in nets:
            for m in net.modules():
                if isinstance(m, (Conv2d, ConvParams)):
                    spectral = getattr(m, "spectral", False)
                    w = m.weight_orig if spectral else m.weight
                    w.copy_(torch.randn(w.shape, generator=generator)
                            / math.sqrt(w[0].numel()))
                    if m.bias is not None:
                        m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=generator))
                    if spectral:
                        mat, u = w.reshape(w.shape[0], -1), m.weight_u
                        for _ in range(50):
                            v = F.normalize(mat.t() @ u, dim=0)
                            u = F.normalize(mat @ v, dim=0)
                        m.weight_u.copy_(u)
                        m.weight_v.copy_(v)
                elif isinstance(m, ParamFreeNorm) and m.kind != "instance":
                    m.running_mean.copy_(0.5 * torch.randn(m.running_mean.shape,
                                                           generator=generator))
                    m.running_var.copy_(0.5 + 1.5 * torch.rand(m.running_var.shape,
                                                               generator=generator))


# Keys of the reference's modules with no counterpart in the port (an own
# copy of deepsee_tpu/utils/torch_import.py:249-282): torch's batch-norm
# bookkeeping, the dead `style_conv` Conv1d of every SEAN/PureSEAN block,
# and the dead per-trunk `final` heads of the combined encoder, which the
# reference builds but its forward never reads.
_DEAD_KEY = re.compile(r"(^|\.)num_batches_tracked$|(^|\.)style_conv\.(weight|bias)$"
                       r"|^encoder_(full|mini)\.final\.")


def reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """One reference `.pth` file -> the port's state_dict: unwraps the
    reference's {"model": sd} (util/util.py:217-224) and drops the keys
    that have no port counterpart."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and set(sd) == {"model"}:
        sd = sd["model"]
    return {k: v for k, v in sd.items() if not _DEAD_KEY.search(k)}


def load_reference_checkpoint(system, checkpoint_dir: str, epoch: str = "latest",
                              include_d: bool = False) -> None:
    """Load `<epoch>_net_SR.pth` (and `<epoch>_net_E.pth` where the system
    has an encoder, `<epoch>_net_D.pth` with include_d) from
    `checkpoint_dir` into `system`'s networks with strict key checking,
    each file cut to this rank's blocks of the networks' sharded parameters
    (tensor parallelism; as it is where nothing is sharded)."""
    nets = {"SR": system.generator, "E": system.encoder}
    if include_d:
        nets["D"] = system.discriminator
    for tag, net in nets.items():
        if net is None:
            continue
        path = os.path.join(checkpoint_dir, f"{epoch}_net_{tag}.pth")
        net.load_state_dict(local_state_dict(net, reference_state_dict(path)), strict=True)


def complete_for_reference(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's state_dict plus the keys of the reference's modules that
    the port does not build (an own copy of
    deepsee_tpu/utils/torch_import.py:249-280), as zeros the reference never
    reads, so its strict `load_state_dict` takes the file: torch's
    `num_batches_tracked` beside every running mean, the dead `style_conv`
    of every SEAN/PureSEAN block, the dead per-trunk `final` heads of the
    combined encoder."""
    out = {k: v.detach().cpu() for k, v in sd.items()}
    if any(k.startswith("encoder_full.") for k in sd):
        for key, val in sd.items():
            if key.startswith("final."):
                out["encoder_full." + key] = torch.zeros_like(out[key])
                out["encoder_mini." + key] = torch.zeros_like(out[key])
    for key in list(out):
        if key.endswith("running_mean"):
            out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(
                0, dtype=torch.int64)
        if key.endswith("mlp_style_gamma.weight"):
            base = key[: -len("mlp_style_gamma.weight")]
            out[base + "style_conv.weight"] = torch.zeros(19, 19, 1)
            out[base + "style_conv.bias"] = torch.zeros(19)
    return out


def save_reference_checkpoint(nets: Mapping[str, Any], checkpoint_dir: str,
                              epoch: str = "latest") -> Dict[str, str]:
    """Write `<epoch>_net_<tag>.pth` for each {tag: network or its
    state_dict} in the reference's save_network format ({"model":
    state_dict}, util/util.py:217-224); returns {tag: path}."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    written = {}
    for tag, net in nets.items():
        path = os.path.join(checkpoint_dir, f"{epoch}_net_{tag}.pth")
        sd = net.state_dict() if isinstance(net, torch.nn.Module) else net
        torch.save({"model": complete_for_reference(sd)}, path + ".tmp")
        os.replace(path + ".tmp", path)  # a crash never leaves half a file
        written[tag] = path
    return written
