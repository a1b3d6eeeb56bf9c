"""Weight bridge: the JAX package's variable trees -> the port's state_dict,
and the reference's released `<epoch>_net_{SR,E}.pth` files -> the port.

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

__all__ = ["jax_to_state_dict", "randomize_weights", "load_reference_checkpoint",
           "reference_state_dict"]

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


def load_reference_checkpoint(system, checkpoint_dir: str, epoch: str = "latest") -> None:
    """Load `<epoch>_net_SR.pth` (and `<epoch>_net_E.pth` where the system
    has an encoder) from `checkpoint_dir` into `system`'s networks with
    strict key checking."""
    nets = {"SR": system.generator, "E": system.encoder}
    for tag, net in nets.items():
        if net is None:
            continue
        path = os.path.join(checkpoint_dir, f"{epoch}_net_{tag}.pth")
        net.load_state_dict(reference_state_dict(path), strict=True)
