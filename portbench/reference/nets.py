"""The reference networks in eval mode, as plain functions of a flat dict
of named float32 tensors (the names are the published checkpoints' module
paths, which the port keeps).

`param_spec(cfg, train)` lists every tensor the networks hold, with its
shape; the benchmark draws the values from the seed.  `cfg` is the
configuration file's "model" mapping.

Generator (DeepSEE, sr.py / architecture.py of the published code): a
3x3 conv on the LR image to 16 ngf channels, a head block (plain SPADE
where the norm string says "late"), a nearest 2x upsample, two middle
blocks, then per remaining doubling an upsample and a block; at >= 512 px
the blocks from the fourth up-block on are PureSEAN.  Leaky ReLU, a 3x3
conv to RGB, tanh.  A block is norm -> leaky ReLU -> conv twice plus the
identity (or a learned 1x1 shortcut after its own norm where the widths
differ).  A norm is the parameter-free norm (instance, or the batch norm's
running statistics in eval mode) times a scale plus an offset from one
modulation conv: SPADE convolves the shared ReLU features of the resized
one-hot map; SEAN blends those with the per-pixel style map by sigmoid
weights, which is one conv over both inputs with blended weights (the
form whose input the int8 recipe quantizes); PureSEAN uses the style map
alone and no +1 on the scale.  The feature maps of the modulation are
capped at max_fm_size and then resized to the block; with the published
quirk the resized shared features replace the style map too.

Encoders: trunk layers conv (spectral, no bias) -> instance norm -> leaky
ReLU; the combined encoder's mini trunk on the LR image (three stride-1
convs, then an upsample and a conv) or its full trunk on the HR image
(stride 1, 2, 2, then an upsample and a conv); a shared head conv ->
instance norm -> tanh; the style matrix is the masked sum of the head's
features per region over all H * W pixels, divided by H * W.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from portbench.reference import ops
from portbench.reference.ops import Quant, QuantLog

NHIDDEN = 128
Spec = Dict[str, Tuple[int, ...]]


def semantic_nc(cfg: Mapping) -> int:
    return cfg["label_nc"] + (1 if cfg.get("contain_dontcare_label", False) else 0)


def n_blocks(cfg: Mapping) -> int:
    return int(round(math.log2(cfg["crop_size"] / cfg["start_size"])))


def norm_g(cfg: Mapping) -> dict:
    """The generator norm string, e.g. "spectrallateseansyncbatch3x3"."""
    text = cfg["norm_g"]
    spectral = text.startswith("spectral")
    rest = text[len("spectral"):] if spectral else text
    kind = ("instance" if "instance" in rest else "batch")
    return {"spectral": spectral, "late": rest.startswith("late"), "sean": "sean" in rest,
            "param_free": kind, "ks": int(rest[-3])}


def guided(cfg: Mapping) -> bool:
    return "full" in cfg["net_e"]


# -- parameter names and shapes -------------------------------------------------

def _conv(spec: Spec, name: str, cin: int, cout: int, k: int, spectral: bool,
          bias: bool = True) -> None:
    spec[name + (".weight_orig" if spectral else ".weight")] = (cout, cin, k, k)
    if bias:
        spec[name + ".bias"] = (cout,)
    if spectral:
        spec[name + ".weight_u"] = (cout,)
        spec[name + ".weight_v"] = (cin * k * k,)


def _norm_spec(spec: Spec, cfg: Mapping, name: str, c: int, kind: str) -> None:
    g = norm_g(cfg)
    ks, sem = g["ks"], semantic_nc(cfg)
    if g["param_free"] != "instance":
        spec[name + ".param_free_norm.running_mean"] = (c,)
        spec[name + ".param_free_norm.running_var"] = (c,)
    _conv(spec, name + ".mlp_shared.0", sem, NHIDDEN, ks, False)
    if kind in ("spade", "sean"):
        _conv(spec, name + ".mlp_gamma", NHIDDEN, c, ks, False)
        _conv(spec, name + ".mlp_beta", NHIDDEN, c, ks, False)
    if kind in ("sean", "pure"):
        style = cfg["regional_style_size"]
        _conv(spec, name + ".mlp_style_gamma", style, c, ks, False)
        _conv(spec, name + ".mlp_style_beta", style, c, ks, False)
    if kind == "sean":
        spec[name + ".alpha_gamma"] = (1,)
        spec[name + ".alpha_beta"] = (1,)


def block_kinds(cfg: Mapping):
    """[(name, kind)] of the generator's blocks, in order."""
    g = norm_g(cfg)
    styled = "sean" if g["sean"] else "spade"
    max_full = 4 if cfg["load_size"] >= 512 else 99
    out = [("head_0", "spade" if g["late"] else styled), ("G_middle_0", styled),
           ("G_middle_1", styled)]
    out += [(f"up_list.{i}", "pure" if i + 1 >= max_full else styled)
            for i in range(n_blocks(cfg) - 1)]
    return out


def generator_spec(cfg: Mapping) -> Spec:
    g, nf = norm_g(cfg), 16 * cfg["ngf"]
    spec: Spec = {}
    _conv(spec, "initial", 3, nf, 3, False)
    for name, kind in block_kinds(cfg):
        if cfg.get("add_noise", False):
            for n in ("noise_in", "noise_skip", "noise_middle"):
                spec[f"{name}.{n}.weight"] = (nf,)
        for n in ("norm_0", "norm_1"):
            _norm_spec(spec, cfg, f"{name}.{n}", nf, kind)
        _conv(spec, f"{name}.conv_0", nf, nf, 3, g["spectral"])
        _conv(spec, f"{name}.conv_1", nf, nf, 3, g["spectral"])
    _conv(spec, "conv_img", nf, 3, 3, False)
    return spec


FULL_TRUNK = (("initial.0", 1, 1, False), ("down0.0", 2, 2, False),
              ("down1.0", 4, 2, False), ("up_conv.1", 8, 1, True))
MINI_TRUNK = (("initial.0", 1, 1, False), ("conv0.0", 2, 1, False),
              ("conv1.0", 4, 1, False), ("conv2.1", 8, 1, True))


def _trunk_spec(spec: Spec, prefix: str, layers, nef: int, cin: int = 3) -> None:
    for name, mult, _, _ in layers:
        _conv(spec, f"{prefix}{name}.0", cin, nef * mult, 3, True, bias=False)
        cin = nef * mult


def encoder_spec(cfg: Mapping) -> Spec:
    nef = cfg["nef"]
    spec: Spec = {}
    if cfg.get("noisy_style_scale", 0) > 0:
        spec["noise_weights"] = (cfg["label_nc"],)
    if guided(cfg):
        _trunk_spec(spec, "", FULL_TRUNK, nef)
    else:
        _trunk_spec(spec, "encoder_full.", FULL_TRUNK, nef)
        _trunk_spec(spec, "encoder_mini.", MINI_TRUNK, nef)
    _conv(spec, "final.0.0", 8 * nef, cfg["regional_style_size"], 3, True, bias=False)
    return spec


def param_spec(cfg: Mapping, train: bool = False) -> Dict[str, Spec]:
    """{network: {tensor name: shape}}; "g" and "e" (training adds "d" and
    "vgg")."""
    nets = {"g": generator_spec(cfg), "e": encoder_spec(cfg)}
    if train:
        from portbench.reference import train as train_ref

        nets.update(train_ref.train_spec(cfg))
    return nets


# -- the forward ------------------------------------------------------------------

class Net:
    """One network's tensors.  With `train`, a spectral conv first takes one power iteration of its
    stored u, v (recorded in `updates`, for the next forward) and divides
    by sigma of the new ones, detached; the batch norms use the batch's
    statistics (their running statistics, which no training forward reads,
    are not kept)."""

    def __init__(self, tensors: Mapping[str, torch.Tensor], q: Optional[Quant] = None,
                 log: Optional[QuantLog] = None, train: bool = False):
        self.t, self.q, self.log, self.train = tensors, q, log, train
        self.updates: Dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.t[name]

    def has(self, name: str) -> bool:
        return name in self.t

    def weight(self, name: str) -> torch.Tensor:
        """A conv's weight; a spectral one divided by sigma = u . W v of its
        stored u, v (eval mode: no power iteration)."""
        if not self.has(name + ".weight_orig"):
            return self[name + ".weight"]
        w = self[name + ".weight_orig"]
        u, v = self[name + ".weight_u"], self[name + ".weight_v"]
        m = w.reshape(w.shape[0], -1)
        if self.train:
            with torch.no_grad():
                v = _l2n(m.detach().t() @ u)
                u = _l2n(m.detach() @ v)
            self.updates[name + ".weight_u"], self.updates[name + ".weight_v"] = u, v
        return w / torch.dot(u, m @ v)

    def conv(self, x: torch.Tensor, name: str, stride: int = 1, padding: int = 1,
             weight: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        w = self.weight(name) if weight is None else weight
        if bias is None and weight is None and self.has(name + ".bias"):
            bias = self[name + ".bias"]
        return ops.conv2d(x, w, bias, stride, padding, self.q, self.log)


def _l2n(v: torch.Tensor) -> torch.Tensor:
    return v / (v.norm() + 1e-12)


def style_to_pixels(seg: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """One-hot (B, N, H, W) x style (B, N', S) -> (B, S, H, W); a dontcare
    channel beyond the style's rows gets a zero style."""
    b, n, h, w = seg.shape
    if n == style.shape[1] + 1:
        style = torch.cat([style, style.new_zeros(b, 1, style.shape[2])], 1)
    return torch.einsum("bnhw,bns->bshw", seg, style)


def modulated_norm(p: Net, cfg: Mapping, name: str, kind: str, x: torch.Tensor,
                   seg: torch.Tensor, style: Optional[torch.Tensor], lrelu: bool) -> torch.Tensor:
    g = norm_g(cfg)
    c, ks = x.shape[1], g["ks"]
    if g["param_free"] == "instance":
        xn = ops.instance_norm(x)
    elif p.train:
        xn = ops.batch_norm(x)
    else:
        xn = ops.running_norm(x, p[name + ".param_free_norm.running_mean"],
                              p[name + ".param_free_norm.running_var"])
    x_hw = tuple(x.shape[-2:])
    cap = cfg["max_fm_size"]
    fm_hw = x_hw if kind == "spade" else (min(x_hw[0], cap), min(x_hw[1], cap))
    seg_r = ops.nearest(seg, fm_hw)
    actv = torch.relu(p.conv(seg_r, name + ".mlp_shared.0", padding=ks // 2))
    style_map = None if kind == "spade" else style_to_pixels(seg_r, style)
    if fm_hw != x_hw:
        actv = ops.nearest(actv, x_hw)
        style_map = actv if cfg["replicate_fm_resize_quirk"] else ops.nearest(style_map, x_hw)
    if kind == "spade":
        w = torch.cat([p[name + ".mlp_gamma.weight"], p[name + ".mlp_beta.weight"]])
        b = torch.cat([p[name + ".mlp_gamma.bias"] + 1.0, p[name + ".mlp_beta.bias"]])
        inp = actv
    elif kind == "sean":
        wg, wb = torch.sigmoid(p[name + ".alpha_gamma"]), torch.sigmoid(p[name + ".alpha_beta"])
        gm, bt = name + ".mlp_gamma", name + ".mlp_beta"
        gs, bs = name + ".mlp_style_gamma", name + ".mlp_style_beta"
        w = torch.cat([torch.cat([(1 - wg) * p[gm + ".weight"], wg * p[gs + ".weight"]], 1),
                       torch.cat([(1 - wb) * p[bt + ".weight"], wb * p[bs + ".weight"]], 1)])
        b = torch.cat([(1 - wg) * p[gm + ".bias"] + wg * p[gs + ".bias"] + 1.0,
                       (1 - wb) * p[bt + ".bias"] + wb * p[bs + ".bias"]])
        inp = torch.cat([actv, style_map], 1)
    else:
        gs, bs = name + ".mlp_style_gamma", name + ".mlp_style_beta"
        w = torch.cat([p[gs + ".weight"], p[bs + ".weight"]])
        b = torch.cat([p[gs + ".bias"], p[bs + ".bias"]])
        inp = style_map
    mod = p.conv(inp, name, padding=ks // 2, weight=w, bias=b)
    y = xn * mod[:, :c] + mod[:, c:]
    return ops.leaky_relu(y) if lrelu else y


def resblock(p: Net, cfg: Mapping, name: str, kind: str, x: torch.Tensor, seg: torch.Tensor,
             style: Optional[torch.Tensor], noise=None, run=None) -> torch.Tensor:
    """`noise`: the (in, skip, middle) N(0, 1) maps of a training forward
    with add_noise, NCHW; each scaled per channel by its weight and added
    to the block's input, its shortcut's input and conv_0's output.
    `run(fn, *tensors)` runs each norm -> conv unit (the training reference
    checkpoints them)."""
    run = run or (lambda fn, *a: fn(*a))

    def unit(norm: str, conv: str, lrelu: bool, padding: int):
        return lambda t, sg, st: p.conv(
            modulated_norm(p, cfg, f"{name}.{norm}", kind, t, sg, st, lrelu),
            f"{name}.{conv}", padding=padding)

    if noise is not None:
        x = x + p[name + ".noise_in.weight"][:, None, None] * noise[0]
    x_s = x if noise is None else x + p[name + ".noise_skip.weight"][:, None, None] * noise[1]
    if p.has(name + ".conv_s.weight_orig") or p.has(name + ".conv_s.weight"):
        x_s = run(unit("norm_s", "conv_s", False, 0), x_s, seg, style)
    dx = run(unit("norm_0", "conv_0", True, 1), x, seg, style)
    if noise is not None:
        dx = dx + p[name + ".noise_middle.weight"][:, None, None] * noise[2]
    dx = run(unit("norm_1", "conv_1", True, 1), dx, seg, style)
    return x_s + dx


def generator(p: Net, cfg: Mapping, lr: torch.Tensor, seg: torch.Tensor,
              style: Optional[torch.Tensor], draws=None, block_fn=None) -> torch.Tensor:
    """lr (B, 3, h, w), seg (B, N, H, W) one-hot, style (B, label_nc, S) ->
    (B, 3, H, W) in [-1, 1].  A training forward with add_noise draws each
    block's noise from `draws` (in, skip, middle, in the NHWC layout the
    program draws them in); `block_fn(fn, *tensors)` runs each norm -> conv
    unit of the blocks (the training reference checkpoints them)."""
    x = p.conv(lr, "initial")
    for i, (name, kind) in enumerate(block_kinds(cfg)):
        if i == 1 or i >= 3:
            x = ops.up2(x)
        noise = None
        if p.train and cfg.get("add_noise", False):
            b, c, h, w = x.shape
            noise = tuple(draws.randn((b, h, w, c)).permute(0, 3, 1, 2) for _ in range(3))
        x = resblock(p, cfg, name, kind, x, seg, style, noise, block_fn)
    return torch.tanh(p.conv(ops.leaky_relu(x), "conv_img"))


def _trunk(p: Net, prefix: str, layers, x: torch.Tensor) -> torch.Tensor:
    for name, _, stride, upsample in layers:
        if upsample:
            x = ops.up2(x)
        x = ops.leaky_relu(ops.instance_norm(p.conv(x, f"{prefix}{name}.0", stride=stride)))
    return x


def extract_style(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) features, (B, N, Hs, Ws) one-hot -> (B, N, C): per
    region the sum of its pixels' features over all H * W pixels."""
    h, w = x.shape[-2:]
    seg = ops.nearest(seg, (h, w))
    return torch.einsum("bnhw,bchw->bnc", seg, x) / (h * w)


def _head_style(p: Net, y: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    return extract_style(torch.tanh(ops.instance_norm(p.conv(y, "final.0.0"))), seg)


def encode(p: Net, cfg: Mapping, pre: Mapping[str, torch.Tensor], use_full: bool = False,
           no_noise: bool = True, draws=None) -> torch.Tensor:
    """The style.  Guided: the full trunk on the guiding image (the HR image
    where the batch has none).  Independent: the mini trunk on the LR image,
    or with `use_full` the full trunk on the HR image; a training forward
    runs both (full first), as the published encoder does.  Unless
    `no_noise`, the learned style noise from `draws`: U[0, 1) * 2 - 1,
    times the scale and sigmoid of the region's weight, then clipped."""
    if guided(cfg):
        image = pre.get("guiding_image", pre["image_hr"])
        seg = pre.get("guiding_semantics", pre["semantics"])
        style = _head_style(p, _trunk(p, "", FULL_TRUNK, image), seg)
    else:
        styles = {}
        if use_full or p.train:
            styles[True] = _head_style(p, _trunk(p, "encoder_full.", FULL_TRUNK,
                                                 pre["image_hr"]), pre["semantics"])
        if not use_full or p.train:
            styles[False] = _head_style(p, _trunk(p, "encoder_mini.", MINI_TRUNK,
                                                  pre["image_lr"]), pre["semantics"])
        style = styles[bool(use_full)]
    if not no_noise and cfg.get("noisy_style_scale", 0) > 0:
        noise = (draws.rand(tuple(style.shape)) * 2.0 - 1.0) * cfg["noisy_style_scale"]
        style = torch.clamp(style + noise * torch.sigmoid(p["noise_weights"])[None, :, None],
                            -1.0, 1.0)
    return style


def preprocess(cfg: Mapping, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Host batch (NHWC images, (B, H, W) labels) -> NCHW tensors: the
    one-hot maps and the LR image."""
    sem = semantic_nc(cfg)
    out = {"image_hr": batch["image_hr"].permute(0, 3, 1, 2).float(),
           "semantics": ops.one_hot(batch["label"], sem)}
    out["image_lr"] = ops.downsample(out["image_hr"], cfg["start_size"])
    if "guiding_image" in batch:
        out["guiding_image"] = batch["guiding_image"].permute(0, 3, 1, 2).float()
        out["guiding_semantics"] = ops.one_hot(batch["guiding_label"], sem)
    return out


def infer(tensors: Mapping[str, Mapping[str, torch.Tensor]], cfg: Mapping,
          batch: Mapping[str, torch.Tensor], q: Optional[Quant] = None,
          log: Optional[QuantLog] = None) -> torch.Tensor:
    """The eval path: preprocess -> style -> generate; (B, H, W, 3)."""
    pre = preprocess(cfg, batch)
    g, e = Net(tensors["g"], q, log), Net(tensors["e"], q, log)
    style = encode(e, cfg, pre)
    return generator(g, cfg, pre["image_lr"], pre["semantics"], style).permute(0, 2, 3, 1)
