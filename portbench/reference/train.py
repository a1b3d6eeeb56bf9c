"""The reference's GAN training step (the published sr_model.py and
trainer: a generator update, then a discriminator update), float32.

G update: the coins (the independent model draws use_full and no_noise,
each with probability 1/2; the guided one uses (True, False)), the
encoder and the generator in training mode, the multiscale discriminator
on fake and real in one 2B batch, the generator's hinge loss, the
feature-matching L1 over every discriminator layer but the logit (x 10 /
num_D), the VGG19 L1 over five taps weighted 1/32 .. 1 (x 10); the
gradient with respect to the generator's and the encoder's parameters;
Adam (beta1 0, beta2 0.9, eps 1e-8) at lr / 2, the encoder's "mini"
parameters at a quarter of that.  D update: new coins, the fake
regenerated without a gradient by the updated generator, the hinge losses
on fake and real, the gradient with respect to the discriminator's
parameters, Adam at 2 lr.  Every training forward takes one power
iteration per spectral conv first.

The random numbers (coins, style noise, noise injection) come from
`Draws`, seeded as the program seeds its own: the coins from a CPU
generator, the noise from one on the device, drawn in the program's order
and shapes.  Each norm -> conv unit of the generator's blocks runs under
torch.utils.checkpoint, so the float32 step fits beside nothing else on one
card; each block's noise is drawn before it, so a recomputation draws
nothing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import nets, ops
from portbench.reference.nets import Net

VGG_LAYOUT = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512)
VGG_TAPS = (1, 3, 5, 9, 13)                   # after these convs (1-indexed)
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
LOSSES = ("GAN", "GAN_Feat", "VGG", "D_Fake", "D_real")


def _d_layers(cfg: Mapping):
    """[(name, cin, cout, stride, normed)] of one NLayer discriminator."""
    nf, cin = cfg["ndf"], nets.semantic_nc(cfg) + cfg.get("output_nc", 3)
    out = [("model0.0", cin, nf, 2, False)]
    for n in range(1, cfg["n_layers_d"]):
        prev, nf = nf, min(nf * 2, 512)
        out.append((f"model{n}.0.0", prev, nf, 1 if n == cfg["n_layers_d"] - 1 else 2, True))
    out.append((f"model{cfg['n_layers_d']}.0", nf, 1, 1, False))
    return out


def train_spec(cfg: Mapping) -> Dict[str, nets.Spec]:
    if cfg["norm_d"] != "spectralinstance":
        raise ValueError(f"the reference's discriminator takes norm_d spectralinstance, "
                         f"not {cfg['norm_d']!r}")
    d: nets.Spec = {}
    for i in range(cfg["num_d"]):
        for name, cin, cout, _, normed in _d_layers(cfg):
            nets._conv(d, f"discriminator_{i}.{name}", cin, cout, 4, normed, bias=not normed)
    vgg: nets.Spec = {}
    cin, idx = 3, 0
    for spec in VGG_LAYOUT:
        if spec == "M":
            idx += 1
            continue
        vgg[f"features.{idx}.weight"] = (spec, cin, 3, 3)
        vgg[f"features.{idx}.bias"] = (spec,)
        cin, idx = spec, idx + 2
    return {"d": d, "vgg": vgg}


class Draws:
    """The step's random numbers, as the program draws them: coins from a
    CPU generator seeded `seed + 1`, noise from one on `device` seeded
    `seed + 2` (`zeros`: every draw 0 and no coin drawn, for counting
    operations on the meta device)."""

    def __init__(self, seed: int, device, zeros: bool = False):
        self.device, self.zeros = torch.device(device), zeros
        if not zeros:
            self.coin = torch.Generator().manual_seed(seed + 1)
            self.noise = torch.Generator(device=self.device).manual_seed(seed + 2)

    def coins(self, cfg: Mapping) -> Tuple[bool, bool]:
        if nets.guided(cfg):
            return True, False
        if self.zeros:
            return True, False
        d = torch.rand(2, generator=self.coin)
        return bool(d[0] < 0.5), bool(d[1] < 0.5)

    def rand(self, shape) -> torch.Tensor:
        if self.zeros:
            return torch.zeros(shape, device=self.device)
        return torch.rand(shape, generator=self.noise, device=self.device)

    def randn(self, shape) -> torch.Tensor:
        if self.zeros:
            return torch.zeros(shape, device=self.device)
        return torch.randn(shape, generator=self.noise, device=self.device)


def _checkpointed(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def discriminator(p: Net, cfg: Mapping, x: torch.Tensor) -> List[List[torch.Tensor]]:
    """Per scale, every layer's output (leaky ReLU after all but the logit;
    instance norm on the normed layers); each coarser scale sees the input
    average-pooled 3x3 / 2 (padding 1, the pad not counted)."""
    out = []
    for i in range(cfg["num_d"]):
        if i:
            x = F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)
        y, feats = x, []
        layers = _d_layers(cfg)
        for j, (name, _, _, stride, normed) in enumerate(layers):
            y = p.conv(y, f"discriminator_{i}.{name}", stride=stride, padding=2)
            if normed:
                y = ops.instance_norm(y)
            if j < len(layers) - 1:
                y = ops.leaky_relu(y)
            feats.append(y)
        out.append(feats)
    return out


def vgg_features(p: Net, x: torch.Tensor, q=None) -> List[torch.Tensor]:
    taps, convs, idx = [], 0, 0
    for spec in VGG_LAYOUT:
        if spec == "M":
            x = F.max_pool2d(x, 2, 2)
            idx += 1
            continue
        x = torch.relu(ops.conv2d(x, p[f"features.{idx}.weight"], p[f"features.{idx}.bias"],
                                  1, 1, q))
        convs, idx = convs + 1, idx + 2
        if convs in VGG_TAPS:
            taps.append(x)
    return taps


def _gan(pred, real: bool, for_d: bool) -> torch.Tensor:
    per = []
    for scale in pred:
        x = scale[-1]
        if for_d:
            per.append(torch.relu(1.0 - x).mean() if real else torch.relu(1.0 + x).mean())
        else:
            per.append(-x.mean())
    return torch.stack(per).sum() / len(pred)


def g_param_names(tensors: Mapping[str, Mapping[str, torch.Tensor]]):
    """The G optimizer's leaves: ("g"|"e", name, lr scale)."""
    out = []
    for net in ("g", "e"):
        for name in sorted(tensors[net]):
            if _is_param(name):
                out.append((net, name, 0.25 if net == "e" and "mini" in name else 1.0))
    return out


def _is_param(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return leaf not in ("weight_u", "weight_v", "running_mean", "running_var")


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad)."""

    def __init__(self, lr: float, betas=(0.0, 0.9), eps: float = 1e-8):
        self.lr, self.betas, self.eps = lr, betas, eps
        self.state: Dict[tuple, tuple] = {}

    def step(self, params: Dict[tuple, torch.Tensor], grads: Dict[tuple, torch.Tensor],
             scales: Dict[tuple, float]) -> None:
        b1, b2 = self.betas
        for key, p in params.items():
            g = grads[key]
            m, v, t = self.state.get(key, (torch.zeros_like(p), torch.zeros_like(p), 0))
            t += 1
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            denom = v.sqrt() / math.sqrt(1 - b2 ** t) + self.eps
            p.sub_(self.lr * scales.get(key, 1.0) / (1 - b1 ** t) * m / denom)
            self.state[key] = (m, v, t)


class TrainReference:
    """The step, float32, from the benchmark's initial weights."""

    def __init__(self, cfg: Mapping, train_cfg: Mapping, weights, device, seed: int,
                 zeros: bool = False, checkpoint_blocks: bool = True, q=None):
        self.cfg, self.tc = cfg, train_cfg
        self.t = {net: {n: v.detach().clone().float() for n, v in ts.items()}
                  for net, ts in weights.items()}
        self.draws = Draws(seed, device, zeros)
        lr = train_cfg.get("lr", 2e-4)
        self.opt_g, self.opt_d = Adam(lr / 2), Adam(lr * 2)
        self.block_fn = _checkpointed if checkpoint_blocks else None
        self.q = q       # a lower precision put in the program's place (the control)

    def _net(self, name: str) -> Net:
        return Net(self.t[name], q=self.q, train=True)

    def _forward_g(self, pre, grad: bool):
        use_full, no_noise = self.draws.coins(self.cfg)
        e, g = self._net("e"), self._net("g")
        with torch.set_grad_enabled(grad):
            style = nets.encode(e, self.cfg, pre, use_full, no_noise, self.draws)
            fake = nets.generator(g, self.cfg, pre["image_lr"], pre["semantics"], style,
                                  self.draws, self.block_fn)
        return fake, (e, g)

    def _keep(self, *nets_):
        """The power iterations' u, v for the next forward (after any
        backward: a checkpointed block recomputes with the ones it read)."""
        for n in nets_:
            n.t.update({k: v.detach() for k, v in n.updates.items()})

    def _disc(self, pre, fake):
        d = self._net("d")
        sem = pre["semantics"]
        both = torch.cat([torch.cat([sem, fake], 1), torch.cat([sem, pre["image_hr"]], 1)], 0)
        preds = discriminator(d, self.cfg, both)
        self._keep(d)
        b = fake.shape[0]
        return [[t[:b] for t in s] for s in preds], [[t[b:] for t in s] for s in preds]

    def step(self, batch: Mapping[str, torch.Tensor]):
        """One G update and one D update on a batch in the program's layout;
        returns ({loss name: 0-dim tensor}, {("g"|"e"|"d", name): gradient})."""
        pre = nets.preprocess(self.cfg, batch)
        tc = self.tc
        lam_feat, lam_vgg = tc.get("lambda_feat", 10.0), tc.get("lambda_vgg", 10.0)
        keys = g_param_names(self.t)
        params = {(n, k): self.t[n][k].requires_grad_(True) for n, k, _ in keys}
        fake, g_nets = self._forward_g(pre, grad=True)
        self.last_fake = fake.detach()
        pred_fake, pred_real = self._disc(pre, fake)
        losses = {"GAN": _gan(pred_fake, True, False)}
        feat = torch.zeros((), device=fake.device)
        num_d = len(pred_fake)
        for fs, rs in zip(pred_fake, pred_real):
            for f, r in zip(fs[:-1], rs[:-1]):
                feat = feat + (f - r.detach()).abs().mean() * (lam_feat / num_d)
        losses["GAN_Feat"] = feat
        v = Net(self.t["vgg"])
        with torch.no_grad():
            real_feats = vgg_features(v, pre["image_hr"], self.q)
        vgg = torch.zeros((), device=fake.device)
        for w, fx, fy in zip(VGG_WEIGHTS, vgg_features(v, fake, self.q), real_feats):
            vgg = vgg + w * (fx - fy).abs().mean()
        losses["VGG"] = vgg * lam_vgg
        total = losses["GAN"] + losses["GAN_Feat"] + losses["VGG"]
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        self._keep(*g_nets)
        with torch.no_grad():
            for p in params.values():
                p.requires_grad_(False)
            self.opt_g.step(params, grads, {(n, k): s for n, k, s in keys})
        del fake, pred_fake, pred_real, total

        fake, g_nets = self._forward_g(pre, grad=False)
        self._keep(*g_nets)
        d_keys = [("d", k) for k in sorted(self.t["d"]) if _is_param(k)]
        d_params = {k: self.t["d"][k[1]].requires_grad_(True) for k in d_keys}
        pred_fake, pred_real = self._disc(pre, fake.detach())
        losses["D_Fake"] = _gan(pred_fake, False, True)
        losses["D_real"] = _gan(pred_real, True, True)
        d_grads = torch.autograd.grad(losses["D_Fake"] + losses["D_real"],
                                      list(d_params.values()), allow_unused=True)
        with torch.no_grad():
            d_grads = {k: torch.zeros_like(p) if g is None else g
                       for (k, p), g in zip(d_params.items(), d_grads)}
            for p in d_params.values():
                p.requires_grad_(False)
            self.opt_d.step(d_params, d_grads, {})
        grads.update(d_grads)
        return {k: v.detach() for k, v in losses.items()}, grads

    def leaves(self) -> Dict[tuple, torch.Tensor]:
        """Every parameter (not u, v or running statistics)."""
        return {(n, k): v for n in ("g", "e", "d") for k, v in self.t[n].items()
                if _is_param(k)}


# -- the numbers compared -----------------------------------------------------------

def _median(values: List[float]) -> float:
    s = sorted(values)
    return s[len(s) // 2] if s else 0.0


def norm_gap(got: Mapping[tuple, float], want: Mapping[tuple, float],
             keep: Optional[set] = None) -> Tuple[float, tuple]:
    """The worst leaf's gap between two norms: |got - want| over the larger
    of want's norm of that leaf and of the median leaf; (gap, leaf)."""
    keys = [k for k in want if keep is None or k in keep]
    med = _median([want[k] for k in keys])
    worst, leaf = 0.0, None
    for k in keys:
        gap = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def moving_leaves(grad_norms: Mapping[tuple, float]) -> set:
    """Leaves whose reference gradient is more than a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = _median(list(grad_norms.values()))
    return {k for k, v in grad_norms.items() if v > 1e-3 * med}


def loss_gap(got: List[Mapping[str, float]], want: List[Mapping[str, float]]) -> float:
    """The worst step's relative gap of the generator's and the
    discriminator's total losses."""
    worst = 0.0
    for g, w in zip(got, want):
        for names in (("GAN", "GAN_Feat", "VGG"), ("D_Fake", "D_real")):
            a, b = sum(g[n] for n in names), sum(w[n] for n in names)
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    return worst
