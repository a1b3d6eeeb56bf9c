"""The work a cell asks of the card, from the configuration's shapes alone:
the least time of every K1 (`modnorm`) launch and of every K4 (int8 conv)
call, and the model's operations counted over the reference.  Nothing here
reads the port: a later change to a kernel cannot change these numbers.

K1's least time (the port's csrc/modnorm.cu; the function normalize ->
modulate -> leaky ReLU): each input read once and the output written once
over the HBM rate, or its float32 operations over the CUDA cores' rate,
whichever is larger.  K4's (the W8A8 conv): the unpadded activation, the
float32 weight, the bias and the output once over the HBM rate, or the
multiply-adds (two operations each) at the int8 tensor-core rate, per conv
the larger.
"""

from __future__ import annotations

import math
from typing import Callable, List, Mapping, Sequence, Tuple

from portbench import peaks

Shape = Tuple[int, int, int, int]


def _n_blocks(cfg: Mapping) -> int:
    return int(round(math.log2(cfg["crop_size"] / cfg["start_size"])))


def generator_norms(cfg: Mapping, batch: int):
    """Every K1 launch of one generator call, by shape:
    [(mode, (B, C, H, W), with_mod, lrelu, launches)]; two per block, the
    running-statistics ("affine") mode unless the norm string says
    instance."""
    s, c = cfg["start_size"], 16 * cfg["ngf"]
    mode = "instance" if "instance" in cfg["norm_g"].removeprefix("spectral") else "affine"
    blocks = [s, 2 * s, 2 * s] + [s * 2 ** (i + 2) for i in range(_n_blocks(cfg) - 1)]
    return [(mode, (batch, c, hw, hw), True, True, 2 * blocks.count(hw))
            for hw in sorted(set(blocks))]


def mini_trunk_norms(cfg: Mapping, batch: int):
    """The five instance norms of the mini trunk and the head on the LR
    image: [((B, C, H, W), lrelu)]."""
    s, nef = cfg["start_size"], cfg["nef"]
    return [((batch, nef, s, s), True), ((batch, 2 * nef, s, s), True),
            ((batch, 4 * nef, s, s), True), ((batch, 8 * nef, 2 * s, 2 * s), True),
            ((batch, cfg["regional_style_size"], 2 * s, 2 * s), False)]


def full_trunk_norms(cfg: Mapping, batch: int):
    """The five instance norms of the full trunk and the head on the HR (or
    guiding) image."""
    s, nf = cfg["crop_size"], cfg["nef"]
    return [((batch, nf, s, s), True), ((batch, 2 * nf, s // 2, s // 2), True),
            ((batch, 4 * nf, s // 4, s // 4), True),
            ((batch, 8 * nf, s // 2, s // 2), True),
            ((batch, cfg["regional_style_size"], s // 2, s // 2), False)]


def path_norms(cfg: Mapping, batch: int, full_trunk: bool):
    """Every K1 launch of one inference call (style encode and generate)."""
    trunk = full_trunk_norms if full_trunk else mini_trunk_norms
    return generator_norms(cfg, batch) + [("instance", shape, False, lrelu, 1)
                                          for shape, lrelu in trunk(cfg, batch)]


def k1_bound_ms(mode: str, shape: Shape, with_mod: bool, lrelu: bool, elt_bytes: int) -> float:
    """The least time of one inference launch."""
    b, c, h, w = shape
    n = b * c * h * w
    tensors = 2 + (2 if with_mod else 0)            # x, out (+ the 2C modulation)
    nbytes = n * tensors * elt_bytes + (2 * c * 4 if mode == "affine" else 0)
    per_elt = (2 if mode == "affine" else 7) + (2 if with_mod else 0) + (1 if lrelu else 0)
    return max(nbytes / peaks.HBM_BYTES_PER_S, n * per_elt / peaks.F32_FLOPS_PER_S) * 1e3


def infer_k1_bound_ms(cfg: Mapping, batch: int, full_trunk: bool, elt_bytes: int) -> float:
    """The least time of every K1 launch of one inference call."""
    return sum(n * k1_bound_ms(mode, shape, m, lrelu, elt_bytes)
               for mode, shape, m, lrelu, n in path_norms(cfg, batch, full_trunk))


def disc_norms(cfg: Mapping, batch2: int) -> List[Shape]:
    """The normed layers of the multiscale discriminator on a 2B batch (4x4
    convs with padding 2; each coarser scale's input avg-pooled 3x3 / 2)."""
    out, h = [], cfg["crop_size"]
    for scale in range(cfg["num_d"]):
        if scale:
            h = (h + 2 - 3) // 2 + 1
        hh, nf = h // 2 + 1, cfg["ndf"]
        for n in range(1, cfg["n_layers_d"]):
            nf = min(nf * 2, 512)
            hh = hh // 2 + 1 if n < cfg["n_layers_d"] - 1 else hh + 1
            out.append((batch2, nf, hh, hh))
    return out


def train_norms(cfg: Mapping, batch: int, g_full: bool, regen: bool = True):
    """Every K1 launch of one training step:
    [(stats, (B, C, H, W), with_mod, lrelu, forwards, backwards)].  The G
    update runs G, the encoder's trunks and D (on 2B) forward, and backward
    through G, the trunk its coin picked (the guided encoder has the full
    trunk alone) and D; the D update regenerates the fake (forward only)
    and runs D forward and backward."""
    fwd = 2 if regen else 1
    rows = [("batch", shape, True, True, fwd * n, n)
            for _, shape, _, _, n in generator_norms(cfg, batch)]
    guided = "full" in cfg["net_e"]
    for full, trunk in ((True, full_trunk_norms), (False, mini_trunk_norms)):
        if guided and not full:
            continue
        rows += [("instance", shape, False, lrelu, fwd, int(guided or full == g_full))
                 for shape, lrelu in trunk(cfg, batch)]
    rows += [("instance", shape, False, True, 2, 2) for shape in disc_norms(cfg, 2 * batch)]
    return rows


def k1_train_bound_ms(backward: bool, shape: Shape, with_mod: bool, lrelu: bool,
                      elt_bytes: int) -> float:
    """The least time of one training launch (forward: x, mod -> out;
    backward: x, mod, gout -> grad_x, grad_mod)."""
    b, c, h, w = shape
    n = b * c * h * w
    if backward:
        tensors = 3 + (4 if with_mod else 0)
        per_elt = 9 + (4 if with_mod else 0) + (1 if lrelu else 0)
    else:
        tensors = 2 + (2 if with_mod else 0)
        per_elt = 6 + (2 if with_mod else 0) + (1 if lrelu else 0)
    return max(n * tensors * elt_bytes / peaks.HBM_BYTES_PER_S,
               n * per_elt / peaks.F32_FLOPS_PER_S) * 1e3


def train_k1_bound_ms(cfg: Mapping, batch: int, elt_bytes: int) -> float:
    """The least time of every K1 launch of one training step (the guided
    model's encoder runs the full trunk; the independent one's backward
    takes one trunk, whose launches are the same in count either way up to
    the trunk's shapes: the mean of the two)."""
    def one(g_full: bool) -> float:
        return sum(fwd * k1_train_bound_ms(False, shape, m, lrelu, elt_bytes)
                   + bwd * k1_train_bound_ms(True, shape, m, lrelu, elt_bytes)
                   for _, shape, m, lrelu, fwd, bwd in train_norms(cfg, batch, g_full))
    if "full" in cfg["net_e"]:
        return one(True)
    return 0.5 * (one(True) + one(False))


def k4_bound_ms(convs: Sequence, elt_bytes: int) -> float:
    """The least time of the quantized convs [(x shape, w shape, stride,
    padding)] of one call."""
    total = 0.0
    for (b, cin, h, w), (cout, _, kh, kw), stride, pad in convs:
        ho = (h + 2 * pad - kh) // stride + 1
        wo = (w + 2 * pad - kw) // stride + 1
        macs = b * ho * wo * cout * cin * kh * kw
        nbytes = (b * cin * h * w * elt_bytes + cout * cin * kh * kw * 4 + cout * 4
                  + b * cout * ho * wo * elt_bytes)
        total += max(nbytes / peaks.HBM_BYTES_PER_S, 2 * macs / peaks.INT8_OPS_PER_S)
    return total * 1e3


def k4_ops(convs: Sequence) -> float:
    """Two operations per multiply-add of the quantized convs."""
    total = 0
    for (b, cin, h, w), (cout, _, kh, kw), stride, pad in convs:
        ho = (h + 2 * pad - kh) // stride + 1
        wo = (w + 2 * pad - kw) // stride + 1
        total += 2 * b * ho * wo * cout * cin * kh * kw
    return float(total)


def count_flops(fn: Callable[[], object]) -> float:
    """The operations `fn` runs, by torch's FlopCounterMode (convolutions
    and matrix products, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


def least_seconds(bf16_flops: float, int8_ops: float) -> float:
    """The least time the published dense peaks allow: the int8 ops at the
    int8 rate, the rest at the bf16 rate."""
    return bf16_flops / peaks.BF16_FLOPS_PER_S + int8_ops / peaks.INT8_OPS_PER_S
