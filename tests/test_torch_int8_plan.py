"""Kernel (d)'s tile plan on the CPU.

`ic.igemm_plan` chooses the output-pixel rectangle, BN, BK, the ring and the
persistent grid; `ic.igemm_tile` and `ic.igemm_loads` give the tiles each
block walks and the coordinates its producer hands TMA.  Here TMA's tiled
gather is emulated on the CPU (a box of the 4-D x_q map [N][H][W][Cp] with
the map's element strides, and of the 3-D k_q map [Cout][tap][Cp], zero
outside the tensor), the tiles are multiplied in int64 as wgmma would, and
their rows are written back where the kernel's epilogue writes them.  The
product must be the exact convolution and, dequantized, `igemm_plain`'s
output bit for bit, with every output written exactly once.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepsee_torch.ops import int8conv as ic

# name: (x (N, Cin, H, W), weight (Cout, Cin, kh, kw), stride, padding: one
# int or (pad_h, pad_w); a stripe's slab with its halo rows comes at pad_h 0)
CASES = {
    "19x23 cin 72 (Cp 80 read as 128)": ((2, 72, 19, 23), (40, 72, 3, 3), 1, 1),
    "7x5 Cp 64, Cout 20": ((3, 64, 7, 5), (20, 64, 3, 3), 1, 1),
    "stride 2, odd sizes": ((2, 32, 19, 23), (24, 32, 3, 3), 2, 1),
    "stride 2, two N tiles": ((1, 128, 16, 18), (300, 128, 3, 3), 2, 1),
    "1x1, two chunks": ((2, 256, 6, 7), (260, 256, 1, 1), 1, 0),
    "Cp 16 (Cin 3)": ((2, 3, 9, 9), (8, 3, 3, 3), 1, 1),
    "a row wider than 128": ((1, 16, 3, 150), (8, 16, 3, 3), 1, 1),
    "stride 3": ((1, 16, 20, 20), (8, 16, 3, 3), 3, 1),
    "5x5, padding 2": ((1, 16, 11, 13), (8, 16, 5, 5), 1, 2),
    "slab: pad_h 0, pad_w 1": ((2, 72, 10, 23), (40, 72, 3, 3), 1, (0, 1)),
    "slab at stride 2: pad_h 0, pad_w 1": ((2, 32, 11, 23), (24, 32, 3, 3), 2, (0, 1)),
    "slab 5x5: pad_h 0, pad_w 2": ((1, 16, 12, 13), (8, 16, 5, 5), 1, (0, 2)),
    "pad_h 2, pad_w 0": ((1, 16, 9, 150), (8, 16, 3, 3), 1, (2, 0)),
}


def _operands(case, seed=0):
    """x_q (N, Cp, H, W) and k_q (Cout, kh, kw, Cp) int8 with zero padding
    channels, s_k, s_x and a bias, from numpy."""
    (n, cin, h, w), (cout, _, kh, kw), stride, pad = CASES[case]
    rng = np.random.default_rng(seed)
    cp = ic.padded_channels(cin)
    x_q = np.zeros((n, cp, h, w), np.int8)
    x_q[:, :cin] = rng.integers(-127, 128, (n, cin, h, w))
    k_q = np.zeros((cout, kh, kw, cp), np.int8)
    k_q[..., :cin] = rng.integers(-127, 128, (cout, kh, kw, cin))
    s_k = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32))
    s_x = torch.tensor(np.float32(rng.uniform(1e-3, 1e-1)))
    bias = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))
    x_q = torch.from_numpy(x_q).contiguous(memory_format=torch.channels_last)
    return x_q, torch.from_numpy(k_q), s_k, s_x, bias, stride, pad


def _box(t: torch.Tensor, start, box, strides) -> torch.Tensor:
    """TMA's tiled load of `box` elements (innermost first) from t (whose
    dims are outermost first) at `start`, every strides[i]-th element along
    dim i, zero outside t: the result's rows run over the outer dims, the
    innermost dim along each row."""
    dims = t.shape[::-1]                             # innermost first, as the map
    idx, ok = [], []
    for d in range(len(box)):
        i = start[d] + strides[d] * torch.arange(-(-box[d] // strides[d]))
        ok.append((i >= 0) & (i < dims[d]))
        idx.append(i.clamp(0, dims[d] - 1))
    grids = torch.meshgrid(*idx[::-1], indexing="ij")       # outermost first
    masks = torch.meshgrid(*ok[::-1], indexing="ij")
    mask = masks[0]
    for m in masks[1:]:
        mask = mask & m
    vals = t[grids].long() * mask
    return vals.reshape(-1, box[0])


def _emulate(plan, x_q, k_q, stride, pad):
    """The product as the kernel forms it: (N, Ho, Wo, Cout) int64, and how
    many times each output was written."""
    n, _, h, w = x_q.shape
    cout, kh, kw, cp = k_q.shape
    ph, pw = ic.pads(pad)
    ho, wo = ic.conv_out_size(h, kh, stride, ph), ic.conv_out_size(w, kw, stride, pw)
    x_nhwc = x_q.permute(0, 2, 3, 1)                 # [N][H][W][Cp]
    k_3d = k_q.reshape(cout, kh * kw, cp)            # [Cout][tap][Cp]
    out = torch.zeros((n, ho, wo, cout), dtype=torch.long)
    writes = torch.zeros((n, ho, wo, cout), dtype=torch.long)
    rows = torch.arange(ic.IGEMM_BM)
    cols = torch.arange(plan.bn)
    for block in range(plan.grid):                   # the persistent blocks
        for t in range(block, plan.tiles, plan.grid):
            img, ho0, wo0, n0 = ic.igemm_tile(plan, t)
            acc = torch.zeros((ic.IGEMM_BM, plan.bn), dtype=torch.long)
            for x_at, k_at in ic.igemm_loads(plan, (img, ho0, wo0, n0), kw, stride, pad):
                a = _box(x_nhwc, x_at, plan.x_box, plan.x_element_strides)
                b = _box(k_3d, k_at, plan.k_box, (1, 1, 1))
                assert a.shape == (ic.IGEMM_BM, plan.bk) and b.shape == (plan.bn, plan.bk)
                acc += a @ b.T
            r_h, r_w = ho0 + rows // plan.wbox, wo0 + rows % plan.wbox
            keep = (r_h < ho) & (r_w < wo)
            c_keep = n0 + cols < cout
            sub = acc[keep][:, c_keep]
            out[img, r_h[keep][:, None], r_w[keep][:, None], (n0 + cols[c_keep])[None]] = sub
            writes[img, r_h[keep][:, None], r_w[keep][:, None], (n0 + cols[c_keep])[None]] += 1
    return out, writes


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_tma_gather_gives_the_exact_product(case):
    x_q, k_q, s_k, s_x, bias, stride, pad = _operands(case)
    plan = ic.igemm_plan(tuple(x_q.shape), tuple(k_q.shape), stride, pad)
    acc, writes = _emulate(plan, x_q, k_q, stride, pad)
    assert bool((writes == 1).all()), "every output written exactly once"
    want = F.conv2d(x_q.double(), k_q.permute(0, 3, 1, 2).double(), stride=stride,
                    padding=ic.pads(pad))
    assert torch.equal(acc.permute(0, 3, 1, 2), want.long())
    for dtype in (torch.float32, torch.bfloat16):
        for b in (bias, None):
            # the epilogue's float sequence on the emulated sums
            y = (acc.permute(0, 3, 1, 2).float() * (s_x * s_k)[:, None, None]).to(dtype)
            if b is not None:
                y = y + b.to(dtype)[:, None, None]
            ref = ic.igemm_plain(x_q, k_q.permute(0, 3, 1, 2), s_x, s_k, b, stride, pad, dtype)
            assert torch.equal(y, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_plan_fits_the_kernel(case):
    """What the kernel and TMA take: 128-row rectangles, boxes of at most 256
    elements a dimension, BK-byte rows under a BK-byte swizzle, the ring and
    its barriers in 227 KB, one block per SM at most, channel chunks that
    cover Cp."""
    (n, cin, h, w), (cout, _, kh, kw), stride, pad = CASES[case]
    cp = ic.padded_channels(cin)
    plan = ic.igemm_plan((n, cp, h, w), (cout, kh, kw, cp), stride, pad, sms=132)
    assert plan.hbox * plan.wbox == ic.IGEMM_BM
    assert all(1 <= d <= ic.TMA_BOX_MAX for d in plan.x_box + plan.k_box)
    assert plan.x_box == (plan.bk, plan.wbox * stride, plan.hbox * stride, 1)
    assert plan.bk in (64, 128) and plan.bn in (128, 256)
    assert plan.chunks * plan.bk >= cp > (plan.chunks - 1) * plan.bk
    stage = (ic.IGEMM_BM + plan.bn) * plan.bk
    assert 3 <= plan.stages <= ic.IGEMM_MAX_STAGES and plan.stages * stage <= ic.IGEMM_RING_BYTES
    assert plan.smem <= 232448                      # an H100 block's shared memory
    assert plan.grid == min(plan.tiles, 132)
    ph, pw = ic.pads(pad)
    ho, wo = ic.conv_out_size(h, kh, stride, ph), ic.conv_out_size(w, kw, stride, pw)
    assert plan.tiles == n * -(-ho // plan.hbox) * -(-wo // plan.wbox) * -(-cout // plan.bn)


@pytest.mark.parametrize("wo,stride,wbox", [(32, 1, 32), (64, 1, 64), (256, 1, 128), (23, 1, 32),
                                            (5, 1, 8), (128, 2, 128), (1, 2, 1), (1, 8, 4),
                                            (200, 3, 64)])
def test_rectangle_width(wo, stride, wbox):
    """The narrowest power of 2 that covers the row (4 x 32 at 32^2, 2 x 64 at
    64^2, 1 x 128 from 128^2 on), within what the boxes of a strided load
    allow."""
    h = w = (wo - 1) * stride + 1
    plan = ic.igemm_plan((1, 16, h, w), (8, 1, 1, 16), stride, 0)
    assert plan.wbox == wbox


def test_plan_refuses_a_stride_tma_cannot_take():
    with pytest.raises(ValueError):
        ic.igemm_plan((1, 16, 64, 64), (8, 3, 3, 16), 9, 1)


@pytest.mark.parametrize("cp", [16, 64, 80, 128, 256, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_plan_covers_every_channel_group(cp, dtype):
    plan = ic.quantize_plan(32 * 64 * 64, cp, dtype, sms=132)
    groups = cp // 16
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes * plan.rows == ic.THREADS
    assert plan.blocks_y * plan.lanes >= groups > (plan.blocks_y - 1) * plan.lanes
    assert 1 <= plan.blocks_x * plan.blocks_y <= ic.QUANTIZE_BLOCKS_PER_SM * 132
    assert plan.unroll * plan.rows * plan.blocks_x <= 32 * 64 * 64 + plan.unroll * plan.rows


# -- kernel (b): one launch per weight ------------------------------------------

# (Cout, Cin, kh, kw): every quantized weight of the int8 main and 8x guided
# paths, the ragged shapes of chip_smoke.py (Cin 72, Cout 20, a 1x1), a
# weight whose threads take several units each, a 5x5 (taps at run time) and
# an odd Cin
WEIGHT_SHAPES = {"512x512": (512, 512, 3, 3), "mod 256->1024": (1024, 256, 3, 3),
                 "mod 128->1024": (1024, 128, 3, 3), "64->128": (128, 64, 3, 3),
                 "128->256": (256, 128, 3, 3), "256->128": (128, 256, 3, 3),
                 "cin 72": (40, 72, 3, 3), "cout 20": (20, 64, 3, 3), "1x1": (256, 512, 1, 1),
                 "1024x1024": (1024, 1024, 3, 3), "5x5": (48, 40, 5, 5),
                 "cin 31": (64, 31, 3, 3)}
# the kernel's static shared memory (row_max, row_sk, row_rk, red) and the
# runtime's reserve
WEIGHT_STATIC_SMEM = (3 * ic.WEIGHT_MAX_ROWS + ic.WEIGHT_THREADS // 32) * 4 + 1024


def _units(plan, cout, cin, block):
    """[(output channel, pair)] of `block`'s units in the order its threads
    take them: unit u = thread + k * WEIGHT_THREADS."""
    lo, hi = ic.weight_rows(plan, cout, block)
    pairs = ic.padded_channels(cin) // ic.WEIGHT_UNIT_COLUMNS
    return [(lo + u // pairs, u % pairs) for u in range((hi - lo) * pairs)]


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("case", list(WEIGHT_SHAPES))
def test_weight_plan_covers_every_output_channel_once(case, smooth):
    """Block b owns output channels [b*Cout/G, (b+1)*Cout/G): together every
    channel once, none empty, at most `rows` each; their units write every
    word of k_q once (a row's Cp / 2 pairs per tap); the input channels
    whose s_c a block writes split the same way; the grid is at most one
    block per SM and the shared memory fits one block on an SM; where a
    block has WEIGHT_THREADS units or fewer (every main-path weight), each
    thread's one unit stays in its registers."""
    cout, cin, kh, kw = WEIGHT_SHAPES[case]
    plan = ic.weight_plan(cout, cin, kh * kw, smooth)
    assert 1 <= plan.grid <= min(cout, ic.SMS)
    seen = np.zeros(cout, int)
    cols = np.zeros(cin, int)
    words = np.zeros((cout, ic.padded_channels(cin) // ic.WEIGHT_UNIT_COLUMNS), int)
    for b in range(plan.grid):
        lo, hi = ic.weight_rows(plan, cout, b)
        assert 1 <= hi - lo <= plan.rows <= ic.WEIGHT_MAX_ROWS
        seen[lo:hi] += 1
        clo, chi = ic.weight_rows(plan, cin, b)
        cols[clo:chi] += 1
        units = _units(plan, cout, cin, b)
        assert len(units) <= plan.units
        for o, q in units:
            words[o, q] += 1
    assert (seen == 1).all() and (cols == 1).all() and (words == 1).all()
    assert plan.units == plan.rows * ic.padded_channels(cin) // ic.WEIGHT_UNIT_COLUMNS
    assert plan.cached == (kh * kw in (1, 9)) and plan.vector == (cin % 2 == 0)
    assert plan.smem == cin * 4 * (2 if smooth else 1)
    assert plan.smem + WEIGHT_STATIC_SMEM <= 232448       # one block on an SM
    if case in ("512x512", "mod 256->1024", "mod 128->1024", "64->128", "128->256",
                "256->128"):
        assert plan.cached and plan.vector and plan.units <= ic.WEIGHT_THREADS


def test_weight_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        ic.weight_plan(64, ic.WEIGHT_MAX_CIN + 1, 9)
    with pytest.raises(ValueError):           # more than WEIGHT_MAX_ROWS rows a block
        ic.weight_plan(ic.WEIGHT_MAX_ROWS * 132 + 1, 64, 9, sms=132)
    with pytest.raises(ValueError):
        ic.weight_plan(0, 64, 9)


def _fma32(a, b, c):
    """float32 fma(a, b, c) with one rounding: a * b is exact in float64; the
    float64 sum's own error (TwoSum) breaks the ties its rounding may have
    made at a float32 midpoint."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    t = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    d = s - r.astype(np.float64)
    toward = np.nextafter(r, np.where(d > 0, np.float32(np.inf), np.float32(-np.inf)))
    mid = (r.astype(np.float64) + toward.astype(np.float64)) / 2
    move = (d != 0) & (s == mid) & (np.sign(t) == np.sign(d))
    return np.where(move, toward, r)


def _div32(a, b):
    """RN(a / b) in float32 (float64's quotient rounds to the same float32)."""
    return (a.astype(np.float64) / b.astype(np.float64)).astype(np.float32)


def _div_rn_by(a, b, r):
    """int8conv.cu's div_rn_by: q0 = RN(a * r), two FMA corrections; a zero
    numerator is its own quotient."""
    q0 = (a.astype(np.float64) * r.astype(np.float64)).astype(np.float32)
    q1 = _fma32(r, _fma32(-b, q0, a), q0)
    q2 = _fma32(r, _fma32(-b, q1, a), q1)
    return np.where(a == 0, a, q2)


def _exact_levels(v, sk, rk):
    """clip(rint(RN(v / sk)), +-127) as int8: int8conv.cu's weight_level
    (the reciprocal route where it is exact, else the IEEE division)."""
    fast = (sk >= 2.0 ** -60) & (sk <= 2.0 ** 60) & (
        ((np.abs(v) >= 2.0 ** -64) & (np.abs(v) <= 2.0 ** 64)) | (v == 0))
    q = np.where(fast, _div_rn_by(v, sk, rk), _div32(v, sk))
    level = np.clip(q, -ic.LEVELS, ic.LEVELS).astype(np.float32) + np.float32(12582912.0)
    return (level.astype(np.float64) - 12582912.0).astype(np.int8)


def _product_levels(v, rk):
    """int8conv.cu's weight_level_by_product before its exact branch: the
    level from q0 = RN(v * rk), and whether q0, clipped, lies within 2^-14
    of a half."""
    c = np.clip((v.astype(np.float64) * rk).astype(np.float32), -ic.LEVELS, ic.LEVELS)
    r = (c.astype(np.float64) + 12582912.0).astype(np.float32)
    near = np.abs(c - (r.astype(np.float64) - 12582912.0)) > 0.5 - 2.0 ** -14
    return (r.astype(np.float64) - 12582912.0).astype(np.int8), near


def _emulate_quantize_weight(w, mx, mx_raw, smooth, plan, order):
    """Kernel (b) from its plan, in float32 as the kernel computes: each
    block's column maxima over its units merged by the max of their bit
    patterns in `order`; s_c for every column; s_x from every column (block
    0's); per row s_k, then k_q through the reciprocal route where the kernel
    takes it, clipped, rounded by adding 1.5 * 2^23 and written unit by unit.
    Returns (s_c, s_k, s_x, k_q [Cout][tap][Cp])."""
    cout, cin, kh, kw = w.shape
    taps, cp = kh * kw, ic.padded_channels(cin)
    rows = w.reshape(cout, cin, taps)
    if smooth:
        mk_bits = np.zeros(cin, np.uint32)
        for b in order:
            for o, q in _units(plan, cout, cin, b):
                n = ic.WEIGHT_UNIT_COLUMNS
                part = np.abs(rows[o, n * q:n * q + n]).max(axis=1, initial=np.float32(0))
                cols = slice(n * q, n * q + part.size)
                mk_bits[cols] = np.maximum(mk_bits[cols], part.view(np.uint32))
        mk = np.maximum(mk_bits.view(np.float32), np.float32(ic.FLOOR))
        s_c = _div32(np.sqrt(mx.astype(np.float64)).astype(np.float32),
                     np.sqrt(mk.astype(np.float64)).astype(np.float32))
        top = _div32(mx_raw, s_c).max(initial=np.float32(0))
    else:
        s_c = np.ones(cin, np.float32)
        top = mx_raw.max(initial=np.float32(0))
    s_x = _div32(np.maximum(np.array([top], np.float32), np.float32(ic.FLOOR)),
                 np.float32(ic.LEVELS))[0]
    v = (rows.astype(np.float64) * s_c[None, :, None]).astype(np.float32)   # RN(w * s_c)
    s_k = _div32(np.maximum(np.abs(v).max(axis=(1, 2)), np.float32(ic.FLOOR)),
                 np.full(cout, ic.LEVELS, np.float32))
    r_k = _div32(np.ones(cout, np.float32), s_k)
    k_q = np.full((cout, taps, cp), 99, np.int8)        # every byte written below
    for b in order:
        for o, q in _units(plan, cout, cin, b):
            n = ic.WEIGHT_UNIT_COLUMNS
            k_q[o, :, n * q:n * q + n] = 0
            vq = v[o, n * q:n * q + n]                   # (<= 2 columns, taps)
            if not vq.size:
                continue
            sk = np.full(vq.shape, s_k[o], np.float32)
            rk = np.full(vq.shape, r_k[o], np.float32)
            level, near = _product_levels(vq, rk)
            exact = _exact_levels(vq, sk, rk)
            # values near a half, and every value of an uncached unit, by the division
            level = np.where(near | (not plan.cached), exact, level)
            k_q[o, :, n * q:n * q + vq.shape[0]] = level.T
    return s_c, s_k, s_x, k_q


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("case,sms", [("512x512", ic.SMS), ("mod 256->1024", ic.SMS),
                                      ("64->128", ic.SMS), ("cin 72", ic.SMS),
                                      ("cout 20", ic.SMS), ("1x1", ic.SMS), ("5x5", ic.SMS),
                                      ("cin 31", ic.SMS), ("256->128", 8)])
def test_weight_emulation_equals_plain_bit_for_bit(case, sms, smooth):
    """(b)'s arithmetic from its plan (`_emulate_quantize_weight`), with the
    blocks merging in a shuffled order and, at 8 SMs, several units per
    thread, gives `quantize_weight_plain`'s s_k and k_q, `smooth_scales_plain`'s
    s_c and `quantize_activation_plain`'s s_x bit for bit, with an all-zero
    input channel of the weight (its mk the 1e-8 floor) and of x."""
    cout, cin, kh, kw = WEIGHT_SHAPES[case]
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, cin, 3, 4)) * np.logspace(-2, 1, cin)[None, :, None, None])
    x[:, 0] = 0.0
    x = torch.from_numpy(x.astype(np.float32))
    w = (rng.standard_normal((cout, cin, kh, kw)) * 0.05).astype(np.float32)
    w[:, 1] = 0.0
    mx_raw, mx = ic.absmax_channels_plain(x)
    s_c = ic.smooth_scales_plain(torch.from_numpy(w), mx, smooth)
    s_k, k_q = ic.quantize_weight_plain(torch.from_numpy(w), s_c)
    s_x, _ = ic.quantize_activation_plain(x, s_c)
    plan = ic.weight_plan(cout, cin, kh * kw, smooth, sms)
    if sms == 8:
        assert plan.units > ic.WEIGHT_THREADS
    order = rng.permutation(plan.grid)
    got = _emulate_quantize_weight(w, mx.numpy(), mx_raw.numpy(), smooth, plan, order)
    assert np.array_equal(got[0].view(np.uint32), s_c.numpy().view(np.uint32))
    assert np.array_equal(got[1].view(np.uint32), s_k.numpy().view(np.uint32))
    assert np.float32(got[2]).view(np.uint32) == s_x.numpy().view(np.uint32)
    assert np.array_equal(got[3][:, :, :cin].transpose(0, 2, 1).reshape(cout, cin, kh, kw),
                          k_q.numpy())
    assert not got[3][:, :, cin:].any()


def test_levels_from_the_product_equal_the_exact_division_away_from_halves():
    """Where q0 = RN(v * RN(1 / s_k)) does not lie within 2^-14 of a half
    (below the clip), its level is clip(rint(RN(v / s_k))): on random rows
    at scales from 1e-12 to 1e30, and on values placed a few ulps around
    every k + 0.5 (which the kernel takes again by the exact division)."""
    rng = np.random.default_rng(11)
    for scale in (1e-12, 1e-6, 0.05, 1.0, 3e4, 1e30):
        v = (rng.standard_normal(200_000) * scale).astype(np.float32)
        sk = np.float32(max(np.abs(v).max(), 1e-8) / np.float32(127))
        sk = np.full(v.shape, sk, np.float32)
        rk = _div32(np.ones_like(sk), sk)
        got, near = _product_levels(v, rk)
        want = _exact_levels(v, sk, rk)
        assert near.mean() < 1e-3
        assert np.array_equal(got[~near], want[~near])
    # around the halves: q = k + 0.5 + d ulps, v = q * sk
    sk = np.float32(0.0123)
    half = np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)
    ulps = np.arange(-64, 65, dtype=np.float32)
    q = (half[:, None] + ulps[None, :] * np.spacing(np.abs(half))[:, None]).astype(np.float32)
    v = (q.astype(np.float64) * sk).astype(np.float32).ravel()
    skv = np.full(v.shape, sk, np.float32)
    rk = _div32(np.ones_like(skv), skv)
    got, near = _product_levels(v, rk)
    want = _exact_levels(v, skv, rk)
    assert near.any() and np.array_equal(got[~near], want[~near])


def test_fma_emulation_rounds_once():
    """`_fma32` against exact rationals on values whose float64 sum lands on
    a float32 midpoint."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    # c puts a*b + c near a float32 midpoint, off by a tiny amount
    prod32 = (a.astype(np.float64) * b).astype(np.float32)
    half_ulp = np.spacing(np.abs(prod32)).astype(np.float64) / 2
    c = (-(a.astype(np.float64) * b - prod32) + half_ulp).astype(np.float32)
    got = _fma32(a, b, c)
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.uint32)) & 1))
        assert gi == best


# -- (b) split around the model group's maxima ------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("shard", ["column", "row"])
def test_split_weight_quantization_is_one_process_bit_for_bit(shard, smooth, world):
    """The split (b)'s plain versions on each of `world` blocks of a weight,
    with the MAX all-reduce as an elementwise maximum over the blocks: every
    block's s_c, s_k, s_x and k_q are the whole layer's, bit for bit, and
    `int8_conv_sharded` gives each block's share of the one-process conv
    (the row blocks' partial outputs summing to it within float32
    rounding)."""
    rng = np.random.default_rng(3)
    cout, cin = 48, 64
    spread = 10.0 ** rng.uniform(-1.5, 0.5, size=(1, cin, 1, 1))
    x = torch.from_numpy((rng.standard_normal((2, cin, 6, 7)) * spread).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3)) * 0.05 * 10.0 **
                          rng.uniform(0, 1.3, size=(1, cin, 1, 1))).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    want = ic.quantize_plain(x, w, smooth)
    dim = 0 if shard == "column" else 1
    ws = w.chunk(world, dim)
    xs = [x] * world if shard == "column" else [
        c.contiguous(memory_format=torch.channels_last) for c in x.chunk(world, 1)]

    def group_max(parts):
        top = torch.stack(parts).amax(0)
        return lambda t: top

    maxima = [ic.absmax_channels_plain(xi) for xi in xs]
    if shard == "column":
        if smooth:
            reduce_ = group_max([ic.weight_column_maxima_plain(wi) for wi in ws])
            got = [ic.quantize_weight_columns_plain(wi, raw, mx, reduce_(None))
                   for wi, (raw, mx) in zip(ws, maxima)]
            for s_c, s_k, s_x, k_q in got:
                assert torch.equal(s_c, want.s_c) and torch.equal(s_x, want.s_x)
            assert torch.equal(torch.cat([g[1] for g in got]), want.s_k)
            assert torch.equal(torch.cat([g[3] for g in got]), want.k_q)
    else:
        firsts = [ic.weight_row_maxima_plain(wi, raw, mx, smooth)
                  for wi, (raw, mx) in zip(ws, maxima)]
        reduce_ = group_max([m for _, m in firsts])
        got = [ic.quantize_weight_rows_plain(wi, s_c, reduce_(None))
               for wi, (s_c, _) in zip(ws, firsts)]
        assert torch.equal(torch.cat([s_c for s_c, _ in firsts]), want.s_c)
        for s_k, s_x, _ in got:
            assert torch.equal(s_k, want.s_k) and torch.equal(s_x, want.s_x)
        assert torch.equal(torch.cat([g[2] for g in got], 1), want.k_q)
    whole = ic.int8_conv_plain(x, w, bias, 1, 1, smooth)
    max_parts = {"column": [ic.weight_column_maxima_plain(wi) for wi in ws],
                 "row": [ic.weight_row_maxima_plain(wi, *m, smooth)[1]
                         for wi, m in zip(ws, maxima)]}[shard]
    reduce_ = group_max(max_parts)
    if shard == "column":
        ys = [ic.int8_conv_sharded(x, wi, bi, 1, 1, smooth, shard, reduce_)
              for wi, bi in zip(ws, bias.chunk(world))]
        assert torch.equal(torch.cat(ys, 1), whole)
    else:
        y = sum(ic.int8_conv_sharded(xi, wi, None, 1, 1, smooth, shard, reduce_)
                for xi, wi in zip(xs, ws)) + bias[:, None, None]
        err = float((y.double() - whole.double()).norm() / whole.double().norm())
        assert err <= 1e-6, err


def test_split_weight_refuses_another_shard():
    x = torch.zeros(1, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        ic.int8_conv_sharded(x, torch.zeros(8, 16, 3, 3), None, 1, 1, True, "spatial",
                             lambda t: t)


# -- (b) under a shard: the column maxima's and the scales' launches ------------
#
# numpy emulations of int8conv.cu's `column_maxima_kernel` and
# `weight_scales_kernel` at their plans: which thread reads which value, how
# the partial maxima merge, where each level lands in the k_q tile and how
# the tile is stored, held against the plain versions at every block shape
# of the main path's tensor-parallel int8 call and at odd shapes
SPLIT_BLOCKS = {"column 64x64": (64, 64, 3, 3), "column 256x512": (256, 512, 3, 3),
                "column 512x128": (512, 128, 3, 3), "column 512x256": (512, 256, 3, 3),
                "row 256x64": (256, 64, 3, 3), "5x5": (48, 40, 5, 5), "cin 62": (64, 62, 3, 3),
                "1x1": (96, 3, 1, 1), "mod 256->1024": (1024, 256, 3, 3)}


def _split_weight(shape, seed=5):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.05 * 10.0 ** rng.uniform(0, 1.3, size=(1, shape[1], 1, 1))
         ).astype(np.float32)
    w[:, 1 % shape[1]] = 0.0  # an all-zero column
    return torch.from_numpy(w)


@pytest.mark.parametrize("case", list(SPLIT_BLOCKS))
def test_column_maxima_plan_reads_every_value_once(case):
    """Block b's threads t < R * L hold the run value e = t % L of rows
    t // L, t // L + R, ... of its own columns (L = columns * taps, R =
    COLUMN_THREADS // L): every column in one block, so every weight value
    read by exactly one thread; the threads' maxima merged by column (e //
    taps, the key the lanes of a warp group by) give max|k_c| exactly; the
    grid is at most two blocks per SM."""
    cout, cin, kh, kw = SPLIT_BLOCKS[case]
    taps = kh * kw
    plan = ic.column_maxima_plan(cin, taps, sms=ic.SMS)
    assert plan.grid <= 2 * ic.SMS
    w = np.abs(_split_weight((cout, cin, kh, kw)).numpy().reshape(cout, cin * taps))
    owner = np.zeros(cin, int)
    got = np.full(cin, -1.0, np.float32)
    for b in range(plan.grid):
        c0 = b * plan.columns
        n = min(plan.columns, cin - c0)
        length = n * taps
        rows = ic.COLUMN_THREADS // length
        assert n >= 1 and rows >= 1
        owner[c0:c0 + n] += 1
        run = np.zeros((-(-cout // rows) * rows, length), np.float32)
        run[:cout] = w[:, c0 * taps:c0 * taps + length]
        held = run.reshape(-1, rows * length).max(0)   # thread t's max: t = r * L + e
        column = (np.arange(rows * length) % length) // taps
        for j in range(n):
            got[c0 + j] = held[column == j].max()
    assert (owner == 1).all()
    want = ic.weight_column_maxima_plain(_split_weight((cout, cin, kh, kw)))
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("columns", [True, False])
@pytest.mark.parametrize("case", list(SPLIT_BLOCKS))
def test_scales_plan_units_give_k_q(case, columns):
    """Block b stages its rows [b * Cout / G, (b + 1) * Cout / G) in shared
    memory (16-byte copies where a row is a multiple of 4 floats, else one
    float at a time into rows padded to 16 bytes); unit u (row u // Q,
    input channels 2q, 2q + 1, q = u % Q, Q = Cp / 2) reads its 2 * taps
    values from the stage at r * srow + 2q * taps + k and writes one 16-bit
    word per tap at k_q's [o][t][2q]: every word once, the levels of the
    plain version (zeros in the padding channels); every output channel in
    one block, at most WEIGHT_MAX_ROWS a block, s_c and the rows within the
    plan's shared memory."""
    cout, cin, kh, kw = SPLIT_BLOCKS[case]
    taps, cp = kh * kw, ic.padded_channels(cin)
    weight = _split_weight((cout, cin, kh, kw))
    rng = np.random.default_rng(8)
    if columns:
        mx = torch.from_numpy(rng.uniform(0.01, 3.0, cin).astype(np.float32))
        _, _, _, want = ic.quantize_weight_columns_plain(
            weight, mx, mx.clamp_min(ic.FLOOR), ic.weight_column_maxima_plain(weight))
    else:
        s_c = torch.from_numpy(rng.uniform(0.5, 2.0, cin).astype(np.float32))
        rows = ic._smoothed(weight, s_c).abs().amax(dim=(1, 2, 3))
        _, _, want = ic.quantize_weight_rows_plain(weight, s_c,
                                                   torch.cat([rows, torch.ones(1)]))
    levels = np.zeros((cout, taps, cp), np.uint8)
    levels[..., :cin] = want.permute(0, 2, 3, 1).reshape(cout, taps, cin).numpy().view(np.uint8)
    plan = ic.scales_plan(cout, cin, taps, sms=ic.SMS)
    row_len, srow, q_per_row = cin * taps, -(-cin * taps // 4) * 4, cp // 2
    assert plan.rows <= ic.WEIGHT_MAX_ROWS and plan.smem <= ic.SMEM_MAX
    assert plan.smem == (-(-cin // 4) + plan.rows * srow // 4) * 16
    flat = weight.numpy().reshape(cout, row_len)
    k_q = np.zeros((cout, taps, q_per_row), np.uint16)
    writes = np.zeros((cout, taps, q_per_row), int)
    owned = np.zeros(cout, int)
    for b in range(plan.grid):
        lo, hi = ic.weight_rows(plan, cout, b)
        assert 1 <= hi - lo <= plan.rows
        owned[lo:hi] += 1
        stage = np.full((hi - lo) * srow, np.nan, np.float32)
        if row_len % 4 == 0:
            stage[:] = flat[lo:hi].reshape(-1)
        else:
            i = np.arange((hi - lo) * row_len)
            stage[(i // row_len) * srow + i % row_len] = flat[lo:hi].reshape(-1)
        r, q = np.divmod(np.arange((hi - lo) * q_per_row), q_per_row)
        k = np.arange(2 * taps)
        c = 2 * q[:, None] + k // taps
        inside = c < cin
        staged = stage[np.where(inside, r[:, None] * srow + 2 * q[:, None] * taps + k, 0)]
        direct = flat[lo + r[:, None], np.minimum(c, cin - 1) * taps + k % taps]
        assert np.array_equal(staged[inside], direct[inside])
        for t in range(taps):
            k_q[lo + r, t, q] = (levels[lo + r, t, 2 * q].astype(np.uint16)
                                 | levels[lo + r, t, 2 * q + 1].astype(np.uint16) << 8)
            np.add.at(writes, (lo + r, t, q), 1)
    assert (owned == 1).all() and (writes == 1).all()
    assert np.array_equal(k_q.view(np.uint8).reshape(cout, taps, cp), levels)


def test_split_plans_refuse_what_the_kernels_cannot_take():
    with pytest.raises(ValueError):
        ic.column_maxima_plan(64, ic.COLUMN_THREADS + 1)
    with pytest.raises(ValueError):           # one output channel beyond a block's memory
        ic.scales_plan(64, 8192, 9)
    with pytest.raises(ValueError):
        ic.scales_plan(0, 64, 9)


# -- (b) under a shard: the row maxima's launch ------------------------------------
#
# A numpy emulation of int8conv.cu's `row_maxima_kernel` at its plan: which
# thread stages which value, which thread takes which (row, column) of the
# staged runs, how the columns' maxima merge over a warp's lanes and the
# warps, how s_c and max|x'| form, and how a cluster's blocks merge their
# maxima, each rank a share; held against `weight_row_maxima_plain` at the
# row blocks of the main path's tensor-parallel int8 call (1 x 2) and at
# edges (odd Cin, Cin that 16 does not divide, fewer output channels than
# SMs, one tap, one input channel, 5x5 taps)
ROW_BLOCKS = {"encoder conv2.1.0": (256, 64, 3, 3), "generator 512x256": (512, 256, 3, 3),
              "cin 31": (64, 31, 3, 3), "cin 17, cout 7": (7, 17, 3, 3),
              "1x1 cin 200": (40, 200, 1, 1), "cin 1": (64, 1, 3, 3), "5x5": (130, 96, 5, 5)}


def _emulate_row_maxima(weight, mx_raw, mx, smooth: bool, plan):
    """(s_c, maxima (parts, Cout + 1)) as the kernel forms them, and how
    often each weight value was staged, each (row, column) of a block's
    table and each output written."""
    cout, cin, kh, kw = weight.shape
    taps, cols, threads = kh * kw, plan.columns, ic.ROW_THREADS
    a = np.abs(weight.numpy().reshape(cout, cin * taps))
    reads = np.zeros(a.shape, int)
    s_c = np.full(cin, np.nan, np.float32)
    s_c_writes = np.zeros(cin, int)
    blocks = []
    for b in range(plan.grid):
        c0 = b * cols
        n = max(0, min(cols, cin - c0))
        length = n * taps
        row = np.zeros(cout + 1, np.float32)
        blocks.append(row)
        if n == 0:
            continue
        vec = plan.vec if length % plan.vec == 0 else 1    # the stage, by cp.async of vec floats
        assert (c0 * taps) % vec == 0 and (cin * taps) % vec == 0
        i = np.arange(cout * length // vec)
        o, e = i // (length // vec), i % (length // vec) * vec
        stage = np.zeros((cout, length), np.float32)
        for k in range(vec):
            stage[o, e + k] = a[o, c0 * taps + e + k]
            np.add.at(reads, (o, c0 * taps + e + k), 1)
        t = np.arange(threads)                             # thread t: column t % cols
        j = t % cols
        step = threads // cols                             # of rows t // cols, + step, ...
        o = t[:, None] // cols + step * np.arange(-(-cout // step))[None, :]
        mine = (o < cout) & (j[:, None] < n)
        tt, oo = np.broadcast_to(t[:, None], o.shape)[mine], o[mine]
        taps_max = stage.reshape(cout, n, taps).max(2)     # each (row, column) over its taps
        table = np.full((cout, n), np.nan, np.float32)
        table[oo, j[tt]] = taps_max[oo, j[tt]]
        table_writes = np.zeros((cout, n), int)
        np.add.at(table_writes, (oo, j[tt]), 1)
        assert (table_writes == 1).all()
        m = np.zeros(threads, np.float32)
        np.maximum.at(m, tt, taps_max[oo, j[tt]])
        # a warp's lanes of one column (xor offsets 16 .. cols), then its lanes < n over the warps
        warp_max = m.reshape(-1, 32 // cols, cols).max(1)     # (warps, cols)
        col = warp_max[:, :n].max(0)
        cs = slice(c0, c0 + n)
        if smooth:
            sc = ic._div_rn(ic._sqrt_rn(mx[cs]), ic._sqrt_rn(torch.from_numpy(col)
                                                              .clamp_min(ic.FLOOR))).numpy()
            row[cout] = ic._div_rn(mx_raw[cs], torch.from_numpy(sc)).max()
        else:
            sc = np.ones(n, np.float32)
            row[cout] = mx_raw[cs].max()
        s_c[cs] = sc
        s_c_writes[cs] += 1
        row[:cout] = (table * sc[None, :]).max(1)         # float32 products, rounded once
    maxima = np.full((plan.parts, cout + 1), np.nan, np.float32)
    writes = np.zeros(maxima.shape, int)
    for k in range(plan.parts):
        merged = np.stack(blocks[k * plan.cluster:(k + 1) * plan.cluster]).max(0)
        for q in range(plan.cluster):
            lo, hi = q * (cout + 1) // plan.cluster, (q + 1) * (cout + 1) // plan.cluster
            maxima[k, lo:hi] = merged[lo:hi]
            writes[k, lo:hi] += 1
    return s_c, maxima, reads, s_c_writes, writes


def _row_inputs(shape, seed=9):
    rng = np.random.default_rng(seed)
    raw = torch.from_numpy((10.0 ** rng.uniform(-2, 1, shape[1])).astype(np.float32))
    raw[0] = 0.0                                       # a channel of zeros
    return _split_weight(shape, seed), raw, raw.clamp_min(ic.FLOOR)


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("case", list(ROW_BLOCKS))
def test_row_maxima_plan_reads_every_value_once(case, smooth):
    """The chosen plan and two of wider blocks in smaller clusters: every
    weight value staged once, every table entry, s_c and cluster maximum
    written once, s_c bit for bit the plain version's, each cluster's row
    of maxima the plain version's over that cluster's input channels alone,
    and the rows folded by their max the plain version's maxima."""
    cout, cin, kh, kw = ROW_BLOCKS[case]
    taps = kh * kw
    weight, mx_raw, mx = _row_inputs((cout, cin, kh, kw))
    want_sc, want = ic.weight_row_maxima_plain(weight, mx_raw, mx, smooth)
    plans = [ic.row_maxima_plan(cout, cin, taps)]
    if cin >= 4:
        plans.append(ic._row_maxima_launch(cout, cin, taps, 4, 2))
        plans.append(ic._row_maxima_launch(cout, cin, taps, 2, 4))
    for plan in plans:
        cols = plan.columns
        assert cols & (cols - 1) == 0 and cols <= ic.ROW_MAX_COLUMNS
        assert plan.grid % plan.cluster == 0 and plan.parts == plan.grid // plan.cluster
        assert plan.grid * cols >= cin > (plan.grid - plan.cluster) * cols
        assert plan.smem == ic.row_maxima_smem(cout, taps, cols) <= ic.SMEM_MAX
        assert plan.vec in (1, 2, 4) and (cin * taps) % plan.vec == (cols * taps) % plan.vec == 0
        assert plan.vec == 4 or (cin * taps) % (2 * plan.vec) or (cols * taps) % (2 * plan.vec)
        s_c, maxima, reads, s_c_writes, writes = _emulate_row_maxima(weight, mx_raw, mx, smooth,
                                                                     plan)
        assert (reads == 1).all() and (s_c_writes == 1).all() and (writes == 1).all()
        assert np.array_equal(s_c, want_sc.numpy())
        assert np.array_equal(maxima.max(0), want.numpy())
        span = cols * plan.cluster
        for k in range(plan.parts):
            cs = slice(k * span, (k + 1) * span)
            _, part = ic.weight_row_maxima_plain(weight[:, cs], mx_raw[cs], mx[cs], smooth)
            assert np.array_equal(maxima[k], part.numpy())
        _, _, kq = ic.quantize_weight_rows_plain(weight, want_sc, torch.from_numpy(maxima))
        assert torch.equal(kq, ic.quantize_weight_rows_plain(weight, want_sc, want)[2])


def test_row_maxima_plan_sizes_the_grid():
    """At most two blocks per SM where a block's columns stay within
    ROW_MAX_COLUMNS and its runs within its shared memory; narrower blocks
    where they would not fit; refusals of what the kernel cannot take."""
    for cout, cin, taps in ((512, 256, 9), (256, 64, 9), (64, 8192, 9), (40, 200, 1)):
        plan = ic.row_maxima_plan(cout, cin, taps)
        assert plan.grid <= max(2 * ic.SMS, -(-cin // ic.ROW_MAX_COLUMNS) + plan.cluster)
    wide = ic.row_maxima_plan(4096, 8192, 9)
    assert wide.columns < 32 and wide.smem <= ic.SMEM_MAX
    for plan, args in ((ic.row_maxima_plan, (6000, 64, 9)),   # one column beyond the memory
                       (ic.row_maxima_plan, (0, 64, 9)),
                       (ic._row_maxima_launch, (64, 64, 9, 3, 8)),
                       (ic._row_maxima_launch, (64, 64, 9, 64, 8)),
                       (ic._row_maxima_launch, (64, 64, 9, 4, ic.ROW_MAX_CLUSTER + 1))):
        with pytest.raises(ValueError):
            plan(*args)
