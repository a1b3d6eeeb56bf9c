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

# name: (x (N, Cin, H, W), weight (Cout, Cin, kh, kw), stride, padding)
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
    ho, wo = ic.conv_out_size(h, kh, stride, pad), ic.conv_out_size(w, kw, stride, pad)
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
    want = F.conv2d(x_q.double(), k_q.permute(0, 3, 1, 2).double(), stride=stride, padding=pad)
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
    ho, wo = ic.conv_out_size(h, kh, stride, pad), ic.conv_out_size(w, kw, stride, pad)
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
