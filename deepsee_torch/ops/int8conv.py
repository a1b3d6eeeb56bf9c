"""`int8_conv`: the W8A8 quantized convolution of the int8 serving path.

The port of the JAX package's `_int8_conv` (deepsee_tpu/models/layers.py:81-113,
K4 in ROADMAP.md), plus the bias add that its callers apply after it.  A
float32 sequence, reproduced operation for operation:

    mx_c = max(max|x_c|, 1e-8)      over N, H, W          (smooth only)
    mk_c = max(max|k_c|, 1e-8)      over cout, kh, kw     (smooth only)
    s_c  = sqrt(mx_c) / sqrt(mk_c);  x' = x / s_c;  k' = k * s_c
    s_k  = max(max|k'_o|, 1e-8) / 127;  k_q = clip(round(k' / s_k), +-127)
    s_x  = max(max|x'|, 1e-8) / 127;    x_q = clip(round(x' / s_x), +-127)
    y    = float32(conv_s32(x_q, k_q)) * (s_x * s_k), cast to x's type,
           then + bias in that type

(SmoothQuant with alpha 0.5; without `smooth` s_c is 1, which leaves x and k
as they are, bit for bit.)  The activation scale is one per tensor, so a
sample's result depends on its batch-mates: the JAX package's semantics.

`int8_conv` is the registered custom op `torch.ops.deepsee.int8_conv`, so
`torch.export` keeps it as one node.  On CUDA tensors it launches the four
hand-written kernels of deepsee_torch/csrc/int8conv.cu -- (a)
`absmax_channels`, (b) `quantize_weight`, (c) `quantize_activation`, (d)
`int8_conv_igemm` -- or raises; on CPU tensors it computes
`int8_conv_plain`, whose integer product is a float64 convolution (exact:
|acc| <= 127 * 127 * K stays far below 2^53).  There is no fallback from one
to the other.  Importing this module registers the op.

Under tensor parallelism a rank holds a block of a conv's weight, and the
scales must still be the whole layer's, as the JAX package's mesh runs take
them: `int8_conv_sharded` splits (b) into this rank's maxima, a MAX
all-reduce over the model group that the caller passes in, and the rest of
(b) from the reduced maxima, so the scales and k_q equal one process's bit
for bit.  Its stages are the kernels' wrappers, each of which launches its
kernel on CUDA tensors and runs its plain version on CPU tensors.

Under the spatial layout a rank holds a horizontal stripe of the map, and
the maxima must still be the whole map's: `int8_conv_striped` runs (a) on
the stripe, takes the model group's MAX all-reduce of its maxima (exact, so
one process's bit for bit), then (b) and (c) as one process does, and hands
(d) the stripe's x_q with its halo rows (int8, from the caller's window)
at a padding of 0 along H.  Kernel (d) and its plan take the padding per
axis, (pad_h, pad_w), for that.

The launch plans are pure Python, so the CPU tests reach them:
`weight_plan` gives (b)'s blocks their runs of output channels and their
threads their units; `quantize_plan` sizes (c)'s grid; `igemm_plan`
chooses (d)'s tile (the output-pixel rectangle, BN, BK, the ring's stages,
the persistent grid) and the boxes of its two TMA tensor maps, and `igemm_tile` /
`igemm_loads` give the tile order and the coordinates that the kernel's
producer hands TMA, from which tests/test_torch_int8_plan.py rebuilds the
product on the CPU.

Activations are NCHW tensors in channels_last memory (bf16 or float32), the
weight OIHW float32.  The kernels' intermediates keep the GEMM's layouts:
x_q (N, Cp, H, W) channels_last and k_q (Cout, kh, kw, Cp), int8, where Cp
is Cin rounded up to 16 and the padding channels are zero.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from deepsee_torch.ops import _build
from deepsee_torch.ops.modnorm import card_sms

__all__ = ["int8_conv", "int8_conv_plain", "quantize_plain", "igemm_plain", "Quantized",
           "absmax_channels_plain", "smooth_scales_plain", "quantize_weight_plain",
           "quantize_activation_plain",
           "absmax_channels", "quantize_weight", "quantize_activation", "int8_conv_igemm",
           "divide_check", "QuantizePlan", "quantize_plan", "WeightPlan", "weight_plan",
           "weight_rows", "IgemmPlan", "igemm_plan",
           "igemm_tile", "igemm_loads",
           "padded_channels", "conv_out_size", "pads", "launches", "plain_calls",
           "reset_launches", "int8_conv_sharded", "int8_conv_striped", "weight_column_maxima",
           "quantize_weight_columns", "weight_row_maxima", "quantize_weight_rows",
           "weight_column_maxima_plain", "quantize_weight_columns_plain",
           "weight_row_maxima_plain", "quantize_weight_rows_plain"]

FLOOR = 1e-8
LEVELS = 127.0
CHANNEL_ALIGN = 16          # Cp: TMA wants every row of x_q and k_q on 16 bytes
SMS = 132                   # H100 SXM
ABSMAX_BLOCKS = 4 * SMS     # the partials pass: four blocks per SM
THREADS = 256
# (c): a block strides over the pixels; at most this many blocks per SM
QUANTIZE_BLOCKS_PER_SM = 4
QUANTIZE_MAX_PIXELS = 1 << 30   # the kernel indexes pixels in 32 bits
# (d): a tile is 128 output pixels (two consumer warpgroups of 64 rows) by
# BN output channels; the shared-memory ring holds up to 192 KB of stages
IGEMM_BM = 128
IGEMM_RING_BYTES = 192 * 1024
IGEMM_MAX_STAGES = 8
TMA_BOX_MAX = 256           # elements of a box along one dimension
TMA_MAX_ELEMENT_STRIDE = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# float64 rows of the plain product at once: bounds its memory on the card
PLAIN_ELEMENTS = 1 << 28

# (b): a block of WEIGHT_THREADS per SM at most, owning at most
# WEIGHT_MAX_ROWS output channels; at most WEIGHT_MAX_CIN input channels
WEIGHT_THREADS = 1024
WEIGHT_MAX_ROWS = 32
WEIGHT_MAX_CIN = 8192
WEIGHT_UNIT_COLUMNS = 2   # input channels of a unit: a 16-bit word of k_q per tap

# Kernel launches, one per wrapper call that launches its kernel: (a) is two
# launches in the source (partials and merge), counted as one.  `plain_calls`
# counts the op's plain version on CPU tensors, so CPU runs can count
# quantized convs too.
#
# Under a tensor-parallel shard (`int8_conv_sharded`) (b) is two launches
# around the model group's MAX all-reduce: "weight_column_maxima" or
# "weight_row_maxima" (this rank's maxima, by the block's role) and
# "weight_scales" (the scales and k_q from the group's).
launches = {"absmax": 0, "quantize_weight": 0, "quantize_activation": 0, "igemm": 0,
            "weight_column_maxima": 0, "weight_row_maxima": 0, "weight_scales": 0}
plain_calls = {"int8_conv": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    plain_calls["int8_conv"] = 0


def padded_channels(cin: int) -> int:
    return -(-cin // CHANNEL_ALIGN) * CHANNEL_ALIGN


def conv_out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


Padding = Union[int, Tuple[int, int]]


def pads(padding: Padding) -> Tuple[int, int]:
    """(pad_h, pad_w) of a padding given as one int or per axis."""
    if isinstance(padding, int):
        return padding, padding
    ph, pw = padding
    return int(ph), int(pw)


# -- the plain version ---------------------------------------------------------

class Quantized(NamedTuple):
    """The quantization of one conv's inputs: per input channel mx_raw
    (max|x_c|), mx (clamped at 1e-8) and s_c (ones without smoothing); per
    output channel s_k; the scalar s_x; k_q (OIHW) and x_q (NCHW,
    channels_last), int8."""
    mx_raw: torch.Tensor
    mx: torch.Tensor
    s_c: torch.Tensor
    s_k: torch.Tensor
    s_x: torch.Tensor
    k_q: torch.Tensor
    x_q: torch.Tensor


def _sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """float32 sqrt rounded to nearest, as the kernels' __fsqrt_rn and an eager
    jnp.sqrt give it (PyTorch's vectorized CPU sqrt is not always the nearest
    float32): the float64 root of a float32 rounds to the nearest float32."""
    return torch.sqrt(t.double()).float()


def _div_rn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a / b rounded to nearest, as the kernels' __fdiv_rn and XLA's
    divide give it: through float64, whose quotient rounds to the same
    float32.  (PyTorch divides by a scalar as a multiply by its reciprocal
    on CUDA, which is not always the nearest float32.)"""
    return (a.double() / b.to(a.device).double()).float()


def absmax_channels_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max|x_c|, max(max|x_c|, 1e-8)) over N, H, W, float32: kernel (a)'s
    function and step 1."""
    mx_raw = x.float().abs().amax(dim=(0, 2, 3))
    return mx_raw, mx_raw.clamp_min(FLOOR)


def smooth_scales_plain(weight: torch.Tensor, mx: torch.Tensor, smooth: bool) -> torch.Tensor:
    """Steps 2-3: s_c = sqrt(mx) / sqrt(max(max|k_c|, 1e-8)); ones without
    smoothing."""
    if not smooth:
        return torch.ones_like(mx)
    mk = weight.float().abs().amax(dim=(0, 2, 3)).clamp_min(FLOOR)
    return _div_rn(_sqrt_rn(mx), _sqrt_rn(mk))


def _scale(top: torch.Tensor) -> torch.Tensor:
    """max(top, 1e-8) / 127: a weight row's s_k or the activation's s_x."""
    return _div_rn(top.clamp_min(FLOOR), torch.tensor(LEVELS))


def _smoothed(weight: torch.Tensor, s_c: torch.Tensor) -> torch.Tensor:
    return weight.float() * s_c[:, None, None]


def _weight_levels(w: torch.Tensor, s_k: torch.Tensor) -> torch.Tensor:
    """k_q = clip(round(k' / s_k), +-127) as OIHW int8."""
    k_q = torch.clamp(torch.round(_div_rn(w, s_k[:, None, None, None])), -LEVELS, LEVELS)
    return k_q.to(torch.int8)


def quantize_weight_plain(weight: torch.Tensor, s_c: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 4-5 for the weight: k' = k * s_c, s_k = max(max|k'_o|, 1e-8) /
    127, k_q = clip(round(k' / s_k), +-127) as OIHW int8."""
    w = _smoothed(weight, s_c)
    s_k = _scale(w.abs().amax(dim=(1, 2, 3)))
    return s_k, _weight_levels(w, s_k)


def quantize_activation_plain(x: torch.Tensor, s_c: torch.Tensor,
                              s_x: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 4 and 6 for the activation: x' = x / s_c, s_x = max(max|x'|,
    1e-8) / 127 (unless given: the model group's, for a channel block of
    x), x_q = clip(round(x' / s_x), +-127) as NCHW channels_last int8."""
    xs = _div_rn(x.float(), s_c[:, None, None])
    if s_x is None:
        s_x = _scale(xs.abs().amax())
    x_q = torch.clamp(torch.round(_div_rn(xs, s_x)), -LEVELS, LEVELS)
    return s_x, x_q.to(torch.int8).contiguous(memory_format=torch.channels_last)


# -- (b) split around the model group's maxima (tensor parallelism) --------------
#
# A column block (this rank's output channels, x whole) needs the whole
# layer's column maxima mk; a row block (this rank's input channels and x's
# channel block) the whole layer's row maxima of k' = k * s_c and max|x'|.
# Each is one rank's partial maxima, a MAX all-reduce over the model group,
# and the rest of (b) from the reduced maxima: bit for bit what one process
# computes from the whole weight and x.

def weight_column_maxima_plain(weight: torch.Tensor) -> torch.Tensor:
    """(b)'s first launch for a column block: max|k_c| over this block's
    output channels and the taps, (Cin,) float32, unclamped."""
    return weight.float().abs().amax(dim=(0, 2, 3))


def quantize_weight_columns_plain(weight: torch.Tensor, mx_raw: torch.Tensor, mx: torch.Tensor,
                                  mk: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(b)'s second launch for a column block: (s_c, s_k, s_x, k_q) from the
    group's column maxima mk (unclamped), x's maxima and this block."""
    s_c = _div_rn(_sqrt_rn(mx), _sqrt_rn(mk.float().clamp_min(FLOOR)))
    s_k, k_q = quantize_weight_plain(weight, s_c)
    return s_c, s_k, _scale(_div_rn(mx_raw, s_c).amax()), k_q


def weight_row_maxima_plain(weight: torch.Tensor, mx_raw: torch.Tensor, mx: torch.Tensor,
                            smooth: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b)'s first launch for a row block: s_c (this block's columns are
    whole here) and the maxima (Cout + 1,): max|k'_o| of each output channel
    over this block's columns, then max|x'| over x's channel block."""
    s_c = smooth_scales_plain(weight, mx, smooth)
    rows = _smoothed(weight, s_c).abs().amax(dim=(1, 2, 3))
    return s_c, torch.cat([rows, _div_rn(mx_raw, s_c).amax()[None]])


def quantize_weight_rows_plain(weight: torch.Tensor, s_c: torch.Tensor, maxima: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(b)'s second launch for a row block: (s_k, s_x, k_q) from s_c and the
    group's maxima."""
    s_k = _scale(maxima[:-1].float())
    return s_k, _scale(maxima[-1].float()), _weight_levels(_smoothed(weight, s_c), s_k)


def quantize_plain(x: torch.Tensor, weight: torch.Tensor, smooth: bool) -> Quantized:
    """Steps 1-6 of `_int8_conv` in float32, in its order."""
    mx_raw, mx = absmax_channels_plain(x)
    s_c = smooth_scales_plain(weight, mx, smooth)
    s_k, k_q = quantize_weight_plain(weight, s_c)
    s_x, x_q = quantize_activation_plain(x, s_c)
    return Quantized(mx_raw, mx, s_c, s_k, s_x, k_q, x_q)


def igemm_plain(x_q: torch.Tensor, k_q: torch.Tensor, s_x: torch.Tensor, s_k: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int, padding: Padding,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Step 7 and the bias: the s8 x s8 -> s32 product as an exact float64
    conv (in batch slices of at most PLAIN_ELEMENTS outputs), rounded to
    float32, times (s_x * s_k); cast to out_dtype; + bias in out_dtype.
    `padding` is one int or (pad_h, pad_w)."""
    n, _, h, w = x_q.shape
    cout, _, kh, kw = k_q.shape
    padding = pads(padding)
    ho, wo = conv_out_size(h, kh, stride, padding[0]), conv_out_size(w, kw, stride, padding[1])
    k64 = k_q.double()
    scale = (s_x * s_k)[:, None, None]
    rows = max(1, PLAIN_ELEMENTS // max(1, cout * ho * wo))
    out = []
    for xs in x_q.split(rows):
        acc = F.conv2d(xs.double(), k64, stride=stride, padding=padding)
        y = (acc.float() * scale).to(out_dtype)
        if bias is not None:
            y = y + bias.to(out_dtype)[:, None, None]
        out.append(y)
    return torch.cat(out).contiguous(memory_format=torch.channels_last)


def int8_conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                    stride: int = 1, padding: int = 1, smooth: bool = True,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`_int8_conv` and the bias add after it, in plain PyTorch; the result
    in out_dtype (x's type by default), channels_last."""
    q = quantize_plain(x, weight, smooth)
    return igemm_plain(q.x_q, q.k_q, q.s_x, q.s_k, bias, stride, padding,
                       out_dtype or x.dtype)


# -- the launch plans ------------------------------------------------------------

def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _pow2_at_most(n: int) -> int:
    return 1 << (n.bit_length() - 1)


class QuantizePlan(NamedTuple):
    """Kernel (c)'s grid: a block takes `lanes` 16-channel groups (a power of
    2, at most 32) of `rows` = 256 / lanes pixels a step, `unroll` steps at
    once; blocks_y channel ranges times blocks_x blocks striding over the
    pixels."""
    lanes: int
    rows: int
    unroll: int
    blocks_x: int
    blocks_y: int


def quantize_plan(pixels: int, cp: int, dtype: torch.dtype, sms: int = SMS) -> QuantizePlan:
    groups = cp // 16
    lanes = min(32, _pow2_at_least(groups))
    rows = THREADS // lanes
    unroll = 4 if dtype == torch.bfloat16 else 2   # 128 bytes of loads in flight a thread
    blocks_y = -(-groups // lanes)
    blocks_x = max(1, min(-(-pixels // (rows * unroll)),
                          QUANTIZE_BLOCKS_PER_SM * sms // blocks_y))
    return QuantizePlan(lanes, rows, unroll, blocks_x, blocks_y)


class WeightPlan(NamedTuple):
    """Kernel (b)'s launch for one weight: `grid` blocks (at most one per SM),
    block b owning the output channels `weight_rows(plan, cout, b)`, at most
    `rows` of them; a unit is one output channel's two input channels over
    the taps (a 16-bit word of k_q per tap), `units` of them in the largest block,
    thread t taking units t, t + WEIGHT_THREADS, ...; `cached`: taps 1 or 9,
    a thread's first unit held in registers (the weight read once where
    units <= WEIGHT_THREADS); `vector`: Cin even, units loaded 8 bytes at a
    time; `smem`: dynamic shared memory (s_c, and the column maxima where
    smoothing)."""
    grid: int
    rows: int
    units: int
    cached: bool
    vector: bool
    smem: int


def weight_plan(cout: int, cin: int, taps: int, smooth: bool = True,
                sms: int = SMS) -> WeightPlan:
    """One block per SM, or per output channel where there are fewer, each a
    run of Cout / grid output channels."""
    if min(cout, cin, taps) < 1:
        raise ValueError(f"int8conv: no weight of ({cout}, {cin}, {taps} taps)")
    if cin > WEIGHT_MAX_CIN:
        raise ValueError(f"int8conv: quantize_weight takes at most {WEIGHT_MAX_CIN} input "
                         f"channels, got {cin}")
    grid = min(cout, sms)
    rows = -(-cout // grid)
    if rows > WEIGHT_MAX_ROWS:
        raise ValueError(f"int8conv: quantize_weight gives a block at most {WEIGHT_MAX_ROWS} "
                         f"output channels; {cout} on {grid} blocks need {rows}")
    return WeightPlan(grid, rows, rows * padded_channels(cin) // WEIGHT_UNIT_COLUMNS,
                      taps in (1, 9), cin % WEIGHT_UNIT_COLUMNS == 0,
                      cin * 4 * (2 if smooth else 1))


def weight_rows(plan: WeightPlan, n: int, block: int) -> Tuple[int, int]:
    """The [begin, end) output channels of `block` (n = Cout: the kernel's
    o_begin, o_end); with n = Cin, the input channels whose s_c it writes."""
    return block * n // plan.grid, (block + 1) * n // plan.grid


class IgemmPlan(NamedTuple):
    """Kernel (d)'s tile and grid for one conv.

    An M tile is an hbox x wbox rectangle (hbox * wbox = 128) of one image's
    output pixels, an N tile bn output channels; tiles_h x tiles_w
    rectangles per image, tiles_n N tiles, `tiles` in all, walked N fastest
    (`igemm_tile`) by `grid` persistent blocks.  K runs over the taps and, in
    each, over `chunks` chunks of bk channels (zero-filled past Cp).  The
    TMA boxes: x_box over x_q [N][H][W][Cp] (innermost first: channels, W,
    H, N) with x_element_strides, k_box over k_q [Cout][tap][Cp]."""
    bn: int
    bk: int
    stages: int
    smem: int
    hbox: int
    wbox: int
    tiles_h: int
    tiles_w: int
    tiles_n: int
    tiles: int
    taps: int
    chunks: int
    grid: int
    x_box: Tuple[int, int, int, int]
    x_element_strides: Tuple[int, int, int, int]
    k_box: Tuple[int, int, int]


def igemm_plan(x_shape: Tuple[int, int, int, int], k_shape: Tuple[int, int, int, int],
               stride: int, padding: Padding, sms: int = SMS) -> IgemmPlan:
    """The plan for x_q of shape (N, Cp, H, W) and k_q (Cout, kh, kw, Cp),
    `padding` one int or (pad_h, pad_w).

    bk: 64 bytes (64-byte swizzle) for Cp <= 64, else 128 (128-byte swizzle);
    bn: 256, or 128 for Cout <= 128; as many ring stages as 192 KB hold (at
    most 8).  The rectangle's width is the smallest power of 2 that covers
    Wo (at most 128), kept where TMA's boxes (wbox * stride and hbox *
    stride elements, at most 256) allow."""
    n, cp, h, w = x_shape
    cout, kh, kw, _ = k_shape
    if not 1 <= stride <= TMA_MAX_ELEMENT_STRIDE:
        raise ValueError(f"int8conv: stride {stride}: TMA's element strides run from 1 to "
                         f"{TMA_MAX_ELEMENT_STRIDE}")
    ph, pw = pads(padding)
    ho, wo = conv_out_size(h, kh, stride, ph), conv_out_size(w, kw, stride, pw)
    bk = 64 if cp <= 64 else 128
    bn = 128 if cout <= 128 else 256
    stage = (IGEMM_BM + bn) * bk
    stages = min(IGEMM_MAX_STAGES, IGEMM_RING_BYTES // stage)
    widest = min(IGEMM_BM, _pow2_at_most(TMA_BOX_MAX // stride))
    narrowest = _pow2_at_least(-(-IGEMM_BM * stride // TMA_BOX_MAX))
    wbox = max(narrowest, min(widest, _pow2_at_least(wo)))
    hbox = IGEMM_BM // wbox
    tiles_h, tiles_w, tiles_n = -(-ho // hbox), -(-wo // wbox), -(-cout // bn)
    tiles = n * tiles_h * tiles_w * tiles_n
    return IgemmPlan(bn=bn, bk=bk, stages=stages, smem=1024 + stages * stage + 16 * stages,
                     hbox=hbox, wbox=wbox, tiles_h=tiles_h, tiles_w=tiles_w, tiles_n=tiles_n,
                     tiles=tiles, taps=kh * kw, chunks=-(-cp // bk), grid=min(tiles, sms),
                     x_box=(bk, wbox * stride, hbox * stride, 1),
                     x_element_strides=(1, stride, stride, 1), k_box=(bk, 1, bn))


def igemm_tile(plan: IgemmPlan, t: int) -> Tuple[int, int, int, int]:
    """Tile t's (image, ho0, wo0, n0): N fastest, then the rectangles of
    each image in raster order (the kernel's `tile_at`)."""
    mt, nt = divmod(t, plan.tiles_n)
    rest, tw = divmod(mt, plan.tiles_w)
    img, th = divmod(rest, plan.tiles_h)
    return img, th * plan.hbox, tw * plan.wbox, nt * plan.bn


def igemm_loads(plan: IgemmPlan, tile: Tuple[int, int, int, int], kw: int, stride: int,
                padding: Padding):
    """The producer's TMA coordinates for one tile, in K order: for each tap
    (r, q) and channel chunk, ((c, w, h, image) of the x_q box, (c, tap, n0)
    of the k_q box).  The box's corner is shifted by pad_h along H and pad_w
    along W; TMA fills zeros outside the tensor."""
    img, ho0, wo0, n0 = tile
    ph, pw = pads(padding)
    h0, w0 = ho0 * stride - ph, wo0 * stride - pw
    for tap in range(plan.taps):
        r, q = divmod(tap, kw)
        for c in range(plan.chunks):
            yield (c * plan.bk, w0 + q, h0 + r, img), (c * plan.bk, tap, n0)



# -- the kernels -----------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8conv")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.int8_absmax_channels.argtypes = [p, p, p, p, i64, i32, i32, i32, i32, p]
    lib.int8_quantize_weight.argtypes = [p] * 8 + [i32] * 6 + [p]
    lib.int8_quantize_weight_split.argtypes = [i32] + [p] * 9 + [i32] * 6 + [p]
    lib.int8_quantize_activation.argtypes = [p, p, p, p] + [i32] * 6 + [p]
    lib.int8_conv_igemm.argtypes = [p, p, p, p, p, p] + [i32] * 18 + [p]
    lib.int8_divide_check.argtypes = [p, p, i32, p, p, p, p]
    for fn in (lib.int8_absmax_channels, lib.int8_quantize_weight, lib.int8_quantize_weight_split,
               lib.int8_quantize_activation, lib.int8_conv_igemm, lib.int8_divide_check):
        fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# int8_conv_igemm's own error codes beside CUDA's (int8conv.cu)
_IGEMM_ERRORS = {9001: "the tile plan is out of the kernel's range",
                 9002: "cuTensorMapEncodeTiled was not found in the driver"}


def _check(err: int, name: str) -> None:
    if err == 0:
        return
    if err in _IGEMM_ERRORS:
        raise RuntimeError(f"int8conv: {name}: {_IGEMM_ERRORS[err]}")
    if err >= 9100:
        raise RuntimeError(f"int8conv: {name}: the driver refused a tensor map "
                           f"(CUresult {err - 9100})")
    raise RuntimeError(f"int8conv: {name} launch failed with CUDA error {err}")


def _check_cuda(name: str, t: torch.Tensor, dtypes, dim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"int8conv: {name} must be on a CUDA device, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"int8conv: {name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != dim or t.numel() == 0:
        raise ValueError(f"int8conv: {name} must be a non-empty {dim}-d tensor, "
                         f"got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"int8conv: {name} must be 16-byte aligned")


def _check_activation(name: str, x: torch.Tensor, dtypes) -> None:
    _check_cuda(name, x, dtypes, 4)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"int8conv: {name} must be channels_last contiguous")


def _check_vector(name: str, t: torch.Tensor, n: int, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or t.shape != (n,) \
            or not t.is_contiguous():
        raise ValueError(f"int8conv: {name} must be float32 ({n},) on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _plain_here(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether a wrapper runs its plain version: its tensors lie on the CPU.
    Tensors on two devices are refused."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"int8conv: tensors on {sorted(map(str, devices))}")
    return next(iter(devices)).type == "cpu"


# Each wrapper below launches its kernel on CUDA tensors and runs its plain
# version on CPU tensors, in the plain version's layouts (k_q OIHW, x_q
# without padding channels), which the CPU (d) takes.

def absmax_channels(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel (a): (max|x_c|, max(max|x_c|, 1e-8)) over N, H, W, float32 (C,)."""
    if _plain_here(x):
        return absmax_channels_plain(x)
    _check_activation("x", x, tuple(_DTYPE_CODE))
    b, c, h, w = x.shape
    pixels = b * h * w
    per_load = 16 // x.element_size()
    vector = c % per_load == 0
    col_blocks = -(-(c // per_load if vector else c) // 32)
    rows = max(1, min(-(-pixels // 8), -(-ABSMAX_BLOCKS // col_blocks)))
    part = torch.empty((rows, c), dtype=torch.float32, device=x.device)
    mx_raw = torch.empty(c, dtype=torch.float32, device=x.device)
    mx = torch.empty_like(mx_raw)
    with torch.cuda.device(x.device):
        err = _lib().int8_absmax_channels(x.data_ptr(), part.data_ptr(), mx_raw.data_ptr(),
                                          mx.data_ptr(), pixels, c, rows, int(vector),
                                          _DTYPE_CODE[x.dtype], _stream(x))
    _check(err, "absmax_channels")
    launches["absmax"] += 1
    return mx_raw, mx


def quantize_weight(weight: torch.Tensor, mx_raw: torch.Tensor, mx: torch.Tensor,
                    smooth: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Kernel (b): (s_c (Cin,), s_k (Cout,), s_x (), k_q (Cout, kh, kw, Cp)
    int8) from the OIHW float32 weight and kernel (a)'s maxima, in one launch
    of `weight_plan`'s grid (cooperative where it smooths: its blocks merge
    the column maxima in a (Cin,) scratch of this call, taken from the
    caching allocator on the current stream and zeroed there, so calls on
    other streams never share it)."""
    if _plain_here(weight, mx_raw, mx):
        s_c = smooth_scales_plain(weight, mx, smooth)
        s_k, k_q = quantize_weight_plain(weight, s_c)
        return s_c, s_k, _scale(_div_rn(mx_raw, s_c).amax()), k_q
    _check_cuda("weight", weight, (torch.float32,), 4)
    if not weight.is_contiguous():
        raise ValueError("int8conv: weight must be contiguous OIHW")
    cout, cin, kh, kw = weight.shape
    _check_vector("mx_raw", mx_raw, cin, weight.device)
    _check_vector("mx", mx, cin, weight.device)
    cp = padded_channels(cin)
    dev = weight.device
    plan = weight_plan(cout, cin, kh * kw, smooth, card_sms(dev))
    s_c = torch.empty(cin, dtype=torch.float32, device=dev)
    s_k = torch.empty(cout, dtype=torch.float32, device=dev)
    s_x = torch.empty((), dtype=torch.float32, device=dev)
    k_q = torch.empty((cout, kh, kw, cp), dtype=torch.int8, device=dev)
    mk = torch.empty(cin, dtype=torch.int32, device=dev) if smooth else None
    with torch.cuda.device(dev):
        err = _lib().int8_quantize_weight(
            weight.data_ptr(), mx.data_ptr(), mx_raw.data_ptr(), s_c.data_ptr(),
            s_k.data_ptr(), s_x.data_ptr(), k_q.data_ptr(), None if mk is None else mk.data_ptr(),
            cout, cin, cp, kh * kw, int(smooth), plan.grid, _stream(weight))
    _check(err, "quantize_weight")
    launches["quantize_weight"] += 1
    return s_c, s_k, s_x, k_q


# (b)'s launches under a shard (int8conv.cu's WeightMode)
_COLUMN_MAXIMA, _COLUMN_SCALES, _ROW_MAXIMA, _ROW_SCALES = 1, 2, 3, 4


def _weight_split(mode: int, weight: torch.Tensor, smooth: bool, *, mx_raw=None, mx=None,
                  s_c=None, s_k=None, s_x=None, k_q=None, mk=None, maxima=None) -> None:
    """One launch of (b) under a shard, `weight_plan`'s grid, into the
    given outputs; its count."""
    _check_cuda("weight", weight, (torch.float32,), 4)
    if not weight.is_contiguous():
        raise ValueError("int8conv: weight must be contiguous OIHW")
    cout, cin, kh, kw = weight.shape
    for name, t, n in (("mx_raw", mx_raw, cin), ("mx", mx, cin), ("s_c", s_c, cin),
                       ("mk", mk, cin), ("maxima", maxima, cout + 1)):
        if t is not None:
            _check_vector(name, t, n, weight.device)
    plan = weight_plan(cout, cin, kh * kw, smooth, card_sms(weight.device))
    ptr = [None if t is None else t.data_ptr() for t in (mx, mx_raw, s_c, s_k, s_x, k_q, mk,
                                                         maxima)]
    with torch.cuda.device(weight.device):
        err = _lib().int8_quantize_weight_split(mode, weight.data_ptr(), *ptr, cout, cin,
                                                padded_channels(cin), kh * kw, int(smooth),
                                                plan.grid, _stream(weight))
    _check(err, "quantize_weight_split")
    launches[{_COLUMN_MAXIMA: "weight_column_maxima",
              _ROW_MAXIMA: "weight_row_maxima"}.get(mode, "weight_scales")] += 1


def weight_column_maxima(weight: torch.Tensor) -> torch.Tensor:
    """(b)'s first launch for a column block (smoothing): max|k_c| over its
    output channels and taps, (Cin,) float32 (bit patterns merged by
    atomicMax in a buffer zeroed on the stream)."""
    if _plain_here(weight):
        return weight_column_maxima_plain(weight)
    mk = torch.empty(weight.shape[1], dtype=torch.float32, device=weight.device)
    _weight_split(_COLUMN_MAXIMA, weight, True, mk=mk)
    return mk


def quantize_weight_columns(weight: torch.Tensor, mx_raw: torch.Tensor, mx: torch.Tensor,
                            mk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                       torch.Tensor]:
    """(b)'s second launch for a column block: (s_c, s_k, s_x, k_q) from the
    model group's column maxima `mk` and x's maxima, as `quantize_weight`
    gives them (k_q (Cout, kh, kw, Cp))."""
    if _plain_here(weight, mx_raw, mx, mk):
        return quantize_weight_columns_plain(weight, mx_raw, mx, mk)
    cout, cin, kh, kw = weight.shape
    dev = weight.device
    s_c = torch.empty(cin, dtype=torch.float32, device=dev)
    s_k = torch.empty(cout, dtype=torch.float32, device=dev)
    s_x = torch.empty((), dtype=torch.float32, device=dev)
    k_q = torch.empty((cout, kh, kw, padded_channels(cin)), dtype=torch.int8, device=dev)
    _weight_split(_COLUMN_SCALES, weight, True, mx_raw=mx_raw, mx=mx, s_c=s_c, s_k=s_k,
                  s_x=s_x, k_q=k_q, mk=mk)
    return s_c, s_k, s_x, k_q


def weight_row_maxima(weight: torch.Tensor, mx_raw: torch.Tensor, mx: torch.Tensor,
                      smooth: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b)'s first launch for a row block: s_c (Cin,) and the maxima (Cout +
    1,): each output channel's max|k'| over this block's columns, then
    max|x'| over x's channel block (cooperative where it smooths, as
    `quantize_weight`)."""
    if _plain_here(weight, mx_raw, mx):
        return weight_row_maxima_plain(weight, mx_raw, mx, smooth)
    cout, cin = weight.shape[:2]
    dev = weight.device
    s_c = torch.empty(cin, dtype=torch.float32, device=dev)
    maxima = torch.empty(cout + 1, dtype=torch.float32, device=dev)
    mk = torch.empty(cin, dtype=torch.float32, device=dev) if smooth else None
    _weight_split(_ROW_MAXIMA, weight, smooth, mx_raw=mx_raw, mx=mx, s_c=s_c, mk=mk,
                  maxima=maxima)
    return s_c, maxima


def quantize_weight_rows(weight: torch.Tensor, s_c: torch.Tensor, maxima: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(b)'s second launch for a row block: (s_k, s_x, k_q) from s_c and the
    model group's maxima."""
    if _plain_here(weight, s_c, maxima):
        return quantize_weight_rows_plain(weight, s_c, maxima)
    cout, cin, kh, kw = weight.shape
    dev = weight.device
    s_k = torch.empty(cout, dtype=torch.float32, device=dev)
    s_x = torch.empty((), dtype=torch.float32, device=dev)
    k_q = torch.empty((cout, kh, kw, padded_channels(cin)), dtype=torch.int8, device=dev)
    _weight_split(_ROW_SCALES, weight, True, s_c=s_c, s_k=s_k, s_x=s_x, k_q=k_q, maxima=maxima)
    return s_k, s_x, k_q


def quantize_activation(x: torch.Tensor, s_c: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """Kernel (c): x_q = clip(rint((x / s_c) / s_x), +-127), int8 (N, Cp, H, W)
    channels_last with zero padding channels."""
    if _plain_here(x, s_c, s_x):
        return quantize_activation_plain(x, s_c, s_x)[1]
    _check_activation("x", x, tuple(_DTYPE_CODE))
    b, c, h, w = x.shape
    _check_vector("s_c", s_c, c, x.device)
    if s_x.device != x.device or s_x.dtype != torch.float32 or s_x.numel() != 1:
        raise ValueError("int8conv: s_x must be one float32 on x's device")
    cp = padded_channels(c)
    pixels = b * h * w
    if pixels >= QUANTIZE_MAX_PIXELS:
        raise ValueError(f"int8conv: {pixels} pixels: quantize_activation takes fewer than "
                         f"{QUANTIZE_MAX_PIXELS}")
    x_q = torch.empty((b, cp, h, w), dtype=torch.int8, device=x.device,
                      memory_format=torch.channels_last)
    plan = quantize_plan(pixels, cp, x.dtype, card_sms(x.device))
    with torch.cuda.device(x.device):
        err = _lib().int8_quantize_activation(x.data_ptr(), s_c.data_ptr(), s_x.data_ptr(),
                                              x_q.data_ptr(), pixels, c, cp, plan.lanes,
                                              plan.blocks_x, _DTYPE_CODE[x.dtype], _stream(x))
    _check(err, "quantize_activation")
    launches["quantize_activation"] += 1
    return x_q


def int8_conv_igemm(x_q: torch.Tensor, k_q: torch.Tensor, s_x: torch.Tensor,
                    s_k: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
                    padding: Padding, out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel (d): the implicit-GEMM conv of x_q (N, Cp, H, W) channels_last
    with k_q (Cout, kh, kw, Cp) at `padding` (one int or (pad_h, pad_w)),
    dequantized, cast to out_dtype, + bias in out_dtype; (N, Cout, Ho, Wo)
    channels_last.  The tile is `igemm_plan`'s; the stride runs from 1 to 8
    (TMA's element strides)."""
    if _plain_here(x_q, k_q, s_x, s_k, bias):
        return igemm_plain(x_q, k_q, s_x, s_k, bias, stride, padding, out_dtype)
    _check_activation("x_q", x_q, (torch.int8,))
    _check_cuda("k_q", k_q, (torch.int8,), 4)
    n, cp, h, w = x_q.shape
    cout, kh, kw, kcp = k_q.shape
    if cp % CHANNEL_ALIGN or kcp != cp or not k_q.is_contiguous():
        raise ValueError(f"int8conv: x_q {tuple(x_q.shape)} and k_q {tuple(k_q.shape)} must "
                         f"share a channel count that {CHANNEL_ALIGN} divides")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"int8conv: out_dtype must be float32 or bfloat16, got {out_dtype}")
    ph, pw = pads(padding)
    if not 1 <= stride <= TMA_MAX_ELEMENT_STRIDE or min(ph, pw) < 0:
        raise ValueError(f"int8conv: stride {stride} (1 to {TMA_MAX_ELEMENT_STRIDE}) and "
                         f"padding {padding}")
    _check_vector("s_k", s_k, cout, x_q.device)
    if s_x.device != x_q.device or s_x.dtype != torch.float32 or s_x.numel() != 1:
        raise ValueError("int8conv: s_x must be one float32 on x_q's device")
    if bias is not None:
        _check_vector("bias", bias, cout, x_q.device)
    ho, wo = conv_out_size(h, kh, stride, ph), conv_out_size(w, kw, stride, pw)
    if ho < 1 or wo < 1:
        raise ValueError(f"int8conv: no output for {h}x{w} with a {kh}x{kw} kernel")
    plan = igemm_plan(tuple(x_q.shape), tuple(k_q.shape), stride, (ph, pw),
                      card_sms(x_q.device))
    y = torch.empty((n, cout, ho, wo), dtype=out_dtype, device=x_q.device,
                    memory_format=torch.channels_last)
    with torch.cuda.device(x_q.device):
        err = _lib().int8_conv_igemm(x_q.data_ptr(), k_q.data_ptr(), s_x.data_ptr(),
                                     s_k.data_ptr(), None if bias is None else bias.data_ptr(),
                                     y.data_ptr(), n, h, w, cp, cout, kh, kw, stride, ph, pw,
                                     ho, wo, plan.hbox, plan.wbox, plan.bk, plan.bn, plan.grid,
                                     _DTYPE_CODE[out_dtype], _stream(x_q))
    _check(err, "int8_conv_igemm")
    launches["igemm"] += 1
    return y


def divide_check(a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel (c)'s division by a per-channel constant on the card, for the
    card tests: elementwise over float32 a and b (b > 0), the reciprocal
    route's quotient, __fdiv_rn's, and whether (c) takes the reciprocal
    route there (bool)."""
    for name, t in (("a", a), ("b", b)):
        _check_cuda(name, t, (torch.float32,), 1)
    if b.shape != a.shape or not a.is_contiguous() or not b.is_contiguous():
        raise ValueError("int8conv: divide_check takes two contiguous float32 vectors "
                         "of one length")
    fast, ieee = torch.empty_like(a), torch.empty_like(a)
    used = torch.empty(a.shape, dtype=torch.uint8, device=a.device)
    with torch.cuda.device(a.device):
        err = _lib().int8_divide_check(a.data_ptr(), b.data_ptr(), a.numel(), fast.data_ptr(),
                                       ieee.data_ptr(), used.data_ptr(), _stream(a))
    _check(err, "divide_check")
    return fast, ieee, used.bool()


# -- the op --------------------------------------------------------------------

def int8_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
              stride: int = 1, padding: int = 1, smooth: bool = True) -> torch.Tensor:
    """The W8A8 conv of x (NCHW channels_last, bf16 or float32) with the OIHW
    float32 weight, + bias (float32, cast to x's type), in x's type,
    channels_last.  Calls the registered op `torch.ops.deepsee.int8_conv`."""
    return torch.ops.deepsee.int8_conv(x, weight, bias, stride, padding, smooth)


@torch.library.custom_op("deepsee::int8_conv", mutates_args=())
def _int8_conv_op(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  stride: int, padding: int, smooth: bool) -> torch.Tensor:
    """The op's implementation: the plain version on CPU tensors; on CUDA
    tensors kernels (a)-(d), or a raise."""
    if x.device.type == "cpu":
        plain_calls["int8_conv"] += 1
        return int8_conv_plain(x, weight, bias, stride, padding, smooth, x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8conv: unsupported device {x.device}")
    if weight.dim() != 4 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"int8conv: weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    mx_raw, mx = absmax_channels(x)
    s_c, s_k, s_x, k_q = quantize_weight(weight, mx_raw, mx, smooth)
    x_q = quantize_activation(x, s_c, s_x)
    return int8_conv_igemm(x_q, k_q, s_x, s_k, bias, stride, padding, x.dtype)


def int8_conv_sharded(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                      stride: int, padding: int, smooth: bool, shard: str,
                      all_reduce_max: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """`int8_conv` of one rank's block of a tensor-parallel conv: `shard`
    "column" (the weight's block of output channels, x whole) or "row" (its
    block of input channels and x's channel block, the caller summing the
    ranks' outputs and adding the bias after).  The maxima that decide the
    scales are the whole layer's, as one process takes them: (b) splits
    around `all_reduce_max` (the elementwise max over the model group, in
    place or not), so s_c, s_k, s_x and k_q are one process's bit for bit,
    and each rank dequantizes its partial product with them.  Kernels (a),
    the two launches of (b), (c), (d), which run their plain versions on
    CPU tensors."""
    if shard not in ("column", "row"):
        raise ValueError(f"int8conv: shard must be 'column' or 'row', got {shard!r}")
    if weight.dim() != 4 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"int8conv: weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if _plain_here(x, weight, bias):
        plain_calls["int8_conv"] += 1
    mx_raw, mx = absmax_channels(x)
    if shard == "column" and not smooth:  # nothing of the group is needed
        s_c, s_k, s_x, k_q = quantize_weight(weight, mx_raw, mx, False)
    elif shard == "column":
        mk = all_reduce_max(weight_column_maxima(weight))
        s_c, s_k, s_x, k_q = quantize_weight_columns(weight, mx_raw, mx, mk)
    else:
        s_c, maxima = weight_row_maxima(weight, mx_raw, mx, smooth)
        s_k, s_x, k_q = quantize_weight_rows(weight, s_c, all_reduce_max(maxima))
    x_q = quantize_activation(x, s_c, s_x)
    return int8_conv_igemm(x_q, k_q, s_x, s_k, bias, stride, padding, x.dtype)


def int8_conv_striped(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                      stride: int, padding: Padding, smooth: bool,
                      halo: Callable[[torch.Tensor], torch.Tensor],
                      all_reduce_max: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """`int8_conv` of one rank's horizontal stripe x of a map striped over
    the model group.  (a) takes the stripe's maxima and `all_reduce_max`
    (the elementwise max over the model group) makes them the whole map's,
    in one call on (mx_raw, mx): a max is exact in any order, so (b)'s
    s_c, s_k, s_x, k_q and (c)'s x_q are one process's bit for bit.  (c)
    quantizes the stripe; `halo(x_q)` is the int8 slab that this rank's
    output rows read (the neighbours' rows, the global edges' padding: the
    caller's window), and (d) convolves it at `padding` ((pad_h, pad_w):
    pad_h 0, the halo holding H's).  Kernels (a)-(d), which run their plain
    versions on CPU tensors."""
    if weight.dim() != 4 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"int8conv: weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if _plain_here(x, weight, bias):
        plain_calls["int8_conv"] += 1
    c = x.shape[1]
    mx_raw, mx = all_reduce_max(torch.cat(absmax_channels(x))).split(c)
    s_c, s_k, s_x, k_q = quantize_weight(weight, mx_raw, mx, smooth)
    x_q = quantize_activation(x, s_c, s_x)
    return int8_conv_igemm(halo(x_q), k_q, s_x, s_k, bias, stride, padding, x.dtype)


@_int8_conv_op.register_fake
def _int8_conv_fake(x, weight, bias, stride, padding, smooth):
    """Shape, type and layout of the output, for tracing (torch.export)."""
    n, _, h, w = x.shape
    cout, _, kh, kw = weight.shape
    return torch.empty((n, cout, conv_out_size(h, kh, stride, padding),
                        conv_out_size(w, kw, stride, padding)), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)
