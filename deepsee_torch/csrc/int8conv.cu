// W8A8 quantized convolution for Hopper (sm_90a): the port of the JAX package's
// `_int8_conv` (deepsee_tpu/models/layers.py:81-113; K4 in ROADMAP.md), which
// XLA ran as an s8 x s8 -> s32 convolution on the TPU's matrix unit.
//
// One quantized conv is four kernels, launched in this order by
// deepsee_torch/ops/int8conv.py on PyTorch's current stream:
//   (a) absmax_channels      per-channel max |x| of the NHWC activation, kept
//                            unclamped and clamped at 1e-8 (partials, merge)
//   (b) quantize_weight      SmoothQuant s_c = sqrt(mx) / sqrt(mk) (1 when
//                            not smoothing), the per-output-channel s_k, the
//                            per-tensor s_x and k_q as [Cout][kh][kw][Cp] int8
//   (c) quantize_activation  x_q = clip(rint((x / s_c) / s_x), +-127) as
//                            [N*H*W][Cp] int8
//   (d) int8_conv_igemm      the implicit-GEMM conv (M = N*Ho*Wo, N = Cout,
//                            K = kh*kw*Cp) on the tensor cores through
//                            wgmma.mma_async s32.s8.s8, then the JAX
//                            dequantization and the bias in the output type
// Cp is Cin rounded up to 16: the padding channels are zero in both x_q and
// k_q, and every row of x_q and k_q starts on 16 bytes, as TMA wants.
//
// The scales must equal the plain version's bit for bit (a scale one ulp off
// moves whole tensors by a level), so every float operation here is the
// JAX sequence's, with the IEEE intrinsics (__fdiv_rn, __fsqrt_rn,
// __fmul_rn, __fadd_rn, __fmaf_rn): no contraction into an FMA that the
// sequence does not have, and this file must never be built with
// --use_fast_math.  s_x comes from the per-channel maxima: division by a
// positive s_c is monotone under round-to-nearest, so
// max|x / s_c| = max_c(RN(max|x_c| / s_c)) exactly.
//
// Bounds on the H100 SXM, and what each design does about its own:
// (a), (b) and (c) are bound by bytes (the activation read twice, x_q
// written once, at 3.35 TB/s); (d) by its operations (2*M*N*K at the
// 1,979 TOP/s dense int8 peak) at every shape of the serving path.
// (c) was bound by instructions and latency, not bytes (44 % of its bound
// with a 64-bit division, 16 scalar s_c loads and 32 IEEE divisions per 16
// outputs, and one 32-byte read in flight per thread).  Now a block owns a
// channel range and a stretch of pixels: each thread loads its 16 channels'
// s_c and their reciprocals once, keeps four pixels' 16-byte loads in
// flight, indexes in 32 bits and divides by the per-channel constants
// through the correctly rounded reciprocal and two FMA corrections, exact
// as `div_rn_by` states (an IEEE division only for the values outside the
// range where that holds); it rounds by adding 1.5 * 2^23 rather than
// through rintf and a float-to-int conversion, which run at 1/8 of the FMA
// rate on this card.
// (d) was held by mma.sync (Hopper reaches its int8 rate only through
// wgmma), a two-stage cp.async ring with per-thread im2col addresses and
// two block barriers per k-tile.  Now: one persistent block per SM, three
// warpgroups.  A producer warp feeds a ring of shared-memory stages by TMA
// (cp.async.bulk.tensor) through full / empty mbarriers; two consumer
// warpgroups take 64 rows each of a 128 x BN tile (BN 256, or 128 for
// Cout <= 128) through wgmma from swizzled K-major shared memory, the s32
// sums in registers (setmaxnreg moves registers from the producer to
// them).  The implicit im2col is a tiled 4-D tensor map over x_q
// [N][H][W][Cp]: an M tile is an hbox x wbox rectangle of one image's
// output pixels (4 x 32 at 32^2, 2 x 64 at 64^2, 1 x 128 from 128^2 on;
// ragged at the image's edge), and tap (r, q) loads the box shifted by
// (r - pad, q - pad), strided by the map's elementStrides for stride 2.
// TMA's zero fill outside the tensor is the conv's padding, and it fills
// the channels of a BK-byte chunk past Cp (Cp 80 read as 128), so wgmma's
// 32-byte K step never straddles a tap.  k_q is a 3-D map [Cout][tap][Cp].
// Tiles are walked N fastest: the blocks in flight share A rectangles, and
// all of k_q (at most 4.7 MB here) stays in the L2; the producer runs ahead
// into the next tile while the consumers dequantize the last one
// (16-byte stores after a shuffle within each quad of lanes).  Pairs of
// blocks (a cluster of 2) sharing each k_q tile by TMA multicast, which
// takes a third of the L2 reads away, measured slower at every shape of
// the serving path on the H100: the pair's stages can only be refilled
// when both blocks have released them.  TMA's
// im2col mode would need a map per tap or per stride; the tiled map with
// shifted coordinates covers both with one map.  The maps are encoded on
// the host at every call (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so no link flag is added) and passed by value
// as __grid_constant__ parameters: a CUDA graph captures them with its
// static pointers.

#include <cuda.h>  // CUtensorMap and the driver's enums; the function comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFloor = 1e-8f;
constexpr float kLevels = 127.0f;
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = 0.0f;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) r = fmaxf(r, scratch[w]);
  return r;
}

__device__ __forceinline__ float quantize(float v, float scale) {
  const float q = rintf(__fdiv_rn(v, scale));  // round half to even, as jnp.round
  return fminf(fmaxf(q, -kLevels), kLevels);
}

// -- (a) per-channel max |x| ---------------------------------------------------
// x is P rows (pixels) of C channels.  Block (32, 8): threadIdx.x a group of
// VEC channels, threadIdx.y a row lane; each block strides over rows and
// writes its C-wide partial row; the merge takes the max over the partials.

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
absmax_partials_kernel(const T* __restrict__ x, float* __restrict__ part, int64_t P, int C) {
  __shared__ float sm[8][32 * 8];
  const int groups = C / VEC;
  const int g = blockIdx.y * 32 + threadIdx.x;
  float m[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) m[j] = 0.0f;
  if (g < groups) {
    for (int64_t p = (int64_t)blockIdx.x * 8 + threadIdx.y; p < P; p += (int64_t)gridDim.x * 8) {
      const T* src = x + p * C + (int64_t)g * VEC;
      if constexpr (VEC * sizeof(T) == 16) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
        const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < VEC; ++j) m[j] = fmaxf(m[j], fabsf(to_f32(v[j])));
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) m[j] = fmaxf(m[j], fabsf(to_f32(src[j])));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) sm[threadIdx.y][threadIdx.x * VEC + j] = m[j];
  __syncthreads();
  const int t = threadIdx.y * 32 + threadIdx.x;
  if (t < 32 * VEC) {
    float r = sm[0][t];
#pragma unroll
    for (int y = 1; y < 8; ++y) r = fmaxf(r, sm[y][t]);
    const int c = blockIdx.y * 32 * VEC + t;
    if (c < C) part[(int64_t)blockIdx.x * C + c] = r;
  }
}

__global__ void absmax_merge_kernel(const float* __restrict__ part, int rows, int C,
                                    float* __restrict__ mx_raw, float* __restrict__ mx) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float r = 0.0f;
  for (int i = 0; i < rows; ++i) r = fmaxf(r, part[(int64_t)i * C + c]);
  mx_raw[c] = r;
  mx[c] = fmaxf(r, kFloor);
}

// -- (b) the weight: s_c, s_k, s_x and k_q --------------------------------------
// w is OIHW float32.  First one block per input channel: mk = max over
// (o, kh, kw) of |w|, s_c = sqrt(mx) / sqrt(mk); then one block per output
// channel: k' = w * s_c, s_k = max(max|k'|, 1e-8) / 127, k_q in
// [Cout][kh][kw][Cp] with zero padding channels; block 0 also writes s_x.

__global__ void __launch_bounds__(kThreads)
smooth_scales_kernel(const float* __restrict__ w, const float* __restrict__ mx, int Cout,
                     int Cin, int taps, int smooth, float* __restrict__ s_c) {
  __shared__ float scratch[32];
  const int c = blockIdx.x;
  if (!smooth) {
    if (threadIdx.x == 0) s_c[c] = 1.0f;
    return;
  }
  float m = 0.0f;
  const int n = Cout * taps;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int o = j / taps, tap = j - o * taps;
    m = fmaxf(m, fabsf(w[((int64_t)o * Cin + c) * taps + tap]));
  }
  m = block_max(m, scratch);
  if (threadIdx.x == 0) {
    const float mk = fmaxf(m, kFloor);
    s_c[c] = __fdiv_rn(__fsqrt_rn(mx[c]), __fsqrt_rn(mk));
  }
}

__global__ void __launch_bounds__(kThreads)
quantize_weight_kernel(const float* __restrict__ w, const float* __restrict__ s_c,
                       const float* __restrict__ mx_raw, int Cin, int Cp, int taps,
                       float* __restrict__ s_k, int8_t* __restrict__ k_q,
                       float* __restrict__ s_x) {
  __shared__ float scratch[32];
  const int o = blockIdx.x;
  const int K = Cin * taps;
  const float* wo = w + (int64_t)o * K;
  float m = 0.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    m = fmaxf(m, fabsf(__fmul_rn(wo[k], s_c[k / taps])));
  m = block_max(m, scratch);
  const float sk = __fdiv_rn(fmaxf(m, kFloor), kLevels);
  if (threadIdx.x == 0) s_k[o] = sk;
  // k_q in [tap][Cp] order, written contiguously; the reads hit this row of
  // the weight, which the pass above brought into L1
  int8_t* out = k_q + (int64_t)o * taps * Cp;
  for (int k = threadIdx.x; k < taps * Cp; k += blockDim.x) {
    const int tap = k / Cp, c = k - tap * Cp;
    float q = 0.0f;
    if (c < Cin) q = quantize(__fmul_rn(wo[c * taps + tap], s_c[c]), sk);
    out[k] = (int8_t)(int)q;
  }
  if (o == 0) {
    float mm = 0.0f;
    for (int c = threadIdx.x; c < Cin; c += blockDim.x)
      mm = fmaxf(mm, __fdiv_rn(mx_raw[c], s_c[c]));
    mm = block_max(mm, scratch);
    if (threadIdx.x == 0) s_x[0] = __fdiv_rn(fmaxf(mm, kFloor), kLevels);
  }
}

// -- (c) the activation --------------------------------------------------------
// A block owns a range of `lanes` 16-channel groups and strides over the
// pixels, `rows` = 256 / lanes pixels a step, UNROLL steps at once.  VECTOR:
// C % 16 == 0, so the 16 inputs of a group are whole 16-byte loads.

// RN(a / b) for a divisor b > 0 that is fixed per channel, from r = RN(1/b)
// and two FMA corrections.  Exact where divisor_ok(b) and numerator_ok(a)
// hold: then a, b, r and the quotient (within 2^-124..2^124) are normal, and
// every nonzero remainder a - b*q is at least 2^-111.  q0 = RN(a*r) is
// within 1.5 ulp of a/b (r is within half an ulp of 1/b); q1 = RN(q0 + r*e0)
// is within one ulp (e0 carries at most one rounding); so e1 = a - b*q1 is
// exact (q1 is one of the two floats around a/b) and Markstein's theorem
// makes q2 = RN(q1 + r*e1) = RN(a/b).  A zero numerator keeps its sign.
// Elsewhere (0 < |a| < 2^-64, |a| > 2^64, inf, nan, subnormal a) the caller
// divides with __fdiv_rn.  tests/test_torch_kernels.py holds it against
// __fdiv_rn over 2^24 and more values (int8_divide_check below).
constexpr float kDivisorMin = 0x1p-60f, kDivisorMax = 0x1p60f;
constexpr float kNumeratorMin = 0x1p-64f, kNumeratorMax = 0x1p64f;

__device__ __forceinline__ bool divisor_ok(float b) {
  return b >= kDivisorMin && b <= kDivisorMax;
}

__device__ __forceinline__ bool numerator_ok(float a) {
  const float m = fabsf(a);
  return (m >= kNumeratorMin && m <= kNumeratorMax) || a == 0.0f;
}

// q2 above, for a nonzero a (a zero gives +0 there)
__device__ __forceinline__ float div_rn_nonzero(float a, float b, float r) {
  const float q0 = __fmul_rn(a, r);
  const float q1 = __fmaf_rn(r, __fmaf_rn(-b, q0, a), q0);
  return __fmaf_rn(r, __fmaf_rn(-b, q1, a), q1);
}

__device__ __forceinline__ float div_rn_by(float a, float b, float r) {
  return a == 0.0f ? a : div_rn_nonzero(a, b, r);
}

// (c) takes the reciprocal route for a group of 16 values when every s_c is
// within 2^-30..2^30, s_x within divisor_ok and every input 0 or within
// 2^-32..2^32 in magnitude: then x / s_c is 0 or within 2^-62..2^62, so both
// of its divisions stay in the range above.  (As bit patterns of |x|: a
// nonzero value at least 2^-32, none above 2^32, inf and nan included.)
constexpr float kScaleMin = 0x1p-30f, kScaleMax = 0x1p30f;
constexpr uint32_t kInputMinBits = 0x2f800000u, kInputMaxBits = 0x4f800000u;
// 1.5 * 2^23: x + this rounds x to an integer, half to even, for |x| < 2^22,
// and leaves it in the low bits of the sum's pattern (rintf without the
// conversion pipe)
constexpr float kRoundMagic = 12582912.0f;

// 16 values of T as 32-bit words in registers: float one a word, bf16 two
template <typename T>
struct Raw;

template <>
struct Raw<float> {
  static constexpr int kWords = 16;
  __device__ static float get(const uint32_t (&r)[kWords], int j) { return __uint_as_float(r[j]); }
  __device__ static void fill(const float* src, int valid, uint32_t (&r)[kWords]) {
#pragma unroll
    for (int j = 0; j < 16; ++j) r[j] = j < valid ? __float_as_uint(src[j]) : 0u;
  }
};

template <>
struct Raw<__nv_bfloat16> {
  static constexpr int kWords = 8;
  __device__ static float get(const uint32_t (&r)[kWords], int j) {
    return __uint_as_float(((r[j / 2] >> (16 * (j % 2))) & 0xffffu) << 16);
  }
  __device__ static void fill(const __nv_bfloat16* src, int valid, uint32_t (&r)[kWords]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t lo = 2 * k < valid ? __bfloat16_as_ushort(src[2 * k]) : 0u;
      const uint32_t hi = 2 * k + 1 < valid ? __bfloat16_as_ushort(src[2 * k + 1]) : 0u;
      r[k] = lo | (hi << 16);
    }
  }
};

template <typename T, bool VECTOR, int UNROLL>
__global__ void __launch_bounds__(kThreads, 2)
quantize_activation_kernel(const T* __restrict__ x, const float* __restrict__ s_c,
                           const float* __restrict__ s_x, int8_t* __restrict__ x_q, int P,
                           int C, int Cp, int lanes) {
  using W = Raw<T>;
  const int rows = kThreads / lanes;
  const int tp = threadIdx.x / lanes;
  const int c0 = (blockIdx.y * lanes + threadIdx.x % lanes) * 16;
  if (c0 >= Cp) return;  // a group past Cp (Cp / 16 is not a power of 2)
  const int valid = min(16, C - c0);  // channels of the group inside C (<= 0: padding)
  // the group's divisors, once: s_c (1 for the padding channels) and s_x
  const float sx = __ldg(s_x), rx = __frcp_rn(sx);
  float sc[16], rc[16];
  bool fast = divisor_ok(sx);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[j] = j < valid ? __ldg(s_c + c0 + j) : 1.0f;
    rc[j] = __frcp_rn(sc[j]);
    fast = fast && sc[j] >= kScaleMin && sc[j] <= kScaleMax;
  }
  const int step = gridDim.x * rows * UNROLL;
  for (int p0 = blockIdx.x * rows * UNROLL + tp; p0 < P; p0 += step) {
    uint32_t raw[UNROLL][W::kWords];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {  // every load of the step in flight at once
      const int p = p0 + u * rows;
      if (p >= P) continue;
      const T* src = x + (int64_t)p * C + c0;
      if constexpr (VECTOR) {
#pragma unroll
        for (int w = 0; w < W::kWords / 4; ++w) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + w);
          raw[u][4 * w] = v.x;
          raw[u][4 * w + 1] = v.y;
          raw[u][4 * w + 2] = v.z;
          raw[u][4 * w + 3] = v.w;
        }
      } else {
        W::fill(src, valid, raw[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u * rows;
      if (p >= P) break;
      float q[16];
      uint32_t top = 0u, bottom = 0xffffffffu;  // max |x| and min nonzero |x| - 1, as bits
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float v = W::get(raw[u], j);
        const uint32_t m = __float_as_uint(v) & 0x7fffffffu;
        top = max(top, m);
        bottom = min(bottom, m - 1u);  // a zero wraps round and drops out
        // (+-0 / s_c) / s_x is the zero itself
        q[j] = v == 0.0f ? v : div_rn_nonzero(div_rn_nonzero(v, sc[j], rc[j]), sx, rx);
      }
      if (!(fast && top <= kInputMaxBits && bottom >= kInputMinBits - 1u)) {
#pragma unroll
        for (int j = 0; j < 16; ++j) q[j] = __fdiv_rn(__fdiv_rn(W::get(raw[u], j), sc[j]), sx);
      }
      // clip to +-127 and round half to even (clipping first gives the same
      // level); the padding channels are 0 / 1
      uint32_t w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        w[j] = __float_as_uint(__fadd_rn(fminf(fmaxf(q[j], -kLevels), kLevels), kRoundMagic));
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = __byte_perm(__byte_perm(w[4 * k], w[4 * k + 1], 0x0040),
                           __byte_perm(w[4 * k + 2], w[4 * k + 3], 0x0040), 0x5410);
      *reinterpret_cast<uint4*>(x_q + (int64_t)p * Cp + c0) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

__global__ void divide_check_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                    int n, float* __restrict__ fast, float* __restrict__ ieee,
                                    uint8_t* __restrict__ used) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float av = a[i], bv = b[i];
    fast[i] = div_rn_by(av, bv, __frcp_rn(bv));
    ieee[i] = __fdiv_rn(av, bv);
    used[i] = divisor_ok(bv) && numerator_ok(av);
  }
}

// -- (d) the implicit-GEMM conv ------------------------------------------------

constexpr int kBM = 128;                          // two consumer warpgroups of 64 rows
constexpr int kConsumers = 2;
constexpr int kIgemmThreads = 128 * (1 + kConsumers);
constexpr int kRingBytes = 192 * 1024;            // the stages; 1 KB more for alignment
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int BN, int BK>
struct Ring {
  static constexpr int kA = kBM * BK;             // x_q rows (output pixels) x BK bytes
  static constexpr int kB = BN * BK;              // k_q rows (output channels) x BK bytes
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = kRingBytes / kStage < 8 ? kRingBytes / kStage : 8;
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
};

struct IgemmArgs {
  const float* s_x;
  const float* s_k;
  const float* bias;
  void* y;
  int Ho, Wo, Cout, kw, stride, pad, chunks, iters;
  int hbox, wbox, tiles_h, tiles_w, tiles_n, tiles;
};

// tile t: output channels n0.. of the hbox x wbox rectangle at (ho0, wo0)
// of image img; N fastest, then the rectangles in raster order
struct Tile {
  int img, ho0, wo0, n0;
};

template <int BN>
__device__ __forceinline__ Tile tile_at(const IgemmArgs& a, int t) {
  const int mt = t / a.tiles_n;
  const int rest = mt / a.tiles_w;
  Tile r;
  r.n0 = (t - mt * a.tiles_n) * BN;
  r.wo0 = (mt - rest * a.tiles_w) * a.wbox;
  r.img = rest / a.tiles_h;
  r.ho0 = (rest - r.img * a.tiles_h) * a.hbox;
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's shared-memory operand: K-major rows of BK bytes under the BK-byte
// swizzle that TMA wrote (128B: layout 1, 64B: layout 2); the leading offset
// is unused there, the stride offset steps over 8 rows.  A K step of 32
// bytes inside the swizzle atom adds 32 to the start address.
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kLayout = BK == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * BK) >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving the accumulators across the asynchronous
// wgmma and its wait
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x N] += A[64 x 32] * B[N x 32]^T, s8 x s8 -> s32; thread t of the
// warpgroup holds rows 16*(t/32) + (t%32)/4 (+8) and columns 8j + 2(t%4) (+1)
// as d[4j + 2*half + e]
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 256) wgmma_s8_n256(d, a, b);
  else wgmma_s8_n128(d, a, b);
}

// the JAX epilogue of one output: float32(acc) * (s_x * s_k[o]), cast to the
// output type, + the bias cast to that type
__device__ __forceinline__ float finish_f32(int acc, float scale, bool has_bias, float bias) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

__device__ __forceinline__ __nv_bfloat16 finish_bf16(int acc, float scale, bool has_bias,
                                                     float bias) {
  // cast to bf16 first, then add the bf16 bias with one rounding, as the
  // JAX sequence `_int8_conv(...).astype(dtype) + bias.astype(dtype)`
  const __nv_bfloat16 h = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), scale));
  if (!has_bias) return h;
  const float b = __bfloat162float(__float2bfloat16_rn(bias));
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(h), b));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// The consumer's epilogue for its 64 rows of the tile.  Row validity: the
// rectangle's pixels outside the image are not written.  With 16-byte rows
// (Cout * sizeof(OutT) % 16 == 0) each lane writes 16 bytes: bf16, the quad
// of lanes of a row swaps its 4 x 4 words so that lane q holds the 8 columns
// of block 4jj + q; float32, the two lanes of a pair swap so that each holds
// 4 columns.  Otherwise one element a store.
template <int BN, typename OutT>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2], const IgemmArgs& a,
                                           const Tile& tl, int row0, float sx) {
  const int lane = threadIdx.x % 32, q4 = lane % 4;
  OutT* y = static_cast<OutT*>(a.y);
  const bool has_bias = a.bias != nullptr;
  int64_t off[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + lane / 4 + 8 * h;
    const int ho = tl.ho0 + row / a.wbox, wo = tl.wo0 + row % a.wbox;
    ok[h] = ho < a.Ho && wo < a.Wo;
    off[h] = ((int64_t)(tl.img * a.Ho + ho) * a.Wo + wo) * a.Cout;
  }
  auto scales = [&](int col, float (&sc)[2], float (&bb)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = col + e < a.Cout;
      sc[e] = in ? __fmul_rn(sx, __ldg(a.s_k + col + e)) : 0.0f;
      bb[e] = in && has_bias ? __ldg(a.bias + col + e) : 0.0f;
    }
  };
  if ((a.Cout * (int)sizeof(OutT)) % 16 != 0) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = tl.n0 + 8 * j + 2 * q4;
      float sc[2], bb[2];
      scales(col, sc, bb);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!ok[h] || col + e >= a.Cout) continue;
          if constexpr (sizeof(OutT) == 2)
            y[off[h] + col + e] = finish_bf16(acc[4 * j + 2 * h + e], sc[e], has_bias, bb[e]);
          else
            y[off[h] + col + e] = finish_f32(acc[4 * j + 2 * h + e], sc[e], has_bias, bb[e]);
        }
    }
    return;
  }
  if constexpr (sizeof(OutT) == 2) {
#pragma unroll
    for (int jj = 0; jj < BN / 32; ++jj) {
      uint32_t pk[2][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * jj + k;
        float sc[2], bb[2];
        scales(tl.n0 + 8 * j + 2 * q4, sc, bb);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          pk[h][k] = pack_bf16(finish_bf16(acc[4 * j + 2 * h], sc[0], has_bias, bb[0]),
                               finish_bf16(acc[4 * j + 2 * h + 1], sc[1], has_bias, bb[1]));
      }
      const int col = tl.n0 + 8 * (4 * jj + q4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // lane q4 gets word q4 of every lane of its quad: out[m] = pk_m[q4]
        uint32_t out[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(pk[h], q4 ^ s), s);
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (m == (q4 ^ s)) out[m] = got;
        }
        if (ok[h] && col < a.Cout)
          *reinterpret_cast<uint4*>(y + off[h] + col) = make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
  } else {
    const bool odd = q4 & 1;
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj) {
      float v[2][2][2];  // [h][block 2jj + k][e]
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = 2 * jj + k;
        float sc[2], bb[2];
        scales(tl.n0 + 8 * j + 2 * q4, sc, bb);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[h][k][e] = finish_f32(acc[4 * j + 2 * h + e], sc[e], has_bias, bb[e]);
      }
      // the even lane of a pair keeps block 2jj, the odd one block 2jj + 1
      const int col = tl.n0 + 8 * (2 * jj + (odd ? 1 : 0)) + 4 * (q4 >> 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s0 = odd ? v[h][0][0] : v[h][1][0], s1 = odd ? v[h][0][1] : v[h][1][1];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const float4 o = odd ? make_float4(r0, r1, v[h][1][0], v[h][1][1])
                             : make_float4(v[h][0][0], v[h][0][1], r0, r1);
        if (ok[h] && col < a.Cout) *reinterpret_cast<float4*>(y + off[h] + col) = o;
      }
    }
  }
}

template <int BN, int BK, typename OutT>
__global__ void __launch_bounds__(kIgemmThreads, 1)
igemm_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap k_map,
             const IgemmArgs a) {
  using R = Ring<BN, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t bars = ring + R::kStages * R::kStage;
  // full[s] at bars + 8s (the producer's expect_tx and TMA's bytes), empty[s]
  // at bars + 8 (kStages + s) (one arrival per consumer warp)
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (R::kStages + s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer: one thread issues every load; the warpgroup's registers go
    // to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&x_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&k_map))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const Tile tl = tile_at<BN>(a, t);
        const int h0 = tl.ho0 * a.stride - a.pad, w0 = tl.wo0 * a.stride - a.pad;
        int r = 0, q = 0, c = 0;
        for (int i = 0; i < a.iters; ++i) {
          const uint32_t full = bars + 8 * stage, dst = ring + stage * R::kStage;
          mbar_wait(bars + 8 * (R::kStages + stage), phase ^ 1);
          mbar_expect_tx(full, R::kStage);
          tma_load_4d(dst, &x_map, full, c * BK, w0 + q, h0 + r, tl.img);
          tma_load_3d(dst + R::kA, &k_map, full, c * BK, r * a.kw + q, tl.n0);
          if (++c == a.chunks) {
            c = 0;
            if (++q == a.kw) { q = 0; ++r; }
          }
          if (++stage == R::kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cg = wg - 1, lane = threadIdx.x % 32;
    const int row0 = cg * 64 + 16 * ((threadIdx.x / 32) % 4);
    const float sx = __ldg(a.s_x);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = 0;
      for (int i = 0; i < a.iters; ++i) {
        mbar_wait(bars + 8 * stage, phase);
        __syncwarp();  // wgmma is .aligned: the warp converged after its spin
        const uint32_t sa = ring + stage * R::kStage + cg * 64 * BK;
        const uint32_t sb = ring + stage * R::kStage + R::kA;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8<BN>(acc, smem_desc<BK>(sa + 32 * kk), smem_desc<BK>(sb + 32 * kk));
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (i > 0 && lane == 0) mbar_arrive(bars + 8 * (R::kStages + prev));
        prev = stage;
        if (++stage == R::kStages) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(bars + 8 * (R::kStages + prev));
      store_tile<BN, OutT>(acc, a, tile_at<BN>(a, t), row0, sx);
    }
  }
}

int status() { return static_cast<int>(cudaGetLastError()); }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// error codes of int8_conv_igemm beside CUDA's: a plan the kernel does not
// take, no cuTensorMapEncodeTiled, or the driver's refusal of a map (+ its
// CUresult)
constexpr int kBadPlan = 9001, kNoEncoder = 9002, kMapRefused = 9100;

template <int BN, int BK, typename OutT>
int launch_igemm(const CUtensorMap& x_map, const CUtensorMap& k_map, const IgemmArgs& a,
                 int grid, cudaStream_t st) {
  const auto kernel = igemm_kernel<BN, BK, OutT>;
  const int smem = Ring<BN, BK>::kSmem;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kIgemmThreads, smem, st>>>(x_map, k_map, a);
  return status();
}

template <typename OutT>
int launch_igemm_tile(int bn, int bk, const CUtensorMap& x_map, const CUtensorMap& k_map,
                      const IgemmArgs& a, int grid, cudaStream_t st) {
  if (bn == 256)
    return bk == 128 ? launch_igemm<256, 128, OutT>(x_map, k_map, a, grid, st)
                     : launch_igemm<256, 64, OutT>(x_map, k_map, a, grid, st);
  return bk == 128 ? launch_igemm<128, 128, OutT>(x_map, k_map, a, grid, st)
                   : launch_igemm<128, 64, OutT>(x_map, k_map, a, grid, st);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (deepsee_torch/ops/int8conv.py)

extern "C" int int8_absmax_channels(const void* x, void* part, void* mx_raw, void* mx,
                                    int64_t P, int C, int rows, int vector, int dtype,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = vector ? (dtype == 1 ? 8 : 4) : 1;
  const dim3 grid(rows, (C / vec + 31) / 32), block(32, 8);
  float* p = static_cast<float*>(part);
  if (dtype == 1) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    if (vector) absmax_partials_kernel<__nv_bfloat16, 8><<<grid, block, 0, st>>>(xb, p, P, C);
    else absmax_partials_kernel<__nv_bfloat16, 1><<<grid, block, 0, st>>>(xb, p, P, C);
  } else {
    const auto* xf = static_cast<const float*>(x);
    if (vector) absmax_partials_kernel<float, 4><<<grid, block, 0, st>>>(xf, p, P, C);
    else absmax_partials_kernel<float, 1><<<grid, block, 0, st>>>(xf, p, P, C);
  }
  absmax_merge_kernel<<<(C + 255) / 256, 256, 0, st>>>(
      p, rows, C, static_cast<float*>(mx_raw), static_cast<float*>(mx));
  return status();
}

extern "C" int int8_quantize_weight(const void* w, const void* mx, const void* mx_raw,
                                    void* s_c, void* s_k, void* s_x, void* k_q, int Cout,
                                    int Cin, int Cp, int taps, int smooth, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  smooth_scales_kernel<<<Cin, kThreads, 0, st>>>(wf, static_cast<const float*>(mx), Cout, Cin,
                                                 taps, smooth, static_cast<float*>(s_c));
  quantize_weight_kernel<<<Cout, kThreads, 0, st>>>(
      wf, static_cast<const float*>(s_c), static_cast<const float*>(mx_raw), Cin, Cp, taps,
      static_cast<float*>(s_k), static_cast<int8_t*>(k_q), static_cast<float*>(s_x));
  return status();
}

extern "C" int int8_quantize_activation(const void* x, const void* s_c, const void* s_x,
                                        void* x_q, int P, int C, int Cp, int lanes,
                                        int blocks, int dtype, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || P < 1 || Cp % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, (Cp / 16 + lanes - 1) / lanes);
  const auto* sc = static_cast<const float*>(s_c);
  const auto* sx = static_cast<const float*>(s_x);
  auto* q = static_cast<int8_t*>(x_q);
  const bool vector = C % 16 == 0;
  if (dtype == 1) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    if (vector)
      quantize_activation_kernel<__nv_bfloat16, true, 4><<<grid, kThreads, 0, st>>>(
          xb, sc, sx, q, P, C, Cp, lanes);
    else
      quantize_activation_kernel<__nv_bfloat16, false, 4><<<grid, kThreads, 0, st>>>(
          xb, sc, sx, q, P, C, Cp, lanes);
  } else {
    const auto* xf = static_cast<const float*>(x);
    if (vector)
      quantize_activation_kernel<float, true, 2><<<grid, kThreads, 0, st>>>(xf, sc, sx, q, P, C,
                                                                            Cp, lanes);
    else
      quantize_activation_kernel<float, false, 2><<<grid, kThreads, 0, st>>>(xf, sc, sx, q, P,
                                                                             C, Cp, lanes);
  }
  return status();
}

// (c)'s division by a per-channel constant against __fdiv_rn, elementwise
// over a and b (float32, n each): fast (the reciprocal route alone), ieee,
// and used = 1 where (c) takes the fast route
extern "C" int int8_divide_check(const void* a, const void* b, int n, void* fast, void* ieee,
                                 void* used, void* stream) {
  divide_check_kernel<<<1024, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), n, static_cast<float*>(fast),
      static_cast<float*>(ieee), static_cast<uint8_t*>(used));
  return status();
}

// The plan (ops/int8conv.py::igemm_plan) chooses the tile: the hbox x wbox
// rectangle (hbox * wbox = 128), bk (64 or 128 bytes of channels a stage),
// bn (128 or 256 output channels) and the persistent grid; this encodes the
// two tensor maps from it and launches.
extern "C" int int8_conv_igemm(const void* x_q, const void* k_q, const void* s_x,
                               const void* s_k, const void* bias, void* y, int N, int H, int W,
                               int Cp, int Cout, int kh, int kw, int stride, int pad, int Ho,
                               int Wo, int hbox, int wbox, int bk, int bn, int grid,
                               int out_dtype, void* stream) {
  if (hbox * wbox != kBM || (bk != 64 && bk != 128) || (bn != 128 && bn != 256) ||
      stride < 1 || stride > 8 || wbox * stride > 256 || hbox * stride > 256 || Cp % 16 ||
      grid < 1)
    return kBadPlan;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return kNoEncoder;
  const CUtensorMapSwizzle swizzle =
      bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // x_q [N][H][W][Cp]: a box of bk channels x the rectangle's input pixels of
  // one tap, every stride-th along W and H
  CUtensorMap x_map, k_map;
  const cuuint64_t x_dims[4] = {(cuuint64_t)Cp, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t x_strides[3] = {(cuuint64_t)Cp, (cuuint64_t)W * Cp, (cuuint64_t)H * W * Cp};
  const cuuint32_t x_box[4] = {(cuuint32_t)bk, (cuuint32_t)(wbox * stride),
                               (cuuint32_t)(hbox * stride), 1};
  const cuuint32_t x_elem[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  CUresult r = encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x_q), x_dims,
                      x_strides, x_box, x_elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kMapRefused + static_cast<int>(r);
  // k_q [Cout][tap][Cp]: bk channels of one tap for bn output channels
  const int taps = kh * kw;
  const cuuint64_t k_dims[3] = {(cuuint64_t)Cp, (cuuint64_t)taps, (cuuint64_t)Cout};
  const cuuint64_t k_strides[2] = {(cuuint64_t)Cp, (cuuint64_t)taps * Cp};
  const cuuint32_t k_box[3] = {(cuuint32_t)bk, 1, (cuuint32_t)bn};
  const cuuint32_t k_elem[3] = {1, 1, 1};
  r = encode(&k_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(k_q), k_dims, k_strides,
             k_box, k_elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kMapRefused + static_cast<int>(r);

  IgemmArgs a;
  a.s_x = static_cast<const float*>(s_x);
  a.s_k = static_cast<const float*>(s_k);
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.Ho = Ho; a.Wo = Wo; a.Cout = Cout; a.kw = kw; a.stride = stride; a.pad = pad;
  a.chunks = (Cp + bk - 1) / bk;
  a.iters = taps * a.chunks;
  a.hbox = hbox; a.wbox = wbox;
  a.tiles_h = (Ho + hbox - 1) / hbox;
  a.tiles_w = (Wo + wbox - 1) / wbox;
  a.tiles_n = (Cout + bn - 1) / bn;
  const int64_t tiles = (int64_t)N * a.tiles_h * a.tiles_w * a.tiles_n;
  if (tiles > 0x7fffffff) return kBadPlan;
  a.tiles = (int)tiles;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return launch_igemm_tile<__nv_bfloat16>(bn, bk, x_map, k_map, a, grid, st);
  return launch_igemm_tile<float>(bn, bk, x_map, k_map, a, grid, st);
}
