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
//                            per-tensor s_x and k_q as [Cout][kh][kw][Cp] int8,
//                            in one launch that reads the weight once
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
// (b) was two dependent launches, one block per input channel for s_c
// (36-byte runs of the weight at a stride of Cin * 36 bytes) and one per
// output channel for s_k and k_q (the weight read again, one byte stored
// per thread after an IEEE division), at 15-16 % of its bound on the H100.
// Now one launch, at most one block per SM, each thread holding one unit of
// its block's output channels (two input channels over the taps) in
// registers from its loads to its k_q store; the column maxima merge
// across blocks by atomicMax on their bit patterns around a grid barrier
// (see "(b)" below).
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
// (r - pad_h, q - pad_w), strided by the map's elementStrides for stride 2.
// TMA's zero fill outside the tensor is the conv's padding, per axis (a
// stripe's slab, whose halo rows hold H's padding, comes at pad_h 0), and
// it fills the channels of a BK-byte chunk past Cp (Cp 80 read as 128), so
// wgmma's 32-byte K step never straddles a tap.  k_q is a 3-D map [Cout][tap][Cp].
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

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and the driver's enums; the function comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_marks.cuh"

namespace cg = cooperative_groups;

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
  int Ho, Wo, Cout, kw, stride, pad_h, pad_w, chunks, iters;
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
        const int h0 = tl.ho0 * a.stride - a.pad_h, w0 = tl.wo0 * a.stride - a.pad_w;
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

// -- (b) the weight: s_c, s_k, s_x and k_q in one launch -----------------------
// Grid: at most one block per SM (G blocks), block b owning the output
// channels [b*Cout/G, (b+1)*Cout/G).  A unit is one output channel's two
// input channels 2q, 2q+1 over every tap: 2 * taps floats, contiguous in
// OIHW, and the two k_q bytes of each tap, one 16-bit word of a [tap][Cp]
// row.  A block's units are its rows times Cp/2 pairs (the padding pairs
// only write zeros); thread t takes units t, t + 1024, ...  With taps 1 or 9
// a thread's first unit stays in its registers from the one load to the
// store, so where a block has at most 1024 units (every main-path weight)
// the weight is read once, by 8-byte loads that a warp makes contiguous; any
// other unit is read again from L2 in each pass.
// SMOOTH is one cooperative launch with one grid barrier:
//   1. each unit's four column maxima of |w|, merged in shared memory and
//      then across blocks into the launch's own (Cin,) buffer `mk`, zeroed
//      on its stream just before the launch, by atomicMax on their bit
//      patterns (non-negative floats order as unsigned integers, so the
//      merge is exact in any order); grid barrier;
//   2. every block forms s_c for all Cin from the merged maxima (IEEE
//      intrinsics) in shared memory and writes its own columns of s_c;
//      block 0 also takes s_x = max(max_c RN(mx_raw / s_c), 1e-8) / 127;
//   3. v = RN(w * s_c) in place, each row's max |v| merged in shared memory,
//      s_k = max(that, 1e-8) / 127, then k_q: clip(rint(RN(v / s_k))) from
//      q0 = RN(v * RN(1 / s_k)), which lies within 2^-16 of RN(v / s_k) below
//      the clip (s_k >= 1e-8 / 127, |v| <= 127 s_k), rounded by adding
//      1.5 * 2^23; a q0 within 2^-14 of a half (about one value in 8,000)
//      takes the exact division instead (`div_rn_by`, __fdiv_rn outside its
//      range); two bytes packed into one word per tap and stored (a warp
//      writes 64 contiguous bytes).
// Without smoothing s_c is 1: no column pass, no grid barrier, a plain
// launch.  fmaxf drops NaN as the earlier design did (a NaN weight's level
// is -127 either way); an all-zero column keeps mk at 1e-8.
//
// Under tensor parallelism a rank holds a block of the weight, and the JAX
// package's maxima are the whole layer's: a kernel cannot wait for another
// process, so (b) splits around the model group's MAX all-reduce
// (deepsee_torch/ops/int8conv.py::int8_conv_sharded) into two launches,
// each bit for bit the one-process sequence on the reduced maxima:
//   * a column block (its output channels; x whole): `column_maxima_kernel`
//     (this rank's column maxima into mk); the all-reduce of mk;
//     `weight_scales_kernel<..., COLUMNS>` (s_c, s_x, s_k and k_q from the
//     group's mk), both below;
//   * a row block (its input channels; x its channel block):
//     `row_maxima_kernel` (s_c is the rank's own: every output channel of
//     its columns is here; each row's max |v| and max RN(mx_raw / s_c)
//     into `maxima` [Cout + 1]); the all-reduce of maxima;
//     `weight_scales_kernel` (s_k, s_x and k_q from s_c and the group's
//     maxima), both below.  Without smoothing a column block needs nothing
//     of the group (the one-process launch), a row block the two maxima.
constexpr int kWeightThreads = 1024;
constexpr int kUnitCols = 2;         // input channels of a unit
constexpr int kWeightMaxRows = 32;   // output channels per block, at most
constexpr int kWeightMaxCin = 8192;  // input channels (two words each of shared memory), at most
constexpr float kNearHalf = 0.5f - 0x1p-14f;

struct WeightArgs {
  const float* w;
  const float* mx;
  const float* mx_raw;
  float* s_c;
  float* s_k;
  float* s_x;
  int8_t* k_q;
  unsigned* mk;  // SMOOTH: the column maxima across blocks (bit patterns), zero at launch
  int Cout, Cin, Cp, taps;
};

// k_q's level of v: clip(rint(RN(v / sk)), +-127) as the low byte
__device__ __forceinline__ uint32_t weight_level(float v, float sk, float rk, bool fast) {
  const float q = fast && numerator_ok(v) ? div_rn_by(v, sk, rk) : __fdiv_rn(v, sk);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(q, -kLevels), kLevels), kRoundMagic)) & 0xffu;
}

// weight_level out of line: the rare values near a half take it, and one
// copy of its code serves them all
__device__ __noinline__ uint32_t weight_level_exact(float v, float sk, float rk, bool fast) {
  return weight_level(v, sk, rk, fast);
}

// The same level from q0 = RN(v * rk), or, where q0, clipped, lies within
// 2^-14 of a half (RN(v / sk) may round to the other integer there), from
// the exact division.  A NaN v gives -127 either way.
__device__ __forceinline__ uint32_t weight_level_by_product(float v, float sk, float rk,
                                                            bool fast) {
  const float c = fminf(fmaxf(__fmul_rn(v, rk), -kLevels), kLevels);
  const float r = __fadd_rn(c, kRoundMagic);
  if (fabsf(__fsub_rn(c, __fsub_rn(r, kRoundMagic))) > kNearHalf)
    return weight_level_exact(v, sk, rk, fast);
  return __float_as_uint(r) & 0xffu;
}

// The 2 * TAPS floats of unit (row o, pair q): 8-byte loads where Cin is
// even (the unit then lies on 8 bytes), else one float at a time, zero past
// Cin.
template <int TAPS>
__device__ __forceinline__ void load_unit(const WeightArgs& a, int o, int q, float* v) {
  const float* src = a.w + (static_cast<int64_t>(o) * a.Cin + kUnitCols * q) * TAPS;
  if (a.Cin % kUnitCols == 0) {
#pragma unroll
    for (int i = 0; i < TAPS; ++i) {
      const float2 f = __ldg(reinterpret_cast<const float2*>(src) + i);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kUnitCols * TAPS; ++i)
      v[i] = kUnitCols * q + i / TAPS < a.Cin ? __ldg(src + i) : 0.0f;
  }
}

// value k (column 2q + k / taps, tap k % taps) of unit (o, q) from L2
__device__ __forceinline__ float unit_value(const WeightArgs& a, int o, int q, int k) {
  const int c = kUnitCols * q + k / a.taps;
  return c < a.Cin
             ? __ldg(a.w + (static_cast<int64_t>(o) * a.Cin + kUnitCols * q) * a.taps + k)
             : 0.0f;
}

// row_max[r] = max(row_max[r], m) by its bit pattern (m >= 0): one shared
// atomic per warp where the warp's 32 lanes share their row (Cp >= 64),
// else one per lane.  Every lane of the warp calls it.
__device__ __forceinline__ void row_merge(unsigned* row_max, int r, float m) {
  const unsigned bits = __float_as_uint(m);
  const int r0 = __shfl_sync(0xffffffffu, r, 0);
  if (__all_sync(0xffffffffu, r == r0)) {
    const unsigned top = __reduce_max_sync(0xffffffffu, bits);
    if ((threadIdx.x & 31) == 0 && top != 0u) atomicMax(row_max + r0, top);
  } else if (bits != 0u) {
    atomicMax(row_max + r, bits);
  }
}

template <int TAPS, bool SMOOTH>
__global__ void __launch_bounds__(kWeightThreads, 1)
quantize_weight_kernel(const WeightArgs a) {
  PHASE_MARK(0);
  constexpr int NV = TAPS > 0 ? kUnitCols * TAPS : 1;  // a cached unit's values
  extern __shared__ float wsm[];                  // s_c [Cin], then (SMOOTH) mk bits [Cin]
  __shared__ unsigned row_max[kWeightMaxRows];
  __shared__ float row_sk[kWeightMaxRows], row_rk[kWeightMaxRows];
  __shared__ float red[kWeightThreads / 32];
  float* sc_s = wsm;
  unsigned* mk_s = reinterpret_cast<unsigned*>(wsm + a.Cin);
  const int tid = threadIdx.x, G = gridDim.x, b = blockIdx.x;
  const int o_begin = static_cast<int>(static_cast<int64_t>(b) * a.Cout / G);
  const int o_end = static_cast<int>(static_cast<int64_t>(b + 1) * a.Cout / G);
  const int c_begin = static_cast<int>(static_cast<int64_t>(b) * a.Cin / G);
  const int c_end = static_cast<int>(static_cast<int64_t>(b + 1) * a.Cin / G);
  const int taps = TAPS > 0 ? TAPS : a.taps, nv = kUnitCols * taps;
  // pairs per row; those holding weights
  const int Q = a.Cp / kUnitCols, pairs = (a.Cin + kUnitCols - 1) / kUnitCols;
  const int units = (o_end - o_begin) * Q;
  const bool cached = TAPS > 0 && tid < units;    // unit tid in registers
  const int my_q = tid % Q;
  float v[NV];
  if (cached && my_q < pairs) load_unit<(TAPS > 0 ? TAPS : 1)>(a, o_begin + tid / Q, my_q, v);
  // this thread's first column's mx and mx_raw, loaded while the weight loads
  const float mx0 = tid < a.Cin ? __ldg(a.mx + tid) : 0.0f;
  const float raw0 = b == 0 && tid < a.Cin ? __ldg(a.mx_raw + tid) : 0.0f;
  if (tid < kWeightMaxRows) row_max[tid] = 0u;
  // value k of a unit u that is not in registers, from L2
  auto value = [&](int u, int k) { return unit_value(a, o_begin + u / Q, u % Q, k); };

  if constexpr (SMOOTH) {
    // phase 1 (the column maxima)
    for (int c = tid; c < a.Cin; c += kWeightThreads) mk_s[c] = 0u;
    __syncthreads();
    for (int u = tid; u < units; u += kWeightThreads) {
      const int q = u % Q;
      if (q >= pairs) continue;
#pragma unroll
      for (int j = 0; j < kUnitCols; ++j) {
        if (kUnitCols * q + j >= a.Cin) break;
        float m = 0.0f;
        if (cached && u == tid) {
#pragma unroll
          for (int t = 0; t < (TAPS > 0 ? TAPS : 1); ++t) m = fmaxf(m, fabsf(v[j * taps + t]));
        } else {
          for (int t = 0; t < taps; ++t) m = fmaxf(m, fabsf(value(u, j * taps + t)));
        }
        if (m > 0.0f) atomicMax(mk_s + kUnitCols * q + j, __float_as_uint(m));
      }
    }
    __syncthreads();
    for (int c = tid; c < a.Cin; c += kWeightThreads)
      if (mk_s[c] != 0u) atomicMax(a.mk + c, mk_s[c]);
    PHASE_MARK(1);
    cg::this_grid().sync();
    PHASE_MARK(2);
    for (int c = tid; c < a.Cin; c += kWeightThreads) {
      const float mk = fmaxf(__uint_as_float(__ldcg(a.mk + c)), kFloor);
      sc_s[c] = __fdiv_rn(__fsqrt_rn(c == tid ? mx0 : __ldg(a.mx + c)), __fsqrt_rn(mk));
    }
    __syncthreads();
  } else {
    for (int c = tid; c < a.Cin; c += kWeightThreads) sc_s[c] = 1.0f;
    __syncthreads();
  }
  for (int c = c_begin + tid; c < c_end; c += kWeightThreads) a.s_c[c] = sc_s[c];
  PHASE_MARK(3);
  if (b == 0) {  // s_x (without smoothing RN(mx_raw / 1) is mx_raw)
    float m = 0.0f;
    for (int c = tid; c < a.Cin; c += kWeightThreads) {
      const float raw = c == tid ? raw0 : __ldg(a.mx_raw + c);
      m = fmaxf(m, SMOOTH ? __fdiv_rn(raw, sc_s[c]) : raw);
    }
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (tid % 32 == 0) red[tid / 32] = m;
    __syncthreads();
    if (tid == 0) {
      float r = 0.0f;
      for (int w = 0; w < kWeightThreads / 32; ++w) r = fmaxf(r, red[w]);
      a.s_x[0] = __fdiv_rn(fmaxf(r, kFloor), kLevels);
    }
    PHASE_MARK(4);
  }

  // v = RN(w * s_c) (in place for the cached unit), each row's max |v|
  if (TAPS > 0) {  // every thread of the block: row_merge is warp-wide
    float m = 0.0f;
    if (cached && my_q < pairs) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = kUnitCols * my_q + k / taps;
        v[k] = __fmul_rn(v[k], sc_s[c < a.Cin ? c : 0]);
        m = fmaxf(m, fabsf(v[k]));
      }
    }
    row_merge(row_max, tid / Q, m);
  }
  PHASE_MARK(5);
  for (int u = tid + (TAPS > 0 ? kWeightThreads : 0); u < units; u += kWeightThreads) {
    const int q = u % Q;
    if (q >= pairs) continue;
    float m = 0.0f;
    for (int k = 0; k < nv; ++k) {
      const int c = kUnitCols * q + k / taps;
      if (c < a.Cin) m = fmaxf(m, fabsf(__fmul_rn(value(u, k), sc_s[c])));
    }
    if (m > 0.0f) atomicMax(row_max + u / Q, __float_as_uint(m));
  }
  __syncthreads();
  if (tid < o_end - o_begin) {
    const float top = __uint_as_float(row_max[tid]);
    const float sk = __fdiv_rn(fmaxf(top, kFloor), kLevels);
    row_sk[tid] = sk;
    row_rk[tid] = __frcp_rn(sk);
    a.s_k[o_begin + tid] = sk;
  }
  __syncthreads();

  // k_q: two levels a word, one word per tap
  for (int u = tid; u < units; u += kWeightThreads) {
    const int r = u / Q, q = u % Q, o = o_begin + r;
    const float sk = row_sk[r], rk = row_rk[r];
    const bool fast = divisor_ok(sk);
    uint16_t* dst =
        reinterpret_cast<uint16_t*>(a.k_q + static_cast<int64_t>(o) * taps * a.Cp) + q;
    if (q >= pairs) {
      for (int t = 0; t < taps; ++t) dst[t * Q] = 0u;
    } else if (cached && u == tid) {
      constexpr int T = TAPS > 0 ? TAPS : 1;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        uint32_t word = 0u;
#pragma unroll
        for (int j = 0; j < kUnitCols; ++j)
          if (kUnitCols * q + j < a.Cin)
            word |= weight_level_by_product(v[j * T + t], sk, rk, fast) << (8 * j);
        dst[t * Q] = static_cast<uint16_t>(word);
      }
    } else {
      for (int t = 0; t < taps; ++t) {
        uint32_t word = 0u;
        for (int j = 0; j < kUnitCols; ++j) {
          const int c = kUnitCols * q + j;
          if (c < a.Cin)
            word |= weight_level(__fmul_rn(value(u, j * taps + t), sc_s[c]), sk, rk, fast)
                    << (8 * j);
        }
        dst[t * Q] = static_cast<uint16_t>(word);
      }
    }
  }
  PHASE_MARK(6);
}

// -- (b) under a shard, redesigned: the column maxima and the scales ---------
// Both launches are latency-bound at the blocks of the serving path (a
// 512 x 256 3x3 block is 4.7 MB, 1.4 us at the HBM rate; the launch alone
// costs ~1 us in a CUDA graph): they were modes of the one-process kernel
// above, whose units make every warp load 32 runs of 72 bytes 72 bytes
// apart (18 cache lines a load, the L1's wavefronts queueing the loads
// behind them), whose column maxima needed a memset and global atomics, and
// whose block 0 formed s_x alone between two barriers.
//
// `column_maxima_kernel`: block b owns the input channels [b * cols, (b +
// 1) * cols): in OIHW they are one run of L = cols * taps floats in every
// row, so R = threads / L rows are read at once, lane after lane along the
// runs (a warp load touches 2-4 lines), each thread on one fixed value of
// the run, up to kColumnLoads rows in flight, its max |w| kept in a
// register.  The lanes of a warp that hold one column (__match_any_sync)
// reduce their maxima, their leader merges the result into the column's
// shared slot, and after one barrier each column's max is written once: no
// memset, no global atomics, no scratch.  The plan
// (ops/int8conv.py::column_maxima_plan) takes at most two blocks per SM
// (one of 1024 threads per SM, with wider runs, measured slower) and L <=
// threads.
//
// `weight_scales_kernel`: block b owns the output channels [b * Cout / G,
// (b + 1) * Cout / G), a contiguous run of the weight, which it copies into
// shared memory by 16-byte cp.async (the loads coalesced, all in flight at
// once) while it forms s_c for every input channel (COLUMNS: from the
// group's mk and mx, writing its share of s_c; else loaded; a thread's
// columns' loads issued together), block 0
// folding max RN(mx_raw / s_c) into the same loop so that s_x waits on no
// serial pass.  Then, as the one-process kernel, each thread takes units (an
// output channel's two input channels over the taps), its first one held in
// registers from shared memory (8-byte reads: a half-warp's fall on
// distinct banks) to its k_q stores; COLUMNS merges each row's max |v|
// (warp-reduced where a warp shares its row), s_k, and the levels go out
// two a 16-bit word per tap (a warp writes 64 contiguous bytes).  The plan (ops/int8conv.py::scales_plan) gives a block about one
// unit a thread and rows that fit its shared memory.
//
// `row_maxima_kernel` (formerly the mode kRowMaxima of the one-process
// kernel: a memset of a (Cin,) scratch, a cooperative launch, 132 blocks'
// global atomicMax onto the same Cin words, a grid barrier, every block then
// forming all Cin of s_c, block 0 alone max |x'|): block b owns the input
// channels [b * cols, (b + 1) * cols) (cols a power of two) and every
// output channel, so its columns' maxima and s_c need nothing of another
// block.  It copies its run of cols * taps floats of every row into shared
// memory by 4-byte cp.async (coalesced along the runs, every load in flight
// at once); then thread t takes column t % cols of every (kRowThreads /
// cols)-th row: max_t |w| over the taps into a [Cout][cols + 1] table and
// the column's max |w| in a register, merged over the warp's lanes of that
// column by shuffles and over the warps by shared atomics (RN(. * s_c) is
// monotone, so a row's max |RN(w * s_c)| over the block's columns is
// max_c RN(max_t |w| * s_c)); after one barrier the block's threads form s_c
// and max RN(mx_raw / s_c) of its columns, after another each thread takes
// whole rows of the table.  (A first design reduced the taps as the loads
// returned, a warp-wide reduction per load: several times slower on the
// H100.)  The blocks of a
// thread-block cluster merge their Cout + 1 maxima by atomicMax on bit
// patterns into rank 0's shared memory (distributed shared memory; rank 0
// zeroes it first, behind a split cluster barrier that the loads overlap;
// the copies are `vec` floats wide where the runs allow),
// and after one more cluster barrier rank 0 writes them once: maxima
// [parts][Cout + 1], one row per cluster (ops/int8conv.py::row_maxima_plan).
// No memset, no global atomics, no scratch, no grid barrier.
constexpr int kColumnThreads = 512;
constexpr int kColumnLoads = 16;    // rows of a thread's run value in flight
constexpr int kRowThreads = 512;
constexpr int kRowMaxCols = 32;     // a row-maxima block's columns: a power of two up to a warp
constexpr int kRowMaxCluster = 16;  // blocks of a row-maxima cluster, at most
constexpr int kScalesThreads = 256;
constexpr int kScalesAhead = 4;     // input channels a thread loads at once in the prologue

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int TAPS>
__global__ void __launch_bounds__(kColumnThreads)
column_maxima_kernel(const float* __restrict__ w, float* __restrict__ mk, int Cout, int Cin,
                     int taps_rt, int cols) {
  PHASE_MARK(0);
  __shared__ unsigned colmax[kColumnThreads];
  const int taps = TAPS > 0 ? TAPS : taps_rt;
  const int tid = threadIdx.x, lane = tid % 32;
  const int c0 = blockIdx.x * cols;
  const int n = min(cols, Cin - c0);  // this block's columns
  const int L = n * taps, R = kColumnThreads / L;
  const int e = tid % L, r0 = tid / L;
  if (tid < n) colmax[tid] = 0u;
  __syncthreads();
  float m = 0.0f;
  if (r0 < R) {
    const float* src = w + static_cast<int64_t>(c0) * taps + e;
    const int64_t row = static_cast<int64_t>(Cin) * taps;
    for (int o = r0; o < Cout; o += kColumnLoads * R) {
      float f[kColumnLoads];
#pragma unroll
      for (int u = 0; u < kColumnLoads; ++u)
        f[u] = o + u * R < Cout ? __ldg(src + (o + u * R) * row) : 0.0f;
#pragma unroll
      for (int u = 0; u < kColumnLoads; ++u) m = fmaxf(m, fabsf(f[u]));
    }
  }
  PHASE_MARK(7);
  // max |w| >= 0 orders as its bit pattern
  const int j = r0 < R ? e / taps : -1;
  const unsigned group = __match_any_sync(0xffffffffu, j);
  const unsigned top = __reduce_max_sync(group, __float_as_uint(m));
  if (j >= 0 && lane == __ffs(group) - 1) atomicMax(colmax + j, top);
  __syncthreads();
  if (tid < n) mk[c0 + tid] = __uint_as_float(colmax[tid]);
  PHASE_MARK(8);
}

struct RowArgs {
  const float* w;
  const float* mx;
  const float* mx_raw;
  float* s_c;     // [Cin]
  float* maxima;  // [parts][Cout + 1]: each row's max |v| over a cluster's columns, then max |x'|
  int Cout, Cin, taps, cols;
  int vec;        // floats a copy: 1, 2 or 4, dividing Cin * taps and cols * taps
};

// The split cluster barrier: arrive (release) and wait (acquire) apart, so
// that the first one overlaps the loads.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int TAPS, bool SMOOTH>
__global__ void __launch_bounds__(kRowThreads)
row_maxima_kernel(const RowArgs a) {
  PHASE_MARK(0);
  extern __shared__ __align__(16) float rows_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int taps = TAPS > 0 ? TAPS : a.taps;
  const int cols = a.cols;  // a power of two, at most 32
  const int tid = threadIdx.x, lane = tid % 32;
  const int c0 = blockIdx.x * a.cols;
  const int n = max(0, min(cols, a.Cin - c0));  // this block's columns (none past Cin)
  const int L = n * taps;                       // their run in every row
  const int ts = cols + 1;                      // odd: a warp's rows on distinct banks
  float* stage = rows_smem;                                           // [Cout][L]
  float* tm = stage + a.Cout * cols * taps;                           // [Cout][ts]
  unsigned* acc = reinterpret_cast<unsigned*>(tm + a.Cout * ts);      // [Cout + 1], rank 0's
  unsigned* col_max = acc + a.Cout + 1;                               // [cols]
  float* sc = reinterpret_cast<float*>(col_max + cols);               // [cols]
  // the block's runs into shared memory, every load in flight at once:
  // `vec` floats a copy where the runs and the weight allow (the last
  // block's shorter run may not)
  const float* src = a.w + static_cast<int64_t>(c0) * taps;
  const int64_t row = static_cast<int64_t>(a.Cin) * taps;
  const int vec = L % a.vec == 0 && reinterpret_cast<uintptr_t>(a.w) % (4 * a.vec) == 0
                      ? a.vec : 1;
  const int Lv = L / vec;
  for (int i = tid; i < a.Cout * Lv; i += kRowThreads) {
    const int o = i / Lv, e = (i - o * Lv) * vec;
    float* dst = stage + o * L + e;
    const float* from = src + o * row + e;
    if (vec == 4) cp_async16(dst, from);
    else if (vec == 2) cp_async8(dst, from);
    else cp_async4(dst, from);
  }
  const float mx0 = tid < n ? __ldg(a.mx + c0 + tid) : 0.0f;
  const float raw0 = tid < n ? __ldg(a.mx_raw + c0 + tid) : 0.0f;
  if (tid < cols) col_max[tid] = 0u;
  if (rank == 0)  // the cluster's maxima meet here
    for (int o = tid; o <= a.Cout; o += kRowThreads) acc[o] = 0u;
  cluster_arrive();  // rank 0's zeros, released while the loads fly
  cp_async_wait_all();
  __syncthreads();
  PHASE_MARK(7);

  // thread t: column j = t % cols of rows t / cols, t / cols + kRowThreads / cols, ...;
  // each (row, column)'s max over the taps into the table (a warp's reads
  // `taps` words apart), the column's max |w| in a register
  const int j = tid % cols;
  float m = 0.0f;
  if (j < n) {
    for (int o = tid / cols; o < a.Cout; o += kRowThreads / cols) {
      const float* v = stage + o * L + j * taps;
      float t = 0.0f;
#pragma unroll
      for (int k = 0; k < (TAPS > 0 ? TAPS : 1); ++k) t = fmaxf(t, fabsf(v[k]));
      for (int k = TAPS > 0 ? TAPS : 1; k < taps; ++k) t = fmaxf(t, fabsf(v[k]));
      tm[o * ts + j] = t;
      m = fmaxf(m, t);
    }
  }
  if constexpr (SMOOTH) {  // the lanes of one column, then each warp's max (>= 0: bit order)
    for (int off = 16; off >= cols; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane < n) atomicMax(col_max + lane, __float_as_uint(m));
  }
  __syncthreads();
  PHASE_MARK(8);

  // s_c of the block's columns; their max RN(mx_raw / s_c) and, after one
  // barrier, each row's max over the columns of RN(max_t |w| * s_c) (RN(. *
  // s_c) is monotone, so it is the max of |RN(w * s_c)| over the columns and
  // taps) merged into rank 0's maxima by distributed shared memory atomics
  unsigned* to = cluster.map_shared_rank(acc, 0);
  cluster_wait();
  if (tid < n) {
    const float s = SMOOTH ? __fdiv_rn(__fsqrt_rn(mx0),
                                       __fsqrt_rn(fmaxf(__uint_as_float(col_max[tid]), kFloor)))
                           : 1.0f;
    sc[tid] = s;
    a.s_c[c0 + tid] = s;
    atomicMax(to + a.Cout, __float_as_uint(SMOOTH ? __fdiv_rn(raw0, s) : raw0));
  }
  __syncthreads();
  PHASE_MARK(3);
  if (n > 0) {
    for (int o = tid; o < a.Cout; o += kRowThreads) {
      float r = 0.0f;
      for (int i = 0; i < n; ++i) {
        const float t = tm[o * ts + i];
        r = fmaxf(r, SMOOTH ? __fmul_rn(t, sc[i]) : t);
      }
      if (r > 0.0f) atomicMax(to + o, __float_as_uint(r));
    }
  }
  PHASE_MARK(5);
  cluster_arrive();  // every block's atomics, released to rank 0
  cluster_wait();
  PHASE_MARK(9);
  if (rank == 0) {
    float* out = a.maxima + static_cast<int64_t>(blockIdx.x / K) * (a.Cout + 1);
    for (int o = tid; o <= a.Cout; o += kRowThreads) out[o] = __uint_as_float(acc[o]);
  }
  PHASE_MARK(6);
}

struct ScalesArgs {
  const float* w;
  const float* mx;       // COLUMNS
  const float* mx_raw;   // COLUMNS
  const float* mk;       // COLUMNS: the model group's column maxima (unclamped)
  const float* s_c_in;   // rows: the first launch's s_c
  const float* maxima;   // rows: the model group's row maxima, then max |x'| [parts][Cout + 1]
  float* s_c;            // COLUMNS
  float* s_k;
  float* s_x;
  int8_t* k_q;
  int Cout, Cin, Cp, taps, parts;
};

template <int TAPS, bool COLUMNS>
__global__ void __launch_bounds__(kScalesThreads)
weight_scales_kernel(const ScalesArgs a) {
  PHASE_MARK(0);
  constexpr int NT = TAPS > 0 ? TAPS : 1;
  extern __shared__ __align__(16) float scales_smem[];
  const int taps = TAPS > 0 ? TAPS : a.taps, row_len = a.Cin * taps;
  const int srow = (row_len + 3) / 4 * 4;                     // a staged row's floats
  float* sc_s = scales_smem;                                  // s_c [Cin]
  float* stage = scales_smem + (a.Cin + 3) / 4 * 4;           // the block's rows [rows][srow]
  __shared__ unsigned row_max[kWeightMaxRows];
  __shared__ float row_sk[kWeightMaxRows], row_rk[kWeightMaxRows];
  __shared__ float xpart[kScalesThreads / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, G = gridDim.x, b = blockIdx.x;
  const int o_begin = static_cast<int>(static_cast<int64_t>(b) * a.Cout / G);
  const int o_end = static_cast<int>(static_cast<int64_t>(b + 1) * a.Cout / G);
  const int rows = o_end - o_begin;
  const float* src = a.w + static_cast<int64_t>(o_begin) * row_len;
  // the block's rows into shared memory, every load in flight at once
  if (row_len % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0) {
    for (int i = tid; i < rows * row_len / 4; i += kScalesThreads)
      cp_async16(stage + 4 * i, src + 4 * i);
  } else {
    for (int i = tid; i < rows * row_len; i += kScalesThreads)
      cp_async4(stage + (i / row_len) * srow + i % row_len, src + i);
  }
  // s_c for every column (and block 0's max RN(mx_raw / s_c)), or loaded;
  // rows: s_k of the block's rows and s_x from the group's maxima
  if (tid < kWeightMaxRows) row_max[tid] = 0u;
  // kScalesAhead columns a thread at once: their loads in flight together
  float xq = 0.0f;
  for (int c0 = tid; c0 < a.Cin; c0 += kScalesAhead * kScalesThreads) {
    float in[kScalesAhead], top[kScalesAhead], raw[kScalesAhead];
#pragma unroll
    for (int i = 0; i < kScalesAhead; ++i) {
      const int c = c0 + i * kScalesThreads;
      const bool ok = c < a.Cin;
      in[i] = ok ? __ldg((COLUMNS ? a.mx : a.s_c_in) + c) : 1.0f;
      top[i] = COLUMNS && ok ? __ldg(a.mk + c) : 1.0f;
      raw[i] = COLUMNS && ok && b == 0 ? __ldg(a.mx_raw + c) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kScalesAhead; ++i) {
      const int c = c0 + i * kScalesThreads;
      if (c >= a.Cin) break;
      float sc = in[i];
      if constexpr (COLUMNS) {
        sc = __fdiv_rn(__fsqrt_rn(sc), __fsqrt_rn(fmaxf(top[i], kFloor)));
        if (b == 0) xq = fmaxf(xq, __fdiv_rn(raw[i], sc));
        if (c >= static_cast<int64_t>(b) * a.Cin / G &&
            c < static_cast<int64_t>(b + 1) * a.Cin / G)
          a.s_c[c] = sc;
      }
      sc_s[c] = sc;
    }
  }
  if constexpr (COLUMNS) {
    if (b == 0) {
      xq = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(xq)));
      if (lane == 0) xpart[warp] = xq;
    }
  } else {
    // the row maxima's clusters folded: each row's max over the parts
    auto folded = [&](int o) {
      float top = 0.0f;
      for (int k = 0; k < a.parts; ++k)
        top = fmaxf(top, __ldg(a.maxima + static_cast<int64_t>(k) * (a.Cout + 1) + o));
      return top;
    };
    if (tid < rows) {
      const float sk = __fdiv_rn(fmaxf(folded(o_begin + tid), kFloor), kLevels);
      row_sk[tid] = sk;
      row_rk[tid] = __frcp_rn(sk);
      a.s_k[o_begin + tid] = sk;
    }
    if (b == 0 && tid == kScalesThreads - 1)
      a.s_x[0] = __fdiv_rn(fmaxf(folded(a.Cout), kFloor), kLevels);
  }
  cp_async_wait_all();
  __syncthreads();
  PHASE_MARK(3);
  if constexpr (COLUMNS) {
    if (b == 0 && tid == kScalesThreads - 1) {
      float r = xpart[0];
      for (int i = 1; i < kScalesThreads / 32; ++i) r = fmaxf(r, xpart[i]);
      a.s_x[0] = __fdiv_rn(fmaxf(r, kFloor), kLevels);
    }
  }

  // unit u: row u / Q, input channels 2q, 2q + 1 (q = u % Q) over the taps
  const int Q = a.Cp / kUnitCols, pairs = (a.Cin + kUnitCols - 1) / kUnitCols;
  const int units = rows * Q;
  // value k (column 2q + k / taps, tap k % taps) of unit u, times s_c
  auto value = [&](int u, int k) {
    const int q = u % Q, c = kUnitCols * q + k / taps;
    return c < a.Cin ? __fmul_rn(stage[(u / Q) * srow + kUnitCols * q * taps + k], sc_s[c])
                     : 0.0f;
  };
  // this thread's first unit in registers (taps 1 or 9): its 2 * taps values
  // by 8-byte reads, its two s_c by one
  constexpr int NV = TAPS > 0 ? kUnitCols * TAPS : 1;
  float v[NV];
  const bool cached = TAPS > 0 && tid < units && tid % Q < pairs;
  if (cached) {
    const int q = tid % Q;
    const float* base = stage + (tid / Q) * srow + kUnitCols * q * NT;
    const float2 sc = reinterpret_cast<const float2*>(sc_s)[q];
    const bool whole = kUnitCols * q + 1 < a.Cin;  // else only the first column is in the row
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (whole) {
        const float2 f = reinterpret_cast<const float2*>(base)[i];
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      } else {
        v[2 * i] = 2 * i < NT ? base[2 * i] : 0.0f;
        v[2 * i + 1] = 2 * i + 1 < NT ? base[2 * i + 1] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k)  // past Cin (an odd Cin's last pair): zero
      v[k] = kUnitCols * q + k / NT < a.Cin ? __fmul_rn(v[k], k < NT ? sc.x : sc.y) : 0.0f;
  }
  if constexpr (COLUMNS) {
    // each row's max |v|: every lane of a warp takes part in row_merge
    for (int u0 = 0; u0 < units; u0 += kScalesThreads) {
      const int u = u0 + tid;
      float m = 0.0f;
      if (u0 == 0 && cached) {
#pragma unroll
        for (int k = 0; k < NV; ++k) m = fmaxf(m, fabsf(v[k]));
      } else if (u < units && u % Q < pairs) {
        for (int k = 0; k < kUnitCols * taps; ++k) m = fmaxf(m, fabsf(value(u, k)));
      }
      row_merge(row_max, u < units ? u / Q : 0, m);
    }
    __syncthreads();
    if (tid < rows) {
      const float sk = __fdiv_rn(fmaxf(__uint_as_float(row_max[tid]), kFloor), kLevels);
      row_sk[tid] = sk;
      row_rk[tid] = __frcp_rn(sk);
      a.s_k[o_begin + tid] = sk;
    }
    __syncthreads();
    PHASE_MARK(5);
  }
  // k_q: two levels a word, one word per tap
  for (int u = tid; u < units; u += kScalesThreads) {
    const int r = u / Q, q = u % Q;
    const float sk = row_sk[r], rk = row_rk[r];
    const bool fast = divisor_ok(sk);
    uint16_t* dst =
        reinterpret_cast<uint16_t*>(a.k_q + static_cast<int64_t>(o_begin + r) * taps * a.Cp) + q;
    if (TAPS > 0 && u == tid && cached) {
      // weight_level_by_product for the 2 * taps values at once, its rare
      // exact division after: independent chains, no branch between them
      // (a value past Cin is 0 and its level 0)
      uint32_t lv[2 * NT];
      uint32_t near = 0u;
#pragma unroll
      for (int k = 0; k < 2 * NT; ++k) {
        const float c = fminf(fmaxf(__fmul_rn(v[k % NV], rk), -kLevels), kLevels);
        const float rounded = __fadd_rn(c, kRoundMagic);
        near |= (fabsf(__fsub_rn(c, __fsub_rn(rounded, kRoundMagic))) > kNearHalf ? 1u : 0u)
                << k;
        lv[k] = __float_as_uint(rounded) & 0xffu;
      }
      if (near != 0u) {
#pragma unroll
        for (int k = 0; k < 2 * NT; ++k)
          if ((near >> k) & 1u) lv[k] = weight_level_exact(v[k % NV], sk, rk, fast);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) dst[t * Q] = static_cast<uint16_t>(lv[t] | (lv[NT + t] << 8));
      continue;
    }
    for (int t = 0; t < taps; ++t) {
      uint32_t word = 0u;
      if (q < pairs) {
#pragma unroll
        for (int j = 0; j < kUnitCols; ++j)
          if (kUnitCols * q + j < a.Cin)
            word |= weight_level_by_product(value(u, j * taps + t), sk, rk, fast) << (8 * j);
      }
      dst[t * Q] = static_cast<uint16_t>(word);
    }
  }
  PHASE_MARK(6);
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

namespace {

template <typename F>
const void* kernel_ptr(F* kernel) {
  return reinterpret_cast<const void*>(kernel);
}

// (b)'s kernel for (taps, smoothing)
template <int TAPS>
const void* weight_kernel(bool smooth) {
  return smooth ? kernel_ptr(quantize_weight_kernel<TAPS, true>)
                : kernel_ptr(quantize_weight_kernel<TAPS, false>);
}

// One launch of (b) with the plan of ops/int8conv.py::weight_plan: `grid`
// blocks (at most Cout and kWeightMaxRows output channels each, and where a
// barrier is crossed at most what the card holds at once).  With smoothing
// `mk` is the caller's (Cin,) 32-bit buffer on `stream`, zeroed here before
// the launch, so launches on different streams never share it, and the
// launch is cooperative.  cudaErrorInvalidValue for a plan the kernel does
// not take; the cooperative launch itself returns
// cudaErrorCooperativeLaunchTooLarge for a grid the card cannot hold at once.
int launch_weight(const void* w, const void* mx, const void* mx_raw, void* s_c, void* s_k,
                  void* s_x, void* k_q, void* mk, int Cout, int Cin, int Cp, int taps,
                  int smooth, int grid, void* stream) {
  if (Cout < 1 || Cin < 1 || Cin > kWeightMaxCin || taps < 1 || Cp % 16 || Cp < Cin ||
      grid < 1 || grid > Cout || (Cout + grid - 1) / grid > kWeightMaxRows ||
      (smooth && mk == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = taps == 9   ? weight_kernel<9>(smooth)
                       : taps == 1 ? weight_kernel<1>(smooth)
                                   : weight_kernel<0>(smooth);
  const int smem = Cin * 4 * (smooth ? 2 : 1);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024 &&  // beyond the default: Cin above 6144 with smoothing
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return static_cast<int>(e);
  WeightArgs args;
  args.w = static_cast<const float*>(w);
  args.mx = static_cast<const float*>(mx);
  args.mx_raw = static_cast<const float*>(mx_raw);
  args.s_c = static_cast<float*>(s_c);
  args.s_k = static_cast<float*>(s_k);
  args.s_x = static_cast<float*>(s_x);
  args.k_q = static_cast<int8_t*>(k_q);
  args.mk = static_cast<unsigned*>(mk);
  args.Cout = Cout; args.Cin = Cin; args.Cp = Cp; args.taps = taps;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = smooth ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kWeightThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (smooth && (e = cudaMemsetAsync(mk, 0, sizeof(unsigned) * Cin, cfg.stream)) != cudaSuccess)
    return static_cast<int>(e);
  void* argv[] = {&args};
  e = cudaLaunchKernelExC(&cfg, kernel, argv);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

template <bool SMOOTH>
const void* row_kernel(int taps) {
  return taps == 9   ? kernel_ptr(row_maxima_kernel<9, SMOOTH>)
         : taps == 1 ? kernel_ptr(row_maxima_kernel<1, SMOOTH>)
                     : kernel_ptr(row_maxima_kernel<0, SMOOTH>);
}

template <bool COLUMNS>
const void* scales_kernel(int taps) {
  return taps == 9   ? kernel_ptr(weight_scales_kernel<9, COLUMNS>)
         : taps == 1 ? kernel_ptr(weight_scales_kernel<1, COLUMNS>)
                     : kernel_ptr(weight_scales_kernel<0, COLUMNS>);
}

}  // namespace

// (b) in one process: s_c, s_k, s_x and k_q in one launch (see
// launch_weight).
extern "C" int int8_quantize_weight(const void* w, const void* mx, const void* mx_raw,
                                    void* s_c, void* s_k, void* s_x, void* k_q, void* mk,
                                    int Cout, int Cin, int Cp, int taps, int smooth, int grid,
                                    void* stream) {
  return launch_weight(w, mx, mx_raw, s_c, s_k, s_x, k_q, mk, Cout, Cin, Cp, taps, smooth, grid,
                       stream);
}

// (b)'s first launch for a row block under a tensor-parallel shard
// (`row_maxima_kernel`, the plan of ops/int8conv.py::row_maxima_plan):
// `grid` blocks of `cols` input channels (a power of two up to 32), in
// clusters of `cluster`, copying `vec` floats at a time (1, 2 or 4,
// dividing Cin * taps and cols * taps), `smem` bytes of dynamic shared
// memory; s_c [Cin] and maxima [grid / cluster][Cout + 1].
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int int8_weight_row_maxima(const void* w, const void* mx, const void* mx_raw,
                                      void* s_c, void* maxima, int Cout, int Cin, int taps,
                                      int smooth, int grid, int cols, int cluster, int vec,
                                      int smem, void* stream) {
  const int64_t need =
      (static_cast<int64_t>(Cout) * (cols * taps + cols + 2) + 1 + 2 * cols) * 4;
  const int used = cols > 0 ? (Cin + cols - 1) / cols : 0;  // blocks that hold columns
  if (Cout < 1 || Cin < 1 || taps < 1 || cols < 1 || cols > kRowMaxCols || (cols & (cols - 1)) ||
      cluster < 1 || cluster > kRowMaxCluster || grid % cluster || grid < used ||
      grid - cluster >= used || (vec != 1 && vec != 2 && vec != 4) ||
      (static_cast<int64_t>(Cin) * taps) % vec || (cols * taps) % vec || smem < need ||
      w == nullptr || mx == nullptr ||
      mx_raw == nullptr || s_c == nullptr || maxima == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = smooth ? row_kernel<true>(taps) : row_kernel<false>(taps);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  RowArgs args;
  args.w = static_cast<const float*>(w);
  args.mx = static_cast<const float*>(mx);
  args.mx_raw = static_cast<const float*>(mx_raw);
  args.s_c = static_cast<float*>(s_c);
  args.maxima = static_cast<float*>(maxima);
  args.Cout = Cout; args.Cin = Cin; args.taps = taps; args.cols = cols; args.vec = vec;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kRowThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* argv[] = {&args};
  e = cudaLaunchKernelExC(&cfg, kernel, argv);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// (b)'s first launch for a column block: mk [Cin] = max |w| over the output
// channels and taps (`column_maxima_kernel`, the plan of
// ops/int8conv.py::column_maxima_plan: `grid` blocks of `cols` columns).
extern "C" int int8_weight_column_maxima(const void* w, void* mk, int Cout, int Cin, int taps,
                                         int grid, int cols, void* stream) {
  if (Cout < 1 || Cin < 1 || taps < 1 || cols < 1 || cols * taps > kColumnThreads ||
      grid != (Cin + cols - 1) / cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  auto* out = static_cast<float*>(mk);
  if (taps == 9)
    column_maxima_kernel<9><<<grid, kColumnThreads, 0, st>>>(wf, out, Cout, Cin, taps, cols);
  else if (taps == 1)
    column_maxima_kernel<1><<<grid, kColumnThreads, 0, st>>>(wf, out, Cout, Cin, taps, cols);
  else
    column_maxima_kernel<0><<<grid, kColumnThreads, 0, st>>>(wf, out, Cout, Cin, taps, cols);
  return status();
}

// (b)'s second launch under a shard (`weight_scales_kernel`, the plan of
// ops/int8conv.py::scales_plan: `grid` blocks, `smem` bytes of dynamic
// shared memory for s_c and the block's rows): `columns` 1, a column
// block's s_c, s_k, s_x and k_q from mx, mx_raw and the group's mk; 0, a
// row block's s_k, s_x and k_q from its s_c and the group's maxima, `parts`
// rows of Cout + 1 (the row maxima's clusters) folded by their max.
// Pointers the mode does not use may be null.
extern "C" int int8_weight_scales(int columns, const void* w, const void* mx, const void* mx_raw,
                                  const void* mk, const void* s_c_in, const void* maxima,
                                  void* s_c, void* s_k, void* s_x, void* k_q, int Cout, int Cin,
                                  int Cp, int taps, int parts, int grid, int smem,
                                  void* stream) {
  const int rows = grid > 0 ? (Cout + grid - 1) / grid : 0;
  const int64_t need =
      ((Cin + 3) / 4 + static_cast<int64_t>(rows) * ((static_cast<int64_t>(Cin) * taps + 3) / 4))
      * 16;
  if (Cout < 1 || Cin < 1 || taps < 1 || parts < 1 || Cp % 16 || Cp < Cin || grid < 1 ||
      grid > Cout || rows > kWeightMaxRows || smem < need || s_k == nullptr || s_x == nullptr ||
      k_q == nullptr || (columns && (mx == nullptr || mx_raw == nullptr || mk == nullptr ||
                                     s_c == nullptr)) ||
      (!columns && (s_c_in == nullptr || maxima == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = columns ? scales_kernel<true>(taps) : scales_kernel<false>(taps);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return static_cast<int>(e);
  ScalesArgs args;
  args.w = static_cast<const float*>(w);
  args.mx = static_cast<const float*>(mx);
  args.mx_raw = static_cast<const float*>(mx_raw);
  args.mk = static_cast<const float*>(mk);
  args.s_c_in = static_cast<const float*>(s_c_in);
  args.maxima = static_cast<const float*>(maxima);
  args.s_c = static_cast<float*>(s_c);
  args.s_k = static_cast<float*>(s_k);
  args.s_x = static_cast<float*>(s_x);
  args.k_q = static_cast<int8_t*>(k_q);
  args.Cout = Cout; args.Cin = Cin; args.Cp = Cp; args.taps = taps; args.parts = parts;
  void* argv[] = {&args};
  e = cudaLaunchKernel(kernel, dim3(grid), dim3(kScalesThreads), argv, smem,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
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
                               int Cp, int Cout, int kh, int kw, int stride, int pad_h,
                               int pad_w, int Ho, int Wo, int hbox, int wbox, int bk, int bn,
                               int grid, int out_dtype, void* stream) {
  if (hbox * wbox != kBM || (bk != 64 && bk != 128) || (bn != 128 && bn != 256) ||
      stride < 1 || stride > 8 || wbox * stride > 256 || hbox * stride > 256 || Cp % 16 ||
      grid < 1 || pad_h < 0 || pad_w < 0)
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
  a.Ho = Ho; a.Wo = Wo; a.Cout = Cout; a.kw = kw; a.stride = stride;
  a.pad_h = pad_h; a.pad_w = pad_w;
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
