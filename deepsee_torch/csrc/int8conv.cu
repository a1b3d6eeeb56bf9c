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
//                            mma.sync m16n8k32 s8.s8.s32, then the JAX
//                            dequantization and the bias in the output type
// Cp is Cin rounded up to 16: the padding channels are zero in both x_q and
// k_q, so the GEMM loads every A and B chunk as 16 aligned bytes whatever Cin
// is, and a chunk never straddles two taps.
//
// The scales must equal the plain version's bit for bit (a scale one ulp off
// moves whole tensors by a level), so every float operation here is the
// JAX sequence's, with the IEEE intrinsics (__fdiv_rn, __fsqrt_rn,
// __fmul_rn, __fadd_rn): no reciprocal, no contraction into an FMA, and this
// file must never be built with --use_fast_math.  s_x comes from the
// per-channel maxima: division by a positive s_c is monotone under
// round-to-nearest, so max|x / s_c| = max_c(RN(max|x_c| / s_c)) exactly.
//
// Bounds on the H100 SXM: (d) is bound by its operations (2*M*N*K at the
// 1,979 TOP/s dense int8 peak) at every shape of the serving path; (a)-(c)
// by bytes (the activation read twice, x_q written once, at 3.35 TB/s).
// This is the first, simple design: 128x128x64 block tiles, 8 warps of
// 64x32, a two-stage cp.async ring and one warp-level mma per 16x8x32.
// wgmma, TMA and fusing (c) into (d)'s loads are later work (ROADMAP.md).

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
// One thread per 16 output channels of a pixel: 16 bytes of x_q written at
// once.  VECTOR: C % 16 == 0, so the 16 inputs are whole 16-byte loads.

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
quantize_activation_kernel(const T* __restrict__ x, const float* __restrict__ s_c,
                           const float* __restrict__ s_x, int8_t* __restrict__ x_q,
                           int64_t P, int C, int Cp) {
  const float sx = *s_x;
  const int chunks = Cp / 16;
  const int64_t total = P * chunks;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t p = i / chunks;
    const int c0 = (int)(i - p * chunks) * 16;
    float v[16];
    const T* src = x + p * C + c0;
    if constexpr (VECTOR) {
      constexpr int kPer = 16 / sizeof(T);
#pragma unroll
      for (int j = 0; j < 16; j += kPer) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + j));
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < kPer; ++e) v[j + e] = to_f32(t[e]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = c0 + j < C ? to_f32(src[j]) : 0.0f;
    }
    alignas(16) int8_t q[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j;
      q[j] = c < C ? (int8_t)(int)quantize(__fdiv_rn(v[j], s_c[c]), sx) : (int8_t)0;
    }
    *reinterpret_cast<uint4*>(x_q + p * Cp + c0) = *reinterpret_cast<const uint4*>(q);
  }
}

// -- (d) the implicit-GEMM conv ------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // bytes per shared row: the fragment loads hit 32 banks once

struct ConvShape {
  int N, H, W, Cp, Cout, kh, kw, stride, pad, Ho, Wo;
  int64_t M;  // N * Ho * Wo
  int K;      // kh * kw * Cp
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OutT>
__device__ __forceinline__ OutT finish(float y, const float* bias, int o);
template <>
__device__ __forceinline__ float finish<float>(float y, const float* bias, int o) {
  return bias ? __fadd_rn(y, bias[o]) : y;
}
template <>
__device__ __forceinline__ __nv_bfloat16 finish<__nv_bfloat16>(float y, const float* bias,
                                                               int o) {
  // cast to bf16 first, then add the bf16 bias with one rounding, as the
  // JAX sequence `_int8_conv(...).astype(dtype) + bias.astype(dtype)`
  const __nv_bfloat16 h = __float2bfloat16_rn(y);
  if (!bias) return h;
  const float b = __bfloat162float(__float2bfloat16_rn(bias[o]));
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(h), b));
}

// Each thread loads two 16-byte chunks of A and two of B per k-tile: rows
// tid/4 and tid/4 + 64 of the tile, bytes (tid%4)*16 of its 64.  The A
// rows' pixels are fixed for the block, so their coordinates are worked out
// once; the tap and channel of the thread's k advance by BK per tile.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
igemm_kernel(const int8_t* __restrict__ x_q, const int8_t* __restrict__ k_q,
             const float* __restrict__ s_x, const float* __restrict__ s_k,
             const float* __restrict__ bias, OutT* __restrict__ y, ConvShape s) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];
  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kc = (tid % 4) * 16;
  const int lrow = tid / 4;

  // the thread's two A rows (output pixels) and two B rows (output channels)
  int64_t pix[2];
  int ih0[2], iw0[2];
  bool mval[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t m = m0 + lrow + 64 * j;
    mval[j] = m < s.M;
    const int64_t hw = (int64_t)s.Ho * s.Wo;
    const int64_t nb = mval[j] ? m / hw : 0;
    const int rem = mval[j] ? (int)(m - nb * hw) : 0;
    const int ho = rem / s.Wo, wo = rem - (rem / s.Wo) * s.Wo;
    ih0[j] = ho * s.stride - s.pad;
    iw0[j] = wo * s.stride - s.pad;
    pix[j] = nb * s.H;
  }
  const int8_t* brow[2];
  bool nval[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int o = n0 + lrow + 64 * j;
    nval[j] = o < s.Cout;
    brow[j] = k_q + (int64_t)(nval[j] ? o : 0) * s.K + kc;
  }
  // the tap (r, q) and channel c of k = k0 + kc
  int tr = 0, tq = 0, tc = kc;
  while (tc >= s.Cp) {
    tc -= s.Cp;
    if (++tq == s.kw) { tq = 0; ++tr; }
  }

  auto load = [&](int stage, int k0) {
    const bool kval = tr < s.kh;  // k0 + kc < K
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ih = ih0[j] + tr, iw = iw0[j] + tq;
      const bool ok = kval && mval[j] && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W;
      const int8_t* src = ok ? x_q + ((pix[j] + ih) * s.W + iw) * s.Cp + tc : x_q;
      cp_async16(&As[stage][(lrow + 64 * j) * LDS + kc], src, ok);
      const bool okb = kval && nval[j];
      cp_async16(&Bs[stage][(lrow + 64 * j) * LDS + kc], okb ? brow[j] + k0 : k_q, okb);
    }
    tc += BK;
    while (tc >= s.Cp) {
      tc -= s.Cp;
      if (++tq == s.kw) { tq = 0; ++tr; }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (s.K + BK - 1) / BK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) load(cur ^ 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest: tile kt has landed
    __syncthreads();
    const int8_t* a = As[cur];
    const int8_t* b = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* r0 = a + (wm + i * 16 + g) * LDS + kk + t4;
        const int8_t* r8 = r0 + 8 * LDS;
        af[i][0] = lds32(r0);
        af[i][1] = lds32(r8);
        af[i][2] = lds32(r0 + 16);
        af[i][3] = lds32(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* c0 = b + (wn + j * 8 + g) * LDS + kk + t4;
        bf[j][0] = lds32(c0);
        bf[j][1] = lds32(c0 + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // y = float32(acc) * (s_x * s_k[o]), the product of the scales formed first
  const float sx = *s_x;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = n0 + wn + j * 8 + (lane & 3) * 2 + e;
      if (o >= s.Cout) continue;
      const float scale = __fmul_rn(sx, s_k[o]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t m = m0 + wm + i * 16 + g + 8 * h;
          if (m >= s.M) continue;
          const float v = __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), scale);
          y[m * s.Cout + o] = finish<OutT>(v, bias, o);
        }
      }
    }
  }
}

int status() { return static_cast<int>(cudaGetLastError()); }

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
                                        void* x_q, int64_t P, int C, int Cp, int blocks,
                                        int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(s_c);
  const auto* sx = static_cast<const float*>(s_x);
  auto* q = static_cast<int8_t*>(x_q);
  const bool vector = C % 16 == 0;
  if (dtype == 1) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    if (vector)
      quantize_activation_kernel<__nv_bfloat16, true><<<blocks, kThreads, 0, st>>>(xb, sc, sx, q,
                                                                                  P, C, Cp);
    else
      quantize_activation_kernel<__nv_bfloat16, false><<<blocks, kThreads, 0, st>>>(xb, sc, sx,
                                                                                   q, P, C, Cp);
  } else {
    const auto* xf = static_cast<const float*>(x);
    if (vector)
      quantize_activation_kernel<float, true><<<blocks, kThreads, 0, st>>>(xf, sc, sx, q, P, C,
                                                                          Cp);
    else
      quantize_activation_kernel<float, false><<<blocks, kThreads, 0, st>>>(xf, sc, sx, q, P, C,
                                                                           Cp);
  }
  return status();
}

extern "C" int int8_conv_igemm(const void* x_q, const void* k_q, const void* s_x,
                               const void* s_k, const void* bias, void* y, int N, int H, int W,
                               int Cp, int Cout, int kh, int kw, int stride, int pad, int Ho,
                               int Wo, int out_dtype, void* stream) {
  ConvShape s;
  s.N = N; s.H = H; s.W = W; s.Cp = Cp; s.Cout = Cout; s.kh = kh; s.kw = kw;
  s.stride = stride; s.pad = pad; s.Ho = Ho; s.Wo = Wo;
  s.M = (int64_t)N * Ho * Wo;
  s.K = kh * kw * Cp;
  const int64_t mtiles = (s.M + BM - 1) / BM;
  if (mtiles > 0x7fffffff || (Cout + BN - 1) / BN > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)mtiles, (Cout + BN - 1) / BN);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xq = static_cast<const int8_t*>(x_q);
  const auto* kq = static_cast<const int8_t*>(k_q);
  const auto* sx = static_cast<const float*>(s_x);
  const auto* sk = static_cast<const float*>(s_k);
  const auto* b = static_cast<const float*>(bias);
  if (out_dtype == 1)
    igemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(xq, kq, sx, sk, b,
                                                           static_cast<__nv_bfloat16*>(y), s);
  else
    igemm_kernel<float><<<grid, kThreads, 0, st>>>(xq, kq, sx, sk, b, static_cast<float*>(y), s);
  return status();
}
