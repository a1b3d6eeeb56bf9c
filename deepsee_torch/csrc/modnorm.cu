// modnorm: the normalize -> modulate -> leaky-ReLU epilogue of every
// SPADE/SEAN block, and the encoder's instance norm, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepsee_tpu/ops/pallas/modnorm.py::
// modulated_instance_norm (Pallas; `_kernel` at :38, `pl.pallas_call` at
// :147; retired from the JAX package in fe9393d, read it with
// `git show fe9393d^:deepsee_tpu/ops/pallas/modnorm.py`).  It computes
//
//     out = lrelu?( norm(x) * scale + offset )
//
// with x, out: (B, H, W, C) NHWC memory (a channels_last NCHW tensor), and
// scale/offset read straight from the 2C-channel modulation-conv output:
// scale = mod[p, 0:C] (its +1 is already in the conv bias), offset =
// mod[p, C:2C], so no split copy is ever made.  Arithmetic is float32 with
// one rounding to the output type; the statistics are float32.
//
// Two modes of norm(x):
//   * affine   (eval-mode batch / sync-batch norm, the generator main path):
//     norm(x) = x * inv[c] + shift[c] with inv = rsqrt(var + eps) and
//     shift = -mean * inv precomputed by the wrapper from the running stats.
//   * instance (per sample and channel over H*W, the encoder's norm):
//     Welford within a thread, Chan's merge across threads, then apply.
//
// Bound: device-memory bytes.  The affine mode reads x once and the 2C
// modulation once and writes out once: 4 bytes-passes per element, about
// 1 flop per byte.  The design therefore does nothing but stream: one
// elementwise pass, 16-byte vector loads and stores (8 bf16 or 2x4 f32 per
// thread), neighbouring threads on neighbouring channels so a warp touches
// contiguous 512-byte (bf16) runs, a grid-stride loop sized to fill every
// SM, 64-bit offsets (B*H*W*2C exceeds 2^31 at 256^2 b32).  The instance
// mode adds one read of x for the statistics (the TPU kernel's pass 1); it
// keeps the per-(sample, channel-tile) loop inside one block, because
// blocks run in no order and cannot carry a sum from one to the next as the
// TPU's sequential grid did.
//
// The elementwise arithmetic uses explicit round-to-nearest intrinsics
// (no fused multiply-add), so the kernel performs the same float32
// operations in the same order as its plain version in
// deepsee_torch/ops/modnorm.py::modnorm_plain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;        // channels per thread
constexpr int kThreads = 256;  // threads per block

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// y = y * scale + offset (from the 2C modulation row), then leaky ReLU.
template <typename T, bool HAS_MOD, bool LRELU>
__device__ __forceinline__ void epilogue(float* y, const T* mod_row, int C,
                                         float slope) {
  if (HAS_MOD) {
    float s[kVec], o[kVec];
    load8(mod_row, s);
    load8(mod_row + C, o);
#pragma unroll
    for (int k = 0; k < kVec; ++k) y[k] = __fadd_rn(__fmul_rn(y[k], s[k]), o[k]);
  }
  if (LRELU) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) y[k] = y[k] >= 0.f ? y[k] : __fmul_rn(slope, y[k]);
  }
}

template <typename T, bool HAS_MOD, bool LRELU>
__global__ void __launch_bounds__(kThreads)
modnorm_affine_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                      const float* __restrict__ inv,
                      const float* __restrict__ shift, T* __restrict__ out,
                      int64_t P, int C, float slope) {
  const int C8 = C / kVec;
  const int64_t total = P * C8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  // (pixel, channel-vector) of t, advanced incrementally: no 64-bit division
  // inside the loop.
  int64_t p = t / C8;
  int c8 = static_cast<int>(t - p * C8);
  const int64_t dp = stride / C8;
  const int dc = static_cast<int>(stride - dp * C8);
  for (; t < total; t += stride) {
    const int c = c8 * kVec;
    float y[kVec], a[kVec], b[kVec];
    load8(x + p * C + c, y);
    load8(inv + c, a);
    load8(shift + c, b);
#pragma unroll
    for (int k = 0; k < kVec; ++k) y[k] = __fadd_rn(__fmul_rn(y[k], a[k]), b[k]);
    epilogue<T, HAS_MOD, LRELU>(y, HAS_MOD ? mod + p * 2 * C + c : nullptr, C, slope);
    store8(out + p * C + c, y);
    p += dp;
    c8 += dc;
    if (c8 >= C8) {
      c8 -= C8;
      ++p;
    }
  }
}

// One block per (channel tile, sample).  The block is `rows` x `lanes`
// threads; a thread owns 8 channels and walks the pixels row, row+rows, ...
template <typename T, bool HAS_MOD, bool LRELU>
__global__ void __launch_bounds__(kThreads)
modnorm_instance_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                        T* __restrict__ out, int64_t HW, int C, int lanes,
                        float eps, float slope) {
  __shared__ float s_mean[kThreads * kVec];
  __shared__ float s_m2[kThreads * kVec];
  __shared__ float s_cnt[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid % lanes;
  const int row = tid / lanes;
  const int rows = blockDim.x / lanes;
  const int c = (blockIdx.x * lanes + lane) * kVec;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * HW;  // first pixel

  // pass 1: Welford over this thread's pixels
  float mean[kVec], m2[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) mean[k] = m2[k] = 0.f;
  float cnt = 0.f;
  for (int64_t p = row; p < HW; p += rows) {
    float v[kVec];
    load8(x + (base + p) * C + c, v);
    cnt += 1.f;
    const float r = 1.f / cnt;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float d = v[k] - mean[k];
      mean[k] += d * r;
      m2[k] += d * (v[k] - mean[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    s_mean[tid * kVec + k] = mean[k];
    s_m2[tid * kVec + k] = m2[k];
  }
  s_cnt[tid] = cnt;
  __syncthreads();

  // Chan's merge across rows (rows is a power of two); row 0 ends with the
  // totals of each lane's 8 channels.
  for (int s = rows / 2; s > 0; s >>= 1) {
    if (row < s) {
      const int o = tid + s * lanes;
      const float na = s_cnt[tid], nb = s_cnt[o];
      if (nb > 0.f) {
        const float n = na + nb;
        const float fb = nb / n;
        const float fab = na * fb;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float d = s_mean[o * kVec + k] - s_mean[tid * kVec + k];
          s_mean[tid * kVec + k] += d * fb;
          s_m2[tid * kVec + k] += s_m2[o * kVec + k] + d * d * fab;
        }
        s_cnt[tid] = n;
      }
    }
    __syncthreads();
  }

  float inv[kVec];
  const float inv_hw = 1.f / static_cast<float>(HW);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    mean[k] = s_mean[lane * kVec + k];
    inv[k] = rsqrtf(s_m2[lane * kVec + k] * inv_hw + eps);
  }

  // pass 2: apply
  for (int64_t p = row; p < HW; p += rows) {
    const int64_t q = base + p;
    float y[kVec];
    load8(x + q * C + c, y);
#pragma unroll
    for (int k = 0; k < kVec; ++k) y[k] = __fmul_rn(__fsub_rn(y[k], mean[k]), inv[k]);
    epilogue<T, HAS_MOD, LRELU>(y, HAS_MOD ? mod + q * 2 * C + c : nullptr, C, slope);
    store8(out + q * C + c, y);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

template <typename T, bool HAS_MOD, bool LRELU>
void launch_affine(const void* x, const void* mod, const void* inv,
                   const void* shift, void* out, int64_t P, int C, float slope,
                   cudaStream_t stream) {
  const int64_t total = P * (C / kVec);
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kThreads);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  modnorm_affine_kernel<T, HAS_MOD, LRELU><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mod),
      static_cast<const float*>(inv), static_cast<const float*>(shift),
      static_cast<T*>(out), P, C, slope);
}

template <typename T, bool HAS_MOD, bool LRELU>
void launch_instance(const void* x, const void* mod, void* out, int N,
                     int64_t HW, int C, float eps, float slope,
                     cudaStream_t stream) {
  const int c8 = C / kVec;
  const int lanes = c8 % 8 == 0 ? 8 : c8 % 4 == 0 ? 4 : c8 % 2 == 0 ? 2 : 1;
  const dim3 grid(c8 / lanes, N);
  modnorm_instance_kernel<T, HAS_MOD, LRELU><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mod),
      static_cast<T*>(out), HW, C, lanes, eps, slope);
}

template <typename T, template <typename, bool, bool> class L, typename... A>
void dispatch_flags(bool has_mod, bool lrelu, A... args) {
  if (has_mod) {
    if (lrelu) L<T, true, true>::run(args...); else L<T, true, false>::run(args...);
  } else {
    if (lrelu) L<T, false, true>::run(args...); else L<T, false, false>::run(args...);
  }
}

template <typename T, bool M, bool R>
struct Affine {
  template <typename... A> static void run(A... a) { launch_affine<T, M, R>(a...); }
};
template <typename T, bool M, bool R>
struct Instance {
  template <typename... A> static void run(A... a) { launch_instance<T, M, R>(a...); }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `mod` may be null (scale 1, offset 0).
// Returns cudaGetLastError() after the launch.
extern "C" int modnorm_affine(const void* x, const void* mod, const void* inv,
                              const void* shift, void* out, int64_t P, int C,
                              int dtype, int lrelu, float slope, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch_flags<float, Affine>(mod != nullptr, lrelu != 0, x, mod, inv, shift,
                                  out, P, C, slope, s);
  else
    dispatch_flags<__nv_bfloat16, Affine>(mod != nullptr, lrelu != 0, x, mod, inv,
                                          shift, out, P, C, slope, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int modnorm_instance(const void* x, const void* mod, void* out, int N,
                                int64_t HW, int C, float eps, int dtype,
                                int lrelu, float slope, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch_flags<float, Instance>(mod != nullptr, lrelu != 0, x, mod, out, N,
                                    HW, C, eps, slope, s);
  else
    dispatch_flags<__nv_bfloat16, Instance>(mod != nullptr, lrelu != 0, x, mod,
                                            out, N, HW, C, eps, slope, s);
  return static_cast<int>(cudaGetLastError());
}
