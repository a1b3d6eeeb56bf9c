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
//   * instance (per sample and channel over H*W, the encoder's norm).
// Training adds batch statistics (per channel over N*H*W, then the affine
// kernel), the instance kernel's statistics written out, and the backward
// of both: see "training" below.
//
// Bound: device-memory bytes.  Each mode must read x once (and the 2C
// modulation once) and write out once, at about 1 flop per byte.
//
// The affine mode does nothing but stream: one elementwise pass, 16-byte
// vector loads and stores (8 bf16 or 2x4 f32 per thread), neighbouring
// threads on neighbouring channels so a warp touches contiguous 512-byte
// (bf16) runs, a grid-stride loop sized to fill every SM, 64-bit offsets
// (B*H*W*2C exceeds 2^31 at 256^2 b32).
//
// The instance mode needs every pixel of a (sample, channel tile) slab
// before it can write one.  The TPU kernel carried the sums across its
// sequential grid; an earlier design here kept each slab (64 channels) in
// one 256-thread block instead, and was held back by (a) too few blocks:
// B * C/64, 32 of them on 132 SMs at C=32 or 64, each walking H*W alone
// with one 16-byte load in flight per thread; (b) a second read of x from
// device memory for the apply pass, since the slabs in flight exceeded
// the 50 MB L2; (c) a float division per pixel in its Welford update; and
// (d) a log2(rows)-step merge with a __syncthreads per step.
//
// This design splits each slab along H*W over the blocks of a thread-block
// cluster (cudaLaunchKernelEx with a cluster dimension of up to 16, the
// non-portable sizes above 8 allowed).  The channel tile is one 32-byte
// sector of a pixel (16 bf16 or 8 float32 channels; 16 bytes where C forces
// it), two sectors for slabs up to 256 KB where the card stays full, which
// measured faster.  The host (deepsee_torch/ops/modnorm.py::instance_plan)
// picks, by shape before the launch, the tile, the cluster size (one wave
// of 132 blocks where the shape allows it, chunks near 64 KB) and one of
// two variants:
//   * on-chip, where a cluster's shared memory (16 x 227 KB) holds the
//     slab: each block copies its chunk of x once, with 16-byte cp.async
//     copies in four commit groups; sums it as the groups land (pass 1, the
//     chunk mean) and sums the squared deviations from that mean (pass 2);
//     and applies normalize -> modulate -> leaky ReLU from the copy.  x is
//     read from device memory once: the traffic is the bound's.  A chunk
//     too large for two blocks per SM (above ~107 KB: the 256^2 slabs)
//     keeps 8 vectors per thread (32 KB per block) in registers and the
//     rest in shared memory, so that two blocks share an SM and one's
//     cluster barrier overlaps the other's traffic.
//   * streaming, for larger slabs (a 16-channel bf16 tile at 512^2 is
//     8 MB), at the widest tile up to a 128-byte line: the statistics pass
//     streams the chunk with eight independent 16-byte loads in flight per
//     thread, each group of eight reduced exactly (two passes in registers)
//     and merged into the thread's partial; the apply pass re-reads the
//     chunk in reverse order, so that the most recently loaded pixels still
//     come from L2.  At most two reads of x: 1.5x the bound's traffic.
// Within a block, partials combine by warp shuffles and one step through
// shared memory; across the cluster, each block reads every rank's
// (count, mean, centred M2) from the others' shared memory at once
// (distributed shared memory, map_shared_rank) and merges them with Chan's
// formula in rank order, never as E[x^2] - E[x]^2.  Every block of a
// cluster merges the same partials in the same order and so holds the same
// statistics.  Offsets and H*W are 64-bit; a slab has up to 2^18 pixels at
// 512^2.
//
// What bounds it now (chip_smoke.py, H100): a block reads 32 or 64 bytes of
// each pixel, the other channel tiles' clusters the rest at other times,
// and such strided sectors stream at about half the rate of contiguous
// lines, in both directions; short grids (1.4-2.3 waves) lose to their
// tail.
//
// The elementwise arithmetic uses explicit round-to-nearest intrinsics
// (no fused multiply-add), so the kernel performs the same float32
// operations in the same order as its plain version in
// deepsee_torch/ops/modnorm.py::modnorm_plain.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

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

// ---- instance mode ---------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 64;  // channels per slab, at most: one 128-byte line of bf16
constexpr int kMaxLanes = 8;  // 16-byte vectors per pixel of a tile, at most
constexpr int kMaxCluster = 16;
constexpr int kRounds = kMaxTile * kMaxCluster / kThreads;  // (channel, rank) pairs per thread
constexpr int kGroups = 4;    // cp.async commit groups of the on-chip copy
constexpr int kInFlight = 8;  // 16-byte loads in flight per thread when streaming
constexpr int kStep = 4;      // vectors per apply step: the mod loads in flight
constexpr int kRegVectors = 8;  // on-chip vectors per thread held in registers, for large chunks

// 16 bytes global -> shared, asynchronously; the L2::128B hint lets a
// sector's miss bring its whole line, which the neighbouring channel tiles
// (other clusters, running at the same time) then find in L2.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The split cluster barrier: arrive once this block is done reading the
// others' shared memory, wait before exiting so that none of it goes away
// while another block still reads it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes of T <-> floats: 8 bf16 or 4 float32 channels.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4 raw, float* v) {
  if constexpr (std::is_same<T, float>::value) {
    v[0] = __uint_as_float(raw.x); v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z); v[3] = __uint_as_float(raw.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* v) {
  uint4 raw;
  if constexpr (std::is_same<T, float>::value) {
    raw = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  return raw;
}

// (count, mean, m2) <- Chan's merge with (nb, mb, m2b), for V channels.
template <int V>
__device__ __forceinline__ void chan_merge(float& n, float* mean, float* m2, float nb,
                                           const float* mb, const float* m2b) {
  const float nn = n + nb;
  if (nb > 0.f) {
    const float fb = nb / nn, fab = n * fb;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = mb[k] - mean[k];
      mean[k] += d * fb;
      m2[k] += m2b[k] + d * d * fab;
    }
  }
  n = nn;
}

// y <- normalize, modulate, leaky ReLU, for the V = 16 / sizeof(T) channels
// of one 16-byte vector; sc/of are the raw 16-byte scale and offset.
template <typename T, bool HAS_MOD, bool LRELU>
__device__ __forceinline__ uint4 apply16(const uint4 xr, const float* mean, const float* inv,
                                         const uint4 sc, const uint4 of, float slope) {
  constexpr int V = 16 / sizeof(T);
  float y[V];
  unpack16<T>(xr, y);
#pragma unroll
  for (int k = 0; k < V; ++k) y[k] = __fmul_rn(__fsub_rn(y[k], mean[k]), inv[k]);
  if (HAS_MOD) {
    float s[V], o[V];
    unpack16<T>(sc, s);
    unpack16<T>(of, o);
#pragma unroll
    for (int k = 0; k < V; ++k) y[k] = __fadd_rn(__fmul_rn(y[k], s[k]), o[k]);
  }
  if (LRELU) {
#pragma unroll
    for (int k = 0; k < V; ++k) y[k] = y[k] >= 0.f ? y[k] : __fmul_rn(slope, y[k]);
  }
  return pack16<T>(y);
}

// Sums v over the block's threads of one lane (tid % L, the same channels),
// warp by warp with shuffles, then over the warps in order; thread j < tile
// writes sum_j / div to out[j].  Ends with every thread past a barrier.
template <int V>
__device__ __forceinline__ void block_sum(float* v, int L, int tile, float div,
                                          float (*s_red)[kMaxTile], float* out) {
  const int tid = threadIdx.x, wl = tid & 31;
  for (int off = 16; off >= L; off >>= 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  if (wl < L) {
#pragma unroll
    for (int k = 0; k < V; ++k) s_red[tid >> 5][wl * V + k] = v[k];
  }
  __syncthreads();
  if (tid < tile) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_red[w][tid];
    out[tid] = __fdiv_rn(s, div);
  }
  __syncthreads();
}

// One block per (cluster rank, channel tile, sample): grid (cluster * C/tile,
// B), cluster (cluster, 1, 1).  Rank r takes pixels [r*HW/K, (r+1)*HW/K) of
// the slab; thread tid takes the 16-byte vectors v = tid + k*kThreads of its
// chunk, i.e. pixel v / L at channels lane*V.. of the tile, lane = tid % L
// (the same channels throughout, as L divides kThreads).  On-chip, vectors
// k < REG live in the thread's registers and vector k >= REG in shared-memory
// slot tid + (k - REG)*kThreads: with REG = kRegVectors a 128 KB chunk takes
// 96 KB of shared memory, and two blocks share an SM.
template <typename T, bool STREAM, int REG, bool HAS_MOD, bool LRELU>
__global__ void __launch_bounds__(kThreads, REG > 0 ? 2 : 1)
modnorm_instance_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                        T* __restrict__ out, float* __restrict__ mean_out,
                        float* __restrict__ rstd_out, int64_t HW, int C, int tile,
                        float eps, float slope) {
  constexpr int V = 16 / sizeof(T);       // channels per 16-byte vector
  constexpr int U = kStep;
  static_assert(!STREAM || REG == 0, "the streaming variant holds nothing");
  extern __shared__ uint4 s_x[];          // on-chip: the chunk, [pixel][tile]
  __shared__ float s_red[kWarps][kMaxTile];
  __shared__ float s_red2[kWarps][kMaxTile];
  __shared__ float s_redn[kWarps][kMaxLanes];
  __shared__ float s_part[1 + 2 * kMaxTile];  // (count, mean[tile], m2[tile]), read by the cluster
  __shared__ float s_stat[2 * kMaxTile];      // the slab's mean[tile], 1/std[tile]

  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int L = tile / V;                 // vectors per pixel: 1, 2, 4 or 8
  const int shift = __ffs(L) - 1;         // v / L = v >> shift
  const int lane = tid & (L - 1);
  const int64_t start = rank * HW / K;
  const int npix = static_cast<int>((rank + 1) * HW / K - start);
  const int nvec = npix * L;
  const int nk = tid < nvec ? (nvec - 1 - tid) / kThreads + 1 : 0;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * HW + start;  // first pixel
  const int c0 = (blockIdx.x / K) * tile + lane * V;
  const T* xt = x + base * C + c0;        // pixel q of the chunk: xt + q * C
  auto pix = [&](int k) { return static_cast<int64_t>((tid + k * kThreads) >> shift); };
  uint4 reg[REG > 0 ? REG : 1];
  const int ns = nk > REG ? nk - REG : 0;  // vectors in shared memory
  auto slot = [&](int k) { return tid + (k - REG) * kThreads; };
  auto group = [&](int g) { return REG + ns * g / kGroups; };  // first vector of group g

  if (!STREAM) {
    // the chunk into registers and shared memory, the latter in kGroups
    // commit groups
#pragma unroll
    for (int k = 0; k < REG; ++k)
      if (k < nk) reg[k] = __ldg(reinterpret_cast<const uint4*>(xt + pix(k) * C));
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      for (int k = group(g); k < group(g + 1); ++k)
        cp_async16(&s_x[slot(k)], xt + pix(k) * C);
      cp_async_commit();
    }
    // pass 1: the chunk's sum, each group as it lands (a thread reads only
    // the vectors it copied itself, so its own wait suffices)
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < REG; ++k) {
      if (k < nk) {
        float v[V];
        unpack16<T>(reg[k], v);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += v[j];
      }
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (g == 0) cp_async_wait<kGroups - 1>();
      else if (g == 1) cp_async_wait<kGroups - 2>();
      else if (g == 2) cp_async_wait<kGroups - 3>();
      else cp_async_wait<0>();
#pragma unroll 4
      for (int k = group(g); k < group(g + 1); ++k) {
        float v[V];
        unpack16<T>(s_x[slot(k)], v);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += v[j];
      }
    }
    block_sum<V>(acc, L, tile, static_cast<float>(npix), s_red, s_part + 1);
    // pass 2: squared deviations from the chunk mean
    float m[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = s_part[1 + lane * V + j];
      acc[j] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < REG; ++k) {
      if (k < nk) {
        float v[V];
        unpack16<T>(reg[k], v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = v[j] - m[j];
          acc[j] += d * d;
        }
      }
    }
#pragma unroll 4
    for (int k = REG; k < nk; ++k) {
      float v[V];
      unpack16<T>(s_x[slot(k)], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - m[j];
        acc[j] += d * d;
      }
    }
    block_sum<V>(acc, L, tile, 1.f, s_red, s_part + 1 + tile);
  } else {
    // one streaming pass: groups of kInFlight vectors, each reduced exactly
    // in registers, merged into the thread's (n, mean, m2)
    float n = 0.f, mean[V], m2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
    for (int k0 = 0; k0 < nk; k0 += kInFlight) {
      const int cnt = min(kInFlight, nk - k0);
      uint4 raw[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (u < cnt) raw[u] = __ldg(reinterpret_cast<const uint4*>(xt + pix(k0 + u) * C));
      float gm[V], gq[V], v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) gm[j] = gq[j] = 0.f;
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (u < cnt) {
          unpack16<T>(raw[u], v);
#pragma unroll
          for (int j = 0; j < V; ++j) gm[j] += v[j];
        }
      }
      const float fc = static_cast<float>(cnt);
#pragma unroll
      for (int j = 0; j < V; ++j) gm[j] /= fc;
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (u < cnt) {
          unpack16<T>(raw[u], v);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float d = v[j] - gm[j];
            gq[j] += d * d;
          }
        }
      }
      chan_merge<V>(n, mean, m2, fc, gm, gq);
    }
    // across the warp's threads of this lane, then across the warps
    for (int off = 16; off >= L; off >>= 1) {
      float mb[V], m2b[V];
      const float nb = __shfl_xor_sync(0xffffffffu, n, off);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mb[j] = __shfl_xor_sync(0xffffffffu, mean[j], off);
        m2b[j] = __shfl_xor_sync(0xffffffffu, m2[j], off);
      }
      chan_merge<V>(n, mean, m2, nb, mb, m2b);
    }
    const int wl = tid & 31;
    if (wl < L) {
      s_redn[tid >> 5][wl] = n;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s_red[tid >> 5][wl * V + j] = mean[j];
        s_red2[tid >> 5][wl * V + j] = m2[j];
      }
    }
    __syncthreads();
    if (tid < tile) {
      float cn = 0.f, cm = 0.f, cq = 0.f;
      for (int w = 0; w < kWarps; ++w)
        chan_merge<1>(cn, &cm, &cq, s_redn[w][tid / V], &s_red[w][tid], &s_red2[w][tid]);
      s_part[1 + tid] = cm;
      s_part[1 + tile + tid] = cq;
    }
  }
  if (tid == 0) s_part[0] = static_cast<float>(npix);

  // the slab's statistics: thread (j, r) reads rank r's partial of channel
  // j from that block's shared memory, all at once (kRounds channels per
  // thread); then every thread merges its channels' partials in rank order,
  // gathered by shuffles.  Every block of the cluster merges the same
  // numbers in the same order.
  cluster.sync();
  {
    const int r = tid % kMaxCluster;
    const int rounds = (tile + kThreads / kMaxCluster - 1) / (kThreads / kMaxCluster);
    float nb[kRounds], mb[kRounds], qb[kRounds];
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      const int j = tid / kMaxCluster + i * (kThreads / kMaxCluster);
      nb[i] = mb[i] = qb[i] = 0.f;
      if (i < rounds && j < tile && r < K) {
        const float* p = cluster.map_shared_rank(s_part, r);
        nb[i] = p[0];
        mb[i] = p[1 + j];
        qb[i] = p[1 + tile + j];
      }
    }
    cluster_arrive();
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      if (i >= rounds) break;
      const int j = tid / kMaxCluster + i * (kThreads / kMaxCluster);
      float n = 0.f, m = 0.f, q = 0.f;
      for (int k = 0; k < K; ++k) {
        const float nk_ = __shfl_sync(0xffffffffu, nb[i], k, kMaxCluster);
        const float mk = __shfl_sync(0xffffffffu, mb[i], k, kMaxCluster);
        const float qk = __shfl_sync(0xffffffffu, qb[i], k, kMaxCluster);
        chan_merge<1>(n, &m, &q, nk_, &mk, &qk);
      }
      if (r == 0 && j < tile) {
        const float inv =
            __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(q, static_cast<float>(HW)), eps)));
        s_stat[j] = m;
        s_stat[kMaxTile + j] = inv;
        if (mean_out != nullptr && rank == 0) {  // training: the statistics for backward
          const int64_t i = static_cast<int64_t>(blockIdx.y) * C + (blockIdx.x / K) * tile + j;
          mean_out[i] = m;
          rstd_out[i] = inv;
        }
      }
    }
  }
  __syncthreads();

  // apply, U vectors a step: from shared memory, or streaming, re-reading x
  // backwards (the chunk's tail was loaded last and is likeliest in L2)
  float mean[V], inv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = s_stat[lane * V + j];
    inv[j] = s_stat[kMaxTile + lane * V + j];
  }
  const T* mt = HAS_MOD ? mod + base * 2 * C + c0 : nullptr;  // pixel q: mt + q * 2C
  T* ot = out + base * C + c0;
#pragma unroll
  for (int k = 0; k < REG; ++k) {
    if (k < nk) {
      const int64_t q = pix(k);
      uint4 sc = {}, of = {};
      if (HAS_MOD) {
        sc = __ldcs(reinterpret_cast<const uint4*>(mt + q * 2 * C));
        of = __ldcs(reinterpret_cast<const uint4*>(mt + q * 2 * C + C));
      }
      __stcs(reinterpret_cast<uint4*>(ot + q * C),
             apply16<T, HAS_MOD, LRELU>(reg[k], mean, inv, sc, of, slope));
    }
  }
  const int steps = (ns + U - 1) / U;
  for (int i = 0; i < steps; ++i) {
    const int k0 = REG + (STREAM ? steps - 1 - i : i) * U;
    uint4 xr[U], sc[U] = {}, of[U] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < nk) {
        const int64_t q = pix(k0 + u);
        xr[u] = STREAM ? __ldcs(reinterpret_cast<const uint4*>(xt + q * C))
                       : s_x[slot(k0 + u)];
        if (HAS_MOD) {
          sc[u] = __ldcs(reinterpret_cast<const uint4*>(mt + q * 2 * C));
          of[u] = __ldcs(reinterpret_cast<const uint4*>(mt + q * 2 * C + C));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < nk)
        __stcs(reinterpret_cast<uint4*>(ot + pix(k0 + u) * C),
               apply16<T, HAS_MOD, LRELU>(xr[u], mean, inv, sc[u], of[u], slope));
    }
  }
  cluster_wait();
}


// ---- training: batch statistics and the backward ---------------------------
//
// In training, norm(x) takes its statistics from the batch: per channel over
// all N*H*W pixels ("batch", one statistics set per channel) or per sample and
// channel over H*W ("instance", B sets per channel).  The gradient of
//
//     out = lrelu?( x_hat * s + b ),  x_hat = (x - mean) * rstd
//
// with gz = d out / d z (z = x_hat * s + b, slope 0.2 below 0) and gy = gz * s
// is, over each set S,
//
//     grad_x     = rstd * (gy - mean_S(gy) - x_hat * mean_S(gy * x_hat))
//     grad_mod   = [gz * x_hat | gz]   (the 2C layout the modulation conv gave)
//
// Nothing but (mean, rstd) per set is saved by the forward: the backward
// recomputes x_hat and z from x and mod with the forward's own operations,
// so the leaky ReLU's mask is the forward's.
//
// The reductions (the batch statistics; the backward's mean_S(gy) and
// mean_S(gy * x_hat)) cut each set's pixels into chunks; a block takes one
// chunk for L 8-channel vectors (L = 1, 2, 4 or 8): thread tid reads lane
// tid % L at rows tid / L, tid / L + R, ... of its chunk (R = kThreads / L),
// 16-byte vector loads, neighbouring threads on neighbouring channels.  A
// thread's partials combine over its warp's rows by shuffles and over the
// block's warps in warp order; a second kernel combines the blocks' partials
// over the chunks in chunk order.  Every sum is taken in a fixed order, so a
// result never changes from run to run (no float atomics).  The statistics
// are (count, mean, centred M2) partials merged with Chan's formula, never
// E[x^2] - E[x]^2.  The batch forward then runs the affine kernel above with
// inv = rstd and shift = -mean * rstd: two reads of x where the bound has
// one.  The backward reads x, mod and gout twice (reduce, apply) where the
// bound reads them once.
//
// Bound: device-memory bytes, as above.

constexpr int kRowsInFlight = 8;  // pixels per thread loaded before they are reduced
constexpr int kTileChannels = kMaxLanes * kVec;  // channels per block, at most

template <typename T>
__global__ void __launch_bounds__(kThreads)
batch_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part, int64_t P,
                           int C, int L, int64_t chunk) {
  __shared__ float s_n[kWarps][kMaxLanes];
  __shared__ float s_mean[kWarps][kTileChannels];
  __shared__ float s_m2[kWarps][kTileChannels];
  const int tid = threadIdx.x, lane = tid % L, R = kThreads / L;
  const int c0 = blockIdx.y * L * kVec;
  const int64_t start = blockIdx.x * chunk;
  const int64_t end = start + chunk < P ? start + chunk : P;
  const T* xs = x + c0 + lane * kVec;
  float n = 0.f, mean[kVec], m2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) mean[j] = m2[j] = 0.f;
  for (int64_t p0 = start + tid / L; p0 < end; p0 += static_cast<int64_t>(R) * kRowsInFlight) {
    float v[kRowsInFlight][kVec];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int64_t p = p0 + static_cast<int64_t>(u) * R;
      if (p < end) {
        load8(xs + p * C, v[u]);
        cnt = u + 1;
      }
    }
    float gm[kVec], gq[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) gm[j] = gq[j] = 0.f;
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u)
      if (u < cnt) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) gm[j] += v[u][j];
      }
    const float fc = static_cast<float>(cnt);
#pragma unroll
    for (int j = 0; j < kVec; ++j) gm[j] /= fc;
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u)
      if (u < cnt) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = v[u][j] - gm[j];
          gq[j] += d * d;
        }
      }
    chan_merge<kVec>(n, mean, m2, fc, gm, gq);
  }
  for (int off = 16; off >= L; off >>= 1) {
    float mb[kVec], m2b[kVec];
    const float nb = __shfl_xor_sync(0xffffffffu, n, off);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      mb[j] = __shfl_xor_sync(0xffffffffu, mean[j], off);
      m2b[j] = __shfl_xor_sync(0xffffffffu, m2[j], off);
    }
    chan_merge<kVec>(n, mean, m2, nb, mb, m2b);
  }
  const int wl = tid & 31;
  if (wl < L) {
    s_n[tid >> 5][wl] = n;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s_mean[tid >> 5][wl * kVec + j] = mean[j];
      s_m2[tid >> 5][wl * kVec + j] = m2[j];
    }
  }
  __syncthreads();
  if (tid < L * kVec) {
    float cn = 0.f, cm = 0.f, cq = 0.f;
    for (int w = 0; w < kWarps; ++w)
      chan_merge<1>(cn, &cm, &cq, s_n[w][tid / kVec], &s_mean[w][tid], &s_m2[w][tid]);
    const int64_t total = static_cast<int64_t>(gridDim.x) * C;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * C + c0 + tid;
    part[i] = cn;
    part[total + i] = cm;
    part[2 * total + i] = cq;
  }
}

// One thread per channel: the chunks' partials in chunk order -> mean,
// rstd = 1/sqrt(biased var + eps) and shift = -mean * rstd.
__global__ void batch_stats_final_kernel(const float* __restrict__ part, int chunks, int C,
                                         float eps, float* __restrict__ mean_out,
                                         float* __restrict__ rstd_out,
                                         float* __restrict__ shift_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int64_t total = static_cast<int64_t>(chunks) * C;
  float n = 0.f, m = 0.f, q = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const int64_t j = static_cast<int64_t>(k) * C + i;
    chan_merge<1>(n, &m, &q, part[j], &part[total + j], &part[2 * total + j]);
  }
  const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(q, n), eps)));
  mean_out[i] = m;
  rstd_out[i] = r;
  shift_out[i] = __fmul_rn(-m, r);
}

// x_hat, gz and gy of 8 channels, with the forward's operations: the affine
// kernel's x * rstd + shift (batch) or the instance kernel's
// (x - mean) * rstd, then the modulation.
template <bool HAS_MOD, bool LRELU, bool INSTANCE>
__device__ __forceinline__ void backward_terms(const float* xv, const float* gv,
                                               const float* sv, const float* bv,
                                               const float* m, const float* r, float slope,
                                               float* xh, float* gz, float* gy) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float h = INSTANCE ? __fmul_rn(__fsub_rn(xv[k], m[k]), r[k])
                             : __fadd_rn(__fmul_rn(xv[k], r[k]), __fmul_rn(-m[k], r[k]));
    const float z = HAS_MOD ? __fadd_rn(__fmul_rn(h, sv[k]), bv[k]) : h;
    const float g = (LRELU && !(z >= 0.f)) ? __fmul_rn(slope, gv[k]) : gv[k];
    xh[k] = h;
    gz[k] = g;
    gy[k] = HAS_MOD ? __fmul_rn(g, sv[k]) : g;
  }
}

// Partial sums of gy and gy * x_hat per (set, chunk, channel).
template <typename T, bool HAS_MOD, bool LRELU, bool INSTANCE>
__global__ void __launch_bounds__(kThreads)
backward_partial_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                        const T* __restrict__ gout, const float* __restrict__ mean,
                        const float* __restrict__ rstd, float* __restrict__ part, int64_t HW,
                        int C, int L, int64_t chunk, float slope) {
  __shared__ float s_a[kWarps][kTileChannels];
  __shared__ float s_b[kWarps][kTileChannels];
  const int tid = threadIdx.x, lane = tid % L, R = kThreads / L;
  const int c0 = blockIdx.y * L * kVec, c = c0 + lane * kVec;
  const int64_t start = blockIdx.x * chunk;
  const int64_t end = start + chunk < HW ? start + chunk : HW;
  const int64_t base = static_cast<int64_t>(blockIdx.z) * HW;  // the set's first pixel
  float m[kVec], r[kVec];
  load8(mean + static_cast<int64_t>(blockIdx.z) * C + c, m);
  load8(rstd + static_cast<int64_t>(blockIdx.z) * C + c, r);
  float a[kVec], b[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) a[j] = b[j] = 0.f;
#pragma unroll 2
  for (int64_t p = start + tid / L; p < end; p += R) {
    const int64_t q = base + p;
    float xv[kVec], gv[kVec], sv[kVec], bv[kVec], xh[kVec], gz[kVec], gy[kVec];
    load8(x + q * C + c, xv);
    load8(gout + q * C + c, gv);
    if (HAS_MOD) {
      load8(mod + q * 2 * C + c, sv);
      load8(mod + q * 2 * C + C + c, bv);
    }
    backward_terms<HAS_MOD, LRELU, INSTANCE>(xv, gv, sv, bv, m, r, slope, xh, gz, gy);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      a[j] += gy[j];
      b[j] += __fmul_rn(gy[j], xh[j]);
    }
  }
  for (int off = 16; off >= L; off >>= 1) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
      b[j] += __shfl_xor_sync(0xffffffffu, b[j], off);
    }
  }
  const int wl = tid & 31;
  if (wl < L) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s_a[tid >> 5][wl * kVec + j] = a[j];
      s_b[tid >> 5][wl * kVec + j] = b[j];
    }
  }
  __syncthreads();
  if (tid < L * kVec) {
    float sa = 0.f, sb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sa += s_a[w][tid];
      sb += s_b[w][tid];
    }
    const int64_t total = static_cast<int64_t>(gridDim.z) * gridDim.x * C;
    const int64_t i = (static_cast<int64_t>(blockIdx.z) * gridDim.x + blockIdx.x) * C + c0 + tid;
    part[i] = sa;
    part[total + i] = sb;
  }
}

// One thread per (set, channel): coef = [mean_S(gy) | mean_S(gy * x_hat)].
__global__ void backward_final_kernel(const float* __restrict__ part, int chunks, int sets,
                                      int C, float count, float* __restrict__ coef) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= sets * C) return;
  const int s = i / C, c = i - s * C;
  const int64_t total = static_cast<int64_t>(sets) * chunks * C;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const int64_t j = (static_cast<int64_t>(s) * chunks + k) * C + c;
    a += part[j];
    b += part[total + j];
  }
  coef[i] = __fdiv_rn(a, count);
  coef[static_cast<int64_t>(sets) * C + i] = __fdiv_rn(b, count);
}

// grad_x and grad_mod, one elementwise pass; grid (blocks, sets), each block
// striding over its set's (pixel, 8-channel vector) pairs.
template <typename T, bool HAS_MOD, bool LRELU, bool INSTANCE>
__global__ void __launch_bounds__(kThreads)
backward_apply_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                      const T* __restrict__ gout, const float* __restrict__ mean,
                      const float* __restrict__ rstd, const float* __restrict__ coef,
                      T* __restrict__ gx, T* __restrict__ gmod, int64_t HW, int C,
                      float slope) {
  const int C8 = C / kVec;
  const int64_t total = HW * C8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t set = blockIdx.y, sc = set * C;
  const int64_t coef2 = static_cast<int64_t>(gridDim.y) * C;
  int64_t p = t / C8;
  int c8 = static_cast<int>(t - p * C8);
  const int64_t dp = stride / C8;
  const int dc = static_cast<int>(stride - dp * C8);
  for (; t < total; t += stride) {
    const int c = c8 * kVec;
    const int64_t q = set * HW + p;
    float xv[kVec], gv[kVec], sv[kVec], bv[kVec], m[kVec], r[kVec], ca[kVec], cb[kVec];
    float xh[kVec], gz[kVec], gy[kVec];
    load8(x + q * C + c, xv);
    load8(gout + q * C + c, gv);
    if (HAS_MOD) {
      load8(mod + q * 2 * C + c, sv);
      load8(mod + q * 2 * C + C + c, bv);
    }
    load8(mean + sc + c, m);
    load8(rstd + sc + c, r);
    load8(coef + sc + c, ca);
    load8(coef + coef2 + sc + c, cb);
    backward_terms<HAS_MOD, LRELU, INSTANCE>(xv, gv, sv, bv, m, r, slope, xh, gz, gy);
    float o[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      o[k] = __fmul_rn(r[k], __fsub_rn(__fsub_rn(gy[k], ca[k]), __fmul_rn(xh[k], cb[k])));
    store8(gx + q * C + c, o);
    if (HAS_MOD) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) o[k] = __fmul_rn(gz[k], xh[k]);
      store8(gmod + q * 2 * C + c, o);
      store8(gmod + q * 2 * C + C + c, gz);
    }
    p += dp;
    c8 += dc;
    if (c8 >= C8) {
      c8 -= C8;
      ++p;
    }
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

template <typename T, bool STREAM, int REG>
const void* instance_kernel(bool has_mod, bool lrelu) {
  if (has_mod)
    return lrelu ? reinterpret_cast<const void*>(modnorm_instance_kernel<T, STREAM, REG, true, true>)
                 : reinterpret_cast<const void*>(modnorm_instance_kernel<T, STREAM, REG, true, false>);
  return lrelu ? reinterpret_cast<const void*>(modnorm_instance_kernel<T, STREAM, REG, false, true>)
               : reinterpret_cast<const void*>(modnorm_instance_kernel<T, STREAM, REG, false, false>);
}

template <typename T>
const void* instance_kernel(int streaming, int regs, bool has_mod, bool lrelu) {
  if (streaming) return regs == 0 ? instance_kernel<T, true, 0>(has_mod, lrelu) : nullptr;
  if (regs == 0) return instance_kernel<T, false, 0>(has_mod, lrelu);
  return regs == kRegVectors ? instance_kernel<T, false, kRegVectors>(has_mod, lrelu) : nullptr;
}

// The kernel for (dtype, variant, flags) with its attributes set, and its
// cluster launch for the plan; null if the plan is not one the kernel takes.
const void* instance_launch(int N, int64_t HW, int C, int tile, int cluster, int smem,
                            int streaming, int regs, int dtype, bool has_mod, bool lrelu,
                            cudaStream_t stream, cudaLaunchConfig_t* cfg,
                            cudaLaunchAttribute* attr) {
  const int vec = dtype == 0 ? 4 : 8, lanes = tile / vec;
  if (tile % vec || lanes < 1 || lanes > kMaxLanes || (lanes & (lanes - 1)) ||
      tile > kMaxTile || C % tile ||
      cluster < 1 || cluster > kMaxCluster || cluster > HW || N < 1 || N > 65535)
    return nullptr;
  // on-chip, shared memory must hold the largest chunk beyond its registers
  const int64_t vectors = (HW + cluster - 1) / cluster * lanes;
  const int64_t per_thread = (vectors + kThreads - 1) / kThreads;
  const int64_t need = regs == 0 ? vectors * 16
                                 : (per_thread > regs ? per_thread - regs : 0) * kThreads * 16;
  if (!streaming && smem < need) return nullptr;
  const void* kernel = dtype == 0
                           ? instance_kernel<float>(streaming, regs, has_mod, lrelu)
                           : instance_kernel<__nv_bfloat16>(streaming, regs, has_mod, lrelu);
  if (kernel == nullptr ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      (cluster > 8 &&
       cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
           cudaSuccess))
    return nullptr;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * (C / tile), N);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return kernel;
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


// The reductions' launch: grid (chunks, C / (8 L), sets); false if the
// shape is one the kernels do not take.
bool reduce_grid(int sets, int64_t HW, int C, int L, int chunks, int64_t chunk, dim3* grid) {
  if (sets < 1 || sets > 65535 || HW < 1 || chunks < 1 || chunk < 1 ||
      chunk * chunks < HW || (chunks - 1) * chunk >= HW ||
      (L != 1 && L != 2 && L != 4 && L != 8) || C < kVec * L || C % (kVec * L))
    return false;
  *grid = dim3(chunks, C / (kVec * L), sets);
  return true;
}

template <typename T>
void launch_batch_stats(const void* x, float* part, float* mean, float* rstd, float* shift,
                        int64_t P, int C, int L, int chunks, int64_t chunk, float eps,
                        dim3 grid, cudaStream_t stream) {
  batch_stats_partial_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), part,
                                                               P, C, L, chunk);
  batch_stats_final_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, chunks, C, eps, mean, rstd, shift);
}

template <typename T, bool HAS_MOD, bool LRELU, bool INSTANCE>
void launch_backward(const void* x, const void* mod, const void* gout, const float* mean,
                     const float* rstd, float* part, float* coef, void* gx, void* gmod,
                     int sets, int64_t HW, int C, int L, int chunks, int64_t chunk,
                     float slope, dim3 grid, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* mt = static_cast<const T*>(mod);
  const T* gt = static_cast<const T*>(gout);
  backward_partial_kernel<T, HAS_MOD, LRELU, INSTANCE><<<grid, kThreads, 0, stream>>>(
      xt, mt, gt, mean, rstd, part, HW, C, L, chunk, slope);
  const int n = sets * C;
  backward_final_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, chunks, sets, C, static_cast<float>(HW), coef);
  const int64_t want = (HW * (C / kVec) + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kThreads);
  const int64_t per_set = (cap + sets - 1) / sets;
  const int blocks = static_cast<int>(want < per_set ? want : per_set);
  backward_apply_kernel<T, HAS_MOD, LRELU, INSTANCE><<<dim3(blocks, sets), kThreads, 0, stream>>>(
      xt, mt, gt, mean, rstd, coef, static_cast<T*>(gx), static_cast<T*>(gmod), HW, C, slope);
}

template <typename T, bool M, bool R>
struct Backward {
  template <typename... A>
  static void run(bool instance, A... a) {
    if (instance) launch_backward<T, M, R, true>(a...);
    else launch_backward<T, M, R, false>(a...);
  }
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

// The instance mode with the plan of deepsee_torch/ops/modnorm.py::
// instance_plan (training: `mean` and `rstd`, float32 (N, C), receive each
// slab's statistics; null at inference): `tile` channels per slab (one or two 16-byte vectors per
// pixel), `cluster` blocks per slab, `smem` bytes of dynamic shared memory
// per block (the on-chip variant's chunk beyond `regs` 16-byte vectors per
// thread held in registers: 0 or kRegVectors), `streaming` 0 or 1.  Returns the
// launch's error, then cudaGetLastError(); cudaErrorInvalidValue for a plan
// the kernel cannot take.
extern "C" int modnorm_instance(const void* x, const void* mod, void* out, void* mean,
                                void* rstd, int N, int64_t HW, int C, int tile, int cluster,
                                int smem, int streaming, int regs, float eps, int dtype,
                                int lrelu, float slope, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* kernel = instance_launch(N, HW, C, tile, cluster, smem, streaming, regs, dtype,
                                       mod != nullptr, lrelu != 0,
                                       static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (kernel == nullptr) {
    cudaGetLastError();
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&x, &mod, &out, &mean, &rstd, &HW, &C, &tile, &eps, &slope};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, kernel, args);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// How many clusters of the plan's launch the card holds at once, or -1: a
// measurement aid.
extern "C" int modnorm_instance_clusters(int N, int64_t HW, int C, int tile, int cluster,
                                         int smem, int streaming, int regs, int dtype,
                                         int has_mod, int lrelu) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* kernel = instance_launch(N, HW, C, tile, cluster, smem, streaming, regs, dtype,
                                       has_mod != 0, lrelu != 0, nullptr, &cfg, &attr);
  int n = -1;
  if (kernel == nullptr || cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    n = -1;
  cudaGetLastError();
  return n;
}

// Training, batch statistics: per channel over the P = N*H*W pixels,
// float32 mean, rstd and shift = -mean * rstd, for the affine kernel to
// apply.  `part` is scratch of 3 * chunks * C floats; the plan (L, chunks,
// chunk) is deepsee_torch/ops/modnorm.py::reduce_plan's for one set.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan the
// kernels do not take.
extern "C" int modnorm_batch_stats(const void* x, void* part, void* mean, void* rstd,
                                   void* shift, int64_t P, int C, int L, int chunks,
                                   int64_t chunk, float eps, int dtype, void* stream) {
  dim3 grid;
  if (!reduce_grid(1, P, C, L, chunks, chunk, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  float* sh = static_cast<float*>(shift);
  if (dtype == 0)
    launch_batch_stats<float>(x, p, m, r, sh, P, C, L, chunks, chunk, eps, grid, s);
  else
    launch_batch_stats<__nv_bfloat16>(x, p, m, r, sh, P, C, L, chunks, chunk, eps, grid, s);
  return static_cast<int>(cudaGetLastError());
}

// Training, the backward of either mode: grad_x (x's layout) and, where `mod`
// is given, grad_mod (its 2C layout) from x, mod, gout and the forward's
// float32 (sets, C) mean and rstd.  `instance` picks the forward's x_hat
// formula.  `part` is scratch of 2 * sets * chunks * C floats, `coef` of
// 2 * sets * C.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// plan the kernels do not take.
extern "C" int modnorm_backward(const void* x, const void* mod, const void* gout,
                                const void* mean, const void* rstd, void* part, void* coef,
                                void* gx, void* gmod, int sets, int64_t HW, int C, int L,
                                int chunks, int64_t chunk, int instance, int dtype, int lrelu,
                                float slope, void* stream) {
  dim3 grid;
  if (!reduce_grid(sets, HW, C, L, chunks, chunk, &grid) || (mod != nullptr) != (gmod != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(part);
  float* cf = static_cast<float*>(coef);
  if (dtype == 0)
    dispatch_flags<float, Backward>(mod != nullptr, lrelu != 0, instance != 0, x, mod, gout, m,
                                    r, p, cf, gx, gmod, sets, HW, C, L, chunks, chunk, slope,
                                    grid, s);
  else
    dispatch_flags<__nv_bfloat16, Backward>(mod != nullptr, lrelu != 0, instance != 0, x, mod,
                                            gout, m, r, p, cf, gx, gmod, sets, HW, C, L,
                                            chunks, chunk, slope, grid, s);
  return static_cast<int>(cudaGetLastError());
}
