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
// Training adds batch statistics (per channel over N*H*W, one cooperative
// launch), the instance kernel's statistics written out, and the backward
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
// picks, by shape before the launch, the tile, the cluster size (chunks
// near 64 KB, clusters of 2 to 4 where the slabs are few and small, as the
// H100 measured fastest) and one of three variants:
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
//   * grid (the training batch's 128^2 and 256^2 trunk slabs, whose few
//     slabs leave most of a one-wave grid of clusters idle): the batch
//     forward's kernel over the N samples' statistics sets (see "INSTANCE"
//     there), runs of ~64 KB merged across one grid barrier.
// Where the previous kernel on the stream allows it, the launch is a
// programmatic dependent one: its blocks start during that kernel's tail and
// wait (griddepcontrol.wait) before touching device memory.
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

#include "phase_marks.cuh"

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
constexpr int kMergeLoads = 8;  // runs' partials a thread loads at once before merging them
constexpr int kMaxRunsPerSet = 46340;  // (runs per set)^2 < 2^31: the merge's run sizes

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

// Under a programmatic dependent launch (the instance forward's, where the
// wrapper asks for it) the block may start while the previous kernel on the
// stream finishes: wait for that grid's completion and memory before the
// first access to device memory.  Without the launch attribute a no-op.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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
// of one 16-byte vector; sc/of are the raw 16-byte scale and offset.  The
// instance mode normalizes as (x - p) * q with p = mean, q = 1/std; AFFINE
// (batch statistics) as the affine kernel does, x * p + q with p = rstd,
// q = -mean * rstd.
template <typename T, bool AFFINE, bool HAS_MOD, bool LRELU>
__device__ __forceinline__ uint4 apply16(const uint4 xr, const float* p, const float* q,
                                         const uint4 sc, const uint4 of, float slope) {
  constexpr int V = 16 / sizeof(T);
  float y[V];
  unpack16<T>(xr, y);
#pragma unroll
  for (int k = 0; k < V; ++k)
    y[k] = AFFINE ? __fadd_rn(__fmul_rn(y[k], p[k]), q[k]) : __fmul_rn(__fsub_rn(y[k], p[k]), q[k]);
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
  wait_prior_grid();
  PHASE_MARK(0);
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
    PHASE_MARK(1);
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
    PHASE_MARK(2);
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
  PHASE_MARK(3);
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
    PHASE_MARK(4);
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
             apply16<T, false, HAS_MOD, LRELU>(reg[k], mean, inv, sc, of, slope));
    }
  }
  PHASE_MARK(5);
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
               apply16<T, false, HAS_MOD, LRELU>(xr[u], mean, inv, sc[u], of[u], slope));
    }
  }
  PHASE_MARK(6);
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
// Every sum is taken in a fixed order, so a result never changes from run to
// run (no float atomics).  Bound: device-memory bytes, as above.
//
// The batch forward (modnorm_batch_kernel) is one cooperative launch of at
// most the blocks the card holds at once (cudaLaunchKernelEx with
// cudaLaunchAttributeCooperative; the host's plan, deepsee_torch/ops/
// modnorm.py::batch_plan, sizes the grid from the blocks per SM that
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports).  Block i takes
// channel tile i % (C / tile), up to one 128-byte line of each pixel, over
// run i / (C / tile) of the N*H*W pixels, so that the blocks in flight
// together read whole pixel rows.  On the H100 a three-launch design
// (statistics partials, a serial merge, the affine kernel) lost half its
// time in the statistics: the partials streamed at 17-47 % of the HBM rate
// (one group of loads in flight per thread, then a dependent chain with
// divisions) and the one-thread-per-channel merge took as long again.
// Here:
//   * the run's first pixels, as many as the block's shared memory holds,
//     are copied there once with cp.async (all in flight at once); the rest
//     streams through registers, a group of kInFlight 16-byte loads per
//     thread issued while the previous group is summed;
//   * a thread sums d = x - K and d * d (the shifted-data form: no division
//     in the loop), with K the mean of kThreads / L pixels spread evenly
//     over the run; the sum of d * d exceeds the centred M2 by
//     n ((K - mean) / sigma)^2 sigma^2, so K is a sample mean and not one
//     pixel, which may lie far from the mean (an image's corner after zero
//     padding); the block turns its sums into the run's (mean, centred M2)
//     once;
//   * the runs' partials go to device memory, the grid synchronizes
//     (cg::this_grid().sync()), and every block of a channel tile merges its
//     tile's runs with Chan's formula in run order (never E[x^2] - E[x]^2),
//     so all of them hold the same statistics;
//   * the apply pass, x * rstd + (-mean * rstd) as the affine kernel and
//     the backward compute it, reads the streamed pixels again in reverse
//     (the newest lines come from L2) and the rest from shared memory.
// Where every run fits its block's shared memory (32^2 and 64^2 at batch 4
// for 512 bf16 channels), x leaves device memory once.
//
// Across ranks (data parallelism, deepsee_torch/ops/modnorm.py::
// SyncModnormTrain) the batch statistics cover the global batch, as the JAX
// package's batch norm does under jit over a sharded batch.  A kernel cannot
// wait for another process, so the forward splits at its grid barrier
// around one collective: launch A (modnorm_batch_kernel with STATS_ONLY) is
// the statistics half, runs merged inside the launch as above, and writes
// the rank's (count, mean, M2); the caller all-reduces the [world][3][C]
// rows (a few KB); launch B (modnorm_batch_apply_kernel) merges the rows in
// rank order with Chan's formula and applies as the affine kernel does.
// Launch A reads x once; launch B reads x and mod and writes out, the
// affine mode's traffic.  The backward splits likewise: the reduction and
// its chunk-order sums (launch_backward_sums), an all-reduce of the [2][C]
// sums, and the elementwise pass with the sums divided by the world's pixel
// count (launch_backward_apply).  Each rank's gout is the gradient of its own
// mean loss; divided by the global count, each rank's share comes out world
// times too large, and the caller's average of the ranks' gradients undoes
// it (everything here is linear in gout).
//
// The instance backward (modnorm_instance_backward_kernel) mirrors the
// instance forward: one cluster launch, each (sample, channel tile) slab
// split along H*W over the blocks of a cluster (deepsee_torch/ops/
// modnorm.py::instance_backward_plan).  On-chip, each block copies its
// chunk of x and gout (and mod) into shared memory once with cp.async, sums
// gy and gy * x_hat from the copy, adds the ranks' sums in rank order
// through distributed shared memory, and writes grad_x and grad_mod from
// the copy: the traffic is the bound's.  Slabs whose chunks would not leave
// room for two blocks per SM stream, and read the chunk again in reverse
// for the apply pass (the newest lines come from L2).  Where the slabs are
// small (the discriminator's) the launch is bound by latency, not bytes:
// one cluster launch where the earlier design made three.
//
// The batch backward cuts the N*H*W pixels into chunks; a block takes one
// chunk for L 8-channel vectors (L = 1, 2, 4 or 8): thread tid reads lane
// tid % L at rows tid / L, tid / L + R, ... of its chunk (R = kThreads / L),
// 16-byte vector loads, neighbouring threads on neighbouring channels.  A
// thread's partials combine over its warp's rows by shuffles and over the
// block's warps in warp order; a second kernel adds the blocks' partials in
// chunk order, and a third writes the gradients.  It reads x, mod and gout
// twice (reduce, apply) where the bound reads them once: 11 tensor passes
// where the bound has 7 with mod.

constexpr int kTileChannels = kMaxLanes * kVec;  // channels per block, at most

// The batch forward.  Grid: runs * (C / tile) blocks, launched cooperatively;
// block i takes channel tile ct = i % (C / tile) over the pixels
// [r * P / runs, (r + 1) * P / runs) of x, r = i / (C / tile).  Thread tid
// takes the run's 16-byte vectors v = tid + k * kThreads (pixel v / L at
// channels lane * V.. of the tile, lane = tid % L); the run's first
// `resident` vectors live in shared-memory slot v.  `part` receives each
// run's (mean, M2) per channel: [2][runs][C].  STATS_ONLY (launch A of the
// cross-rank forward) stops after the merge of the runs and writes the
// launch's (count, mean, M2) per channel to stats_out, [3][1][C]; the other
// outputs are not touched.
//
// INSTANCE is the instance forward's "grid" variant (ops/modnorm.py::
// instance_plan): the same kernel over `sets` = N statistics sets of H*W
// pixels each (the batch forward has one set of all P), each set cut into
// runs / sets runs; a block merges the runs of its own set, writes the
// set's (mean, rstd) to mean_out / rstd_out [N][C] (where given) and
// normalizes as the instance kernel does, (x - mean) * rstd.  With one run
// per set there is nothing to merge: no partials, no grid barrier, and the
// launch need not be cooperative.
template <typename T, bool HAS_MOD, bool LRELU, bool STATS_ONLY, bool INSTANCE = false>
__global__ void __launch_bounds__(kThreads, 2)
modnorm_batch_kernel(const T* __restrict__ x, const T* __restrict__ mod, T* __restrict__ out,
                     float* __restrict__ part, float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, float* __restrict__ stats_out, int64_t P,
                     int C, int tile, int runs, int sets, int resident, float eps, float slope) {
  constexpr int V = 16 / sizeof(T);        // channels per 16-byte vector
  constexpr int U = kStep;
  extern __shared__ uint4 s_x[];           // the run's first `resident` vectors
  __shared__ float s_red[kWarps][kMaxTile];
  __shared__ float s_sum[2][kMaxTile];     // the block's sums of d and d * d per channel
  __shared__ float s_grp[3][kThreads];     // (count, mean, M2) of each group of runs
  __shared__ float s_stat[2 * kMaxTile];   // rstd[tile], -mean * rstd[tile]

  const int tid = threadIdx.x;
  const int tiles = C / tile;
  const int ct = blockIdx.x % tiles, r = blockIdx.x / tiles;
  const int L = tile / V;                  // vectors per pixel: 1, 2, 4 or 8
  const int shift = __ffs(L) - 1;
  const int lane = tid & (L - 1);
  // run r is run rr of its set; a set is SP consecutive pixels cut into R runs
  const int R = runs / sets, set = r / R, rr = r - set * R;
  const int64_t SP = P / sets;
  const int64_t start = set * SP + rr * SP / R;
  const int npix = static_cast<int>((rr + 1) * SP / R - rr * SP / R);
  const bool merged = !(INSTANCE && R == 1);  // partials merged across a grid barrier
  const int nvec = npix * L;
  const int nk = tid < nvec ? (nvec - 1 - tid) / kThreads + 1 : 0;
  const int rv = min(nvec, resident);
  const int nks = tid < rv ? (rv - 1 - tid) / kThreads + 1 : 0;  // k < nks: in shared memory
  const int c0 = ct * tile + lane * V;
  const T* xt = x + start * C + c0;        // pixel q of the run: xt + q * C
  auto pix = [&](int k) { return static_cast<int64_t>((tid + k * kThreads) >> shift); };
  auto slot = [&](int k) { return tid + k * kThreads; };
  auto group = [&](int g) { return nks * g / kGroups; };  // first vector of commit group g
  if (INSTANCE) wait_prior_grid();
  PHASE_MARK(7);

  // sums of d = x - K and d * d, K the mean of kThreads / L pixels spread
  // evenly over the run (thread tid loads pixel (tid / L) * npix / (kThreads
  // / L)).  The pilot pixels load first, so that K is known when the first
  // group of the run lands rather than after the last.
  const int pilot = kThreads / L;
  const uint4 pilot_raw = __ldg(reinterpret_cast<const uint4*>(
      xt + static_cast<int64_t>(tid >> shift) * npix / pilot * C));
  // the resident vectors: every copy in flight at once, in kGroups groups
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    for (int k = group(g); k < group(g + 1); ++k) cp_async16(&s_x[slot(k)], xt + pix(k) * C);
    cp_async_commit();
  }
  // the first group of streamed loads, in flight while K is found
  uint4 cur[kInFlight] = {};
  if (nks < nk) {
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (nks + u < nk) cur[u] = __ldg(reinterpret_cast<const uint4*>(xt + pix(nks + u) * C));
  }
  float K[V], s1[V], s2[V];
  unpack16<T>(pilot_raw, K);
  block_sum<V>(K, L, tile, static_cast<float>(pilot), s_red, s_stat);
  PHASE_MARK(8);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    K[j] = s_stat[lane * V + j];
    s1[j] = s2[j] = 0.f;
  }
  auto add = [&](const uint4 raw) {
    float v[V];
    unpack16<T>(raw, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - K[j];
      s1[j] += d;
      s2[j] = fmaf(d, d, s2[j]);
    }
  };
  // the streamed vectors: the next group's loads in flight while one is summed
  if (nks < nk) {
    uint4 nxt[kInFlight] = {};
    for (int k0 = nks; k0 < nk; k0 += kInFlight) {
      const int kn = k0 + kInFlight;
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (kn + u < nk) nxt[u] = __ldg(reinterpret_cast<const uint4*>(xt + pix(kn + u) * C));
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (k0 + u < nk) add(cur[u]);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) cur[u] = nxt[u];
    }
  }
  PHASE_MARK(9);
  // the resident vectors, each group as it lands (a thread reads only the
  // vectors it copied itself, so its own wait suffices)
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (g == 0) cp_async_wait<kGroups - 1>();
    else if (g == 1) cp_async_wait<kGroups - 2>();
    else if (g == 2) cp_async_wait<kGroups - 3>();
    else cp_async_wait<0>();
#pragma unroll 4
    for (int k = group(g); k < group(g + 1); ++k) add(s_x[slot(k)]);
  }
  block_sum<V>(s1, L, tile, 1.f, s_red, s_sum[0]);
  block_sum<V>(s2, L, tile, 1.f, s_red, s_sum[1]);
  PHASE_MARK(10);
  float own_m = 0.f, own_q = 0.f;
  if (tid < tile) {  // the run's mean and centred M2 of channel tid
    const int c = ct * tile + tid;
    const float n = static_cast<float>(npix), a = s_sum[0][tid];
    const float da = a / n;
    own_m = s_stat[tid] + da;
    own_q = fmaxf(s_sum[1][tid] - a * da, 0.f);
    if (merged) {
      part[static_cast<int64_t>(r) * C + c] = own_m;
      part[static_cast<int64_t>(runs + r) * C + c] = own_q;
    }
  }
  if (merged) cg::this_grid().sync();
  PHASE_MARK(11);

  // the set's runs of the tile merged in run order: thread (g, j) merges
  // runs [g * R / G, (g + 1) * R / G) of channel j, then thread j the G
  // groups.  Every block of the set and tile does the same, so all hold the
  // same statistics.
  {
    const int G = kThreads / tile, j = tid % tile, g = tid / tile;
    const int c = ct * tile + j;
    float n = 0.f, m = 0.f, q = 0.f;
    if (!merged) {  // one run: its own statistics (thread j < tile holds channel j's)
      if (g == 0) {
        n = static_cast<float>(npix);
        m = own_m;
        q = own_q;
      }
    } else {  // kMergeLoads runs' partials in flight at once, then merged in order
      // run i's pixels, (i + 1) * SP / R - i * SP / R, in 32-bit arithmetic:
      // with SP = q * R + rem, i * SP / R = i * q + i * rem / R
      const int64_t q_run = SP / R;
      const int rem = static_cast<int>(SP - q_run * R);
      const int hi = (g + 1) * R / G;
      for (int i0 = g * R / G; i0 < hi; i0 += kMergeLoads) {
        float mi[kMergeLoads], qi[kMergeLoads];
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          if (i0 + u < hi) {
            const int64_t run = static_cast<int64_t>(set) * R + i0 + u;
            mi[u] = __ldcg(part + run * C + c);
            qi[u] = __ldcg(part + (runs + run) * C + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          if (i0 + u < hi) {
            const int i = i0 + u;
            const float ni = static_cast<float>(q_run + (i + 1) * rem / R - i * rem / R);
            chan_merge<1>(n, &m, &q, ni, &mi[u], &qi[u]);
          }
        }
      }
    }
    s_grp[0][tid] = n;
    s_grp[1][tid] = m;
    s_grp[2][tid] = q;
    __syncthreads();
    if (tid < tile) {
      n = m = q = 0.f;
      for (int h = 0; h < G; ++h)
        chan_merge<1>(n, &m, &q, s_grp[0][h * tile + tid], &s_grp[1][h * tile + tid],
                      &s_grp[2][h * tile + tid]);
      if (STATS_ONLY) {  // [3][sets][C], one set: the batch's
        if (rr == 0) {
          const int64_t o = static_cast<int64_t>(set) * C + c;
          const int64_t NC = static_cast<int64_t>(sets) * C;
          stats_out[o] = n;
          stats_out[NC + o] = m;
          stats_out[2 * NC + o] = q;
        }
      } else {
        const float rs =
            __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(q, static_cast<float>(SP)), eps)));
        if (INSTANCE) {  // (x - mean) * rstd
          s_stat[tid] = m;
          s_stat[kMaxTile + tid] = rs;
        } else {  // x * rstd + (-mean * rstd)
          s_stat[tid] = rs;
          s_stat[kMaxTile + tid] = __fmul_rn(-m, rs);
        }
        if (rr == 0 && mean_out != nullptr) {
          mean_out[static_cast<int64_t>(set) * C + c] = m;
          rstd_out[static_cast<int64_t>(set) * C + c] = rs;
        }
      }
    }
    if (STATS_ONLY) return;
    __syncthreads();
    PHASE_MARK(12);
  }

  // apply: the streamed vectors again, newest first (they come from L2),
  // then the resident ones from shared memory
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = s_stat[lane * V + j];
    b[j] = s_stat[kMaxTile + lane * V + j];
  }
  const T* mt = HAS_MOD ? mod + start * 2 * C + c0 : nullptr;  // pixel q: mt + q * 2C
  T* ot = out + start * C + c0;
  auto apply_step = [&](int k0, int end, bool resident_step) {
    uint4 xr[U], sc[U] = {}, of[U] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < end) {
        const int64_t q = pix(k0 + u);
        xr[u] = resident_step ? s_x[slot(k0 + u)]
                              : __ldcs(reinterpret_cast<const uint4*>(xt + q * C));
        if (HAS_MOD) {
          sc[u] = __ldcs(reinterpret_cast<const uint4*>(mt + q * 2 * C));
          of[u] = __ldcs(reinterpret_cast<const uint4*>(mt + q * 2 * C + C));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < end)
        __stcs(reinterpret_cast<uint4*>(ot + pix(k0 + u) * C),
               apply16<T, !INSTANCE, HAS_MOD, LRELU>(xr[u], a, b, sc[u], of[u], slope));
    }
  };
  const int steps = (nk - nks + U - 1) / U;
  for (int i = steps - 1; i >= 0; --i) apply_step(nks + i * U, nk, false);
  PHASE_MARK(13);
  for (int k0 = 0; k0 < nks; k0 += U) apply_step(k0, nks, true);
  PHASE_MARK(14);
}

// Launch B of the cross-rank batch forward.  `stats` holds each rank's
// (count, mean, M2) per channel, [world][3][C], summed over the ranks by an
// all-reduce (each rank wrote its own row into zeros).  Every block merges
// the rows of all C channels in rank order with Chan's formula, as the
// one-launch kernel merges its runs, into shared memory (rstd, -mean * rstd);
// block 0 writes the merged (mean, rstd) for the backward and the running
// statistics.  Then one elementwise pass as the affine kernel's, with the
// merged statistics: out = lrelu?((x * rstd + (-mean * rstd)) * scale +
// offset).  Every rank merges the same rows in the same order, so all hold
// the same statistics without a second collective.
template <typename T, bool HAS_MOD, bool LRELU>
__global__ void __launch_bounds__(kThreads)
modnorm_batch_apply_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                           const float* __restrict__ stats, int world, T* __restrict__ out,
                           float* __restrict__ mean_out, float* __restrict__ rstd_out,
                           int64_t P, int C, float eps, float slope) {
  extern __shared__ float s_ab[];          // rstd[C], then -mean * rstd[C]
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float n = 0.f, m = 0.f, q = 0.f;
    for (int r = 0; r < world; ++r) {
      const float* row = stats + static_cast<int64_t>(r) * 3 * C;
      chan_merge<1>(n, &m, &q, row[c], &row[C + c], &row[2 * C + c]);
    }
    const float rs = __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(q, n), eps)));
    s_ab[c] = rs;
    s_ab[C + c] = __fmul_rn(-m, rs);
    if (blockIdx.x == 0) {
      mean_out[c] = m;
      rstd_out[c] = rs;
    }
  }
  __syncthreads();
  const int C8 = C / kVec;
  const int64_t total = P * C8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  int64_t p = t / C8;
  int c8 = static_cast<int>(t - p * C8);
  const int64_t dp = stride / C8;
  const int dc = static_cast<int>(stride - dp * C8);
  for (; t < total; t += stride) {
    const int c = c8 * kVec;
    float y[kVec];
    load8(x + p * C + c, y);
#pragma unroll
    for (int k = 0; k < kVec; ++k) y[k] = __fadd_rn(__fmul_rn(y[k], s_ab[c + k]), s_ab[C + c + k]);
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

// x_hat, gz and gy of V channels, with the forward's operations: the affine
// kernel's x * rstd + (-mean * rstd) (batch) or the instance kernel's
// (x - mean) * rstd, then the modulation.
template <int V, bool HAS_MOD, bool LRELU, bool INSTANCE>
__device__ __forceinline__ void backward_terms(const float* xv, const float* gv,
                                               const float* sv, const float* bv,
                                               const float* m, const float* r, float slope,
                                               float* xh, float* gz, float* gy) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float h = INSTANCE ? __fmul_rn(__fsub_rn(xv[k], m[k]), r[k])
                             : __fadd_rn(__fmul_rn(xv[k], r[k]), __fmul_rn(-m[k], r[k]));
    const float z = HAS_MOD ? __fadd_rn(__fmul_rn(h, sv[k]), bv[k]) : h;
    const float g = (LRELU && !(z >= 0.f)) ? __fmul_rn(slope, gv[k]) : gv[k];
    xh[k] = h;
    gz[k] = g;
    gy[k] = HAS_MOD ? __fmul_rn(g, sv[k]) : g;
  }
}

// The instance backward.  Grid (cluster * C / tile, B), cluster (cluster, 1,
// 1); blocks and threads as modnorm_instance_kernel's.  Tensor t of (x, gout,
// scale, offset) has the thread's vector k in shared-memory slot
// t * stride + tid + k * kThreads (on-chip), stride = the largest chunk's
// vectors per thread times kThreads.  On-chip without mod, registers are
// held to three blocks per SM (chunks up to ~64 KB), so that one block's
// cluster barrier overlaps the others' traffic.
template <typename T, bool STREAM, bool HAS_MOD, bool LRELU>
__global__ void __launch_bounds__(kThreads, STREAM || HAS_MOD ? 2 : 3)
modnorm_instance_backward_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                                 const T* __restrict__ gout, const float* __restrict__ mean,
                                 const float* __restrict__ rstd, T* __restrict__ gx,
                                 T* __restrict__ gmod, int64_t HW, int C, int tile,
                                 float slope) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NT = HAS_MOD ? 4 : 2;      // tensors read per pixel
  // vectors a step, U * NT loads in flight: streaming without mod keeps 16
  // per thread (its grids hold about one block per SM)
  constexpr int U = STREAM && !HAS_MOD ? 2 * kStep : 2;
  extern __shared__ uint4 s_x[];
  __shared__ float s_red[kWarps][kMaxTile];
  __shared__ float s_red2[kWarps][kMaxTile];
  __shared__ float s_part[2 * kMaxTile];   // sums of gy and gy * x_hat, read by the cluster
  __shared__ float s_coef[2 * kMaxTile];   // their means over the slab

  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int L = tile / V;
  const int shift = __ffs(L) - 1;
  const int lane = tid & (L - 1);
  const int64_t start = rank * HW / K;
  const int npix = static_cast<int>((rank + 1) * HW / K - start);
  const int nvec = npix * L;
  const int nk = tid < nvec ? (nvec - 1 - tid) / kThreads + 1 : 0;
  const int stride =
      static_cast<int>(((HW + K - 1) / K * L + kThreads - 1) / kThreads * kThreads);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * HW + start;  // first pixel
  const int c0 = (blockIdx.x / K) * tile + lane * V;
  auto pix = [&](int k) { return static_cast<int64_t>((tid + k * kThreads) >> shift); };
  auto slot = [&](int t, int k) { return t * stride + tid + k * kThreads; };
  auto group = [&](int g) { return nk * g / kGroups; };
  auto at = [&](int t, int k) {  // tensor t's vector k in device memory
    const int64_t q = base + pix(k);
    const T* p = t == 0 ? x + q * C : t == 1 ? gout + q * C : mod + q * 2 * C + (t == 3 ? C : 0);
    return reinterpret_cast<const uint4*>(p + c0);
  };
  float m[V], r[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = mean[static_cast<int64_t>(blockIdx.y) * C + c0 + j];
    r[j] = rstd[static_cast<int64_t>(blockIdx.y) * C + c0 + j];
  }
  auto terms = [&](const uint4* raw, float* h, float* gz, float* gy) {
    float xv[V], gv[V], sv[V], bv[V];
    unpack16<T>(raw[0], xv);
    unpack16<T>(raw[1], gv);
    if constexpr (HAS_MOD) {
      unpack16<T>(raw[2], sv);
      unpack16<T>(raw[3], bv);
    }
    backward_terms<V, HAS_MOD, LRELU, true>(xv, gv, sv, bv, m, r, slope, h, gz, gy);
  };

  // the sums of gy and gy * x_hat over the chunk
  float sa[V], sb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sa[j] = sb[j] = 0.f;
  auto accumulate = [&](const uint4* raw) {
    float h[V], gz[V], gy[V];
    terms(raw, h, gz, gy);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sa[j] += gy[j];
      sb[j] += __fmul_rn(gy[j], h[j]);
    }
  };
  if (!STREAM) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      for (int k = group(g); k < group(g + 1); ++k) {
#pragma unroll
        for (int t = 0; t < NT; ++t) cp_async16(&s_x[slot(t, k)], at(t, k));
      }
      cp_async_commit();
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (g == 0) cp_async_wait<kGroups - 1>();
      else if (g == 1) cp_async_wait<kGroups - 2>();
      else if (g == 2) cp_async_wait<kGroups - 3>();
      else cp_async_wait<0>();
      for (int k = group(g); k < group(g + 1); ++k) {
        uint4 raw[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) raw[t] = s_x[slot(t, k)];
        accumulate(raw);
      }
    }
  } else {
    for (int k0 = 0; k0 < nk; k0 += U) {
      uint4 raw[U][NT];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u < nk) {
#pragma unroll
          for (int t = 0; t < NT; ++t) raw[u][t] = __ldg(at(t, k0 + u));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k0 + u < nk) accumulate(raw[u]);
    }
  }
  // both sums over the block at once: shuffles within the warp, then the
  // warps in order (one barrier pair where block_sum would take two)
  for (int off = 16; off >= L; off >>= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sa[j] += __shfl_xor_sync(0xffffffffu, sa[j], off);
      sb[j] += __shfl_xor_sync(0xffffffffu, sb[j], off);
    }
  }
  if ((tid & 31) < L) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s_red[tid >> 5][(tid & 31) * V + j] = sa[j];
      s_red2[tid >> 5][(tid & 31) * V + j] = sb[j];
    }
  }
  __syncthreads();
  if (tid < tile) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += s_red[w][tid];
      b += s_red2[w][tid];
    }
    s_part[tid] = a;
    s_part[tile + tid] = b;
  }

  // the slab's sums: every rank's, read from its shared memory all at once,
  // added in rank order (every block of the cluster gets the same numbers)
  cluster.sync();
  if (tid < 2 * tile) {
    float v[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      v[k] = k < K ? cluster.map_shared_rank(s_part, k)[tid] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < K) s += v[k];
    s_coef[tid] = __fdiv_rn(s, static_cast<float>(HW));
  }
  cluster_arrive();
  __syncthreads();

  // grad_x and grad_mod: from shared memory, or streaming, re-reading the
  // chunk backwards (its tail was loaded last and is likeliest in L2)
  float ca[V], cb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ca[j] = s_coef[lane * V + j];
    cb[j] = s_coef[tile + lane * V + j];
  }
  T* gxt = gx + base * C + c0;
  T* gmt = HAS_MOD ? gmod + base * 2 * C + c0 : nullptr;
  const int steps = (nk + U - 1) / U;
  for (int i = 0; i < steps; ++i) {
    const int k0 = (STREAM ? steps - 1 - i : i) * U;
    uint4 raw[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < nk) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
          raw[u][t] = STREAM ? __ldcs(at(t, k0 + u)) : s_x[slot(t, k0 + u)];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u >= nk) continue;
      float h[V], gz[V], gy[V], o[V];
      terms(raw[u], h, gz, gy);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = __fmul_rn(r[j], __fsub_rn(__fsub_rn(gy[j], ca[j]), __fmul_rn(h[j], cb[j])));
      const int64_t q = pix(k0 + u);
      __stcs(reinterpret_cast<uint4*>(gxt + q * C), pack16<T>(o));
      if constexpr (HAS_MOD) {
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = __fmul_rn(gz[j], h[j]);
        __stcs(reinterpret_cast<uint4*>(gmt + q * 2 * C), pack16<T>(o));
        __stcs(reinterpret_cast<uint4*>(gmt + q * 2 * C + C), pack16<T>(gz));
      }
    }
  }
  cluster_wait();
}

// The batch backward's partial sums of gy and gy * x_hat per (chunk, channel).
template <typename T, bool HAS_MOD, bool LRELU>
__global__ void __launch_bounds__(kThreads)
backward_partial_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                        const T* __restrict__ gout, const float* __restrict__ mean,
                        const float* __restrict__ rstd, float* __restrict__ part, int64_t P,
                        int C, int L, int64_t chunk, float slope) {
  __shared__ float s_a[kWarps][kTileChannels];
  __shared__ float s_b[kWarps][kTileChannels];
  const int tid = threadIdx.x, lane = tid % L, R = kThreads / L;
  const int c0 = blockIdx.y * L * kVec, c = c0 + lane * kVec;
  const int64_t start = blockIdx.x * chunk;
  const int64_t end = start + chunk < P ? start + chunk : P;
  float m[kVec], r[kVec];
  load8(mean + c, m);
  load8(rstd + c, r);
  float a[kVec], b[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) a[j] = b[j] = 0.f;
#pragma unroll 2
  for (int64_t q = start + tid / L; q < end; q += R) {
    float xv[kVec], gv[kVec], sv[kVec], bv[kVec], xh[kVec], gz[kVec], gy[kVec];
    load8(x + q * C + c, xv);
    load8(gout + q * C + c, gv);
    if (HAS_MOD) {
      load8(mod + q * 2 * C + c, sv);
      load8(mod + q * 2 * C + C + c, bv);
    }
    backward_terms<kVec, HAS_MOD, LRELU, false>(xv, gv, sv, bv, m, r, slope, xh, gz, gy);
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
    const int64_t total = static_cast<int64_t>(gridDim.x) * C;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * C + c0 + tid;
    part[i] = sa;
    part[total + i] = sb;
  }
}

// One thread per channel: coef = [mean(gy) | mean(gy * x_hat)] over the chunks
// in chunk order.
__global__ void backward_final_kernel(const float* __restrict__ part, int chunks, int C,
                                      float count, float* __restrict__ coef) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int64_t total = static_cast<int64_t>(chunks) * C;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < chunks; ++k) {
    a += part[static_cast<int64_t>(k) * C + c];
    b += part[total + static_cast<int64_t>(k) * C + c];
  }
  coef[c] = __fdiv_rn(a, count);
  coef[C + c] = __fdiv_rn(b, count);
}

// grad_x and grad_mod, one elementwise pass over the (pixel, 8-channel
// vector) pairs.
template <typename T, bool HAS_MOD, bool LRELU>
__global__ void __launch_bounds__(kThreads)
backward_apply_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                      const T* __restrict__ gout, const float* __restrict__ mean,
                      const float* __restrict__ rstd, const float* __restrict__ coef,
                      T* __restrict__ gx, T* __restrict__ gmod, int64_t P, int C,
                      float slope) {
  const int C8 = C / kVec;
  const int64_t total = P * C8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  int64_t q = t / C8;
  int c8 = static_cast<int>(t - q * C8);
  const int64_t dq = stride / C8;
  const int dc = static_cast<int>(stride - dq * C8);
  for (; t < total; t += stride) {
    const int c = c8 * kVec;
    float xv[kVec], gv[kVec], sv[kVec], bv[kVec], m[kVec], r[kVec], ca[kVec], cb[kVec];
    float xh[kVec], gz[kVec], gy[kVec];
    load8(x + q * C + c, xv);
    load8(gout + q * C + c, gv);
    if (HAS_MOD) {
      load8(mod + q * 2 * C + c, sv);
      load8(mod + q * 2 * C + C + c, bv);
    }
    load8(mean + c, m);
    load8(rstd + c, r);
    load8(coef + c, ca);
    load8(coef + C + c, cb);
    backward_terms<kVec, HAS_MOD, LRELU, false>(xv, gv, sv, bv, m, r, slope, xh, gz, gy);
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
    q += dq;
    c8 += dc;
    if (c8 >= C8) {
      c8 -= C8;
      ++q;
    }
  }
}


// ---- the instance split across ranks ------------------------------------------
//
// Under spatial sharding (deepsee_torch/parallel/spatial.py) each rank holds a
// stripe of every sample's H*W pixels, so an instance norm's statistics are
// partials too.  The instance mode splits as the batch mode does across ranks
// (SplitInstanceModnorm in deepsee_torch/ops/modnorm.py), with N statistics
// sets where the batch split has one:
//   * the partials launch (modnorm_instance_partials_kernel): this rank's
//     (count, mean, M2) per sample and channel into its [3][N][C] row of the
//     [world][3][N][C] buffer, the other rows zeroed by the same launch;
//   * the caller all-reduces the [world][3][N][C] rows over the model group;
//   * the apply launch (modnorm_instance_apply_kernel): the rows of each
//     sample merged in rank order with Chan's formula, then (x - mean) * rstd,
//     the modulation and the leaky ReLU, as the instance kernel applies them;
//   * the backward's sums launch (modnorm_instance_sums_kernel): per sample
//     and channel the sums of gy and gy * x_hat over this rank's pixels;
//   * the caller all-reduces the [2][N][C] sums;
//   * the backward's apply launch (instance_backward_apply_kernel): grad_x
//     and grad_mod from the sums over the global count of a sample's pixels
//     (the stripes may be uneven: the count is the caller's, not P).
// Each launch reads x (and mod, gout) once, so the split moves about twice
// the bytes of the one-launch modes.  At the discriminator's small stripes
// the two statistics launches are bound by latency, not bytes (a load, two
// block reductions, a cluster barrier: ~4-5 us a launch in a CUDA graph on
// the H100, where the bytes take 0.2-1.3 us).

// The apply launch.  Grid (blocks, N): block (i, n) merges sample n's rows of
// `stats` for all C channels into shared memory (mean, rstd), block (0, n)
// writes them to mean_out / rstd_out [N][C], and the blocks of sample n stride
// over its HW * C / 8 vectors.
template <typename T, bool HAS_MOD, bool LRELU>
__global__ void __launch_bounds__(kThreads)
modnorm_instance_apply_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                              const float* __restrict__ stats, int world, T* __restrict__ out,
                              float* __restrict__ mean_out, float* __restrict__ rstd_out, int N,
                              int64_t HW, int C, float eps, float slope) {
  extern __shared__ float s_mr[];          // mean[C], then rstd[C]
  const int n = blockIdx.y;
  const int64_t NC = static_cast<int64_t>(N) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float cnt = 0.f, m = 0.f, q = 0.f;
    for (int r = 0; r < world; ++r) {
      const float* row = stats + static_cast<int64_t>(r) * 3 * NC + static_cast<int64_t>(n) * C;
      chan_merge<1>(cnt, &m, &q, row[c], &row[NC + c], &row[2 * NC + c]);
    }
    const float rs = __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(q, cnt), eps)));
    s_mr[c] = m;
    s_mr[C + c] = rs;
    if (blockIdx.x == 0) {
      mean_out[static_cast<int64_t>(n) * C + c] = m;
      rstd_out[static_cast<int64_t>(n) * C + c] = rs;
    }
  }
  __syncthreads();
  const int C8 = C / kVec;
  const int64_t total = HW * C8;
  const T* xs = x + static_cast<int64_t>(n) * HW * C;
  const T* ms = HAS_MOD ? mod + static_cast<int64_t>(n) * HW * 2 * C : nullptr;
  T* os = out + static_cast<int64_t>(n) * HW * C;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = t / C8;
    const int c = static_cast<int>(t - p * C8) * kVec;
    float y[kVec];
    load8(xs + p * C + c, y);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      y[k] = __fmul_rn(__fsub_rn(y[k], s_mr[c + k]), s_mr[C + c + k]);
    epilogue<T, HAS_MOD, LRELU>(y, HAS_MOD ? ms + p * 2 * C + c : nullptr, C, slope);
    store8(os + p * C + c, y);
  }
}

// The split's two statistics launches split each (sample, channel tile)
// slab along its pixels over the blocks of a thread-block cluster, as the
// one-process instance kernels do: block rank r of a cluster of K takes
// pixels [r * HW / K, (r + 1) * HW / K) of sample blockIdx.y's stripe at the
// channels of tile blockIdx.x / K; thread tid takes the chunk's 16-byte
// vectors tid + k * kThreads (pixel v / L, channels lane * V.., lane =
// tid % L).  A slab is read once, so nothing needs to stay on chip; what
// bounds a streaming block is the bytes it keeps in flight.  So each thread
// streams its vectors through its own slots of a ring in shared memory with
// 16-byte cp.async copies, in groups of kRingLoads: kRingStages - 1 groups
// in flight (80 KB a block) while it sums the oldest, without registers
// held for them and without a barrier (a thread reads only the slots it
// filled); two blocks share an SM.  (A ring of 12 stages, one block per
// SM, measured no faster on the H100: scripts/split_plans.py.)  A thread's sums run in
// groups too: every kSplitFlush groups join its outer sums, so no float32
// sum grows over more than a few hundred terms.  The block adds its
// threads' sums by shuffles and then its warps in order; the cluster's
// rank-0 block reads every rank's sums from the others' shared memory
// (distributed shared memory) and merges them in rank order, and the other
// blocks leave once it has read them.  Fixed orders throughout: the same
// inputs give the same bits, no float atomics, no grid barrier, no scratch
// in device memory, one launch.
constexpr int kRingStages = 6;   // groups a thread's ring holds
constexpr int kRingLoads = 4;    // 16-byte copies a group
constexpr int kRingBytes = kRingStages * kRingLoads * kThreads * 16;  // dynamic shared memory
constexpr int kSplitFlush = 16;  // groups per inner sum

// thread tid's slot u of ring stage s
__device__ __forceinline__ uint4* ring_slot(uint4* ring, int s, int u) {
  return ring + (s * kRingLoads + u) * kThreads + threadIdx.x;
}

// The slab split of a split statistics launch, as the one-process instance
// kernels cut it.
template <typename T>
struct SlabChunk {
  static constexpr int V = 16 / sizeof(T);  // channels per 16-byte vector
  int K, rank, L, shift, lane, npix, nk, ct;
  int64_t first;  // the chunk's first pixel, in the whole (N, HW) batch

  __device__ SlabChunk(int64_t HW, int tile) {
    cg::cluster_group cluster = cg::this_cluster();
    K = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
    L = tile / V;
    shift = __ffs(L) - 1;
    const int tid = threadIdx.x;
    lane = tid & (L - 1);
    const int64_t start = rank * HW / K;
    npix = static_cast<int>((rank + 1) * HW / K - start);
    const int nvec = npix * L;
    nk = tid < nvec ? (nvec - 1 - tid) / kThreads + 1 : 0;
    ct = blockIdx.x / K;
    first = static_cast<int64_t>(blockIdx.y) * HW + start;
  }
  // the chunk's pixel of the thread's vector k
  __device__ int64_t pix(int k) const {
    return static_cast<int64_t>((threadIdx.x + k * kThreads) >> shift);
  }
};

// a and b summed over the block's threads of one lane (the same channels),
// by shuffles within each warp and then over the warps in order; thread
// j < tile writes channel j's sums to out_a[j] and out_b[j].  Ends with
// every thread past a barrier.
template <int V>
__device__ __forceinline__ void block_sum2(float* a, float* b, int L, int tile,
                                           float (*s_a)[kMaxTile], float (*s_b)[kMaxTile],
                                           float* out_a, float* out_b) {
  const int tid = threadIdx.x, wl = tid & 31;
  for (int off = 16; off >= L; off >>= 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
      b[k] += __shfl_xor_sync(0xffffffffu, b[k], off);
    }
  }
  if (wl < L) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s_a[tid >> 5][wl * V + k] = a[k];
      s_b[tid >> 5][wl * V + k] = b[k];
    }
  }
  __syncthreads();
  if (tid < tile) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sa += s_a[w][tid];
      sb += s_b[w][tid];
    }
    out_a[tid] = sa;
    out_b[tid] = sb;
  }
  __syncthreads();
}

// The partials launch.  Grid (cluster * C / tile, N), cluster (cluster, 1,
// 1) (ops/modnorm.py::instance_partials_plan), kRingBytes of dynamic shared
// memory.  Each block sums d = x - P and d * d over its chunk, P the mean of
// the chunk's first kThreads / L pixels (each thread's first vector, which
// it needs first anyway: the batch kernel's shifted-data form without a
// pilot load of its own; no division per pixel), and turns them into the
// chunk's (count, mean, centred M2) once; the rank-0 block merges the K
// chunks' with Chan's formula in rank order into row `row` of stats
// [world][3][N][C], and zeroes the slab's entries of the other world - 1
// rows itself (the caller all-reduces the rows).  Chan's weights of each
// rank's merge depend on the pixel counts alone: they are formed before the
// cluster barrier, so rank 0's merge is a chain of multiply-adds.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
modnorm_instance_partials_kernel(const T* __restrict__ x, float* __restrict__ stats, int row,
                                 int world, int64_t HW, int C, int tile) {
  constexpr int V = SlabChunk<T>::V;
  extern __shared__ uint4 ring[];
  __shared__ float s_a[kWarps][kMaxTile];
  __shared__ float s_b[kWarps][kMaxTile];
  __shared__ float s_sum[2][kMaxTile];
  __shared__ float s_pilot[kMaxTile];
  __shared__ float s_part[2 * kMaxTile];      // (mean[tile], m2[tile]), read by rank 0
  __shared__ float s_w[2][kMaxCluster];       // Chan's weights of rank k: nb / nn, n nb / nn

  cg::cluster_group cluster = cg::this_cluster();
  const SlabChunk<T> ch(HW, tile);
  const int tid = threadIdx.x;
  PHASE_MARK(0);
  const T* xt = x + ch.first * C + ch.ct * tile + ch.lane * V;  // pixel q: xt + q * C
  const int groups = (ch.nk + kRingLoads - 1) / kRingLoads;
  auto fetch = [&](int g) {  // group g into its stage, committed even where empty
    if (g < groups) {
#pragma unroll
      for (int u = 0; u < kRingLoads; ++u) {
        const int k = g * kRingLoads + u;
        if (k < ch.nk) cp_async16(ring_slot(ring, g % kRingStages, u), xt + ch.pix(k) * C);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < kRingStages - 1; ++g) fetch(g);
  const int64_t NC = static_cast<int64_t>(gridDim.y) * C;
  const int64_t o = static_cast<int64_t>(blockIdx.y) * C + ch.ct * tile;  // the slab's first
  if (ch.rank == 0 && tid < tile) {
    for (int w = 0; w < world; ++w) {
      if (w == row) continue;
#pragma unroll
      for (int s = 0; s < 3; ++s) stats[(3 * static_cast<int64_t>(w) + s) * NC + o + tid] = 0.f;
    }
  }
  // P: the first group landed, each thread's first vector summed per lane
  cp_async_wait<kRingStages - 2>();
  PHASE_MARK(1);
  float P[V];
  if (ch.nk > 0) {
    unpack16<T>(*ring_slot(ring, 0, 0), P);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) P[j] = 0.f;
  }
  block_sum<V>(P, ch.L, tile, static_cast<float>(min(ch.npix, kThreads / ch.L)), s_a, s_pilot);
  PHASE_MARK(2);
  float s1[V], s2[V], t1[V], t2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    P[j] = s_pilot[ch.lane * V + j];
    s1[j] = s2[j] = t1[j] = t2[j] = 0.f;
  }
  for (int g = 0; g < groups; ++g) {
    if (g > 0) cp_async_wait<kRingStages - 2>();
#pragma unroll
    for (int u = 0; u < kRingLoads; ++u) {
      if (g * kRingLoads + u < ch.nk) {
        float v[V];
        unpack16<T>(*ring_slot(ring, g % kRingStages, u), v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = v[j] - P[j];
          s1[j] += d;
          s2[j] = fmaf(d, d, s2[j]);
        }
      }
    }
    fetch(g + kRingStages - 1);  // into the stage summed last time round
    if (g % kSplitFlush == kSplitFlush - 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        t1[j] += s1[j];
        t2[j] += s2[j];
        s1[j] = s2[j] = 0.f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    t1[j] += s1[j];
    t2[j] += s2[j];
  }
  PHASE_MARK(3);
  block_sum2<V>(t1, t2, ch.L, tile, s_a, s_b, s_sum[0], s_sum[1]);
  if (tid < tile) {  // the chunk's mean and centred M2 of channel tid
    const float n = static_cast<float>(ch.npix), a = s_sum[0][tid];
    const float da = a / n;
    s_part[tid] = s_pilot[tid] + da;
    s_part[tile + tid] = fmaxf(s_sum[1][tid] - a * da, 0.f);
  }
  if (tid < ch.K) {  // chan_merge's weights of rank tid, from the exact pixel counts
    const float n = static_cast<float>(tid * HW / ch.K);
    const float nb = static_cast<float>((tid + 1) * HW / ch.K) - n;
    const float fb = nb / (n + nb);
    s_w[0][tid] = fb;
    s_w[1][tid] = n * fb;
  }
  PHASE_MARK(4);

  // rank 0: thread j reads channel j's partials of every rank from their
  // blocks' shared memory at once and merges them in rank order (Chan's
  // formula, as chan_merge); the other blocks leave once rank 0 has read
  // them (the split barrier)
  cluster.sync();
  PHASE_MARK(5);
  if (ch.rank != 0) {
    cluster_arrive();
  } else {
    float mb[kMaxCluster], qb[kMaxCluster];
    if (tid < tile) {
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k < ch.K) {
          const float* p = cluster.map_shared_rank(s_part, k);
          mb[k] = p[tid];
          qb[k] = p[tile + tid];
        }
      }
    }
    cluster_arrive();
    if (tid < tile) {
      float m = 0.f, q = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k < ch.K) {
          const float d = mb[k] - m;
          m += d * s_w[0][k];
          q += qb[k] + d * d * s_w[1][k];
        }
      }
      float* out = stats + 3 * static_cast<int64_t>(row) * NC + o + tid;
      out[0] = static_cast<float>(HW);
      out[NC] = m;
      out[2 * NC] = q;
    }
  }
  PHASE_MARK(6);
  cluster_wait();  // no block's shared memory goes while rank 0 may read it
  PHASE_MARK(7);
}

// The backward's sums launch.  Grid, clusters and ring as the partials
// launch's (ops/modnorm.py::instance_sums_plan): a group holds
// kRingLoads / NT pixels' vectors of x, gout (and the modulation's two
// halves).  Each block sums gy and gy * x_hat over its chunk (x_hat, gz and
// gy recomputed with the forward's operations), reading each tensor once;
// the rank-0 block adds the K chunks' sums in rank order into sums
// [2][N][C].
template <typename T, bool HAS_MOD, bool LRELU>
__global__ void __launch_bounds__(kThreads, 2)
modnorm_instance_sums_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                             const T* __restrict__ gout, const float* __restrict__ mean,
                             const float* __restrict__ rstd, float* __restrict__ sums,
                             int64_t HW, int C, int tile, float slope) {
  constexpr int V = SlabChunk<T>::V;
  constexpr int NT = HAS_MOD ? 4 : 2;      // tensors read per pixel
  constexpr int U = kRingLoads / NT;       // vectors a group
  extern __shared__ uint4 ring[];
  __shared__ float s_a[kWarps][kMaxTile];
  __shared__ float s_b[kWarps][kMaxTile];
  __shared__ float s_part[2 * kMaxTile];   // sums of gy and gy * x_hat, read by rank 0

  cg::cluster_group cluster = cg::this_cluster();
  const SlabChunk<T> ch(HW, tile);
  const int tid = threadIdx.x;
  PHASE_MARK(0);
  const int c0 = ch.ct * tile + ch.lane * V;
  auto at = [&](int t, int k) {  // tensor t's vector k
    const int64_t q = ch.first + ch.pix(k);
    const T* p = t == 0 ? x + q * C : t == 1 ? gout + q * C : mod + q * 2 * C + (t == 3 ? C : 0);
    return p + c0;
  };
  const int groups = (ch.nk + U - 1) / U;
  auto fetch = [&](int g) {
    if (g < groups) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (g * U + u < ch.nk) {
#pragma unroll
          for (int t = 0; t < NT; ++t)
            cp_async16(ring_slot(ring, g % kRingStages, u * NT + t), at(t, g * U + u));
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < kRingStages - 1; ++g) fetch(g);
  float m[V], r[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = mean[static_cast<int64_t>(blockIdx.y) * C + c0 + j];
    r[j] = rstd[static_cast<int64_t>(blockIdx.y) * C + c0 + j];
  }
  float sa[V], sb[V], ta[V], tb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sa[j] = sb[j] = ta[j] = tb[j] = 0.f;
  for (int g = 0; g < groups; ++g) {
    cp_async_wait<kRingStages - 2>();
    if (g == 0) PHASE_MARK(1);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (g * U + u >= ch.nk) continue;
      float xv[V], gv[V], sv[V], bv[V], h[V], gz[V], gy[V];
      unpack16<T>(*ring_slot(ring, g % kRingStages, u * NT), xv);
      unpack16<T>(*ring_slot(ring, g % kRingStages, u * NT + 1), gv);
      if constexpr (HAS_MOD) {
        unpack16<T>(*ring_slot(ring, g % kRingStages, u * NT + 2), sv);
        unpack16<T>(*ring_slot(ring, g % kRingStages, u * NT + 3), bv);
      }
      backward_terms<V, HAS_MOD, LRELU, true>(xv, gv, sv, bv, m, r, slope, h, gz, gy);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sa[j] += gy[j];
        sb[j] += __fmul_rn(gy[j], h[j]);
      }
    }
    fetch(g + kRingStages - 1);  // into the stage summed last time round
    if (g % kSplitFlush == kSplitFlush - 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ta[j] += sa[j];
        tb[j] += sb[j];
        sa[j] = sb[j] = 0.f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ta[j] += sa[j];
    tb[j] += sb[j];
  }
  PHASE_MARK(3);
  block_sum2<V>(ta, tb, ch.L, tile, s_a, s_b, s_part, s_part + tile);
  PHASE_MARK(4);

  // rank 0 reads every rank's sums at once and adds them in rank order;
  // the other blocks leave once rank 0 has read them (the split barrier)
  cluster.sync();
  PHASE_MARK(5);
  float v[kMaxCluster];
  if (ch.rank == 0 && tid < 2 * tile) {
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      v[k] = k < ch.K ? cluster.map_shared_rank(s_part, k)[tid] : 0.f;
  }
  cluster_arrive();
  if (ch.rank == 0 && tid < 2 * tile) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < ch.K) s += v[k];
    const int64_t NC = static_cast<int64_t>(gridDim.y) * C;
    sums[(tid < tile ? 0 : NC) + static_cast<int64_t>(blockIdx.y) * C + ch.ct * tile +
         tid % tile] = s;
  }
  PHASE_MARK(6);
  cluster_wait();  // no block's shared memory goes while rank 0 may read it
  PHASE_MARK(7);
}

// The backward's apply launch.  Grid (blocks, N): block (i, n) turns sample
// n's sums [2][N][C] over `count` pixels into the coefficients in shared
// memory, then writes grad_x and grad_mod as backward_apply_kernel does, with
// the instance normalization (x - mean) * rstd.
template <typename T, bool HAS_MOD, bool LRELU>
__global__ void __launch_bounds__(kThreads)
instance_backward_apply_kernel(const T* __restrict__ x, const T* __restrict__ mod,
                               const T* __restrict__ gout, const float* __restrict__ mean,
                               const float* __restrict__ rstd, const float* __restrict__ sums,
                               T* __restrict__ gx, T* __restrict__ gmod, int N, int64_t HW, int C,
                               float count, float slope) {
  extern __shared__ float s_cf[];          // mean(gy)[C], then mean(gy * x_hat)[C]
  const int n = blockIdx.y;
  const int64_t nc = static_cast<int64_t>(n) * C, NC = static_cast<int64_t>(N) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s_cf[c] = __fdiv_rn(sums[nc + c], count);
    s_cf[C + c] = __fdiv_rn(sums[NC + nc + c], count);
  }
  __syncthreads();
  const int C8 = C / kVec;
  const int64_t total = HW * C8, base = static_cast<int64_t>(n) * HW;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t q = base + t / C8;
    const int c = static_cast<int>(t % C8) * kVec;
    float xv[kVec], gv[kVec], sv[kVec], bv[kVec], m[kVec], r[kVec];
    float xh[kVec], gz[kVec], gy[kVec];
    load8(x + q * C + c, xv);
    load8(gout + q * C + c, gv);
    if (HAS_MOD) {
      load8(mod + q * 2 * C + c, sv);
      load8(mod + q * 2 * C + C + c, bv);
    }
    load8(mean + nc + c, m);
    load8(rstd + nc + c, r);
    backward_terms<kVec, HAS_MOD, LRELU, true>(xv, gv, sv, bv, m, r, slope, xh, gz, gy);
    float o[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      o[k] = __fmul_rn(r[k], __fsub_rn(__fsub_rn(gy[k], s_cf[c + k]),
                                       __fmul_rn(xh[k], s_cf[C + c + k])));
    store8(gx + q * C + c, o);
    if (HAS_MOD) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) o[k] = __fmul_rn(gz[k], xh[k]);
      store8(gmod + q * 2 * C + c, o);
      store8(gmod + q * 2 * C + C + c, gz);
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

template <typename F>
const void* fn(F* f) {
  return reinterpret_cast<const void*>(f);
}

template <typename T, bool STREAM, int REG>
const void* instance_kernel(bool has_mod, bool lrelu) {
  if (has_mod)
    return lrelu ? fn(modnorm_instance_kernel<T, STREAM, REG, true, true>)
                 : fn(modnorm_instance_kernel<T, STREAM, REG, true, false>);
  return lrelu ? fn(modnorm_instance_kernel<T, STREAM, REG, false, true>)
               : fn(modnorm_instance_kernel<T, STREAM, REG, false, false>);
}

template <typename T>
const void* instance_kernel(int streaming, int regs, bool has_mod, bool lrelu) {
  if (streaming) return regs == 0 ? instance_kernel<T, true, 0>(has_mod, lrelu) : nullptr;
  if (regs == 0) return instance_kernel<T, false, 0>(has_mod, lrelu);
  return regs == kRegVectors ? instance_kernel<T, false, kRegVectors>(has_mod, lrelu) : nullptr;
}

template <typename T>
const void* batch_kernel(bool has_mod, bool lrelu, bool stats_only) {
  if (stats_only) return fn(modnorm_batch_kernel<T, false, false, true>);
  if (has_mod)
    return lrelu ? fn(modnorm_batch_kernel<T, true, true, false>)
                 : fn(modnorm_batch_kernel<T, true, false, false>);
  return lrelu ? fn(modnorm_batch_kernel<T, false, true, false>)
               : fn(modnorm_batch_kernel<T, false, false, false>);
}

// The batch forward for (dtype, flags); `stats_only` is launch A of the
// cross-rank forward, which takes no mod and applies nothing.
const void* batch_kernel(int dtype, bool has_mod, bool lrelu, bool stats_only) {
  return dtype == 0 ? batch_kernel<float>(has_mod, lrelu, stats_only)
                    : batch_kernel<__nv_bfloat16>(has_mod, lrelu, stats_only);
}

template <typename T>
const void* instance_grid_kernel(bool has_mod, bool lrelu) {
  if (has_mod)
    return lrelu ? fn(modnorm_batch_kernel<T, true, true, false, true>)
                 : fn(modnorm_batch_kernel<T, true, false, false, true>);
  return lrelu ? fn(modnorm_batch_kernel<T, false, true, false, true>)
               : fn(modnorm_batch_kernel<T, false, false, false, true>);
}

// The instance forward's "grid" variant for (dtype, flags).
const void* instance_grid_kernel(int dtype, bool has_mod, bool lrelu) {
  return dtype == 0 ? instance_grid_kernel<float>(has_mod, lrelu)
                    : instance_grid_kernel<__nv_bfloat16>(has_mod, lrelu);
}

// The instance split's partials launch.
const void* instance_partials_kernel(int dtype) {
  return dtype == 0 ? fn(modnorm_instance_partials_kernel<float>)
                    : fn(modnorm_instance_partials_kernel<__nv_bfloat16>);
}

template <typename T>
const void* instance_sums_kernel(bool has_mod, bool lrelu) {
  if (has_mod)
    return lrelu ? fn(modnorm_instance_sums_kernel<T, true, true>)
                 : fn(modnorm_instance_sums_kernel<T, true, false>);
  return lrelu ? fn(modnorm_instance_sums_kernel<T, false, true>)
               : fn(modnorm_instance_sums_kernel<T, false, false>);
}

// The instance split's backward sums launch for (dtype, flags).
const void* instance_sums_kernel(int dtype, bool has_mod, bool lrelu) {
  return dtype == 0 ? instance_sums_kernel<float>(has_mod, lrelu)
                    : instance_sums_kernel<__nv_bfloat16>(has_mod, lrelu);
}

template <typename T, bool STREAM>
const void* instance_backward_kernel(bool has_mod, bool lrelu) {
  if (has_mod)
    return lrelu ? fn(modnorm_instance_backward_kernel<T, STREAM, true, true>)
                 : fn(modnorm_instance_backward_kernel<T, STREAM, true, false>);
  return lrelu ? fn(modnorm_instance_backward_kernel<T, STREAM, false, true>)
               : fn(modnorm_instance_backward_kernel<T, STREAM, false, false>);
}

const void* instance_backward_kernel(int dtype, int streaming, bool has_mod, bool lrelu) {
  if (dtype == 0)
    return streaming ? instance_backward_kernel<float, true>(has_mod, lrelu)
                     : instance_backward_kernel<float, false>(has_mod, lrelu);
  return streaming ? instance_backward_kernel<__nv_bfloat16, true>(has_mod, lrelu)
                   : instance_backward_kernel<__nv_bfloat16, false>(has_mod, lrelu);
}

// A (sample, channel tile) split the cluster kernels take: a tile of one to
// kMaxLanes 16-byte vectors (a power of two) dividing C, 1 to kMaxCluster
// blocks per slab, none of them empty.
bool cluster_split_ok(int N, int64_t HW, int C, int tile, int cluster, int dtype) {
  const int vec = dtype == 0 ? 4 : 8, lanes = tile / vec;
  return !(tile % vec || lanes < 1 || lanes > kMaxLanes || (lanes & (lanes - 1)) ||
           tile > kMaxTile || C % tile || cluster < 1 || cluster > kMaxCluster ||
           cluster > HW || N < 1 || N > 65535);
}

// `kernel`'s cluster launch of (cluster * C / tile, N) blocks with its
// attributes set; null if they cannot be.
const void* cluster_launch(const void* kernel, int N, int C, int tile, int cluster, int smem,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
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

// The instance kernel for (dtype, variant, flags) with its attributes set,
// and its cluster launch for the plan; null if the plan is not one the
// kernel takes.
const void* instance_launch(int N, int64_t HW, int C, int tile, int cluster, int smem,
                            int streaming, int regs, int dtype, bool has_mod, bool lrelu,
                            cudaStream_t stream, cudaLaunchConfig_t* cfg,
                            cudaLaunchAttribute* attr) {
  if (!cluster_split_ok(N, HW, C, tile, cluster, dtype)) return nullptr;
  // on-chip, shared memory must hold the largest chunk beyond its registers
  const int64_t vectors = (HW + cluster - 1) / cluster * (tile / (dtype == 0 ? 4 : 8));
  const int64_t per_thread = (vectors + kThreads - 1) / kThreads;
  const int64_t need = regs == 0 ? vectors * 16
                                 : (per_thread > regs ? per_thread - regs : 0) * kThreads * 16;
  if (!streaming && smem < need) return nullptr;
  const void* kernel = dtype == 0
                           ? instance_kernel<float>(streaming, regs, has_mod, lrelu)
                           : instance_kernel<__nv_bfloat16>(streaming, regs, has_mod, lrelu);
  return cluster_launch(kernel, N, C, tile, cluster, smem, stream, cfg, attr);
}

// Blocks of `kernel` (kThreads each, `smem` bytes of dynamic shared memory)
// an SM holds at once, as the card reports it; -1 where it cannot say.
int blocks_per_sm(const void* kernel, int smem) {
  int n = -1;
  if (kernel == nullptr ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) != cudaSuccess)
    n = -1;
  return n;
}

template <typename T, bool HAS_MOD, bool LRELU>
void launch_backward(const void* x, const void* mod, const void* gout, const float* mean,
                     const float* rstd, float* part, float* coef, void* gx, void* gmod,
                     int64_t P, int C, int L, int chunks, int64_t chunk, float slope,
                     cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* mt = static_cast<const T*>(mod);
  const T* gt = static_cast<const T*>(gout);
  backward_partial_kernel<T, HAS_MOD, LRELU>
      <<<dim3(chunks, C / (kVec * L)), kThreads, 0, stream>>>(xt, mt, gt, mean, rstd, part, P,
                                                              C, L, chunk, slope);
  backward_final_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, chunks, C, static_cast<float>(P), coef);
  const int64_t want = (P * (C / kVec) + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kThreads);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  backward_apply_kernel<T, HAS_MOD, LRELU><<<blocks, kThreads, 0, stream>>>(
      xt, mt, gt, mean, rstd, coef, static_cast<T*>(gx), static_cast<T*>(gmod), P, C, slope);
}

template <typename T, bool HAS_MOD, bool LRELU>
void launch_batch_apply(const void* x, const void* mod, const float* stats, int world,
                        void* out, float* mean, float* rstd, int64_t P, int C, float eps,
                        float slope, cudaStream_t stream) {
  const int64_t want = (P * (C / kVec) + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kThreads);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(float);  // at most 48 KB
  modnorm_batch_apply_kernel<T, HAS_MOD, LRELU><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mod), stats, world, static_cast<T*>(out),
      mean, rstd, P, C, eps, slope);
}

// The batch backward's reduction alone: per-channel sums of gy and gy * x_hat
// over this launch's pixels, in chunk order, into sums [2][C] (the one-process
// path's coefficients before the division by the count).
template <typename T, bool HAS_MOD, bool LRELU>
void launch_backward_sums(const void* x, const void* mod, const void* gout, const float* mean,
                          const float* rstd, float* part, float* sums, int64_t P, int C, int L,
                          int chunks, int64_t chunk, float slope, cudaStream_t stream) {
  backward_partial_kernel<T, HAS_MOD, LRELU>
      <<<dim3(chunks, C / (kVec * L)), kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(mod), static_cast<const T*>(gout),
          mean, rstd, part, P, C, L, chunk, slope);
  backward_final_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, chunks, C, 1.f, sums);
}

// The batch backward's elementwise pass from sums [2][C] over `count` pixels
// (the world's): coef = sums / count (backward_final_kernel over one chunk),
// then grad_x and grad_mod as the one-process path writes them.
template <typename T, bool HAS_MOD, bool LRELU>
void launch_backward_apply(const void* x, const void* mod, const void* gout, const float* mean,
                           const float* rstd, const float* sums, float* coef, void* gx,
                           void* gmod, int64_t P, int C, float count, float slope,
                           cudaStream_t stream) {
  backward_final_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      sums, 1, C, count, coef);
  const int64_t want = (P * (C / kVec) + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kThreads);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  backward_apply_kernel<T, HAS_MOD, LRELU><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mod), static_cast<const T*>(gout), mean,
      rstd, coef, static_cast<T*>(gx), static_cast<T*>(gmod), P, C, slope);
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
struct Backward {
  template <typename... A> static void run(A... a) { launch_backward<T, M, R>(a...); }
};

template <typename T, bool M, bool R>
struct BatchApply {
  template <typename... A> static void run(A... a) { launch_batch_apply<T, M, R>(a...); }
};

template <typename T, bool M, bool R>
struct BackwardSums {
  template <typename... A> static void run(A... a) { launch_backward_sums<T, M, R>(a...); }
};

template <typename T, bool M, bool R>
struct BackwardApply {
  template <typename... A> static void run(A... a) { launch_backward_apply<T, M, R>(a...); }
};


// Blocks per sample of the instance split's elementwise launches: enough for
// eight blocks per SM over the batch, no more than the sample's vectors need.
int per_sample_blocks(int N, int64_t HW, int C) {
  const int64_t want = (HW * (C / kVec) + kThreads - 1) / kThreads;
  int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kThreads) / N;
  if (cap < 1) cap = 1;
  return static_cast<int>(want < cap ? want : cap);
}

template <typename T, bool HAS_MOD, bool LRELU>
void launch_instance_apply(const void* x, const void* mod, const float* stats, int world,
                           void* out, float* mean, float* rstd, int N, int64_t HW, int C,
                           float eps, float slope, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(float);  // at most 48 KB
  modnorm_instance_apply_kernel<T, HAS_MOD, LRELU>
      <<<dim3(per_sample_blocks(N, HW, C), N), kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(mod), stats, world,
          static_cast<T*>(out), mean, rstd, N, HW, C, eps, slope);
}

template <typename T, bool HAS_MOD, bool LRELU>
void launch_instance_backward_apply(const void* x, const void* mod, const void* gout,
                                    const float* mean, const float* rstd, const float* sums,
                                    void* gx, void* gmod, int N, int64_t HW, int C, float count,
                                    float slope, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(float);
  instance_backward_apply_kernel<T, HAS_MOD, LRELU>
      <<<dim3(per_sample_blocks(N, HW, C), N), kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(mod), static_cast<const T*>(gout),
          mean, rstd, sums, static_cast<T*>(gx), static_cast<T*>(gmod), N, HW, C, count, slope);
}

template <typename T, bool M, bool R>
struct InstanceApply {
  template <typename... A> static void run(A... a) { launch_instance_apply<T, M, R>(a...); }
};

template <typename T, bool M, bool R>
struct InstanceBackwardApply {
  template <typename... A> static void run(A... a) {
    launch_instance_backward_apply<T, M, R>(a...);
  }
};

int invalid() {
  cudaGetLastError();
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// the kernel cannot take.  A programmatic dependent launch: its blocks may
// start while the stream's previous kernel finishes (see wait_prior_grid).
extern "C" int modnorm_instance(const void* x, const void* mod, void* out, void* mean,
                                void* rstd, int N, int64_t HW, int C, int tile, int cluster,
                                int smem, int streaming, int regs, float eps, int dtype,
                                int lrelu, float slope, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  const void* kernel = instance_launch(N, HW, C, tile, cluster, smem, streaming, regs, dtype,
                                       mod != nullptr, lrelu != 0,
                                       static_cast<cudaStream_t>(stream), &cfg, attr);
  if (kernel == nullptr) return invalid();
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.numAttrs = 2;
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

// Blocks of the batch forward an SM holds at once with `smem` bytes of
// dynamic shared memory per block (registers and shared memory both
// counted), or -1: deepsee_torch/ops/modnorm.py::batch_plan sizes the
// cooperative grid by it.
extern "C" int modnorm_batch_blocks_per_sm(int dtype, int has_mod, int lrelu, int stats_only,
                                           int smem) {
  const int n = blocks_per_sm(batch_kernel(dtype, has_mod != 0, lrelu != 0, stats_only != 0),
                              smem);
  cudaGetLastError();
  return n;
}

// Training, batch statistics, one cooperative launch: per channel over the
// P = N*H*W pixels, float32 mean and rstd into `mean` and `rstd` (C,), and
// out = lrelu?((x * rstd + (-mean * rstd)) * scale + offset).  The plan is
// deepsee_torch/ops/modnorm.py::batch_plan's: `tile` channels per block (one
// to eight 16-byte vectors), `runs` blocks along the pixels of each channel
// tile, `smem` bytes of dynamic shared memory per block (the run's first
// smem / 16 vectors stay there).  `part` is scratch of 2 * runs * C floats.
// Returns the launch's error, then cudaGetLastError(); cudaErrorInvalidValue
// for a plan the kernel cannot take, or a grid larger than the blocks the
// card holds at once.
namespace {

// The cooperative launch of the batch forward (or, with `stats` given, of
// its statistics-only form, launch A); see modnorm_batch.  `instance`: the
// instance forward's grid variant over `sets` samples (modnorm_instance_grid),
// cooperative only where a set has more than one run, and else a
// programmatic dependent launch.
int launch_batch(const void* x, const void* mod, void* out, void* part, void* mean, void* rstd,
                 void* stats, int64_t P, int C, int tile, int runs, int sets, bool instance,
                 int smem, float eps, int dtype, int lrelu, float slope, void* stream) {
  const int vec = dtype == 0 ? 4 : 8, lanes = tile / vec;
  if (tile % vec || lanes < 1 || lanes > kMaxLanes || (lanes & (lanes - 1)) || C % tile ||
      sets < 1 || P % sets || runs < 1 || runs % sets || runs / sets > P / sets ||
      runs / sets > kMaxRunsPerSet || smem < 0 || smem % 16)
    return invalid();
  const void* kernel = instance ? instance_grid_kernel(dtype, mod != nullptr, lrelu != 0)
                               : batch_kernel(dtype, mod != nullptr, lrelu != 0,
                                              stats != nullptr);
  const int64_t grid = static_cast<int64_t>(runs) * (C / tile);
  const bool cooperative = !instance || runs > sets;
  const int per_sm = blocks_per_sm(kernel, smem);
  if (per_sm < 1 || grid > 0x7fffffff ||
      (cooperative && grid > static_cast<int64_t>(per_sm) * sm_count()))
    return invalid();
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = cooperative ? 1 : 0;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // instance only
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = instance && !cooperative ? 2 : 1;
  int resident = smem / 16;
  void* args[] = {&x, &mod, &out, &part, &mean, &rstd, &stats, &P, &C, &tile, &runs,
                  &sets, &resident, &eps, &slope};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, kernel, args);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

extern "C" int modnorm_batch(const void* x, const void* mod, void* out, void* part, void* mean,
                             void* rstd, int64_t P, int C, int tile, int runs, int smem,
                             float eps, int dtype, int lrelu, float slope, void* stream) {
  return launch_batch(x, mod, out, part, mean, rstd, nullptr, P, C, tile, runs, 1, false, smem,
                      eps, dtype, lrelu, slope, stream);
}

// The instance forward's grid variant (deepsee_torch/ops/modnorm.py::
// instance_plan, variant "grid"): the batch forward's kernel over N sets of
// H*W pixels, `runs` blocks along each (sample, channel tile) slab, `smem`
// bytes of dynamic shared memory per block (the run's first smem / 16
// vectors stay there); cooperative where runs > 1, with `part` scratch of
// 2 * N * runs * C floats.  `mean` and `rstd`, float32 (N, C), receive the
// statistics in training and are null at inference.  A programmatic
// dependent launch where runs == 1 (a cooperative one is not).  Returns the
// launch's error, then cudaGetLastError(); cudaErrorInvalidValue for a plan
// the kernel cannot take.
extern "C" int modnorm_instance_grid(const void* x, const void* mod, void* out, void* part,
                                     void* mean, void* rstd, int N, int64_t HW, int C, int tile,
                                     int runs, int smem, float eps, int dtype, int lrelu,
                                     float slope, void* stream) {
  if (N < 1 || HW < 1 || runs < 1 || (runs > 1 && part == nullptr) ||
      static_cast<int64_t>(N) * runs > 0x7fffffff)
    return invalid();
  return launch_batch(x, mod, out, part, mean, rstd, nullptr, N * HW, C, tile, N * runs, N, true,
                      smem, eps, dtype, lrelu, slope, stream);
}

// Launch A of the cross-rank batch forward: the batch forward's statistics
// alone (the same cooperative launch, plan and merge of its runs), this
// launch's (count, mean, centred M2) per channel into `stats`, [3][C] float32
// (a rank's row of the [world][3][C] buffer the caller all-reduces).  The
// plan is batch_plan's for the statistics-only kernel's blocks per SM
// (modnorm_batch_blocks_per_sm with stats_only 1).
extern "C" int modnorm_batch_partials(const void* x, void* part, void* stats, int64_t P, int C,
                                      int tile, int runs, int smem, int dtype, void* stream) {
  if (stats == nullptr) return invalid();
  return launch_batch(x, nullptr, nullptr, part, nullptr, nullptr, stats, P, C, tile, runs, 1,
                      false, smem, 0.f, dtype, 0, 0.f, stream);
}

// Launch B of the cross-rank batch forward: the `world` rows of `stats`
// ([world][3][C] float32, all-reduced) merged in rank order, their mean and
// rstd into `mean` and `rstd` (C,), and out = lrelu?((x * rstd + (-mean *
// rstd)) * scale + offset) over the P pixels of x.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for C the kernel does not take.
extern "C" int modnorm_batch_apply(const void* x, const void* mod, const void* stats, int world,
                                   void* out, void* mean, void* rstd, int64_t P, int C, float eps,
                                   int dtype, int lrelu, float slope, void* stream) {
  if (P < 1 || C < kVec || C % kVec || C > 6144 || world < 1) return invalid();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (dtype == 0)
    dispatch_flags<float, BatchApply>(mod != nullptr, lrelu != 0, x, mod, st, world, out, m, r,
                                      P, C, eps, slope, s);
  else
    dispatch_flags<__nv_bfloat16, BatchApply>(mod != nullptr, lrelu != 0, x, mod, st, world,
                                              out, m, r, P, C, eps, slope, s);
  return static_cast<int>(cudaGetLastError());
}

// Training, the instance backward, one cluster launch: grad_x (x's layout)
// and, where `mod` is given, grad_mod (its 2C layout) from x, mod, gout and
// the forward's float32 (N, C) mean and rstd, with the plan of
// deepsee_torch/ops/modnorm.py::instance_backward_plan (`tile`, `cluster`,
// `smem`, `streaming` as modnorm_instance's; on-chip, shared memory holds the
// chunk of each tensor read).  Returns the launch's error, then
// cudaGetLastError(); cudaErrorInvalidValue for a plan the kernel cannot take.
extern "C" int modnorm_backward_instance(const void* x, const void* mod, const void* gout,
                                         const void* mean, const void* rstd, void* gx,
                                         void* gmod, int N, int64_t HW, int C, int tile,
                                         int cluster, int smem, int streaming, int dtype,
                                         int lrelu, float slope, void* stream) {
  if ((mod != nullptr) != (gmod != nullptr) || !cluster_split_ok(N, HW, C, tile, cluster, dtype))
    return invalid();
  const int64_t vectors = (HW + cluster - 1) / cluster * (tile / (dtype == 0 ? 4 : 8));
  const int64_t stride = (vectors + kThreads - 1) / kThreads * kThreads;
  if (!streaming && smem < (mod != nullptr ? 4 : 2) * stride * 16) return invalid();
  const void* kernel = instance_backward_kernel(dtype, streaming, mod != nullptr, lrelu != 0);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (cluster_launch(kernel, N, C, tile, cluster, smem, static_cast<cudaStream_t>(stream), &cfg,
                     &attr) == nullptr)
    return invalid();
  void* args[] = {&x, &mod, &gout, &mean, &rstd, &gx, &gmod, &HW, &C, &tile, &slope};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, kernel, args);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// Training, the batch backward: grad_x (x's layout) and, where `mod` is
// given, grad_mod (its 2C layout) from x, mod, gout and the forward's float32
// (C,) mean and rstd, over the P = N*H*W pixels.  The plan (L, chunks, chunk)
// is deepsee_torch/ops/modnorm.py::reduce_plan's; `part` is scratch of
// 2 * chunks * C floats, `coef` of 2 * C.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernels do not take.
extern "C" int modnorm_backward_batch(const void* x, const void* mod, const void* gout,
                                      const void* mean, const void* rstd, void* part,
                                      void* coef, void* gx, void* gmod, int64_t P, int C, int L,
                                      int chunks, int64_t chunk, int dtype, int lrelu,
                                      float slope, void* stream) {
  if (P < 1 || chunks < 1 || chunk < 1 || chunk * chunks < P ||
      (chunks - 1) * chunk >= P || (L != 1 && L != 2 && L != 4 && L != 8) || C < kVec * L ||
      C % (kVec * L) || C / (kVec * L) > 65535 || (mod != nullptr) != (gmod != nullptr))
    return invalid();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(part);
  float* cf = static_cast<float*>(coef);
  if (dtype == 0)
    dispatch_flags<float, Backward>(mod != nullptr, lrelu != 0, x, mod, gout, m, r, p, cf, gx,
                                    gmod, P, C, L, chunks, chunk, slope, s);
  else
    dispatch_flags<__nv_bfloat16, Backward>(mod != nullptr, lrelu != 0, x, mod, gout, m, r, p,
                                            cf, gx, gmod, P, C, L, chunks, chunk, slope, s);
  return static_cast<int>(cudaGetLastError());
}

// The cross-rank batch backward, first half: the reduction of
// modnorm_backward_batch (same plan, same chunk order) stopped before the
// division, sums = [sum gy | sum gy * x_hat] per channel, [2][C] float32,
// over this launch's P pixels; `part` is scratch of 2 * chunks * C floats.
extern "C" int modnorm_backward_batch_sums(const void* x, const void* mod, const void* gout,
                                           const void* mean, const void* rstd, void* part,
                                           void* sums, int64_t P, int C, int L, int chunks,
                                           int64_t chunk, int dtype, int lrelu, float slope,
                                           void* stream) {
  if (P < 1 || chunks < 1 || chunk < 1 || chunk * chunks < P || (chunks - 1) * chunk >= P ||
      (L != 1 && L != 2 && L != 4 && L != 8) || C < kVec * L || C % (kVec * L) ||
      C / (kVec * L) > 65535)
    return invalid();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(part);
  float* sm = static_cast<float*>(sums);
  if (dtype == 0)
    dispatch_flags<float, BackwardSums>(mod != nullptr, lrelu != 0, x, mod, gout, m, r, p, sm, P,
                                        C, L, chunks, chunk, slope, s);
  else
    dispatch_flags<__nv_bfloat16, BackwardSums>(mod != nullptr, lrelu != 0, x, mod, gout, m, r,
                                                p, sm, P, C, L, chunks, chunk, slope, s);
  return static_cast<int>(cudaGetLastError());
}

// The cross-rank batch backward, second half: grad_x (x's layout) and, where
// `mod` is given, grad_mod (its 2C layout) from the all-reduced `sums` [2][C]
// over `count` pixels (the world's; P is this launch's): the coefficients
// sums / count into `coef` (2 * C floats of scratch), then the elementwise
// pass of modnorm_backward_batch.
extern "C" int modnorm_backward_batch_apply(const void* x, const void* mod, const void* gout,
                                            const void* mean, const void* rstd, const void* sums,
                                            void* coef, void* gx, void* gmod, int64_t P, int C,
                                            float count, int dtype, int lrelu, float slope,
                                            void* stream) {
  if (P < 1 || C < kVec || C % kVec || !(count >= 1.f) || (mod != nullptr) != (gmod != nullptr))
    return invalid();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  const float* sm = static_cast<const float*>(sums);
  float* cf = static_cast<float*>(coef);
  if (dtype == 0)
    dispatch_flags<float, BackwardApply>(mod != nullptr, lrelu != 0, x, mod, gout, m, r, sm, cf,
                                         gx, gmod, P, C, count, slope, s);
  else
    dispatch_flags<__nv_bfloat16, BackwardApply>(mod != nullptr, lrelu != 0, x, mod, gout, m, r,
                                                 sm, cf, gx, gmod, P, C, count, slope, s);
  return static_cast<int>(cudaGetLastError());
}

// ---- the instance split across ranks (see the kernels above) ----------------

// The partials launch (deepsee_torch/ops/modnorm.py::instance_partials_plan):
// `cluster` blocks per (sample, channel tile) slab, `smem` bytes of ring
// (kRingBytes, the plan's); this rank's (count, mean, centred M2) per sample and
// channel into row `row` of `stats`, [world][3][N][C] float32, and zeros
// into its other rows.  One cluster launch; cudaErrorInvalidValue for a
// plan the kernel does not take.
extern "C" int modnorm_instance_partials(const void* x, void* stats, int row, int world, int N,
                                         int64_t HW, int C, int tile, int cluster, int smem,
                                         int dtype, void* stream) {
  if (stats == nullptr || world < 1 || row < 0 || row >= world || smem != kRingBytes ||
      !cluster_split_ok(N, HW, C, tile, cluster, dtype))
    return invalid();
  const void* kernel = instance_partials_kernel(dtype);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (cluster_launch(kernel, N, C, tile, cluster, smem, static_cast<cudaStream_t>(stream),
                     &cfg, &attr) == nullptr)
    return invalid();
  void* args[] = {&x, &stats, &row, &world, &HW, &C, &tile};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, kernel, args);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The apply launch: the `world` rows of `stats` ([world][3][N][C] float32,
// all-reduced) merged per sample in rank order, their mean and rstd into
// `mean` and `rstd` (N, C), and out = lrelu?((x - mean) * rstd * scale +
// offset) over each sample's HW pixels.
extern "C" int modnorm_instance_apply(const void* x, const void* mod, const void* stats,
                                      int world, void* out, void* mean, void* rstd, int N,
                                      int64_t HW, int C, float eps, int dtype, int lrelu,
                                      float slope, void* stream) {
  if (N < 1 || N > 65535 || HW < 1 || C < kVec || C % kVec || C > 6144 || world < 1)
    return invalid();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (dtype == 0)
    dispatch_flags<float, InstanceApply>(mod != nullptr, lrelu != 0, x, mod, st, world, out, m,
                                         r, N, HW, C, eps, slope, s);
  else
    dispatch_flags<__nv_bfloat16, InstanceApply>(mod != nullptr, lrelu != 0, x, mod, st, world,
                                                 out, m, r, N, HW, C, eps, slope, s);
  return static_cast<int>(cudaGetLastError());
}

// The backward's sums launch (deepsee_torch/ops/modnorm.py::
// instance_sums_plan): sums = [sum gy | sum gy * x_hat] per sample and
// channel over this rank's pixels, [2][N][C] float32, `cluster` blocks per
// (sample, channel tile) slab, `smem` bytes of ring (kRingBytes).  One
// cluster launch; cudaErrorInvalidValue for a plan the kernel does not
// take.
extern "C" int modnorm_instance_backward_sums(const void* x, const void* mod, const void* gout,
                                              const void* mean, const void* rstd, void* sums,
                                              int N, int64_t HW, int C, int tile, int cluster,
                                              int smem, int dtype, int lrelu, float slope,
                                              void* stream) {
  if (sums == nullptr || smem != kRingBytes || !cluster_split_ok(N, HW, C, tile, cluster, dtype))
    return invalid();
  const void* kernel = instance_sums_kernel(dtype, mod != nullptr, lrelu != 0);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (cluster_launch(kernel, N, C, tile, cluster, smem, static_cast<cudaStream_t>(stream),
                     &cfg, &attr) == nullptr)
    return invalid();
  void* args[] = {&x, &mod, &gout, &mean, &rstd, &sums, &HW, &C, &tile, &slope};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, kernel, args);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The backward's apply launch: grad_x (x's layout) and, where `mod` is given,
// grad_mod (its 2C layout) from the all-reduced `sums` [2][N][C] over `count`
// pixels per sample (the whole map's, every stripe's).
extern "C" int modnorm_instance_backward_apply(const void* x, const void* mod, const void* gout,
                                               const void* mean, const void* rstd,
                                               const void* sums, void* gx, void* gmod, int N,
                                               int64_t HW, int C, float count, int dtype,
                                               int lrelu, float slope, void* stream) {
  if (N < 1 || N > 65535 || HW < 1 || C < kVec || C % kVec || C > 6144 || !(count >= 1.f) ||
      (mod != nullptr) != (gmod != nullptr))
    return invalid();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  const float* sm = static_cast<const float*>(sums);
  if (dtype == 0)
    dispatch_flags<float, InstanceBackwardApply>(mod != nullptr, lrelu != 0, x, mod, gout, m, r,
                                                 sm, gx, gmod, N, HW, C, count, slope, s);
  else
    dispatch_flags<__nv_bfloat16, InstanceBackwardApply>(mod != nullptr, lrelu != 0, x, mod,
                                                         gout, m, r, sm, gx, gmod, N, HW, C,
                                                         count, slope, s);
  return static_cast<int>(cudaGetLastError());
}
