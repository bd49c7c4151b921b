// K-Means assignment (nearest centre and its squared distance), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kmeans_assign_pallas (body _kernel) in
// src/repro/kernels/kmeans_assign.py:45 and its site-axis form (jax.vmap in
// src/repro/kernels/ops.py: kmeans_assign_sites): every site is assigned by
// ONE launch, each against its own centres.
//
// What it computes, per site s and point n (x (S, N, D), centres (S, K, D),
// float32, row-major and contiguous):
//   d2[k]          = (|x|^2 + |c_k|^2) - 2 * x.c_k          (the expanded form)
//   assign[s, n]   = the first k with the smallest d2[k]    (strict <, k ascending)
//   min_d2[s, n]   = max(d2[assign], 0)
// The argmin is taken over the UNCLAMPED d2, as the TPU kernel takes it; only
// the minimum is clamped.  Every dot product and norm is summed over d in
// index order with one rounding per product and per sum (__fmul_rn,
// __fadd_rn and __fsub_rn, which the compiler never fuses into an FMA),
// which is exactly the order of the plain version
// (kernels/ref.py:kmeans_assign_sites_ref): the two agree bit for bit.  No
// padding: the TPU wrapper pads D and K to 128 lanes with 1e30 sentinel
// centres; here D and K are runtime sizes.
//
// What bounds it on this card: bytes and instruction issue, about equally.
// At the clustering path's shape (S=200, N=250,000, K=20, D=8) it reads 1.6
// GB of points and writes 0.4 GB of results, 0.60 ms at 3.35 TB/s; and the
// plain version's order costs 2D + 5 = 21 instructions a (point, centre)
// pair (8 FMUL, 7 FADD, |x|^2 + |c|^2, 2 * dot, the subtraction, the compare
// and its two selects), 2.1e10 over the launch, 0.63 ms at 128 lanes a clock
// on 132 SMs at 1.98 GHz.  No tensor cores: at K=20 and D=8 there is
// nothing for them to do, and TF32 would be another function.  The design
// spends as little as it can beside those two floors and overlaps them:
//   * persistent CTAs (as many as fit on the card at once) each walk one
//     contiguous range of (site, block of threads * P points) work items;
//   * a site's centres and their norms are staged in shared memory once per
//     site a CTA visits (the norms in the plain version's order, one centre
//     a thread); K * D beyond one tile of kTileFloats loops over tiles, each
//     restaged for every block;
//   * each thread holds P points (4 at D <= 8), so one centre read from
//     shared memory (16-byte broadcast loads) feeds P points; point p of a
//     block is row p * threads + thread, so a warp's loads are contiguous;
//   * at D <= 16 the next block's rows are loaded into registers before the
//     current block is computed, so bytes stay in flight during the
//     arithmetic;
//   * D equal to its register width (D = 8 on the path) is its own build,
//     with no per-dimension guard left in the loops;
//   * no atomics and no cross-thread reduction: each output is written once
//     by its own thread, so the result is deterministic.
// Tried and not kept, none faster: staging the next block's rows in shared
// memory with cp.async (its two barriers a block cost more than the
// registers it frees); an L2 prefetch of them in place of the registers,
// with or without a third CTA an SM; and folding 2 * dot and the
// subtraction into one FMA where the norms rule out an overflow
// (bit-identical there, but the second code path it needs cost what the
// saved instruction gained).
//
// Two more builds of this body exist for measurement only (Mode below,
// csrc/kmeans_assign_floors.cu): kLoadOnly reads every point row and writes
// both outputs from its bits with no arithmetic; kArithOnly makes each point
// in registers from its index, loads no row, and does all the arithmetic.
//
// Launch variants, for the autotuner (kernels/autotune.py): the CTA size
// and the points a thread are template parameters, and Variants<MAXD> lists
// the (threads, points) pairs built at MAXD 4, 8 and 16, where the paths run
// (kmeans_assign.cu's kmeans_assign_variant_launch); wider D has only the
// default.  Every variant computes each point with the same arithmetic, over
// d and k in index order: only which thread holds a point changes, so all
// give the same bits.  run() launches the default, variant 0.
//
// D > 128 (wide_kernel below): the points no longer fit in registers, so a
// simpler kernel takes them.  One thread a point, kThreads a CTA, a grid
// row a site.  For each tile of kWideK centres it walks D in chunks of
// kWideChunk: the CTA stages its points' chunk and the tile's chunk in
// shared memory (rows padded to kWideChunk + 1 floats: no bank conflicts),
// and each thread carries its kWideK dot products, |x|^2 (first tile) and
// one thread a centre its norm across the chunks, each summed over d in
// index order with the same roundings as above; once D is done, the tile's
// d2 are formed and compared in k order.  The result is the same function,
// bit for bit.  It has one launch (256 threads, one point a thread), which
// the autotuner leaves at its default, and no floor builds.
//
// Limits: D >= 1 (the register builds to D = 128, wide_kernel past it),
// 1 <= K <= 65,536, 1 <= S <= 65,535, N >= 1 and S * N * D < 2^63.  The
// wrapper raises past them and handles N = 0 without a launch.  The entry
// points launch on the caller's stream (one launch a call), allocate
// nothing, do not synchronise, and return cudaGetLastError().

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace kmeans {

enum Mode : int { kFull = 0, kLoadOnly = 1, kArithOnly = 2 };

constexpr int kThreads = 256;      // the default CTA size
constexpr int kTileFloats = 4096;  // 16 KB of centres in shared memory per tile
constexpr int kMaxDevices = 64;

// the default points a thread, and whether the next block's rows are
// prefetched into registers (which doubles the registers the rows take)
template <int MAXD>
struct Tiling {
  static constexpr int kPoints = MAXD <= 4 ? 8 : MAXD <= 8 ? 4 : MAXD <= 16 ? 2 : 1;
  static constexpr bool kPrefetch = MAXD <= 16;
};

// The launch variants at MAXD: (threads, points a thread); variant 0 is the
// default (kThreads, Tiling<MAXD>::kPoints).  Static shared memory a CTA is
// 4 * (kTileFloats + kTileFloats / MAXD) bytes in every variant.
template <int MAXD>
struct Variants {
  static constexpr int kCount = 1;
  static constexpr int kList[1][2] = {{kThreads, Tiling<MAXD>::kPoints}};
};
template <>
struct Variants<4> {
  static constexpr int kCount = 6;
  static constexpr int kList[6][2] = {{256, 8}, {128, 8}, {512, 8}, {256, 4}, {256, 16}, {128, 16}};
};
template <>
struct Variants<8> {
  static constexpr int kCount = 6;
  static constexpr int kList[6][2] = {{256, 4}, {128, 4}, {512, 4}, {256, 2}, {256, 8}, {128, 8}};
};
template <>
struct Variants<16> {
  static constexpr int kCount = 6;
  static constexpr int kList[6][2] = {{256, 2}, {128, 2}, {512, 2}, {256, 1}, {256, 4}, {128, 4}};
};
static_assert(Variants<4>::kList[0][0] == kThreads && Variants<4>::kList[0][1] == Tiling<4>::kPoints &&
                  Variants<8>::kList[0][0] == kThreads && Variants<8>::kList[0][1] == Tiling<8>::kPoints &&
                  Variants<16>::kList[0][0] == kThreads && Variants<16>::kList[0][1] == Tiling<16>::kPoints,
              "variant 0 is the default launch");

// Rows n0 + p * THREADS + threadIdx.x of site s into xr (zero past N and D).
// FULLD: D == MAXD, so no d needs a guard.
template <int MAXD, int THREADS, int P, int MODE, bool FULLD>
__device__ __forceinline__ void load_rows(float (&xr)[P][MAXD], const float* __restrict__ x, int s,
                                          int n0, int N, int D) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int n = n0 + p * THREADS + static_cast<int>(threadIdx.x);
    if (MODE == kArithOnly) {
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {  // a float in [1, 2) from the index
        xr[p][d] = (FULLD || d < D) ? __int_as_float(0x3f800000 | ((n * (2 * d + 1)) & 0x7fffff)) : 0.f;
        asm volatile("" : "+f"(xr[p][d]));  // held in a register, not remade from n at every use
      }
    } else if (n < N) {
      const float* row = x + (static_cast<size_t>(s) * N + n) * D;
      if ((D & 3) == 0) {  // rows are 16-byte aligned: the wrapper passes an aligned base
#pragma unroll
        for (int q = 0; q < MAXD / 4; ++q) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (FULLD || 4 * q < D) v = __ldg(reinterpret_cast<const float4*>(row) + q);
          xr[p][4 * q] = v.x;
          xr[p][4 * q + 1] = v.y;
          xr[p][4 * q + 2] = v.z;
          xr[p][4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int d = 0; d < MAXD; ++d) xr[p][d] = (FULLD || d < D) ? __ldg(row + d) : 0.f;
      }
    } else {
#pragma unroll
      for (int d = 0; d < MAXD; ++d) xr[p][d] = 0.f;
    }
  }
}

// grid: persistent CTAs of THREADS threads, P points a thread; CTA b takes
// work items [b * per_cta, (b + 1) * per_cta) of the S * blocks_per_site
// items, item = s * blocks_per_site + block.
template <int MAXD, int THREADS, int P, int MODE, bool FULLD>
__global__ void __launch_bounds__(THREADS)
assign_kernel(const float* __restrict__ x, const float* __restrict__ centers, int* __restrict__ assign,
              float* __restrict__ min_d2, int N, int K, int D, int blocks_per_site, long long items,
              long long per_cta) {
  static_assert(MAXD % 4 == 0, "centre rows are read as float4");
  constexpr int kBlock = THREADS * P;  // points a work item
  constexpr bool kPrefetch = Tiling<MAXD>::kPrefetch && MODE != kArithOnly;
  constexpr int kTileK = kTileFloats / MAXD;
  __shared__ __align__(16) float tile[kTileK * MAXD];
  __shared__ float norms[kTileK];

  const long long first = static_cast<long long>(blockIdx.x) * per_cta;
  const long long last = min(items, first + per_cta);
  const bool one_tile = K <= kTileK;
  int staged = -1;  // the site whose centres the tile holds, when they fit one tile

  float xr[P][MAXD];
  float xn[P][MAXD];
  if (kPrefetch && first < last) {
    load_rows<MAXD, THREADS, P, MODE, FULLD>(xn, x, static_cast<int>(first / blocks_per_site),
                                             static_cast<int>(first % blocks_per_site) * kBlock, N, D);
  }
  for (long long item = first; item < last; ++item) {  // uniform across the CTA
    const int s = static_cast<int>(item / blocks_per_site);
    const int n0 = static_cast<int>(item % blocks_per_site) * kBlock;
    if (kPrefetch) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int d = 0; d < MAXD; ++d) xr[p][d] = xn[p][d];
      }
      if (item + 1 < last) {
        load_rows<MAXD, THREADS, P, MODE, FULLD>(xn, x, static_cast<int>((item + 1) / blocks_per_site),
                                                 static_cast<int>((item + 1) % blocks_per_site) * kBlock, N, D);
      }
    } else {
      load_rows<MAXD, THREADS, P, MODE, FULLD>(xr, x, s, n0, N, D);
    }

    if (MODE == kLoadOnly) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int n = n0 + p * THREADS + static_cast<int>(threadIdx.x);
        int bits = 0;
#pragma unroll
        for (int d = 0; d < MAXD; ++d) bits ^= __float_as_int(xr[p][d]);
        if (n < N) {
          const size_t o = static_cast<size_t>(s) * N + n;
          assign[o] = bits;
          min_d2[o] = xr[p][0];
        }
      }
      continue;
    }

    float x2[P];
    float best[P];
    int arg[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      x2[p] = __fmul_rn(xr[p][0], xr[p][0]);
#pragma unroll
      for (int d = 1; d < MAXD; ++d) {
        if (FULLD || d < D) x2[p] = __fadd_rn(x2[p], __fmul_rn(xr[p][d], xr[p][d]));
      }
      best[p] = __int_as_float(0x7f800000);  // +inf
      arg[p] = 0;
    }

    const float* c_site = centers + static_cast<size_t>(s) * K * D;
    for (int k0 = 0; k0 < K; k0 += kTileK) {
      const int kt = min(kTileK, K - k0);
      if (!one_tile || s != staged) {  // uniform across the CTA
        __syncthreads();  // the previous tile is no longer being read
        for (int i = threadIdx.x; i < kt * MAXD; i += THREADS) {  // rows past kt are never read
          const int kk = i / MAXD;
          const int d = i % MAXD;
          tile[i] = (FULLD || d < D) ? c_site[static_cast<size_t>(k0 + kk) * D + d] : 0.f;
        }
        __syncthreads();
        for (int kk = threadIdx.x; kk < kt; kk += THREADS) {
          const float* c = tile + kk * MAXD;
          float c2 = __fmul_rn(c[0], c[0]);
          for (int d = 1; d < D; ++d) c2 = __fadd_rn(c2, __fmul_rn(c[d], c[d]));
          norms[kk] = c2;
        }
        __syncthreads();
        staged = s;
      }
      for (int kk = 0; kk < kt; ++kk) {
        const float4* c4 = reinterpret_cast<const float4*>(tile + kk * MAXD);
        float dot[P];
#pragma unroll
        for (int q = 0; q < MAXD / 4; ++q) {  // each 16-byte load of the centre feeds P points
          const float4 c = c4[q];
          const float cq[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int d = 4 * q + r;
#pragma unroll
            for (int p = 0; p < P; ++p) {
              if (d == 0) {
                dot[p] = __fmul_rn(xr[p][0], cq[0]);
              } else if (FULLD || d < D) {
                dot[p] = __fadd_rn(dot[p], __fmul_rn(xr[p][d], cq[r]));
              }
            }
          }
        }
        const float c2 = norms[kk];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float d2 = __fsub_rn(__fadd_rn(x2[p], c2), __fmul_rn(2.f, dot[p]));
          if (d2 < best[p]) {
            best[p] = d2;
            arg[p] = k0 + kk;
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int n = n0 + p * THREADS + static_cast<int>(threadIdx.x);
      if (n < N) {
        const size_t o = static_cast<size_t>(s) * N + n;
        assign[o] = arg[p];
        min_d2[o] = fmaxf(best[p], 0.f);
      }
    }
  }
}

// CTAs of assign_kernel<MAXD, THREADS, P, MODE, FULLD> resident on the
// current device at once, queried once per device and instantiation, then
// cached.
template <int MAXD, int THREADS, int P, int MODE, bool FULLD>
cudaError_t resident_ctas(int* out) {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int ctas = cached[dev].load(std::memory_order_relaxed);
  if (ctas == 0) {
    int sms = 0;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, assign_kernel<MAXD, THREADS, P, MODE, FULLD>,
                                                        THREADS, 0);
    if (err != cudaSuccess) return err;
    ctas = std::max(1, sms * per_sm);
    cached[dev].store(ctas, std::memory_order_relaxed);
  }
  *out = ctas;
  return cudaSuccess;
}

template <int MAXD, int THREADS, int P, int MODE, bool FULLD>
cudaError_t launch_tiled(const float* x, const float* c, int* assign, float* min_d2, int S, int N, int K, int D,
                         cudaStream_t stream) {
  int ctas = 0;
  const cudaError_t err = resident_ctas<MAXD, THREADS, P, MODE, FULLD>(&ctas);
  if (err != cudaSuccess) return err;
  constexpr int kBlock = THREADS * P;
  const int blocks_per_site = (N + kBlock - 1) / kBlock;
  const long long items = static_cast<long long>(S) * blocks_per_site;
  const long long per_cta = (items + ctas - 1) / ctas;
  const int grid = static_cast<int>((items + per_cta - 1) / per_cta);
  assign_kernel<MAXD, THREADS, P, MODE, FULLD><<<grid, THREADS, 0, stream>>>(x, c, assign, min_d2, N, K, D,
                                                                            blocks_per_site, items, per_cta);
  return cudaSuccess;
}

template <int MAXD, int THREADS, int P, int MODE>
cudaError_t launch(const float* x, const float* c, int* assign, float* min_d2, int S, int N, int K, int D,
                   cudaStream_t stream) {
  if (D == MAXD) return launch_tiled<MAXD, THREADS, P, MODE, true>(x, c, assign, min_d2, S, N, K, D, stream);
  return launch_tiled<MAXD, THREADS, P, MODE, false>(x, c, assign, min_d2, S, N, K, D, stream);
}

// The default launch at MAXD.
template <int MAXD, int MODE>
cudaError_t launch_default(const float* x, const float* c, int* assign, float* min_d2, int S, int N, int K, int D,
                           cudaStream_t stream) {
  return launch<MAXD, kThreads, Tiling<MAXD>::kPoints, MODE>(x, c, assign, min_d2, S, N, K, D, stream);
}

constexpr int kMaxRegisterD = 128;  // the widest register build; wide_kernel past it
constexpr int kWideK = 32;          // centres a tile of wide_kernel
constexpr int kWideChunk = 32;      // dimensions a chunk of wide_kernel

// grid (ceil(N / kThreads), S), kThreads threads, one point a thread: point
// blockIdx.x * kThreads + threadIdx.x of site blockIdx.y against the site's
// K centres at any D.  Static shared memory: 4 * ((kThreads + kWideK) *
// (kWideChunk + 1) + kWideK) bytes.
__global__ void __launch_bounds__(kThreads)
wide_kernel(const float* __restrict__ x, const float* __restrict__ centers, int* __restrict__ assign,
            float* __restrict__ min_d2, int N, int K, int D) {
  constexpr int kLd = kWideChunk + 1;
  __shared__ float xs[kThreads * kLd];
  __shared__ float cs[kWideK * kLd];
  __shared__ float norms[kWideK];
  const int s = blockIdx.y;
  const int n0 = static_cast<int>(blockIdx.x) * kThreads;
  const int n = n0 + static_cast<int>(threadIdx.x);
  const float* x_site = x + static_cast<size_t>(s) * N * D;
  const float* c_site = centers + static_cast<size_t>(s) * K * D;

  float x2 = 0.f;
  float best = __int_as_float(0x7f800000);  // +inf
  int arg = 0;
  for (int k0 = 0; k0 < K; k0 += kWideK) {  // uniform across the CTA
    const int kt = min(kWideK, K - k0);
    float dot[kWideK] = {};
    float c2 = 0.f;  // thread kk < kt: the norm of centre k0 + kk
    for (int d0 = 0; d0 < D; d0 += kWideChunk) {
      const int dc = min(kWideChunk, D - d0);
      __syncthreads();  // the previous chunk (and the previous tile's norms) are read
      for (int i = threadIdx.x; i < kThreads * kWideChunk; i += kThreads) {
        const int r = i / kWideChunk;
        const int c = i - r * kWideChunk;
        xs[r * kLd + c] = (n0 + r < N && c < dc) ? x_site[static_cast<size_t>(n0 + r) * D + d0 + c] : 0.f;
      }
      for (int i = threadIdx.x; i < kWideK * kWideChunk; i += kThreads) {
        const int kk = i / kWideChunk;
        const int c = i - kk * kWideChunk;
        cs[kk * kLd + c] = (kk < kt && c < dc) ? c_site[static_cast<size_t>(k0 + kk) * D + d0 + c] : 0.f;
      }
      __syncthreads();
      const float* xr = xs + threadIdx.x * kLd;
#pragma unroll
      for (int c = 0; c < kWideChunk; ++c) {
        if (c < dc) {
          const bool first = d0 == 0 && c == 0;  // the sum's first term is its first product
          const float xc = xr[c];
          if (k0 == 0) x2 = first ? __fmul_rn(xc, xc) : __fadd_rn(x2, __fmul_rn(xc, xc));
          if (static_cast<int>(threadIdx.x) < kt) {
            const float cc = cs[threadIdx.x * kLd + c];
            c2 = first ? __fmul_rn(cc, cc) : __fadd_rn(c2, __fmul_rn(cc, cc));
          }
#pragma unroll
          for (int kk = 0; kk < kWideK; ++kk) {
            const float pr = __fmul_rn(xc, cs[kk * kLd + c]);
            dot[kk] = first ? pr : __fadd_rn(dot[kk], pr);
          }
        }
      }
    }
    if (static_cast<int>(threadIdx.x) < kt) norms[threadIdx.x] = c2;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWideK; ++kk) {
      if (kk < kt) {
        const float d2 = __fsub_rn(__fadd_rn(x2, norms[kk]), __fmul_rn(2.f, dot[kk]));
        if (d2 < best) {
          best = d2;
          arg = k0 + kk;
        }
      }
    }
  }
  if (n < N) {
    const size_t o = static_cast<size_t>(s) * N + n;
    assign[o] = arg;
    min_d2[o] = fmaxf(best, 0.f);
  }
}

inline cudaError_t launch_wide(const float* x, const float* c, int* assign, float* min_d2, int S, int N, int K,
                               int D, cudaStream_t stream) {
  if (N > 0x7fffffff - kThreads) return cudaErrorInvalidValue;
  wide_kernel<<<dim3((N + kThreads - 1) / kThreads, S), kThreads, 0, stream>>>(x, c, assign, min_d2, N, K, D);
  return cudaSuccess;
}

// True when the sizes are inside the limits stated at the top of this file.
inline bool in_limits(int S, int N, int K, int D) {
  return S >= 1 && S <= 65535 && N >= 1 && K >= 1 && K <= 65536 && D >= 1;
}

// x (S, N, D) f32, centers (S, K, D) f32, assign (S, N) int32 out,
// min_d2 (S, N) f32 out.  Limits as stated at the top of this file.
template <int MODE>
int run(const void* x, const void* centers, void* assign, void* min_d2, int S, int N, int K, int D,
        void* stream_ptr) {
  if (!in_limits(S, N, K, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (MODE != kFull && D > kMaxRegisterD) return static_cast<int>(cudaErrorInvalidValue);  // no wide floors
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(centers);
  int* ap = static_cast<int*>(assign);
  float* mp = static_cast<float*>(min_d2);
  cudaError_t err;
  if (D <= 4) {
    err = launch_default<4, MODE>(xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 8) {
    err = launch_default<8, MODE>(xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 16) {
    err = launch_default<16, MODE>(xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 32) {
    err = launch_default<32, MODE>(xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 64) {
    err = launch_default<64, MODE>(xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= kMaxRegisterD) {
    err = launch_default<128, MODE>(xp, cp, ap, mp, S, N, K, D, stream);
  } else {
    err = launch_wide(xp, cp, ap, mp, S, N, K, D, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kmeans
