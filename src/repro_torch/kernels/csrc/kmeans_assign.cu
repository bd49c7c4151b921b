// K-Means assignment (nearest centre and its squared distance), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kmeans_assign_pallas (body _kernel) in
// src/repro/kernels/kmeans_assign.py:45 and its site-axis form (jax.vmap in
// src/repro/kernels/ops.py: kmeans_assign_sites), which here is the site axis
// of the grid: every site is assigned by ONE launch, each against its own
// centres.
//
// What it computes, per site s and point n (x (S, N, D), centres (S, K, D),
// float32, row-major and contiguous):
//   d2[k]          = (|x|^2 + |c_k|^2) - 2 * x.c_k          (the expanded form)
//   assign[s, n]   = the first k with the smallest d2[k]    (strict <, k ascending)
//   min_d2[s, n]   = max(d2[assign], 0)
// The argmin is taken over the UNCLAMPED d2, as the TPU kernel takes it; only
// the minimum is clamped.  Every dot product and norm is summed over d in
// index order with one rounding per product and per sum (__fmul_rn and
// __fadd_rn, which the compiler never fuses into an FMA), which is exactly
// the order of the plain version (kernels/ref.py:kmeans_assign_sites_ref):
// the two agree bit for bit.  No padding: the TPU wrapper pads D and K to 128
// lanes with 1e30 sentinel centres; here D and K are runtime sizes.
//
// What bounds it on this card: bytes.  At the main path's shape (S=200,
// N=250,000, K=20, D=8) it reads 1.6 GB of points and writes 0.4 GB of
// results, 0.60 ms at 3.35 TB/s, against 2*S*N*K*D = 1.6e10 flops, 0.24 ms at
// the 67 TFLOP/s fp32 peak (with separate multiply and add, 0.48 ms of
// instruction issue).  The design reads every point once and keeps every
// other operand on chip:
//   * one thread per point, its row held in registers (MAXD of them, zero past
//     D) and read as 16-byte loads when D is a multiple of 4; neighbouring
//     threads read neighbouring rows, so a warp's loads are contiguous;
//   * the site's centres and their norms staged in shared memory, a tile of
//     kTileFloats / MAXD centres at a time, and read as 16-byte broadcast loads
//     (every thread of a warp reads the same centre); K * D beyond one tile
//     loops over tiles;
//   * no atomics and no cross-thread reduction: each output is written once
//     by its own thread, so the result is deterministic.
// The TPU's (TN x D) . (D x K) MXU blocks are not carried over: at K=20 and
// D=8 there is nothing for a tensor core to do.
//
// Limits: 1 <= D <= 128, 1 <= K <= 65,536, 1 <= S <= 65,535 (the grid's y
// axis), N >= 1 and S * N * D < 2^63.  The wrapper raises past them and handles
// N = 0 without a launch.  The C entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 4096;  // 16 KB of centres in shared memory per tile

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ x, const float* __restrict__ centers,
              int* __restrict__ assign, float* __restrict__ min_d2, int N, int K, int D) {
  static_assert(MAXD % 4 == 0, "centre rows are read as float4");
  constexpr int kTileK = kTileFloats / MAXD;
  __shared__ __align__(16) float tile[kTileK * MAXD];
  __shared__ float norms[kTileK];

  const int s = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < N;
  const float* c_site = centers + static_cast<size_t>(s) * K * D;

  float xr[MAXD];
  if (live) {
    const float* row = x + (static_cast<size_t>(s) * N + n) * D;
    if ((D & 3) == 0) {  // rows are 16-byte aligned: the wrapper passes an aligned base
#pragma unroll
      for (int q = 0; q < MAXD / 4; ++q) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (4 * q < D) v = reinterpret_cast<const float4*>(row)[q];
        xr[4 * q] = v.x;
        xr[4 * q + 1] = v.y;
        xr[4 * q + 2] = v.z;
        xr[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int d = 0; d < MAXD; ++d) xr[d] = d < D ? row[d] : 0.f;
    }
  } else {
#pragma unroll
    for (int d = 0; d < MAXD; ++d) xr[d] = 0.f;
  }
  float x2 = __fmul_rn(xr[0], xr[0]);
#pragma unroll
  for (int d = 1; d < MAXD; ++d) {
    if (d < D) x2 = __fadd_rn(x2, __fmul_rn(xr[d], xr[d]));
  }

  float best = __int_as_float(0x7f800000);  // +inf
  int arg = 0;
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    const int kt = min(kTileK, K - k0);
    __syncthreads();  // the previous tile is no longer being read
    for (int i = threadIdx.x; i < kt * MAXD; i += kThreads) {  // rows past kt are never read
      const int kk = i / MAXD;
      const int d = i % MAXD;
      tile[i] = d < D ? c_site[static_cast<size_t>(k0 + kk) * D + d] : 0.f;
    }
    __syncthreads();
    for (int kk = threadIdx.x; kk < kt; kk += kThreads) {
      const float* c = tile + kk * MAXD;
      float c2 = __fmul_rn(c[0], c[0]);
      for (int d = 1; d < D; ++d) c2 = __fadd_rn(c2, __fmul_rn(c[d], c[d]));
      norms[kk] = c2;
    }
    __syncthreads();
    for (int kk = 0; kk < kt; ++kk) {
      const float4* c4 = reinterpret_cast<const float4*>(tile + kk * MAXD);
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < MAXD / 4; ++q) {
        const float4 c = c4[q];
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int d = 4 * q + r;
          if (d == 0) {
            dot = __fmul_rn(xr[0], cv[0]);
          } else if (d < D) {
            dot = __fadd_rn(dot, __fmul_rn(xr[d], cv[r]));
          }
        }
      }
      const float d2 = __fsub_rn(__fadd_rn(x2, norms[kk]), __fmul_rn(2.f, dot));
      if (d2 < best) {
        best = d2;
        arg = k0 + kk;
      }
    }
  }
  if (live) {
    const size_t o = static_cast<size_t>(s) * N + n;
    assign[o] = arg;
    min_d2[o] = fmaxf(best, 0.f);
  }
}

template <int MAXD>
void launch(const float* x, const float* c, int* assign, float* min_d2, int S, int N, int K, int D,
            cudaStream_t stream) {
  dim3 grid((N + kThreads - 1) / kThreads, S);
  assign_kernel<MAXD><<<grid, kThreads, 0, stream>>>(x, c, assign, min_d2, N, K, D);
}

}  // namespace

extern "C" {

// x (S, N, D) f32, centers (S, K, D) f32, assign (S, N) int32 out,
// min_d2 (S, N) f32 out.  Limits as stated at the top of this file.
int kmeans_assign_sites_launch(const void* x, const void* centers, void* assign, void* min_d2,
                               int S, int N, int K, int D, void* stream_ptr) {
  if (S < 1 || S > 65535 || N < 1 || K < 1 || K > 65536 || D < 1 || D > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(centers);
  int* ap = static_cast<int*>(assign);
  float* mp = static_cast<float*>(min_d2);
  if (D <= 4) {
    launch<4>(xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 8) {
    launch<8>(xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 16) {
    launch<16>(xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 32) {
    launch<32>(xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 64) {
    launch<64>(xp, cp, ap, mp, S, N, K, D, stream);
  } else {
    launch<128>(xp, cp, ap, mp, S, N, K, D, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
