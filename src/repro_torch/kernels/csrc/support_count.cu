// Itemset support counting over packed bitmaps, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/support_count.py:
//   support_count_pallas        (body _kernel)        -> count-only launch
//   support_count_prune_pallas  (body _prune_kernel)  -> count + threshold flags
// and their site-axis forms (jax.vmap in src/repro/kernels/ops.py:
// support_count_sites, support_count_prune_sites), which here are the site
// axis of the grid: every site is counted by ONE launch.
//
// What it computes, per site s, candidate c:
//   counts[s, c] = #{ n < N : (tx[s, n, w] & masks[s, c, w]) == masks[s, c, w] for all w < W }
//   flags[s, c]  = counts[s, c] >= min_counts[s]          (prune form only)
// Layout is the natural one: tx (S, N, W), masks (S, C, W), int32 bit views of
// the uint32 packed words, row-major and contiguous.  N is not padded, so an
// all-zero mask counts every row it is given, exactly as the plain version.
//
// What bounds it on this card: integer ALU throughput, not bytes.  At the main-path
// shape (S=4, N=25,000, C=2,048, W=32) the 12.8 MB of packed transactions are
// read from HBM in microseconds, while the dense test is S*N*C*W = 6.6e9
// word tests, one LOP3 each.  The design keeps every operand on chip:
//   * one thread per candidate, its W mask words held in registers (zero past
//     W, and a zero mask word always matches, so no per-word predicate);
//   * a CTA stages TN transaction rows in shared memory, and each row is read
//     as 16-byte broadcast loads (every thread of a warp reads the same row);
//   * the TPU's sequential N-innermost accumulation has no GPU counterpart:
//     the N axis is split across CTAs so the grid fills every SM even when
//     S * C is small, and each CTA adds its partial count with one int32
//     atomicAdd per candidate (exact and order-free);
//   * the prune form's threshold runs as a second, tiny launch on the same
//     stream once every partial count has landed.
// Not yet done (later work): skipping the all-zero mask words, of which a
// k-itemset has at least W - k.
//
// The C entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kTileC = 128;  // candidates per CTA: one per thread
constexpr int kTileN = 64;   // transaction rows staged in shared memory per step
constexpr int kMaxDevices = 64;

template <int MAXW>
__global__ void __launch_bounds__(kTileC)
count_kernel(const int* __restrict__ tx, const int* __restrict__ masks,
             int* __restrict__ counts, int N, int C, int W, int rows_per_split) {
  static_assert(MAXW % 4 == 0, "rows are read as int4");
  __shared__ __align__(16) int tile[kTileN * MAXW];

  const int s = blockIdx.z;
  const int c = blockIdx.x * kTileC + threadIdx.x;
  const int n_begin = blockIdx.y * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int* tx_site = tx + static_cast<size_t>(s) * N * W;

  int m[MAXW];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    m[w] = (c < C && w < W) ? masks[(static_cast<size_t>(s) * C + c) * W + w] : 0;
  }

  int cnt = 0;
  for (int n0 = n_begin; n0 < n_end; n0 += kTileN) {
    const int rows = min(kTileN, n_end - n0);
    __syncthreads();  // the previous tile is no longer being read
    for (int i = threadIdx.x; i < kTileN * MAXW; i += kTileC) {
      const int r = i / MAXW;
      const int w = i % MAXW;
      tile[i] = (r < rows && w < W) ? tx_site[static_cast<size_t>(n0 + r) * W + w] : 0;
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const int4* row = reinterpret_cast<const int4*>(tile + r * MAXW);
      int miss = 0;  // bits the candidate needs and the transaction lacks
#pragma unroll
      for (int q = 0; q < MAXW / 4; ++q) {
        const int4 t = row[q];
        miss |= (m[4 * q] & ~t.x) | (m[4 * q + 1] & ~t.y) | (m[4 * q + 2] & ~t.z) |
                (m[4 * q + 3] & ~t.w);
      }
      cnt += (miss == 0);
    }
  }
  if (c < C && cnt != 0) atomicAdd(&counts[static_cast<size_t>(s) * C + c], cnt);
}

__global__ void threshold_kernel(const int* __restrict__ counts, const int* __restrict__ min_counts,
                                 unsigned char* __restrict__ flags, int C, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) flags[i] = counts[i] >= min_counts[i / C] ? 1 : 0;
}

// One full wave of count_kernel<MAXW> on device `dev`: its SMs times the
// CTAs of this instantiation that fit on one SM (registers decide it: ptxas
// gives MAXW=32 64 registers, so 8 CTAs of 128 threads; the narrower
// instantiations use fewer and fit more).  Queried once per device and
// template, then cached.
template <int MAXW>
cudaError_t wave_ctas(int dev, int* out) {
  static std::atomic<int> cached[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int wave = cached[dev].load(std::memory_order_relaxed);
  if (wave == 0) {
    int sms = 0;
    int per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_kernel<MAXW>, kTileC, 0);
    if (err != cudaSuccess) return err;
    wave = std::max(1, sms * per_sm);
    cached[dev].store(wave, std::memory_order_relaxed);
  }
  *out = wave;
  return cudaSuccess;
}

template <int MAXW>
cudaError_t launch_count(const int* tx, const int* masks, int* counts, int S, int N, int C, int W,
                         int dev, cudaStream_t stream) {
  int target = 0;
  const cudaError_t err = wave_ctas<MAXW>(dev, &target);
  if (err != cudaSuccess) return err;
  const int c_tiles = (C + kTileC - 1) / kTileC;
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const long long base = static_cast<long long>(c_tiles) * S;
  // as many N splits as fit in ONE wave of resident CTAs: a grid just over
  // a wave leaves a tail of CTAs that run alone
  int splits = static_cast<int>(std::min<long long>(target / base, n_tiles));
  splits = std::max(1, splits);
  // whole row tiles per split, so only the last split has a ragged tile
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const int rows_per_split = tiles_per_split * kTileN;
  splits = (N + rows_per_split - 1) / rows_per_split;
  dim3 grid(c_tiles, splits, S);
  count_kernel<MAXW><<<grid, kTileC, 0, stream>>>(tx, masks, counts, N, C, W, rows_per_split);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// tx (S, N, W) int32, masks (S, C, W) int32, counts (S, C) int32 out.
// min_counts (S,) int32 and flags (S, C) bool out are both null for the
// count-only form.  S, N, C >= 1 and 1 <= W <= 32; the caller handles zero
// sizes without a launch.  `device` is the ordinal the tensors live on,
// which is also the current device.
int support_count_sites_launch(const void* tx, const void* masks, const void* min_counts,
                               void* counts, void* flags, int S, int N, int C, int W,
                               int device, void* stream_ptr) {
  if (S < 1 || N < 1 || C < 1 || W < 1 || W > 32) return static_cast<int>(cudaErrorInvalidValue);
  if ((min_counts == nullptr) != (flags == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int* t = static_cast<const int*>(tx);
  const int* mk = static_cast<const int*>(masks);
  int* out = static_cast<int*>(counts);
  const int total = S * C;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * static_cast<size_t>(total), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W <= 4) {
    err = launch_count<4>(t, mk, out, S, N, C, W, device, stream);
  } else if (W <= 8) {
    err = launch_count<8>(t, mk, out, S, N, C, W, device, stream);
  } else if (W <= 16) {
    err = launch_count<16>(t, mk, out, S, N, C, W, device, stream);
  } else {
    err = launch_count<32>(t, mk, out, S, N, C, W, device, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (min_counts != nullptr) {
    const int threads = 256;
    threshold_kernel<<<(total + threads - 1) / threads, threads, 0, stream>>>(
        out, static_cast<const int*>(min_counts), static_cast<unsigned char*>(flags), C, total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
