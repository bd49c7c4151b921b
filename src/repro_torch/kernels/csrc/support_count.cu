// Itemset support counting over bit-sliced bitmaps, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/support_count.py:
//   support_count_pallas        (body _kernel)        -> counts only
//   support_count_prune_pallas  (body _prune_kernel)  -> counts + threshold flags
// and their site-axis forms (jax.vmap in src/repro/kernels/ops.py:
// support_count_sites, support_count_prune_sites), which here are the site
// axis of the grids: every site is counted by ONE call.
//
// What it computes, per site s, candidate c:
//   counts[s, c] = #{ n < N : (tx[s, n, w] & masks[s, c, w]) == masks[s, c, w] for all w < W }
//   flags[s, c]  = counts[s, c] >= min_counts[s]          (prune form only)
// tx (S, N, W) and masks (S, C, W) are int32 bit views of the uint32 packed
// words (bit b of word w is item 32w + b), row-major and contiguous.  N is
// not padded, so an all-zero mask counts every row it is given, zero pad
// rows included, exactly as the plain version.
//
// What bounds it on this card: the work of the algorithm.  The horizontal
// test (one row against one mask, word by word) decides ONE transaction per
// word operation: S*N*C*W = 3.5e10 of them at GFM's level 4 (S=4, N=25,000,
// C=10,883, W=32).  Bit-sliced, one 32-bit AND decides 32 transactions: a
// candidate of k items needs ceil(N/32) * (k + 1) word operations a site,
// about 200x fewer there, and the kernel's time goes to reading the item
// columns.  Two stages on the caller's stream:
//   1. transpose_kernel: tx (S, N, W) -> vt (S, 32W, ceil(N/32)), bit r of
//      vt[s, i, j] = item i of transaction 32j + r (zero past N).  A CTA
//      reads its 256 rows x W words as one contiguous, coalesced run, all
//      32 loads a thread in flight at once, into shared memory (row stride
//      W | 1: no bank conflicts); each lane of a warp takes one of its 32
//      rows, and each word of those rows, a 32 x 32 bit block, is
//      transposed with five __shfl_xor_sync butterfly stages; the results
//      go back through shared memory (stride 9) and out as 8 consecutive
//      words of every item row.  At level 4 vt is 12.8 MB and stays in the
//      50 MB L2 for stage 2.
//   2. count_kernel: one warp per (site, candidate), or per (site,
//      candidate, share of the words) where S*C warps would not fill the
//      card.  The warp reads the mask's W words (one coalesced load) and
//      lists its items in shared memory (a prefix sum of the words'
//      popcounts across lanes, then __ffs); for 4 words a lane at a time it
//      loads the columns vt[s, i, .] of 4 items at once (contiguous across
//      lanes, 16 loads in flight a lane), ANDs them into the valid-row bits
//      (all ones but the last word's rows past N), then adds __popc.  The
//      lanes' sums meet in __reduce_add_sync.  With one warp per count the
//      count and its flag are written once: no memset, no atomics; shared
//      words add exact int32 atomicAdd partials into zeroed counts, and the
//      one partial that takes a count from below its threshold to at or
//      above it (or the first share, for a threshold <= 0) sets the zeroed
//      flag.
// The TPU's sequential N-innermost accumulation has no GPU counterpart; the
// word split above takes its place where the grid is small.
//
// Any W.  Both stages hold the word axis in groups of 32 (one word a lane,
// up to 1,024 items a group).  At W <= 32 there is one group and the
// kernels are the builds above (kWide = false).  Past it (kWide = true):
// the transpose takes one group a grid row (blockIdx.z), reading its words
// of each row at the row stride W; the count walks the mask's groups for
// every block of vt words, skips a group whose words are all zero (a
// candidate of k items touches at most k groups), lists each other group's
// items in the warp's list as indices within the group (below 1,024, so
// the 16-bit list neither overflows nor wraps at any W), and ANDs their
// columns into the same accumulators.  The limit is the transpose grid's z
// axis: ceil(W / 32) <= 65,535.
//
// Launch variants, for the autotuner (kernels/autotune.py, the counterpart
// of the TPU kernels' block sizes): count_kernel is a template over its CTA
// size and (kU, kI), instantiated for the fixed list kCountVariants, and
// support_count_sites_variant_launch takes a variant index and a word split
// (0: the heuristic above; s >= 1: s shares asked for, at least 32 words
// each, so at most ceil(ceil(N/32) / 32) of them).  Every variant and every
// split gives exactly the same counts and flags: a warp's share of the
// words is summed as exact integers in any order.  Variant 0 is the launch
// the other entry points make.  transpose_kernel keeps its one size: its
// static buffer would pass the 48 KB static shared-memory limit at 512
// threads, and it is a bandwidth pass with nothing to tune.
//
// The C entry points launch on the caller's stream, allocate nothing (the
// caller passes vt), do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;              // a transpose CTA, and the default count CTA
constexpr int kRowsT = kThreads;           // transaction rows a transpose CTA
constexpr int kWordsT = kRowsT / 32;       // vt words (32 rows each) a transpose CTA
constexpr int kOutStride = kWordsT + 1;    // odd: no bank conflicts
constexpr int kMaxDevices = 64;
constexpr int kMaxGroups = 65535;          // 32-word groups: the transpose grid's z axis

// The count's launch variants: (CTA threads, kU = vt words a lane ANDs at
// once, kI = items whose words a lane loads at once).  Variant 0 is the
// default launch.  Static shared memory a CTA: threads / 32 * 2 KB.
constexpr int kCountVariants[][3] = {
    {256, 4, 4}, {128, 4, 4}, {512, 4, 4}, {256, 2, 4}, {256, 8, 4},
    {256, 4, 2}, {256, 4, 8}, {128, 8, 4}, {512, 2, 4},
};
constexpr int kNumCountVariants = sizeof(kCountVariants) / sizeof(kCountVariants[0]);
static_assert(kCountVariants[0][0] == kThreads && kCountVariants[0][1] == 4 && kCountVariants[0][2] == 4,
              "variant 0 is the default launch");

// The 32 x 32 bit matrix held one row a lane (bit b of lane t's word is
// M[t][b]) transposed in registers: lane b returns the word whose bit t is
// M[t][b].  Stage j exchanges index bit j between rows and columns: an
// element whose row and column differ in bit j swaps with the one at
// (t ^ j, b ^ j), so the lane with bit j clear keeps its columns with bit j
// clear and takes its partner's columns with bit j clear, shifted up by j.
template <int J, unsigned LOW>  // LOW: the columns with bit J clear
__device__ __forceinline__ unsigned transpose_stage(unsigned x, int lane) {
  const unsigned y = __shfl_xor_sync(kFull, x, J);
  return (lane & J) ? ((x & ~LOW) | ((y & ~LOW) >> J)) : ((x & LOW) | ((y & LOW) << J));
}

__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  x = transpose_stage<16, 0x0000ffffu>(x, lane);
  x = transpose_stage<8, 0x00ff00ffu>(x, lane);
  x = transpose_stage<4, 0x0f0f0f0fu>(x, lane);
  x = transpose_stage<2, 0x33333333u>(x, lane);
  return transpose_stage<1, 0x55555555u>(x, lane);
}

// grid (ceil(N / 256), S[, ceil(W / 32)]), 256 threads: rows 256*blockIdx.x
// .. +255 of site s, warp k transposing rows 32k .. 32k + 31 of them (vt
// word 8*blockIdx.x + k).  kWide: words 32*blockIdx.z .. +31 of each row
// (the group's G <= 32 words), whose items are vt rows 1024*blockIdx.z on;
// otherwise all W <= 32 words, G = W.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const unsigned* __restrict__ tx, unsigned* __restrict__ vt, int N, int W) {
  // first the CTA's rows at stride G | 1, then vt[s, item, 8*blockIdx.x + k] at item * 9 + k
  __shared__ unsigned buf[32 * 32 * kOutStride];
  const int s = blockIdx.y;
  const int nw = (N + 31) >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = static_cast<int>(blockIdx.x) * kRowsT;
  const int w0 = kWide ? 32 * static_cast<int>(blockIdx.z) : 0;
  const int G = kWide ? min(32, W - w0) : W;
  const int ld = G | 1;

  // the CTA's rows * G words: word i * 256 + thread of them, every load
  // unconditional (the address clamped to the run, the value zeroed past
  // it) so that all are in flight at once.  At W <= 32 they are one
  // contiguous run; a wide group's rows are G words at stride W
  const int run = min(kRowsT, N - r0) * G;
  const unsigned* src = tx + (static_cast<size_t>(s) * N + r0) * W + w0;
  unsigned in[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int e = min(i * kThreads + static_cast<int>(threadIdx.x), run - 1);
    const unsigned v = kWide ? __ldg(src + static_cast<size_t>(e / G) * W + e % G) : __ldg(src + e);
    in[i] = i * kThreads + static_cast<int>(threadIdx.x) < run ? v : 0u;
  }
  int r = static_cast<int>(threadIdx.x) / G;  // word e = i * 256 + thread is (row r, word w)
  int w = static_cast<int>(threadIdx.x) - r * G;
  const int step_r = kThreads / G;
  const int step_w = kThreads - step_r * G;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i < G) buf[r * ld + w] = in[i];
    w += step_w;
    r += step_r;
    if (w >= G) {
      w -= G;
      ++r;
    }
  }
  __syncthreads();
  unsigned words[32];  // this lane's row (32 * warp + lane)
#pragma unroll
  for (int i = 0; i < 32; ++i) words[i] = i < G ? buf[(warp * 32 + lane) * ld + i] : 0u;
  __syncthreads();  // every input word is read
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const unsigned t = transpose32(words[i], lane);
    if (i < G) buf[(32 * i + lane) * kOutStride + warp] = t;
  }
  __syncthreads();
  const int words_here = min(kWordsT, nw - static_cast<int>(blockIdx.x) * kWordsT);
  unsigned* dst = vt + (static_cast<size_t>(s) * 32 * W + 32 * w0) * nw + blockIdx.x * kWordsT;
  for (int e = threadIdx.x; e < 32 * G * kWordsT; e += kThreads) {  // 8 consecutive words of each item row
    const int item = e / kWordsT;
    const int k = e - item * kWordsT;
    if (k < words_here) dst[static_cast<size_t>(item) * nw + k] = buf[item * kOutStride + k];
  }
}

// The items of the 32 mask words the warp holds (lane w: word w of a
// 32-word group of a wide mask) into the warp's list, in order: lane w
// writes the items of word w after those of the words below it, as
// indices 32 * w + bit within the group.  Returns the group's item count.
__device__ __forceinline__ int list_group_items(unsigned m, int lane, unsigned short* list) {
  const int own = __popc(m);
  int below = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, below, o);
    if (lane >= o) below += t;
  }
  const int n_items = __shfl_sync(kFull, below, 31);
  below -= own;
  for (unsigned bits = m; bits != 0u; bits &= bits - 1u) {
    list[below++] = static_cast<unsigned short>(32 * lane + __ffs(bits) - 1);
  }
  __syncwarp();
  return n_items;
}

// One warp per task; task = (s * C + c) * splits + share.  splits == 1: each
// count (and flag) written once.  splits > 1: counts and flags zeroed by the
// caller first, partial counts added with atomicAdd.  kWide: any W, the
// mask's 32-word groups listed one at a time; otherwise W <= 32, the whole
// mask listed once, in a build of its own so that the wide path costs the
// W <= 32 launches no register.
template <int THREADS, int kU, int kI, bool kWide>
__global__ void __launch_bounds__(THREADS)
count_kernel(const unsigned* __restrict__ vt, const unsigned* __restrict__ masks,
             const int* __restrict__ min_counts, int* __restrict__ counts,
             unsigned char* __restrict__ flags, int N, int C, int W, long long tasks, int splits,
             int words_per_split) {
  constexpr int kWarps = THREADS / 32;
  __shared__ unsigned short items[kWarps][32 * 32];  // each warp's mask (group) as a list of items
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (task >= tasks) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int share = static_cast<int>(task % splits);
  const long long sc = task / splits;
  const int s = static_cast<int>(sc / C);
  const int nw = (N + 31) >> 5;
  const int j_begin = share * words_per_split;
  const int j_end = min(nw, j_begin + words_per_split);
  const unsigned tail = (N & 31) ? (1u << (N & 31)) - 1u : kFull;  // valid rows of the last word
  int cnt = 0;
  if constexpr (!kWide) {
    const unsigned m = lane < W ? masks[sc * W + lane] : 0u;
    const unsigned* site = vt + static_cast<size_t>(s) * 32 * W * nw;

    // the mask's items in order, into this warp's list: lane w writes the
    // items of word w after those of the words below it
    unsigned short* list = items[threadIdx.x >> 5];
    const int own = __popc(m);
    int below = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, below, o);
      if (lane >= o) below += t;
    }
    const int n_items = __shfl_sync(kFull, below, 31);
    below -= own;
    for (unsigned bits = m; bits != 0u; bits &= bits - 1u) {
      list[below++] = static_cast<unsigned short>(32 * lane + __ffs(bits) - 1);
    }
    __syncwarp();

    for (int base = j_begin; base < j_end; base += 32 * kU) {  // uniform across the warp
      unsigned acc[kU];
      int at[kU];
#pragma unroll
      for (int q = 0; q < kU; ++q) {
        const int j = base + 32 * q + lane;
        acc[q] = j < j_end ? (j == nw - 1 ? tail : kFull) : 0u;
        at[q] = min(j, nw - 1);  // past j_end: a valid address, ANDed into 0
      }
      for (int t = 0; t < n_items; t += kI) {
        // kI items' words loaded before any is ANDed, so kI * kU loads are in
        // flight; past the last item the last one repeats (AND is idempotent)
        unsigned v[kI][kU];
#pragma unroll
        for (int u = 0; u < kI; ++u) {
          const unsigned* col = site + static_cast<size_t>(list[min(t + u, n_items - 1)]) * nw;
#pragma unroll
          for (int q = 0; q < kU; ++q) v[u][q] = __ldg(col + at[q]);
        }
#pragma unroll
        for (int u = 0; u < kI; ++u) {
#pragma unroll
          for (int q = 0; q < kU; ++q) acc[q] &= v[u][q];
        }
      }
#pragma unroll
      for (int q = 0; q < kU; ++q) cnt += __popc(acc[q]);
    }
  } else {
    const unsigned* site = vt + static_cast<size_t>(s) * 32 * W * nw;
    unsigned short* list = items[threadIdx.x >> 5];
    for (int base = j_begin; base < j_end; base += 32 * kU) {  // uniform across the warp
      unsigned acc[kU];
      int at[kU];
#pragma unroll
      for (int q = 0; q < kU; ++q) {
        const int j = base + 32 * q + lane;
        acc[q] = j < j_end ? (j == nw - 1 ? tail : kFull) : 0u;
        at[q] = min(j, nw - 1);
      }
      for (int g0 = 0; g0 < W; g0 += 32) {  // the mask's 32-word groups, uniform across the warp
        const unsigned m = g0 + lane < W ? masks[sc * W + g0 + lane] : 0u;
        if (__ballot_sync(kFull, m != 0u) == 0u) continue;  // no item in this group
        const int n_items = list_group_items(m, lane, list);
        const unsigned* group = site + static_cast<size_t>(32 * g0) * nw;  // item 32 * g0 on
        for (int t = 0; t < n_items; t += kI) {
          unsigned v[kI][kU];
#pragma unroll
          for (int u = 0; u < kI; ++u) {
            const unsigned* col = group + static_cast<size_t>(list[min(t + u, n_items - 1)]) * nw;
#pragma unroll
            for (int q = 0; q < kU; ++q) v[u][q] = __ldg(col + at[q]);
          }
#pragma unroll
          for (int u = 0; u < kI; ++u) {
#pragma unroll
            for (int q = 0; q < kU; ++q) acc[q] &= v[u][q];
          }
        }
        __syncwarp();  // every lane has read the list before the next group's
      }
#pragma unroll
      for (int q = 0; q < kU; ++q) cnt += __popc(acc[q]);
    }
  }
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane != 0) return;
  if (splits == 1) {
    counts[sc] = cnt;
    if (flags != nullptr) flags[sc] = cnt >= min_counts[s] ? 1 : 0;
    return;
  }
  const int old = atomicAdd(counts + sc, cnt);
  if (flags != nullptr) {
    const int mc = min_counts[s];
    if (old + cnt >= mc && (old < mc || share == 0)) flags[sc] = 1;
  }
}

// Warps resident on the whole card at full occupancy (SMs x 64), queried
// once per device and cached.
cudaError_t card_warps(int dev, int* out) {
  static std::atomic<int> cached[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int warps = cached[dev].load(std::memory_order_relaxed);
  if (warps == 0) {
    int sms = 0;
    int threads = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    if (err != cudaSuccess) return err;
    warps = std::max(1, sms * threads / 32);
    cached[dev].store(warps, std::memory_order_relaxed);
  }
  *out = warps;
  return cudaSuccess;
}

template <int V, bool kWide>
const void* count_kernel_ptr() {
  return reinterpret_cast<const void*>(
      &count_kernel<kCountVariants[V][0], kCountVariants[V][1], kCountVariants[V][2], kWide>);
}

// The __global__ function of count variant v (0 <= v < kNumCountVariants),
// the W <= 32 build or the wide one.
const void* count_kernel_of(int v, bool wide) {
  switch (v) {
    case 0: return wide ? count_kernel_ptr<0, true>() : count_kernel_ptr<0, false>();
    case 1: return wide ? count_kernel_ptr<1, true>() : count_kernel_ptr<1, false>();
    case 2: return wide ? count_kernel_ptr<2, true>() : count_kernel_ptr<2, false>();
    case 3: return wide ? count_kernel_ptr<3, true>() : count_kernel_ptr<3, false>();
    case 4: return wide ? count_kernel_ptr<4, true>() : count_kernel_ptr<4, false>();
    case 5: return wide ? count_kernel_ptr<5, true>() : count_kernel_ptr<5, false>();
    case 6: return wide ? count_kernel_ptr<6, true>() : count_kernel_ptr<6, false>();
    case 7: return wide ? count_kernel_ptr<7, true>() : count_kernel_ptr<7, false>();
    case 8: return wide ? count_kernel_ptr<8, true>() : count_kernel_ptr<8, false>();
    default: return nullptr;
  }
}
static_assert(kNumCountVariants == 9, "count_kernel_of lists every variant");

// Stage 2 with count variant `variant` and word split `split` (0: the
// heuristic; s >= 1: s shares asked for), then cudaGetLastError().
// Arguments as support_count_vertical_launch.
cudaError_t count_stage(const void* vt, const void* masks, const void* min_counts, void* counts, void* flags,
                        int S, int N, int C, int W, int device, int variant, int split, cudaStream_t stream) {
  if (S < 1 || N < 1 || C < 1 || W < 1 || W > 32 * kMaxGroups) return cudaErrorInvalidValue;
  if ((min_counts == nullptr) != (flags == nullptr)) return cudaErrorInvalidValue;
  if (variant < 0 || variant >= kNumCountVariants || split < 0) return cudaErrorInvalidValue;
  int target = 0;
  cudaError_t err = card_warps(device, &target);
  if (err != cudaSuccess) return err;
  const long long pairs = static_cast<long long>(S) * C;
  const int nw = (N + 31) >> 5;
  // share the words only while S*C warps leave the card short (or as many
  // ways as asked), and never below one word a lane
  const long long want = split >= 1 ? split : (target + pairs - 1) / pairs;
  int splits = static_cast<int>(std::max(1LL, std::min<long long>(want, (nw + 31) / 32)));
  const int words_per_split = ((nw + splits - 1) / splits + 31) / 32 * 32;
  splits = (nw + words_per_split - 1) / words_per_split;
  if (splits > 1) {
    err = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(pairs), stream);
    if (err == cudaSuccess && flags != nullptr) err = cudaMemsetAsync(flags, 0, static_cast<size_t>(pairs), stream);
    if (err != cudaSuccess) return err;
  }
  const int threads = kCountVariants[variant][0];
  const long long tasks = pairs * splits;
  const long long ctas = (tasks + threads / 32 - 1) / (threads / 32);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned* vt_p = static_cast<const unsigned*>(vt);
  const unsigned* masks_p = static_cast<const unsigned*>(masks);
  const int* mc_p = static_cast<const int*>(min_counts);
  int* counts_p = static_cast<int*>(counts);
  unsigned char* flags_p = static_cast<unsigned char*>(flags);
  void* args[] = {&vt_p, &masks_p, &mc_p, &counts_p, &flags_p, &N, &C, &W,
                  const_cast<long long*>(&tasks), &splits, const_cast<int*>(&words_per_split)};
  const cudaError_t launched = cudaLaunchKernel(count_kernel_of(variant, W > 32), dim3(static_cast<unsigned>(ctas)),
                                                dim3(threads), args, 0, stream);
  const cudaError_t last = cudaGetLastError();  // and clears a refused launch's error
  return launched != cudaSuccess ? launched : last;
}

}  // namespace

extern "C" {

// Stage 1: tx (S, N, W) int32 -> vt (S, 32W, ceil(N/32)) int32.
// 1 <= S <= 65,535, N >= 1 and 1 <= W <= 32 * 65,535.
int support_count_transpose_launch(const void* tx, void* vt, int S, int N, int W, void* stream_ptr) {
  if (S < 1 || S > 65535 || N < 1 || W < 1 || W > 32 * kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned* tx_p = static_cast<const unsigned*>(tx);
  unsigned* vt_p = static_cast<unsigned*>(vt);
  if (W <= 32) {
    transpose_kernel<false><<<dim3((N + kRowsT - 1) / kRowsT, S), kThreads, 0, stream>>>(tx_p, vt_p, N, W);
  } else {
    transpose_kernel<true><<<dim3((N + kRowsT - 1) / kRowsT, S, (W + 31) / 32), kThreads, 0, stream>>>(
        tx_p, vt_p, N, W);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage 2: vt (S, 32W, ceil(N/32)) int32 from stage 1, masks (S, C, W)
// int32, counts (S, C) int32 out; min_counts (S,) int32 and flags (S, C)
// bool out are both null for the count-only form.  `device` is the ordinal
// the tensors live on, which is also the current device.
int support_count_vertical_launch(const void* vt, const void* masks, const void* min_counts,
                                  void* counts, void* flags, int S, int N, int C, int W, int device,
                                  void* stream_ptr) {
  return static_cast<int>(count_stage(vt, masks, min_counts, counts, flags, S, N, C, W, device, 0, 0,
                                      static_cast<cudaStream_t>(stream_ptr)));
}

// Both stages: tx (S, N, W), masks (S, C, W), min_counts (S,) or null,
// counts (S, C) out, flags (S, C) or null out, and vt (S, 32W, ceil(N/32))
// int32 scratch.  S, N, C >= 1 and 1 <= W <= 32 * 65,535; the caller
// handles zero sizes without a launch.
int support_count_sites_launch(const void* tx, const void* masks, const void* min_counts,
                               void* counts, void* flags, void* vt, int S, int N, int C, int W,
                               int device, void* stream_ptr) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = support_count_transpose_launch(tx, vt, S, N, W, stream_ptr);
  if (err != 0) return err;
  return support_count_vertical_launch(vt, masks, min_counts, counts, flags, S, N, C, W, device,
                                       stream_ptr);
}

// Both stages, the count as launch variant `variant` (an index into
// kCountVariants) with word split `split` (0: the heuristic; s >= 1: s
// shares asked for).  Other arguments as support_count_sites_launch;
// variant 0 with split 0 is the launch that function makes.
int support_count_sites_variant_launch(const void* tx, const void* masks, const void* min_counts,
                                       void* counts, void* flags, void* vt, int S, int N, int C, int W,
                                       int device, int variant, int split, void* stream_ptr) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = support_count_transpose_launch(tx, vt, S, N, W, stream_ptr);
  if (err != 0) return err;
  return static_cast<int>(count_stage(vt, masks, min_counts, counts, flags, S, N, C, W, device, variant, split,
                                      static_cast<cudaStream_t>(stream_ptr)));
}

// Count variant `variant` on the current device: its (threads, kU, kI), the
// static shared memory, local memory (spills) and registers a thread that
// cudaFuncGetAttributes reports for its W <= 32 build, and its resident
// CTAs an SM.
int support_count_variant_info(int variant, int* threads, int* u, int* i, int* shared_bytes, int* local_bytes,
                               int* registers, int* ctas_per_sm) {
  if (variant < 0 || variant >= kNumCountVariants) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = count_kernel_of(variant, false);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, kCountVariants[variant][0], 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = kCountVariants[variant][0];
  *u = kCountVariants[variant][1];
  *i = kCountVariants[variant][2];
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *registers = attr.numRegs;
  return 0;
}

}  // extern "C"
