// The K-Means assignment kernel as the port runs it (ops.kmeans_assign,
// ops.kmeans_assign_sites), and its launch variants for the autotuner: the
// kernel itself, its design, its variants and its limits are in
// kmeans_assign.cuh.  Replaces the Pallas TPU kernel kmeans_assign_pallas
// (src/repro/kernels/kmeans_assign.py:45).
#include "kmeans_assign.cuh"

namespace {

// One case of the two switches below: variant i of V = Variants<MAXD>, for
// i < V::kCount (the list has at most six).
#define KMEANS_VARIANT_CASES(BODY) \
  BODY(0)                          \
  BODY(1)                          \
  BODY(2)                          \
  BODY(3)                          \
  BODY(4)                          \
  BODY(5)

// Launches variant v of Variants<MAXD> (0 <= v < Variants<MAXD>::kCount).
template <int MAXD>
cudaError_t launch_variant(int v, const float* x, const float* c, int* assign, float* min_d2, int S, int N, int K,
                           int D, cudaStream_t stream) {
  using V = kmeans::Variants<MAXD>;
  static_assert(V::kCount <= 6, "KMEANS_VARIANT_CASES lists six variants");
  switch (v) {
#define LAUNCH_CASE(i)                                                                                  \
  case i:                                                                                               \
    if constexpr (i < V::kCount) {                                                                      \
      return kmeans::launch<MAXD, V::kList[i][0], V::kList[i][1], kmeans::kFull>(x, c, assign, min_d2, \
                                                                                 S, N, K, D, stream);   \
    }                                                                                                   \
    break;
    KMEANS_VARIANT_CASES(LAUNCH_CASE)
#undef LAUNCH_CASE
  }
  return cudaErrorInvalidValue;
}

// The __global__ function that variant v of Variants<MAXD> runs at D (the
// build with D == MAXD or the one without), or null past the list.
template <int MAXD>
const void* variant_kernel(int v, int D) {
  using V = kmeans::Variants<MAXD>;
  switch (v) {
#define KERNEL_CASE(i)                                                                             \
  case i:                                                                                          \
    if constexpr (i < V::kCount) {                                                                 \
      if (D == MAXD) {                                                                             \
        return reinterpret_cast<const void*>(                                                      \
            &kmeans::assign_kernel<MAXD, V::kList[i][0], V::kList[i][1], kmeans::kFull, true>);    \
      }                                                                                            \
      return reinterpret_cast<const void*>(                                                        \
          &kmeans::assign_kernel<MAXD, V::kList[i][0], V::kList[i][1], kmeans::kFull, false>);     \
    }                                                                                              \
    break;
    KMEANS_VARIANT_CASES(KERNEL_CASE)
#undef KERNEL_CASE
  }
  return nullptr;
}

// Variant v at MAXD: (variants at MAXD, threads, points a thread, kernel).
template <int MAXD>
bool variant_info(int v, int D, int* count, int* threads, int* points, const void** fn) {
  using V = kmeans::Variants<MAXD>;
  *count = V::kCount;
  if (v < 0 || v >= V::kCount) return false;
  *threads = V::kList[v][0];
  *points = V::kList[v][1];
  *fn = variant_kernel<MAXD>(v, D);
  return true;
}

}  // namespace

extern "C" {

// x (S, N, D) f32, centers (S, K, D) f32, assign (S, N) int32 out,
// min_d2 (S, N) f32 out, at any D.  Limits as stated in kmeans_assign.cuh.
int kmeans_assign_sites_launch(const void* x, const void* centers, void* assign, void* min_d2,
                               int S, int N, int K, int D, void* stream_ptr) {
  return kmeans::run<kmeans::kFull>(x, centers, assign, min_d2, S, N, K, D, stream_ptr);
}

// As kmeans_assign_sites_launch, as launch variant `variant` of D's build
// (kmeans::Variants: 0 to 5 at D <= 16, only 0, the default, past it; past
// D = 128 only 0, wide_kernel).
int kmeans_assign_variant_launch(const void* x, const void* centers, void* assign, void* min_d2, int S, int N,
                                 int K, int D, int variant, void* stream_ptr) {
  if (!kmeans::in_limits(S, N, K, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (D > kmeans::kMaxRegisterD) {
    if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
    return kmeans::run<kmeans::kFull>(x, centers, assign, min_d2, S, N, K, D, stream_ptr);
  }
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(centers);
  int* ap = static_cast<int*>(assign);
  float* mp = static_cast<float*>(min_d2);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (D <= 4) {
    err = launch_variant<4>(variant, xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 8) {
    err = launch_variant<8>(variant, xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 16) {
    err = launch_variant<16>(variant, xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 32) {
    err = launch_variant<32>(variant, xp, cp, ap, mp, S, N, K, D, stream);
  } else if (D <= 64) {
    err = launch_variant<64>(variant, xp, cp, ap, mp, S, N, K, D, stream);
  } else {
    err = launch_variant<128>(variant, xp, cp, ap, mp, S, N, K, D, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch variant `variant` at D (D >= 1) on the current device: the
// number of variants at D, the variant's (threads, points a thread), the
// static shared memory, local memory (spills) and registers a thread that
// cudaFuncGetAttributes reports for the build the launch uses, and its
// resident CTAs an SM.  Past D = 128 the one variant is wide_kernel.
int kmeans_assign_variant_info(int variant, int D, int* count, int* threads, int* points, int* shared_bytes,
                               int* local_bytes, int* registers, int* ctas_per_sm) {
  const void* fn = nullptr;
  bool ok = false;
  if (D >= 1 && D <= 4) {
    ok = variant_info<4>(variant, D, count, threads, points, &fn);
  } else if (D > 4 && D <= 8) {
    ok = variant_info<8>(variant, D, count, threads, points, &fn);
  } else if (D > 8 && D <= 16) {
    ok = variant_info<16>(variant, D, count, threads, points, &fn);
  } else if (D > 16 && D <= 32) {
    ok = variant_info<32>(variant, D, count, threads, points, &fn);
  } else if (D > 32 && D <= 64) {
    ok = variant_info<64>(variant, D, count, threads, points, &fn);
  } else if (D > 64 && D <= kmeans::kMaxRegisterD) {
    ok = variant_info<128>(variant, D, count, threads, points, &fn);
  } else if (D > kmeans::kMaxRegisterD && variant == 0) {
    *count = 1;
    *threads = kmeans::kThreads;
    *points = 1;
    fn = reinterpret_cast<const void*>(&kmeans::wide_kernel);
    ok = true;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, *threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *registers = attr.numRegs;
  return 0;
}

}  // extern "C"
