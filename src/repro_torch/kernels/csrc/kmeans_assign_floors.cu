// Two floors of the K-Means assignment kernel, for measurement only: the
// kernel body of kmeans_assign.cuh built with its loads and nothing else
// (mode 1, kLoadOnly: every point row read, both outputs written from its
// bits) and with its arithmetic and nothing else (mode 2, kArithOnly: each
// point made in registers from its index, no row loaded, every d2, argmin
// and clamp computed and both outputs written).  Built into a library of
// its own; only ops.kmeans_assign_floor loads it, never the clustering path.
#include "kmeans_assign.cuh"

extern "C" {

// As kmeans_assign_sites_launch, plus mode (1 or 2); x is not read in mode 2.
int kmeans_assign_floor_launch(const void* x, const void* centers, void* assign, void* min_d2,
                               int S, int N, int K, int D, int mode, void* stream_ptr) {
  if (mode == kmeans::kLoadOnly) {
    return kmeans::run<kmeans::kLoadOnly>(x, centers, assign, min_d2, S, N, K, D, stream_ptr);
  }
  if (mode == kmeans::kArithOnly) {
    return kmeans::run<kmeans::kArithOnly>(x, centers, assign, min_d2, S, N, K, D, stream_ptr);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
