// The K-Means assignment kernel as the port runs it (ops.kmeans_assign,
// ops.kmeans_assign_sites): the kernel itself, its design and its limits are
// in kmeans_assign.cuh.  Replaces the Pallas TPU kernel kmeans_assign_pallas
// (src/repro/kernels/kmeans_assign.py:45).
#include "kmeans_assign.cuh"

extern "C" {

// x (S, N, D) f32, centers (S, K, D) f32, assign (S, N) int32 out,
// min_d2 (S, N) f32 out.  Limits as stated in kmeans_assign.cuh.
int kmeans_assign_sites_launch(const void* x, const void* centers, void* assign, void* min_d2,
                               int S, int N, int K, int D, void* stream_ptr) {
  return kmeans::run<kmeans::kFull>(x, centers, assign, min_d2, S, N, K, D, stream_ptr);
}

}  // extern "C"
