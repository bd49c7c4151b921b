// The sLSTM recurrence over a whole sequence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel slstm_scan_pallas (body _kernel) in
// src/repro/kernels/slstm_cell.py:95, reached through ops.slstm_scan and
// models/xlstm.py:apply_slstm when the config sets slstm_kernel.
//
// What it computes (wx (B, S, H, 4P) batch-major in T = float or bf16;
// R (H, P, 4P) and bias (H, 4P) float32; c0/n0/h0 (B, H, P) in T), per
// head h, batch row b and step t, with the state (c, n, h) kept in float32
// for the whole sequence:
//   g       = (wx[b, t, h] + h_{t-1}[b] @ R[h]) + bias[h]        (4P gates)
//   z, i, f, o = tanh(g_z), sigmoid(g_i), sigmoid(g_f), sigmoid(g_o)
//   c = f*c + i*z;   n = f*n + i;   h_t = o*c / max(n, 1)
//   hids[b, t, h] = h_t rounded to T; the final (c, n, h) rounded to T.
// These are the semantics of the plain version kernels/ref.py:slstm_scan_ref.
// Every sum has a fixed order (each gate's dot product over P is four
// partial sums over consecutive quarters of P, each an fmaf chain in index
// order, added in quarter order), so two runs give the same bits.  The
// arithmetic is float32 FMA throughout: no tensor cores, no TF32.
//
// What bounds it on this card: operations, and the sequence.  Per step a
// head needs all of its h_{t-1} (B, P) before any of its 4P gate columns,
// so the S steps run one after the other.  At the serving path's launch
// (S=4,096, B=8, H=4, P=512): 2*B*H*P*4P = 6.7e7 flop a step, 2.75e11 for
// the call, 4.1 ms at the 67 TFLOP/s fp32 peak; the bytes (0.54 GB of wx,
// 0.13 GB of hids, 16.8 MB of R) take 0.2 ms at 3.35 TB/s.
//
// The design keeps R and the state on chip for the whole sequence, in ONE
// launch per call, as the TPU kernel keeps them in VMEM:
//   * R of one head is 4 MB at P=512 and fits no SM.  Each CTA owns
//     kUnits=16 hidden units of one head and keeps that head's R columns of
//     its units (z, i, f and o of each: P x 64 floats, 128 KB at P=512) in
//     shared memory, loaded once.  H * P/16 CTAs: 128 at full width, one per
//     SM.
//   * The CTA's cell threads (one per (b, unit)) keep c and n in registers
//     for the whole sequence; h goes to the other CTAs of the head through
//     a ping-pong float32 buffer in global memory (L2-resident, read with
//     __ldcg past the incoherent L1), one buffer written while the other is
//     read.
//   * After each step the CTAs of a head meet at a barrier: a monotonic
//     arrival counter per head (zeroed by the wrapper), released with a
//     fence and acquired with ld.acquire.  It waits for the head's own CTAs
//     only, never for the whole grid.  The wait needs every CTA resident at
//     once, so the launch is cooperative (cudaLaunchCooperativeKernel
//     refuses a grid that cannot be co-resident), and the wrapper checks
//     slstm_scan_capacity first and raises.
//   * The next step's wx is loaded before the barrier, so its latency hides
//     behind the wait.
//
// Limits: P a multiple of 16 with P <= 768 (shared memory: (64 + NB) * P
// floats plus 8 KB, at most 227 KB), 1 <= B <= 8, S >= 1, and H * P/16 CTAs
// co-resident.  The wrapper raises past them and handles S = 0 and B = 0
// without a launch.  The C entry point launches on the caller's stream,
// allocates nothing (outputs, the h buffer and the counters come from the
// wrapper), does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 16;                 // hidden units per CTA
constexpr int kCols = 4 * kUnits;          // gate columns per CTA (z, i, f, o of each unit)
constexpr int kSplit = kThreads / kCols;   // partial sums over P per column

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) { return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x))); }

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every CTA of one head arrives; none leaves before all `target` arrivals.
__device__ __forceinline__ void head_barrier(unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (load_acquire(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

size_t smem_bytes(int P, int NB) {
  return sizeof(float) * (static_cast<size_t>(P) * kCols + static_cast<size_t>(P) * NB +
                          static_cast<size_t>(kSplit) * kCols * NB);
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
slstm_scan_kernel(const T* __restrict__ wx, const float* __restrict__ r, const float* __restrict__ bias,
                  const T* __restrict__ c0, const T* __restrict__ n0, const T* __restrict__ h0,
                  T* __restrict__ hids, T* __restrict__ cT, T* __restrict__ nT, T* __restrict__ hT,
                  float* hbuf, unsigned int* arrive, int B, int S, int H, int P) {
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                                   // [P][kCols]: this CTA's columns of R
  float* hs = rs + static_cast<size_t>(P) * kCols;    // [P][NB]: h_{t-1} of the head, zero rows b >= B
  float* part = hs + static_cast<size_t>(P) * NB;     // [kSplit][kCols][NB]: partial gate sums

  const int ctas_per_head = P / kUnits;
  const int head = blockIdx.x / ctas_per_head;
  const int u0 = (blockIdx.x % ctas_per_head) * kUnits;
  const int tid = threadIdx.x;
  const int P4 = 4 * P;

  const float* r_head = r + static_cast<size_t>(head) * P * P4;
  for (int idx = tid; idx < P * kCols; idx += kThreads) {
    const int k = idx / kCols, col = idx % kCols;
    rs[idx] = r_head[static_cast<size_t>(k) * P4 + (col / kUnits) * P + u0 + col % kUnits];
  }
  for (int idx = tid; idx < P * NB; idx += kThreads) {
    const int k = idx / NB, b = idx % NB;
    hs[idx] = b < B ? to_f32(h0[(static_cast<size_t>(b) * H + head) * P + k]) : 0.f;
  }

  // cell threads: one per (batch row, unit) of this CTA
  const bool cell = tid < B * kUnits;
  const int cb = tid / kUnits, cj = tid % kUnits;
  const int unit = u0 + cj;
  float c = 0.f, n = 0.f, hcur = 0.f;
  float bq[4], wq[4];
  if (cell) {
    const size_t si = (static_cast<size_t>(cb) * H + head) * P + unit;
    c = to_f32(c0[si]);
    n = to_f32(n0[si]);
    hcur = to_f32(h0[si]);
    const T* w = wx + (static_cast<size_t>(cb) * S * H + head) * P4 + unit;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bq[q] = bias[head * P4 + q * P + unit];
      wq[q] = to_f32(w[q * P]);
    }
  }
  __syncthreads();

  const int col = tid % kCols, split = tid / kCols;
  const int klen = P / kSplit;
  const float* rp = rs + static_cast<size_t>(split) * klen * kCols + col;
  const float* hp = hs + static_cast<size_t>(split) * klen * NB;

  for (int t = 0; t < S; ++t) {
    // this thread's partial sums of column `col` over its quarter of P, all batch rows
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
#pragma unroll 4
    for (int k = 0; k < klen; ++k) {
      const float rv = rp[k * kCols];
      if constexpr (NB >= 4) {
#pragma unroll
        for (int v = 0; v < NB / 4; ++v) {
          const float4 h4 = reinterpret_cast<const float4*>(hp + k * NB)[v];
          acc[4 * v] = fmaf(h4.x, rv, acc[4 * v]);
          acc[4 * v + 1] = fmaf(h4.y, rv, acc[4 * v + 1]);
          acc[4 * v + 2] = fmaf(h4.z, rv, acc[4 * v + 2]);
          acc[4 * v + 3] = fmaf(h4.w, rv, acc[4 * v + 3]);
        }
      } else {
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[b] = fmaf(hp[k * NB + b], rv, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) part[(split * kCols + col) * NB + b] = acc[b];
    __syncthreads();

    if (cell) {
      float wnext[4] = {0.f, 0.f, 0.f, 0.f};
      if (t + 1 < S) {  // next step's wx, in flight during the barrier
        const T* w = wx + ((static_cast<size_t>(cb) * S + t + 1) * H + head) * P4 + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) wnext[q] = to_f32(w[q * P]);
      }
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int cc = q * kUnits + cj;
        float rec = part[cc * NB + cb];
#pragma unroll
        for (int s = 1; s < kSplit; ++s) rec = __fadd_rn(rec, part[(s * kCols + cc) * NB + cb]);
        g[q] = __fadd_rn(__fadd_rn(wq[q], rec), bq[q]);
      }
      const float z = tanhf(g[0]);
      const float i = sigmoid(g[1]);
      const float f = sigmoid(g[2]);
      const float o = sigmoid(g[3]);
      c = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, z));
      n = __fadd_rn(__fmul_rn(f, n), i);
      hcur = __fdiv_rn(__fmul_rn(o, c), fmaxf(n, 1.f));
      hids[((static_cast<size_t>(cb) * S + t) * H + head) * P + unit] = from_f32<T>(hcur);
      __stcg(hbuf + ((static_cast<size_t>((t + 1) & 1) * B + cb) * H + head) * P + unit, hcur);
#pragma unroll
      for (int q = 0; q < 4; ++q) wq[q] = wnext[q];
    }

    if (t + 1 < S) {
      head_barrier(arrive + head, static_cast<unsigned int>(t + 1) * ctas_per_head);
      const float* hb = hbuf + static_cast<size_t>((t + 1) & 1) * B * H * P;
      for (int idx = tid; idx < B * P; idx += kThreads) {
        const int b = idx / P, k = idx % P;
        hs[k * NB + b] = __ldcg(hb + (static_cast<size_t>(b) * H + head) * P + k);
      }
      __syncthreads();
    }
  }

  if (cell) {
    const size_t si = (static_cast<size_t>(cb) * H + head) * P + unit;
    cT[si] = from_f32<T>(c);
    nT[si] = from_f32<T>(n);
    hT[si] = from_f32<T>(hcur);
  }
}

template <typename T, int NB>
cudaError_t configure(int P) {
  return cudaFuncSetAttribute(slstm_scan_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(P, NB)));
}

template <typename T, int NB>
cudaError_t capacity(int P, int* max_ctas) {
  cudaError_t e = configure<T, NB>(P);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slstm_scan_kernel<T, NB>, kThreads,
                                                    smem_bytes(P, NB));
  if (e != cudaSuccess) return e;
  *max_ctas = per_sm * sms;
  return cudaSuccess;
}

template <typename T, int NB>
cudaError_t launch(const void* wx, const void* r, const void* bias, const void* c0, const void* n0,
                   const void* h0, void* hids, void* cT, void* nT, void* hT, void* hbuf, void* arrive, int B,
                   int S, int H, int P, cudaStream_t stream) {
  cudaError_t e = configure<T, NB>(P);
  if (e != cudaSuccess) return e;
  const T* a_wx = static_cast<const T*>(wx);
  const float* a_r = static_cast<const float*>(r);
  const float* a_bias = static_cast<const float*>(bias);
  const T* a_c0 = static_cast<const T*>(c0);
  const T* a_n0 = static_cast<const T*>(n0);
  const T* a_h0 = static_cast<const T*>(h0);
  T* a_hids = static_cast<T*>(hids);
  T* a_cT = static_cast<T*>(cT);
  T* a_nT = static_cast<T*>(nT);
  T* a_hT = static_cast<T*>(hT);
  float* a_hbuf = static_cast<float*>(hbuf);
  unsigned int* a_arrive = static_cast<unsigned int*>(arrive);
  void* args[] = {&a_wx, &a_r, &a_bias, &a_c0, &a_n0, &a_h0, &a_hids, &a_cT, &a_nT, &a_hT,
                  &a_hbuf, &a_arrive, &B, &S, &H, &P};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_scan_kernel<T, NB>),
                                  dim3(H * (P / kUnits)), dim3(kThreads), args, smem_bytes(P, NB), stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

int padded_batch(int B) { return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8; }

}  // namespace

extern "C" {

// The most CTAs of the kernel for (P, B, dtype) that can be resident at once
// on the current device; the launch needs H * P/16 of them.
int slstm_scan_capacity(int P, int B, int is_bf16, int* max_ctas) {
  if (P % kUnits != 0 || B < 1 || B > 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (padded_batch(B) * 2 + (is_bf16 ? 1 : 0)) {
    case 2: e = capacity<float, 1>(P, max_ctas); break;
    case 3: e = capacity<__nv_bfloat16, 1>(P, max_ctas); break;
    case 4: e = capacity<float, 2>(P, max_ctas); break;
    case 5: e = capacity<__nv_bfloat16, 2>(P, max_ctas); break;
    case 8: e = capacity<float, 4>(P, max_ctas); break;
    case 9: e = capacity<__nv_bfloat16, 4>(P, max_ctas); break;
    case 16: e = capacity<float, 8>(P, max_ctas); break;
    default: e = capacity<__nv_bfloat16, 8>(P, max_ctas); break;
  }
  return static_cast<int>(e);
}

// One cooperative launch over the whole sequence.  `hbuf` is 2*B*H*P floats
// of scratch, `arrive` H zeroed uint32 counters.
int slstm_scan_launch(const void* wx, const void* r, const void* bias, const void* c0, const void* n0,
                      const void* h0, void* hids, void* cT, void* nT, void* hT, void* hbuf, void* arrive, int B,
                      int S, int H, int P, int is_bf16, void* stream) {
  if (P % kUnits != 0 || B < 1 || B > 8 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define SLSTM_ARGS wx, r, bias, c0, n0, h0, hids, cT, nT, hT, hbuf, arrive, B, S, H, P, st
  switch (padded_batch(B) * 2 + (is_bf16 ? 1 : 0)) {
    case 2: e = launch<float, 1>(SLSTM_ARGS); break;
    case 3: e = launch<__nv_bfloat16, 1>(SLSTM_ARGS); break;
    case 4: e = launch<float, 2>(SLSTM_ARGS); break;
    case 5: e = launch<__nv_bfloat16, 2>(SLSTM_ARGS); break;
    case 8: e = launch<float, 4>(SLSTM_ARGS); break;
    case 9: e = launch<__nv_bfloat16, 4>(SLSTM_ARGS); break;
    case 16: e = launch<float, 8>(SLSTM_ARGS); break;
    default: e = launch<__nv_bfloat16, 8>(SLSTM_ARGS); break;
  }
#undef SLSTM_ARGS
  return static_cast<int>(e);
}

}  // extern "C"
