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
// Every sum has a fixed order, whatever order the data arrives in: each
// gate's dot product over P is 16 partial sums (8 warps x 2 half-warps, each
// an fmaf chain over its rows in a fixed order), the two halves of a warp
// added first, then the warps in warp order; so two runs give the same bits.
// The arithmetic is float32 FMA throughout: no tensor cores, no TF32.
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
//     SM.  The launch is cooperative (cudaLaunchCooperativeKernel refuses a
//     grid that cannot be co-resident, and the wrapper checks
//     slstm_scan_capacity first and raises), since every CTA waits on the
//     others of its head.
//   * h crosses CTAs without a barrier.  Each cell thread publishes its h_t
//     as ONE 64-bit word, the float's bits in the low half and the tag t+1
//     in the high half, with a scalar st.relaxed.gpu.b64 into a double
//     buffer in global memory (L2), laid out [parity][head][P][NB] as the
//     consumers keep h in shared memory.  A consumer polls each word with
//     ld.relaxed.gpu (16-byte loads of two words: each 64-bit element is
//     single-copy atomic) until its tag matches, and then uses its value:
//     one L2 round trip, no fence, no shared counter (NCCL's "LL" protocol).
//     Two buffers are enough: a CTA writes step t+2 over step t only after
//     it has read step t+1 from every CTA of its head, which each published
//     after reading step t.  The wrapper zeroes the buffer on every call, so
//     no tag left by an earlier launch in reused memory can match (tags
//     start at 1).
//   * The exchange overlaps the matvec.  The P rows of h come from P/16
//     source CTAs, 16 rows each; warp w takes sources w, w+8, w+16, ...,
//     issues the loads of all of them at the top of the step, and starts on
//     each source's rows as soon as they have arrived, keeping them in its
//     own region of shared memory.  No warp waits for another's data.
//   * The matvec is register-blocked: a lane keeps 4 columns x NB batch rows
//     of sums, so one 16-byte load of R feeds 4*NB FMAs and each h load 4
//     (3 loads a 32 FMAs at B=8; 3 a 8 before).  The half-warps take
//     alternate 8-row halves of each source and are added by a shuffle.
//   * The gate sums and their tanh/sigmoid are spread over all 256 threads
//     (two entries each at B=8); the cell threads (one per (unit, batch
//     row)) keep c and n in registers for the whole sequence.  Each step's
//     wx is loaded at the top of the step, before the exchange, and
//     converted only where the gate sum needs it.
//
// Limits: P a multiple of 16 with P <= 768, 1 <= B <= 8, S >= 1, and
// H * P/16 CTAs co-resident.  Shared memory: (64 + NB) * P + 68 * NB floats,
// plus 8 * 64 * NB floats of partial sums when P < 512 (from P = 512 on,
// every warp has at least 4 sources and writes its partial sums over its
// own rows of h, which it has finished reading): 223,360 bytes at P = 768,
// NB = 8.  The wrapper raises past the limits and handles S = 0 and B = 0
// without a launch.  The C entry point launches on the caller's stream,
// allocates nothing (outputs and the exchange buffer come from the
// wrapper), does not synchronise, and returns cudaGetLastError().
//
// Phase timers: compiled with SLSTM_PHASE_TIMERS defined to 1
// (slstm_scan_timed.cu), thread 0 of each CTA adds the clock64() cycles of
// each phase of every step into cycles[CTA][phase] (kPhases int64 a CTA,
// zeroed by the wrapper).  Without it (slstm_scan.cu, the path the port
// runs) the timers compile to nothing and `cycles` is not read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef SLSTM_PHASE_TIMERS
#define SLSTM_PHASE_TIMERS 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 16;                  // hidden units per CTA = rows of h a source CTA publishes
constexpr int kCols = 4 * kUnits;           // gate columns per CTA (z, i, f, o of each unit)
constexpr int kMaxP = 768;
constexpr int kMaxSrc = kMaxP / kUnits / kWarps;  // sources a warp takes, at most
constexpr int kActStride = kCols + 4;       // a row of activated gates in shared memory (no bank conflicts)
constexpr int kAliasP = kUnits * kWarps * 4;  // from this P on, partial sums go over the warps' own h rows
constexpr unsigned int kMaxSpins = 1u << 24;  // polls of one word, seconds: past them the kernel traps

// the phases of one step (thread 0's view)
enum Phase {
  kMatvec = 0,   // FMAs over each source's rows, the half-warp shuffle, partial sums stored, __syncthreads
  kCell = 1,     // the partial sums added, tanh/sigmoid, __syncthreads, the cell update
  kPublish = 2,  // hids and the tagged h word stored
  kWait = 3,     // polling until a source's words carry this step's tag
  kReload = 4,   // the arrived words into shared memory, __syncwarp
  kPhases = 5
};

struct PhaseClock {
#if SLSTM_PHASE_TIMERS
  long long acc[kPhases];
  long long last;
  bool on;
  __device__ __forceinline__ explicit PhaseClock(bool on_) : on(on_) {
#pragma unroll
    for (int i = 0; i < kPhases; ++i) acc[i] = 0;
    last = clock64();
  }
  // the cycles since the last tick go to phase `ph`
  __device__ __forceinline__ void tick(int ph) {
    if (on) {
      const long long now = clock64();
      acc[ph] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void flush(long long* cycles) const {
    if (on) {
#pragma unroll
      for (int i = 0; i < kPhases; ++i) cycles[static_cast<size_t>(blockIdx.x) * kPhases + i] = acc[i];
    }
  }
#else
  __device__ __forceinline__ explicit PhaseClock(bool) {}
  __device__ __forceinline__ void tick(int) {}
  __device__ __forceinline__ void flush(long long*) const {}
#endif
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) { return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x))); }

// two tagged words, each 64-bit element single-copy atomic
__device__ __forceinline__ ulonglong2 load_words(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];" : "=l"(v.x), "=l"(v.y) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" : : "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned int tag_of(unsigned long long w) { return static_cast<unsigned int>(w >> 32); }
__device__ __forceinline__ bool arrived(ulonglong2 v, unsigned int tag) {
  return tag_of(v.x) == tag && tag_of(v.y) == tag;
}
__device__ __forceinline__ float value_of(unsigned long long w) {
  return __uint_as_float(static_cast<unsigned int>(w));
}

// sources of warp w: w, w + 8, ... below nsrc
__device__ __forceinline__ int sources_of(int w, int nsrc) { return w < nsrc ? (nsrc - w + kWarps - 1) / kWarps : 0; }

// the first of warp w's sources in hs, counted in sources: those of warps 0 .. w-1
__device__ __forceinline__ int src_base_of(int w, int nsrc) {
  int base = 0;
#pragma unroll
  for (int v = 0; v < kWarps - 1; ++v)
    if (v < w) base += sources_of(v, nsrc);
  return base;
}

size_t smem_bytes(int P, int NB) {
  size_t floats = static_cast<size_t>(P) * (kCols + NB) + static_cast<size_t>(kActStride) * NB;
  if (P < kAliasP) floats += static_cast<size_t>(kWarps) * kCols * NB;
  return sizeof(float) * floats;
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 1)
slstm_scan_kernel(const T* __restrict__ wx, const float* __restrict__ r, const float* __restrict__ bias,
                  const T* __restrict__ c0, const T* __restrict__ n0, const T* __restrict__ h0,
                  T* __restrict__ hids, T* __restrict__ cT, T* __restrict__ nT, T* __restrict__ hT,
                  unsigned long long* xbuf, long long* cycles, int B, int S, int H, int P) {
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                                    // [P][kCols]: this CTA's columns of R
  float* hs = rs + static_cast<size_t>(P) * kCols;     // h_{t-1}, [warp][its sources][16][NB]
  float* act = hs + static_cast<size_t>(P) * NB;       // [NB][kActStride]: activated gates
  float* part = act + kActStride * NB;                 // [kWarps][NB][kCols] partial sums, when P < kAliasP

  const int ctas_per_head = P / kUnits;
  const int nsrc = ctas_per_head;
  const int head = blockIdx.x / ctas_per_head;
  const int u0 = (blockIdx.x % ctas_per_head) * kUnits;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int P4 = 4 * P;

  // where warp w's partial sums go: its own rows of h from P = kAliasP on, else part
  __shared__ float* partials[kWarps];
  if (tid < kWarps)
    partials[tid] = P >= kAliasP ? hs + static_cast<size_t>(src_base_of(tid, nsrc)) * kUnits * NB
                                 : part + static_cast<size_t>(tid) * kCols * NB;

  const float* r_head = r + static_cast<size_t>(head) * P * P4;
  for (int idx = tid; idx < P * kCols; idx += kThreads) {
    const int k = idx / kCols, col = idx % kCols;
    rs[idx] = r_head[static_cast<size_t>(k) * P4 + (col / kUnits) * P + u0 + col % kUnits];
  }
  for (int idx = tid; idx < P * NB; idx += kThreads) {
    const int k = idx / NB, b = idx % NB;
    const int s = k / kUnits;
    const int slot = src_base_of(s % kWarps, nsrc) + s / kWarps;
    hs[(slot * kUnits + k % kUnits) * NB + b] =
        b < B ? to_f32(h0[(static_cast<size_t>(b) * H + head) * P + k]) : 0.f;
  }

  // gate entries: thread tid sums and activates entries tid, tid + 256, ..., entry e being gate
  // q = e / (16 NB), batch row b = e / 16 % NB, unit j = e % 16, so a warp works on one gate
  constexpr int kEntries = (kCols * NB + kThreads - 1) / kThreads;
  auto entry = [](int e, int& b, int& col) {
    b = e / kUnits % NB;
    col = e / (kUnits * NB) * kUnits + e % kUnits;
  };
  float bq[kEntries];
  const T* wq_ptr[kEntries];  // this entry's wx at step 0; a step is H * 4P further
#pragma unroll
  for (int m = 0; m < kEntries; ++m) {
    const int e = tid + m * kThreads;
    int b, col;
    entry(e, b, col);
    const int gcol = (col / kUnits) * P + u0 + col % kUnits;
    const bool used = e < kCols * NB && b < B;
    bq[m] = used ? bias[head * P4 + gcol] : 0.f;
    wq_ptr[m] = used ? wx + (static_cast<size_t>(b) * S * H + head) * P4 + gcol : nullptr;
  }

  // cell threads: one per (unit, batch row), batch row fastest
  const bool cell = tid < kUnits * NB;
  const int cu = tid / NB, cb = tid % NB;
  const bool live = cell && cb < B;
  float c = 0.f, n = 0.f, hcur = 0.f;
  if (live) {
    const size_t si = (static_cast<size_t>(cb) * H + head) * P + u0 + cu;
    c = to_f32(c0[si]);
    n = to_f32(n0[si]);
    hcur = to_f32(h0[si]);
  }
  __syncthreads();

  // the matvec lane: columns 4*cg .. 4*cg+3, rows half*8 .. half*8+7 of each source
  const int cg = lane & 15, half = lane >> 4;
  const int my_src = sources_of(warp, nsrc);
  float* my_hs = hs + static_cast<size_t>(src_base_of(warp, nsrc)) * kUnits * NB;
  float* my_part = P >= kAliasP ? my_hs : part + static_cast<size_t>(warp) * kCols * NB;
  constexpr int kWords = kUnits * NB;                  // tagged words a source publishes
  constexpr int kPairs = kWords / 2;                   // 16-byte loads of a source
  constexpr int kPairsPerLane = (kPairs + 31) / 32;

  PhaseClock clk(tid == 0);
  for (int t = 0; t < S; ++t) {
    // this step's wx, raw: its latency hides behind the exchange and the matvec
    T wraw[kEntries];
#pragma unroll
    for (int m = 0; m < kEntries; ++m)
      if (wq_ptr[m] != nullptr) wraw[m] = wq_ptr[m][static_cast<size_t>(t) * H * P4];

    // the words of h_{t-1}, tag t, from every source of this warp: loads issued at once
    const unsigned int want = static_cast<unsigned int>(t);
    const unsigned long long* xin =
        xbuf + (static_cast<size_t>((t + 1) & 1) * H + head) * static_cast<size_t>(P) * NB;
    ulonglong2 v[kMaxSrc][kPairsPerLane];
    if (t > 0) {
#pragma unroll
      for (int j = 0; j < kMaxSrc; ++j) {
        if (j < my_src) {
          const unsigned long long* src = xin + static_cast<size_t>(warp + j * kWarps) * kWords;
#pragma unroll
          for (int m = 0; m < kPairsPerLane; ++m) {
            const int pi = lane + 32 * m;
            if (pi < kPairs) v[j][m] = load_words(src + 2 * pi);
          }
        }
      }
    }

    float acc[4][NB];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[q][b] = 0.f;

#pragma unroll
    for (int j = 0; j < kMaxSrc; ++j) {
      if (j < my_src) {
        const int s = warp + j * kWarps;
        float* hsrc = my_hs + static_cast<size_t>(j) * kWords;
        if (t > 0) {
#pragma unroll
          for (int m = 0; m < kPairsPerLane; ++m) {
            const int pi = lane + 32 * m;
            if (pi < kPairs) {
              // until this source's words have arrived, poll again every word of this and the later
              // sources that has not: one round trip serves them all
              for (unsigned int spins = 0; !arrived(v[j][m], want); ++spins) {
                if (spins == kMaxSpins) __trap();  // a source that never publishes: fail, do not hang
#pragma unroll
                for (int j2 = j; j2 < kMaxSrc; ++j2) {
#pragma unroll
                  for (int m2 = 0; m2 < kPairsPerLane; ++m2) {
                    const int pi2 = lane + 32 * m2;
                    if (j2 < my_src && pi2 < kPairs && !arrived(v[j2][m2], want))
                      v[j2][m2] = load_words(xin + static_cast<size_t>(warp + j2 * kWarps) * kWords + 2 * pi2);
                  }
                }
              }
            }
          }
          clk.tick(kWait);
#pragma unroll
          for (int m = 0; m < kPairsPerLane; ++m) {
            const int pi = lane + 32 * m;
            if (pi < kPairs)
              reinterpret_cast<float2*>(hsrc)[pi] = make_float2(value_of(v[j][m].x), value_of(v[j][m].y));
          }
          __syncwarp();
          clk.tick(kReload);
        }
        const float* hp = hsrc + half * 8 * NB;
        const float* rp = rs + static_cast<size_t>(s * kUnits + half * 8) * kCols + 4 * cg;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 r4 = *reinterpret_cast<const float4*>(rp + i * kCols);
          float hv[NB];
          if constexpr (NB >= 4) {
#pragma unroll
            for (int u = 0; u < NB / 4; ++u) {
              const float4 h4 = reinterpret_cast<const float4*>(hp + i * NB)[u];
              hv[4 * u] = h4.x;
              hv[4 * u + 1] = h4.y;
              hv[4 * u + 2] = h4.z;
              hv[4 * u + 3] = h4.w;
            }
          } else {
#pragma unroll
            for (int b = 0; b < NB; ++b) hv[b] = hp[i * NB + b];
          }
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            acc[0][b] = fmaf(hv[b], r4.x, acc[0][b]);
            acc[1][b] = fmaf(hv[b], r4.y, acc[1][b]);
            acc[2][b] = fmaf(hv[b], r4.z, acc[2][b]);
            acc[3][b] = fmaf(hv[b], r4.w, acc[3][b]);
          }
        }
        clk.tick(kMatvec);
      }
    }
    // the two half-warps' sums (rows 0-7 + rows 8-15 of each source), then this warp's partial sums
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[q][b] = __fadd_rn(acc[q][b], __shfl_xor_sync(0xffffffffu, acc[q][b], 16));
    __syncwarp();  // every lane of this warp has read its rows of h before they take the partial sums
    if (half == 0) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
        *reinterpret_cast<float4*>(my_part + b * kCols + 4 * cg) = make_float4(acc[0][b], acc[1][b], acc[2][b], acc[3][b]);
    }
    __syncthreads();
    clk.tick(kMatvec);

    // gate sums in warp order, plus wx and bias, activated
#pragma unroll
    for (int m = 0; m < kEntries; ++m) {
      if (wq_ptr[m] != nullptr) {
        int b, col;
        entry(tid + m * kThreads, b, col);
        const int pe = b * kCols + col;
        float rec = partials[0][pe];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) rec = __fadd_rn(rec, partials[w][pe]);
        const float g = __fadd_rn(__fadd_rn(to_f32(wraw[m]), rec), bq[m]);
        act[b * kActStride + col] = col < kUnits ? tanhf(g) : sigmoid(g);
      }
    }
    __syncthreads();

    if (cell) {
      if (live) {
        const float* a = act + cb * kActStride + cu;
        const float z = a[0], i = a[kUnits], f = a[2 * kUnits], o = a[3 * kUnits];
        c = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, z));
        n = __fadd_rn(__fmul_rn(f, n), i);
        hcur = __fdiv_rn(__fmul_rn(o, c), fmaxf(n, 1.f));
      }
      clk.tick(kCell);
      if (live) hids[((static_cast<size_t>(cb) * S + t) * H + head) * P + u0 + cu] = from_f32<T>(hcur);
      if (t + 1 < S) {  // h_t with tag t + 1; zero for the padding rows b >= B
        const unsigned long long word = (static_cast<unsigned long long>(t + 1) << 32) |
                                        (live ? __float_as_uint(hcur) : 0u);
        store_word(xbuf + ((static_cast<size_t>(t & 1) * H + head) * P + u0 + cu) * NB + cb, word);
      }
      clk.tick(kPublish);
    }
  }
  clk.flush(cycles);

  if (live) {
    const size_t si = (static_cast<size_t>(cb) * H + head) * P + u0 + cu;
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
                   const void* h0, void* hids, void* cT, void* nT, void* hT, void* xbuf, void* cycles, int B,
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
  unsigned long long* a_xbuf = static_cast<unsigned long long*>(xbuf);
  long long* a_cycles = static_cast<long long*>(cycles);
  void* args[] = {&a_wx, &a_r, &a_bias, &a_c0, &a_n0, &a_h0, &a_hids, &a_cT, &a_nT, &a_hT,
                  &a_xbuf, &a_cycles, &B, &S, &H, &P};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_scan_kernel<T, NB>),
                                  dim3(H * (P / kUnits)), dim3(kThreads), args, smem_bytes(P, NB), stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

int padded_batch(int B) { return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8; }

bool valid(int P, int B) { return P % kUnits == 0 && P >= kUnits && P <= kMaxP && B >= 1 && B <= 8; }

}  // namespace

extern "C" {

// The most CTAs of the kernel for (P, B, dtype) that can be resident at once
// on the current device; the launch needs H * P/16 of them.
int slstm_scan_capacity(int P, int B, int is_bf16, int* max_ctas) {
  if (!valid(P, B)) return static_cast<int>(cudaErrorInvalidValue);
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

// One cooperative launch over the whole sequence.  `xbuf` is the zeroed
// exchange buffer, 2 * H * P * padded_batch(B) uint64 words; `cycles`
// (CTAs, kPhases) zeroed int64 phase timers, read only by the timed build.
int slstm_scan_launch(const void* wx, const void* r, const void* bias, const void* c0, const void* n0,
                      const void* h0, void* hids, void* cT, void* nT, void* hT, void* xbuf, void* cycles, int B,
                      int S, int H, int P, int is_bf16, void* stream) {
  if (!valid(P, B) || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define SLSTM_ARGS wx, r, bias, c0, n0, h0, hids, cT, nT, hT, xbuf, cycles, B, S, H, P, st
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

// The number of phases each CTA's timers hold, and whether this build has them.
int slstm_scan_phases(int* timed) {
  *timed = SLSTM_PHASE_TIMERS;
  return kPhases;
}

}  // extern "C"
