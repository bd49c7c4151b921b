// Forward flash attention in float32 with GQA, causal and sliding-window
// masks and a tanh logit softcap, for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _kernel) in
// src/repro/kernels/flash_attention.py:84 for float32 inputs, reached through
// ops.flash_attention and models/attention.py:attention when the config sets
// flash_kernel.  Bfloat16 inputs go to csrc/flash_attention_wgmma.cu, on the
// tensor cores; float32 stays here because on the tensor cores it would be
// TF32, another function.
//
// What it computes (q (B, Sq, H, Dh), k/v (B, Skv, Kv, Dh), float32 and
// contiguous; out (B, Sq, H, Dh) float32), for each batch row
// b, query head h (reading KV head h / (H/Kv), never a repeated copy) and
// query row i, over the key tiles of kBK keys in order:
//   s_j  = (f32(q_i) * scale) . f32(k_j)                 f32, scale = 1/sqrt(Dh)
//   s_j  = tanh(s_j / cap) * cap                          when cap > 0
//   s_j  = -1e30 unless j < Skv, i >= j (causal) and i - j < window (window > 0)
//   m'   = max(m, max_j s_j);  p_j = exp(s_j - m'), 0 when m' <= -5e29
//   l    = l * exp(m - m') + sum_j p_j
//   acc  = acc * exp(m - m') + sum_j p_j * v_j
//   out_i = acc / max(l, 1e-30)                          (0 for a row with no visible key)
// These are the semantics of the plain version kernels/ref.py:flash_attention_ref,
// which walks the same key tiles, so both see the same running maximum and
// differ only in the order of the dot products' sums.  The arithmetic is f32
// FMA on the CUDA cores: no tensor cores, no TF32; expf and tanhf, no fast math.
//
// What bounds it on this card: operations, on the f32 pipes (67 TFLOP/s):
// TF32 on the tensor cores would be another function.  At the float32
// scoring path's full layer (gemma2-2b at B=1: Sq=Skv=8,192, H=8, Kv=4,
// Dh=256, causal, cap 50) there are 8 x 33,558,528 visible (query, key)
// pairs, 4*Dh flop each: 2.75e11 flop, 4.10 ms at that peak; the bytes (q,
// k, v read once, out written once: 201 MB) take 0.06 ms at 3.35 TB/s.  The
// bfloat16 path's tensor-core kernel is csrc/flash_attention_wgmma.cu.
//
// The design, simple and right first:
//   * One CTA of 256 threads per (query tile of kBQ=64 rows, head, batch row);
//     it loops over the key tiles, as the TPU's sequential kv grid axis did.
//     m, l and acc stay in registers for the whole loop.  The q tiles of a
//     head run next to each other, longest rows first, so K/V come from L2.
//   * Key tiles wholly masked for every row of the CTA (above the diagonal,
//     or wholly before the window) are skipped.  This is exact: before a
//     row's first visible key its state stays (-1e30, 0, 0); after it a
//     masked tile gives p = 0 and exp(m - m') = 1.
//   * Shared memory holds q*scale, K and V of the tile (rows past Sq or Skv
//     are zero) and p^T: at Dh=256, 211 KB
//     (opted into with cudaFuncSetAttribute).  Rows of q and K are padded by
//     4 floats so the float4 reads of 16 different rows hit distinct banks.
//   * Thread (ty, tx) = (tid/16, tid%16) owns query rows 4ty..4ty+3: for
//     S = Q K^T the keys tx + 16j (j < 4), for the accumulator the columns
//     64jj + 4tx..+3 (jj < NJ = ceil(Dh/64)), 16 NJ accumulators a row, 64
//     registers at Dh=256.  A row's max and sum go across its 16 lanes by
//     __shfl_xor_sync.
//   * Each step over d reads 4 float4 of q and 4 of K for 64 FMAs; each key of
//     PV reads 1 float4 of p and NJ float4 of V for 16 NJ FMAs.
//
// Limits: Dh a multiple of 8 (as the bf16 kernel needs) and at most 256, B and H
// at most 65,535 (grid y and z).  The wrapper raises past them, checks types,
// shapes and contiguity, and handles an empty B, Sq or Skv without a launch.
// The C entry point launches on the caller's stream, allocates nothing (the
// wrapper allocates out), does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile (the plain version's FLASH_BLOCK_K)
constexpr int kPad = 4;  // floats of padding per row of q, K and p^T
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

__host__ __device__ constexpr int row_stride(int dh) { return dh + kPad; }

size_t smem_bytes(int Dh) {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBK) * row_stride(Dh) + static_cast<size_t>(kBK) * Dh +
                          static_cast<size_t>(kBK) * (kBQ + kPad));
}

template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       float* __restrict__ out, int Sq, int Skv, int H, int Kv, int Dh, float scale,
                       int causal, int window, float cap) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(Dh);
  float* qs = smem;                                  // [kBQ][ld]: q * scale
  float* ks = qs + static_cast<size_t>(kBQ) * ld;    // [kBK][ld]
  float* vs = ks + static_cast<size_t>(kBK) * ld;    // [kBK][Dh]
  float* ps = vs + static_cast<size_t>(kBK) * Dh;    // [kBK][kBQ + kPad]: p^T

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int dh4 = Dh >> 2;
  const size_t q_step = static_cast<size_t>(H) * Dh;   // between positions of q and out
  const size_t kv_step = static_cast<size_t>(Kv) * Dh;  // between positions of k and v
  const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * Dh;
  const float* kb = k + (static_cast<size_t>(b) * Skv * Kv + kvh) * Dh;
  const float* vb = v + (static_cast<size_t>(b) * Skv * Kv + kvh) * Dh;
  float* ob = out + (static_cast<size_t>(b) * Sq * H + h) * Dh;

  for (int idx = tid; idx < kBQ * dh4; idx += kThreads) {
    const int r = idx / dh4, c = (idx - r * dh4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      x = load4(qb + (q0 + r) * q_step + c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    store4(qs + r * ld + c, x);
  }

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][jj][c] = 0.f;
    }
  }

  // the key tiles some row of this CTA can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    const int kn = min(kBK, Skv - k0);
    __syncthreads();  // the previous tile's readers are done with ks, vs and ps
    for (int idx = tid; idx < kBK * dh4; idx += kThreads) {
      const int r = idx / dh4, c = (idx - r * dh4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (r < kn) {
        kx = load4(kb + (k0 + r) * kv_step + c);
        vx = load4(vb + (k0 + r) * kv_step + c);
      }
      store4(ks + r * ld + c, kx);
      store4(vs + r * Dh + c, vx);
    }
    __syncthreads();

    // S = (q * scale) K^T: rows 4ty + i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 2
    for (int d = 0; d < Dh; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(qs + (ty * 4 + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = load4(ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, kk[j].w, s[i][j]);
        }
      }
    }

    // softcap, mask, online softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (cap > 0.f) x = tanhf(x / cap) * cap;
        const bool visible = kp < Skv && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
        s[i][j] = visible ? x : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = m_new > 0.5f * kNeg ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        s[i][j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][jj][c] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(ps + (tx + 16 * j) * (kBQ + kPad) + ty * 4, make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
    __syncthreads();

    // acc += p V over the tile's real keys (past Skv p and v are 0)
    for (int key = 0; key < kn; ++key) {
      const float4 pp = load4(ps + key * (kBQ + kPad) + ty * 4);
      const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = 64 * jj + 4 * tx;
        if (d < Dh) {
          const float4 vv = load4(vs + key * Dh + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jj][0] = fmaf(pr[i], vv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(pr[i], vv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(pr[i], vv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(pr[i], vv.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = 64 * jj + 4 * tx;
      if (d < Dh)
        store4(ob + qp * q_step + d, make_float4(acc[i][jj][0] / den, acc[i][jj][1] / den,
                                                 acc[i][jj][2] / den, acc[i][jj][3] / den));
    }
  }
}

template <int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int H, int Kv,
                   int Dh, float scale, int causal, int window, float cap, cudaStream_t stream) {
  const size_t smem = smem_bytes(Dh);
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Skv, H, Kv, Dh, scale, causal, window, cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int H,
                           int Kv, int Dh, float scale, int causal, int window, float cap, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Kv < 1 || H % Kv != 0 || Dh < 8 || Dh > 256 || Dh % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch ((Dh + 63) / 64) {
    case 1: e = launch<1>(q, k, v, out, B, Sq, Skv, H, Kv, Dh, scale, causal, window, cap, s); break;
    case 2: e = launch<2>(q, k, v, out, B, Sq, Skv, H, Kv, Dh, scale, causal, window, cap, s); break;
    case 3: e = launch<3>(q, k, v, out, B, Sq, Skv, H, Kv, Dh, scale, causal, window, cap, s); break;
    default: e = launch<4>(q, k, v, out, B, Sq, Skv, H, Kv, Dh, scale, causal, window, cap, s); break;
  }
  return static_cast<int>(e);
}

}  // extern "C"
