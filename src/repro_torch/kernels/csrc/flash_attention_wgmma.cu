// Forward flash attention in bfloat16 on Hopper's tensor cores (sm_90a):
// wgmma for both products, TMA for every load, one producer warpgroup and
// two consumer warpgroups.  GQA, causal and sliding-window masks and a tanh
// logit softcap.
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _kernel) in
// src/repro/kernels/flash_attention.py:84 for bfloat16 inputs, reached
// through ops.flash_attention and models/attention.py:attention when the
// config sets flash_kernel.  Float32 inputs go to csrc/flash_attention.cu
// (f32 FMA on the CUDA cores): on the tensor cores float32 would mean TF32,
// another function.
//
// What it computes (q (B, Sq, H, Dh), k/v (B, Skv, Kv, Dh), bf16 and
// contiguous; out (B, Sq, H, Dh) bf16), for each batch row b, query head h
// (reading KV head h / (H/Kv), never a repeated copy) and query row i, over
// the key tiles of kBK = 64 keys in order (ref.FLASH_BLOCK_K):
//   s_j  = scale * (q_i . k_j)        bf16 x bf16 products, exact in f32, summed in f32
//   s_j  = tanhf((q_i . k_j) * (scale/cap)) * cap        instead, when cap > 0
//   s_j  = -1e30 unless j < Skv, i >= j (causal) and i - j < window (window > 0)
//   m'   = max(m, max_j s_j);  p_j = exp(s_j - m'), 0 when m' <= -5e29
//   l    = l * exp(m - m') + sum_j p_j                   (the f32 p)
//   acc  = acc * exp(m - m') + sum_j bf16(p_j) * v_j     (f32 accumulator)
//   out_i = bf16(acc / max(l, 1e-30))                    (0 for a row with no visible key)
// These are the semantics of the plain version kernels/ref.py:flash_attention_ref,
// which walks the same key tiles, so both see the same running maximum.  The
// differences allowed: the order of the dot products' sums; scale applied to
// the f32 score instead of to q (exact where scale = 1/sqrt(Dh) is a power of
// two: Dh 16, 64, 256; one f32 rounding elsewhere); s/cap as one multiply by
// scale * (1/cap) (one or two f32 roundings); exp as ex2.approx.ftz.f32 of one
// FFMA with log2(e) folded in (2 ulps; a p below 2^-126 flushes to 0, which
// moves l and the output by less than 1e-37).  The softcap is tanhf, not
// tanh.approx.f32, whose 2^-11 relative error times cap 50 would move a score
// by 0.024.  No atomics: two launches on the same inputs are bit-identical.
//
// What bounds it on this card: operations.  At the scoring path's largest
// launch (gemma2-2b's full layer: B=4, Sq=Skv=8,192, H=8, Kv=4, Dh=256,
// causal, cap 50) there are 32 x 33,558,528 visible (query, key) pairs, 4*Dh
// flop each: 1.10e12 flop, 1.11 ms at the 989 TFLOP/s bf16 tensor-core peak.
// The bytes (q, k, v read once, out written once: 403 MB) take 0.12 ms at
// 3.35 TB/s; an exp and a tanh a pair on the special-function units take
// 0.51 ms.  The float32 kernel runs the flop on the FMA pipes (67 TFLOP/s)
// and cannot come nearer than 16.4 ms; this one puts them on the tensor cores.
//
// The design:
//   * One CTA of 384 threads per (kBQ = 128 query rows, head, batch row).
//     Warpgroup 2 is the producer: it drops to 24 registers (setmaxnreg)
//     and one of its threads issues the TMA loads, 128-byte swizzled, of the
//     Q tile once and of the K and V tiles into a 2-stage ring, with a full
//     and an empty mbarrier a stage.  Warpgroups 0 and 1 are consumers
//     (setmaxnreg to 240 registers), 64 query rows each.
//   * S = Q K^T is wgmma m64n64k16 (bf16 -> f32), Q and K both K-major in
//     shared memory, ceil(Dh/16) steps (16 at Dh 256); S takes 32 f32
//     registers a thread.  A Dh that is not a multiple of 64 is padded with
//     zeros: TMA fills the columns past Dh with zeros, which add nothing.
//   * O += P V is wgmma m64n(64*NC)k16 with P as a register A operand: the
//     f32 S fragment, rounded to bf16 in place, is already laid out as the A
//     fragment.  V (keys x Dh, Dh contiguous) is the B operand through the
//     transpose bit.  The accumulator takes 32*NC f32 registers a thread,
//     NC = ceil(Dh/64): 128 at Dh 256.
//   * The softmax runs on the wgmma fragment: a thread holds 2 rows of 16
//     keys each, and a row lives in 4 lanes of a warp, so a row's max and sum
//     take two shuffles.  m, l and the accumulator stay f32 in registers; a
//     warp whose rows kept their maximum skips the accumulator's rescale (a
//     multiply by exactly 1).
//   * Shared memory at Dh 256: Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB.
//   * Key tiles wholly masked for all 128 rows are never loaded; a consumer
//     skips the tiles wholly masked for its own 64 rows (exact, as in the
//     float32 kernel); element masks apply only on the diagonal and
//     window-edge tiles and past Skv.  Ragged Sq and Skv need no copy: TMA
//     fills rows past the end with zeros, and rows past Sq are never stored.
//   * Grid (H, query tiles, B): the heads of one query tile run next to each
//     other, so the heads of a KV group read K/V from L2; query tiles run
//     longest causal rows first.
//   * Later: overlap of one warpgroup's softmax with the other's wgmma
//     (ping-pong), a persistent tile scheduler, cluster multicast of K/V.
//
// Limits: Dh a multiple of 8 (16-byte rows for TMA) and at most 256,
// ceil(Sq/128) and B at most 65,535 (grid y and z), 16-byte aligned bases.
// The C entry point returns cudaErrorInvalidValue past them (the wrapper
// checks first), 1000 + the CUresult when a tensor map cannot be encoded,
// else the launch's cudaGetLastError().  It launches on the caller's stream,
// allocates nothing (the wrapper allocates out) and does not synchronise.
// The TMA and mbarrier helpers, and the tensor maps (cuTensorMapEncodeTiled
// through cudaGetDriverEntryPointByVersion, so nothing links libcuda), are in
// tma.cuh, shared with the float32 kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kConsumers = 2;                   // consumer warpgroups, 64 query rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBQ = 64 * kConsumers;            // query rows per CTA
constexpr int kBK = 64;                         // keys per tile (the plain version's FLASH_BLOCK_K)
constexpr int kStages = 2;                      // K/V ring
constexpr int kSpan = 64;                       // Dh columns in one 128-byte swizzle span
constexpr uint32_t kRowBytes = 128;             // a row of a span in shared memory
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// a wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units in the descriptor)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving reads of wgmma results above the wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the special-function unit, denormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// S (+)= Q K^T on one 64-key tile's 16-deep slice: m64n64k16, A and B from
// shared memory (K-major, 128-byte swizzle); d is overwritten when !accumulate.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[96], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, "
      "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "
      "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int NC>
struct Layout {                                      // byte offsets from the 1024-aligned base
  static constexpr uint32_t q_bytes = NC * kBQ * kRowBytes;   // span c of Q at c * kBQ rows
  static constexpr uint32_t kv_bytes = NC * kBK * kRowBytes;  // one K (or V) tile, span c at c * kBK rows
  static constexpr uint32_t bars = q_bytes + 2 * kStages * kv_bytes;  // q_full, full[kStages], empty[kStages]
  static constexpr size_t smem = 1024 + bars + 8 * (1 + 2 * kStages);  // + the alignment's slack
  __device__ static uint32_t k(int s) { return q_bytes + 2 * s * kv_bytes; }
  __device__ static uint32_t v(int s) { return k(s) + kv_bytes; }
};

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, int Sq,
                             int Skv, int H, int Kv, int Dh, float scale, int causal, int window, float cap) {
  using L = Layout<NC>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle atoms are 1024-byte aligned
  const uint32_t q_full = base + L::bars;
  auto full = [&](int s) { return base + L::bars + 8 * (1 + s); };
  auto empty = [&](int s) { return base + L::bars + 8 * (1 + kStages + s); };

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the longest causal rows first
  const int kvh = h / (H / Kv);
  const int n_tiles = (Skv + kBK - 1) / kBK;
  // the key tiles that rows first..last can see
  auto first_tile = [&](int first) { return window > 0 ? max(0, first - window + 1) / kBK : 0; };
  auto end_tile = [&](int last) { return causal ? min(n_tiles, last / kBK + 1) : n_tiles; };
  const int kt_begin = first_tile(q0);
  const int kt_end = max(kt_begin, end_tile(min(q0 + kBQ, Sq) - 1));

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- the producer: one thread issues every TMA load -------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, L::q_bytes);
      for (int c = 0; c < NC; ++c) tma_load(base + c * kBQ * kRowBytes, &tq, q_full, c * kSpan, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), 2 * L::kv_bytes);
        for (int c = 0; c < NC; ++c) {
          tma_load(base + L::k(stage) + c * kBK * kRowBytes, &tk, full(stage), c * kSpan, kvh, kt * kBK, b);
          tma_load(base + L::v(stage) + c * kBK * kRowBytes, &tv, full(stage), c * kSpan, kvh, kt * kBK, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- a consumer: 64 query rows, every key tile of the CTA -------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int w0 = q0 + 64 * wg;                    // this warpgroup's first row
    const int w_last = min(w0 + 63, Sq - 1);
    const int row = w0 + 16 * warp + lane / 4;      // the thread's rows: row and row + 8
    const int col = 2 * (lane % 4);                 // its first column in each group of 8
    const int my_begin = first_tile(w0);
    const int my_end = w0 < Sq ? end_tile(w_last) : 0;
    const int k_steps = (Dh + 15) / 16;
    const float arg_scale = cap > 0.f ? scale * (1.f / cap) : scale;

    float o[32 * NC];
#pragma unroll
    for (int i = 0; i < 32 * NC; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      mbar_wait(full(stage), phase);
      if (kt >= my_begin && kt < my_end) {
        const int k0 = kt * kBK;
        // S = Q K^T: Q rows 64 wg.., both K-major; a 16-deep step is 32 bytes into a span
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NC; ++kk) {
          if (kk < k_steps)
            wgmma_qk(s, smem_desc(base + (kk / 4) * kBQ * kRowBytes + wg * 64 * kRowBytes + (kk % 4) * 32, 16, 1024),
                     smem_desc(base + L::k(stage) + (kk / 4) * kBK * kRowBytes + (kk % 4) * 32, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(s);

        // softcap and masks; s[i] is row row + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + col + (i & 1)
        const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > w0) || (window > 0 && w_last - k0 >= window);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = s[i] * arg_scale;
          if (cap > 0.f) x = tanhf(x) * cap;
          if (edge) {
            const int r = row + 8 * ((i >> 1) & 1), kp = k0 + 8 * (i >> 2) + col + (i & 1);
            const bool visible = kp < Skv && (!causal || r >= kp) && (window <= 0 || r - kp < window);
            x = visible ? x : kNeg;
          }
          s[i] = x;
        }
        // online softmax, a row across the 4 lanes that hold it
        float mx[2] = {kNeg, kNeg};
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float corr[2], m_scaled[2];
        bool live[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          corr[r] = exp2f((m[r] - m_new) * kLog2e);
          live[r] = m_new > 0.5f * kNeg;
          m_scaled[r] = m_new * kLog2e;
          m[r] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const float p = live[r] ? ex2(fmaf(s[i], kLog2e, -m_scaled[r])) : 0.f;
          rs[r] += p;
          s[i] = p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
          l[r] = l[r] * corr[r] + rs[r];
        }
        if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
          for (int i = 0; i < 32 * NC; ++i) o[i] *= corr[(i >> 1) & 1];
        }

        // O += P V: the S fragment of keys 16kk.. is the A fragment of step kk;
        // V is K x N = keys x Dh with N contiguous (transposed B): 8-key groups
        // 1024 bytes apart (SBO), 64-column spans kBK rows apart (LBO)
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_pv(o, pa[kk], smem_desc(base + L::v(stage) + kk * 16 * kRowBytes, kBK * kRowBytes, 1024));
        wgmma_commit();
        wgmma_wait_all();
        pin(o);
      }
      mbar_arrive(empty(stage));
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // out = acc / max(l, 1e-30): o[i] is row row + 8 ((i >> 1) & 1), column 8 (i >> 2) + col + (i & 1)
    const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
    const size_t q_step = static_cast<size_t>(H) * Dh;
    __nv_bfloat16* ob = out + (static_cast<size_t>(b) * Sq * H + h) * Dh;
#pragma unroll
    for (int i = 0; i < 32 * NC; i += 2) {
      const int r = (i >> 1) & 1, qp = row + 8 * r, c = 8 * (i >> 2) + col;
      if (qp < Sq && c < Dh)
        *reinterpret_cast<__nv_bfloat162*>(ob + qp * q_step + c) =
            __floats2bfloat162_rn(o[i] / den[r], o[i + 1] / den[r]);
    }
  }
}

template <int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int H, int Kv, int Dh,
           float scale, int causal, int window, float cap, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  constexpr CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  constexpr size_t es = sizeof(__nv_bfloat16);
  CUresult r = tensor_map(&tq, bf16, es, q, B, Sq, H, Dh, kSpan, kBQ, sw);
  if (r == CUDA_SUCCESS) r = tensor_map(&tk, bf16, es, k, B, Skv, Kv, Dh, kSpan, kBK, sw);
  if (r == CUDA_SUCCESS) r = tensor_map(&tv, bf16, es, v, B, Skv, Kv, Dh, kSpan, kBK, sw);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  const size_t smem = Layout<NC>::smem;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  flash_attention_wgmma_kernel<NC><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Skv, H, Kv, Dh, scale, causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
                                 int H, int Kv, int Dh, float scale, int causal, int window, float cap,
                                 void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || (Sq + kBQ - 1) / kBQ > 65535 || Skv < 1 || Kv < 1 || H % Kv != 0 ||
      Dh < 8 || Dh > 256 || Dh % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((Dh + kSpan - 1) / kSpan) {
    case 1: return launch<1>(q, k, v, out, B, Sq, Skv, H, Kv, Dh, scale, causal, window, cap, s);
    case 2: return launch<2>(q, k, v, out, B, Sq, Skv, H, Kv, Dh, scale, causal, window, cap, s);
    case 3: return launch<3>(q, k, v, out, B, Sq, Skv, H, Kv, Dh, scale, causal, window, cap, s);
    default: return launch<4>(q, k, v, out, B, Sq, Skv, H, Kv, Dh, scale, causal, window, cap, s);
  }
}

// the dynamic shared memory one launch at this Dh takes, in bytes
size_t flash_attention_wgmma_smem_bytes(int Dh) {
  switch ((Dh + kSpan - 1) / kSpan) {
    case 1: return Layout<1>::smem;
    case 2: return Layout<2>::smem;
    case 3: return Layout<3>::smem;
    default: return Layout<4>::smem;
  }
}

}  // extern "C"
