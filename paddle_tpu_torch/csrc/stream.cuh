// Pieces shared by the weight-streaming kernels of the fused block on
// float32 weights at a few rows (ffn_stream.cu, linear_residual_stream.cu):
// bulk copies by the copy engine (cp.async.bulk) of a block's whole share
// of the weights, a copy a row of a weight slab, issued at once and
// completing on mbarriers, one per stage; and the product of 8 rows by one
// 4-column quad of a slab with one warp, its lanes over the depth, summed
// across the lanes in a fixed order.
//
// A slab of `width` columns sits in shared memory as dense rows of `width`
// floats.  When width / 4 is odd the 8 lanes of a 16-byte load phase, on 8
// consecutive rows, hit 8 different groups of 4 banks (GPT-125M's 28 and
// 36); an even width / 4 costs two-way bank conflicts.
#pragma once

#include "common.cuh"

namespace ptt_stream {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;      // rows a pass: 8 rows x 4 columns = 32 sums
static_assert(kRows * 4 == 32, "one sum a lane after the lane reduction");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// An mbarrier in shared memory that one arrival (with the bytes it expects)
// and the bytes of the bulk copies that name it complete.  Initialised by
// one thread, made visible to the copy engine before the block's barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's first phase has completed (every byte it
// expected has landed); returns at once ever after.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory by the copy engine (TMA), completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Fetch the 128-byte line of `p` into L2 ahead of its use.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// acc[r * 4 + j] += sum over k = k_lo + lane, k_lo + lane + 32, ... < k_hi
// of a[r * lda + k] * w[k * ldw + j] (w already offset to the quad).  One
// warp; a's rows are kRows float32 rows in shared memory.
__device__ __forceinline__ void quad_products(const float* a, int lda,
                                              const float* w, int ldw,
                                              int k_lo, int k_hi,
                                              float (&acc)[32]) {
  const int lane = threadIdx.x % 32;
  for (int k = k_lo + lane; k < k_hi; k += 32) {
    const float4 wv = *reinterpret_cast<const float4*>(w + k * ldw);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float av = a[r * lda + k];
      acc[r * 4 + 0] = fmaf(av, wv.x, acc[r * 4 + 0]);
      acc[r * 4 + 1] = fmaf(av, wv.y, acc[r * 4 + 1]);
      acc[r * 4 + 2] = fmaf(av, wv.z, acc[r * 4 + 2]);
      acc[r * 4 + 3] = fmaf(av, wv.w, acc[r * 4 + 3]);
    }
  }
}

// One step of lane_sums: lanes l and l ^ O swap the halves of their first
// 2 * O values that the other keeps, and add.
template <int O>
__device__ __forceinline__ void fold(float (&acc)[32], bool upper) {
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? acc[i] : acc[i + O];
    const float keep = upper ? acc[i + O] : acc[i];
    acc[i] = keep + __shfl_xor_sync(ptt::kFullMask, send, O);
  }
}

// The 32 per-lane sums of a warp, summed over its lanes by a butterfly that
// halves the values each lane carries at every step (31 shuffles): lane l
// returns the warp's total of acc[l], that is row l / 4, column l % 4.
// The order of the additions is fixed, so results repeat bit for bit.
// Every index is a constant, so acc stays in registers.
__device__ __forceinline__ float lane_sums(float (&acc)[32]) {
  const int lane = threadIdx.x % 32;
  fold<16>(acc, lane & 16);
  fold<8>(acc, lane & 8);
  fold<4>(acc, lane & 4);
  fold<2>(acc, lane & 2);
  fold<1>(acc, lane & 1);
  return acc[0];
}

}  // namespace ptt_stream
