// Pieces shared by the weight-streaming kernels of the fused block on
// float32 weights at a few rows (ffn_stream.cu, linear_residual_stream.cu,
// ln_linear_stream.cu): bulk copies by the copy engine (cp.async.bulk) of a
// block's whole share of the weights, a copy a row of a weight slab, issued
// at once and completing on mbarriers, one per stage; the product of 8 rows
// by one 4-column quad of a slab with one warp, its lanes over the depth,
// summed across the lanes in a fixed order; and `gemm`, the whole body of
// the depth-split GEMM that K2 and K1 share, with their own prologue and
// epilogue.
//
// A slab of `width` columns sits in shared memory as dense rows of `width`
// floats.  When width / 4 is odd the 8 lanes of a 16-byte load phase, on 8
// consecutive rows, hit 8 different groups of 4 banks (GPT-125M's 28 and
// 36); an even width / 4 costs two-way bank conflicts.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace ptt_stream {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;      // rows a pass: 8 rows x 4 columns = 32 sums
static_assert(kRows * 4 == 32, "one sum a lane after the lane reduction");
constexpr int kMaxCluster = 8;   // portable

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

__host__ __device__ inline int rows8(int n) {
  return (n + kRows - 1) / kRows * kRows;
}

// Floats of dynamic shared memory a block of `gemm` takes for n rows,
// `width` columns and `depth` rows of W.
__host__ __device__ inline size_t gemm_smem_floats(int n, int width,
                                                   int depth) {
  return static_cast<size_t>(depth) * width                     // W
         + static_cast<size_t>(rows8(n)) * depth                // A
         + static_cast<size_t>(n) * width;                      // the partial
}

// out[row, col] = finish(row, col, sum over k of A[row, k] * w[k, col]) for
// n rows of a float32 (k, cols) weight, by a grid of column tiles of
// `width` (a multiple of 4) x `cluster` depth chunks of `depth` rows, one
// chunk a block, the `cluster` blocks of a tile one thread-block cluster
// with rank q owning depth chunk q.  A block puts its whole chunk in flight
// at once, a bulk copy a row of its valid columns (a multiple of 4; the
// others' products are never read) on one mbarrier; meanwhile
// `stage(xs, k0, kd, c0, cw, e_lo, e_hi)` writes the A operand's rows over
// the rank's depth [k0, k0 + kd) into xs (rows8(n) rows of stride `depth`,
// zero from row n on; all threads call it, and it may fetch what the
// epilogue of elements [e_lo, e_hi) of the (n, cw) tile at column c0 will
// read).  Then each warp takes a quad of the tile's columns, its lanes
// walking the depth with 8 rows x 4 columns of sums each, summed across the
// lanes by a butterfly in a fixed order.  The cluster adds its ranks'
// (n, width) partials through distributed shared memory in rank order, rank
// q a slice of the tile's elements, and hands each sum to `finish`: no
// scratch, no atomics, so a call repeats bit for bit.
template <class Stage, class Finish>
__device__ __forceinline__ void gemm(const float* w, int n, int k, int cols,
                                     int width, int depth, const Stage& stage,
                                     const Finish& finish) {
  extern __shared__ __align__(16) float smem[];
  const int n8 = rows8(n);
  float* ws = smem;                   // depth x width: W[k0 : +kd, c0 : +cw]
  float* xs = ws + depth * width;     // n8 x depth: A[:, k0 : k0 + kd]
  float* ps = xs + n8 * depth;        // n x width: the rank's partial
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int c0 = (blockIdx.x / csize) * width;
  const int k0 = crank * depth;
  const int kd = max(0, min(depth, k - k0));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quads = width / 4;

  __shared__ __align__(8) uint64_t bar;
  const int cw = min(width, cols - c0);
  const int total = n * cw;
  const int span = (total + csize - 1) / csize;
  const int e_lo = crank * span;
  const int e_hi = min(total, e_lo + span);
  if (tid == 0) {
    mbar_init(&bar);
    mbar_fence_init();
    mbar_expect(&bar, kd * cw * 4);
  }
  __syncthreads();   // the bytes expected before any can land
  for (int kk = tid; kk < kd; kk += kThreads)
    bulk_copy(ws + kk * width, w + static_cast<int64_t>(k0 + kk) * cols + c0,
              cw * 4, &bar);
  stage(xs, k0, kd, c0, cw, e_lo, e_hi);
  __syncthreads();
  mbar_wait(&bar);

  for (int row0 = 0; row0 < n; row0 += kRows) {
    for (int q = warp; q < quads; q += kWarps) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      quad_products(xs + row0 * depth, depth, ws + 4 * q, width, 0, kd, acc);
      const float v = lane_sums(acc);
      const int rr = row0 + lane / 4;
      if (rr < n) ps[rr * width + 4 * q + lane % 4] = v;
    }
  }

  // The cluster's sum, rank q over its slice of the tile's elements, the
  // ranks in order; the first barrier also orders every peer's start
  // before the reads.
  cluster.sync();
  for (int e = e_lo + tid; e < e_hi; e += kThreads) {
    const int rr = e / cw;
    const int c = e % cw;
    float v[kMaxCluster];   // every rank's load in flight, then the sum
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < csize) v[q] = cluster.map_shared_rank(ps, q)[rr * width + c];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < csize) s += v[q];
    finish(rr, c0 + c, s);
  }
  cluster.sync();   // no block leaves while a peer still reads its partial
}

// Launch `kernel` (a `gemm` kernel) on `tiles` column tiles x `cluster`
// depth chunks, a cluster a tile, with `smem` bytes of dynamic shared
// memory; returns the launch's error.
template <typename Kernel, typename... Args>
inline cudaError_t launch_gemm(Kernel kernel, int tiles, int cluster,
                               size_t smem, void* stream, Args... args) {
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(tiles * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace ptt_stream
