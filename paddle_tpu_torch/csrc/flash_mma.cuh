// Tensor-core pieces of the bf16 flash kernels (flash_fwd.cu, flash_dkdv.cu,
// flash_dq.cu):
// 16-byte cp.async staging of bf16 tiles, ldmatrix fragment loads and the
// m16n8k16 bf16 mma with float32 accumulation.
//
// Tiles sit in shared memory as bf16 rows of stride D + 8 elements: a row is
// D / 8 chunks of 16 bytes, and the 16 extra bytes shift consecutive rows by
// four banks, so the eight row addresses of one ldmatrix 8x8 matrix hit all
// 32 banks once (at every D of 16, 32, 64, 128).
//
// Fragments of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major)  a0 (g, 2t..2t+1)   a1 (g+8, 2t..)
//                           a2 (g, 2t+8..)     a3 (g+8, 2t+8..)
//   B (16 x 8, k x n)       b0 (k 2t..2t+1, n g)   b1 (k 2t+8.., n g)
//   C (16 x 8, float32)     c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)
// So two n8 accumulator tiles j, j+1 packed to bf16 pairs are the A operand
// of the next product over the same 16 columns: (c0 c1 | c2 c3) of tile j
// and then of tile j + 1.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash.cuh"

namespace ptt_flash {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;             // one block: 4 warps x 16 rows = 64
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, or zero when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + ROWS - 1 of a (n, D) bf16 matrix into a tile of
// stride D + 8, by kThreads threads in 16-byte chunks (consecutive threads
// on consecutive chunks of a row); rows at or past n are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(const bf16* __restrict__ src,
                                                int row0, int n, bf16* dst) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int g = row0 + r;
    const bool ok = g < n;
    cp_async16(dst + r * (D + 8) + c * 8,
               src + (ok ? static_cast<int64_t>(g) * D + c * 8 : 0), ok);
  }
}

// ROWS float32 statistics from row0 of a (n,) vector; zero past n.
template <int ROWS>
__device__ __forceinline__ void load_stats_async(const float* __restrict__ src,
                                                 int row0, int n,
                                                 float* dst) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool ok = row0 + i < n;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

// Four 8x8 bf16 matrices; lanes 8m .. 8m + 7 give the row addresses of
// matrix m, and register m receives it (row lane / 4, columns 2 (lane % 4)
// and + 1; with .trans the transpose: rows 2 (lane % 4) and + 1 of column
// lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of rows 0..15, columns k0..k0+15 of a row-major tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + (lane % 16) * LD + k0 + (lane / 16) * 8);
}

// B fragments of two n8 tiles, rows n0..n0+15 of a tile stored [n][k]
// (K for Q.K^T, Q or dO for K.Q^T / V.dO^T), columns k0..k0+15:
// b[0], b[1] for n0..n0+7 and b[2], b[3] for n0+8..n0+15.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, tile + (n0 + lane % 8 + (lane / 16) * 8) * LD + k0 +
                 ((lane / 8) % 2) * 8);
}

// B fragments of two n8 tiles from a tile stored [k][n] (V, dO, Q, K as the
// right operand of P.V, pd^T.dO, dS^T.Q, dS.K): rows k0..k0+15, columns
// n0..n0+15, transposed by ldmatrix.
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + n0 +
                       (lane / 16) * 8);
}

// d += a . b on the tensor cores: bf16 x bf16 products are exact in the
// float32 accumulator.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand over columns 16 kk .. 16 kk + 15 from n8 accumulator tiles
// 2 kk and 2 kk + 1.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// The A fragments of 16 rows (at `tile`) over all D columns of a row-major
// tile.
template <int D>
__device__ __forceinline__ void load_rows_a(uint32_t (&a)[D / 16][4],
                                            const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<D + 8>(a[kk], tile, kk * 16);
}

// c[j] += A . B^T over D columns: A as fragments (load_rows_a), B the
// N8 * 8 rows of a tile stored [n][k].
template <int D, int N8>
__device__ __forceinline__ void gemm_nt(float (&c)[N8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const bf16* b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < N8 / 2; ++np) {
      uint32_t b[4];
      load_b_nk<D + 8>(b, b_tile, np * 16, kk * 16);
      mma16816(c[2 * np], a[kk], b[0], b[1]);
      mma16816(c[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// c[j] += P . B over the K8 * 8 columns of the accumulator tiles p (packed
// to bf16 as the A operand) and the rows of a tile stored [k][n] with D
// columns: P.V, pd^T.dO, dS^T.Q, dS.K.
template <int D, int K8>
__device__ __forceinline__ void gemm_pv(float (&c)[D / 8][4],
                                        const float (&p)[K8][4],
                                        const bf16* b_tile) {
#pragma unroll
  for (int kk = 0; kk < K8 / 2; ++kk) {
    uint32_t a[4];
    acc_to_a(a, p, kk);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      load_b_kn<D + 8>(b, b_tile, kk * 16, np * 16);
      mma16816(c[2 * np], a, b[0], b[1]);
      mma16816(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Max / sum over the four lanes of a quad (the threads that share an
// accumulator row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(ptt::kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(ptt::kFullMask, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(ptt::kFullMask, v, 1);
  return v + __shfl_xor_sync(ptt::kFullMask, v, 2);
}

// Every pointer the bf16 kernels stage with 16-byte copies is 16-byte
// aligned.
__device__ __host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace mma
}  // namespace ptt_flash
