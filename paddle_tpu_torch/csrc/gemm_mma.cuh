// Pieces shared by the tensor-core kernels of the fused block on bf16
// weights (ln_linear_mma.cu, linear_residual_mma.cu, ffn_mma.cu): the LN of
// a row tile into shared memory as bf16, 16-byte cp.async staging of a bf16
// sub-matrix into a ring stage, and the product of a warp's rows of a bf16 A
// tile by a bf16 [k][n] stage on mma.sync.m16n8k16 with float32
// accumulators, fed by ldmatrix (flash_mma.cuh).
//
// Every tile sits in shared memory as bf16 rows of stride COLS + 8
// elements: the 16 extra bytes shift consecutive rows by four banks, so the
// eight row addresses of an ldmatrix 8x8 matrix hit all 32 banks once.
#pragma once

#include "common.cuh"
#include "flash_mma.cuh"

namespace ptt_gemm {

using ptt_flash::mma::bf16;

// LN of a tile of ROWS rows of x (width H) into shared memory as bf16
// (stride H + 8), in the order of the JAX kernels: mean, the mean of the
// squared deviations, rsqrt(var + eps), gain, bias, rounded once.  One warp
// per row, the row's H / 32 values in registers; rows at or past n are
// zero.  The caller synchronises before reading it.
template <int H, int ROWS, int WARPS>
__device__ __forceinline__ void ln_tile(const void* x, int x_bf16,
                                        int64_t row0, int n, const void* g,
                                        int g_bf16, const void* beta,
                                        int beta_bf16, float eps, bf16* lnx) {
  constexpr int kPer = H / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += WARPS) {
    bf16* d = lnx + r * (H + 8);
    const int64_t row = row0 + r;
    if (row >= n) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) d[lane + 32 * u] = __float2bfloat16(0.f);
      continue;
    }
    float v[kPer];
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      v[u] = ptt::ld(x, row * H + lane + 32 * u, x_bf16);
      sum += v[u];
    }
    const float mean = ptt::warp_sum(sum) / H;
    float sq = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const float dv = v[u] - mean;
      sq += dv * dv;
    }
    const float rstd = rsqrtf(ptt::warp_sum(sq) / H + eps);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = lane + 32 * u;
      d[c] = __float2bfloat16((v[u] - mean) * rstd * ptt::ld(g, c, g_bf16) +
                              ptt::ld(beta, c, beta_bf16));
    }
  }
}

// ROWS x COLS bf16 elements from `src` (row stride ld elements) into `dst`
// (stride COLS + 8) by THREADS threads in 16-byte cp.async chunks,
// consecutive threads on consecutive chunks of a row: a thread copies the
// same column chunk of rows r0, r0 + THREADS / (COLS / 8), ...  Chunks of
// rows at or past rows_ok, or of columns at or past cols_ok (a multiple of
// 8), are zero-filled and not read.  The thread's row and column are
// computed once, not per chunk: per chunk, the h = 768 loop of
// linear_residual_mma.cu spilled past its 128 registers (ptxas).
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_tile(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int64_t ld, int rows_ok,
                                           int cols_ok) {
  constexpr int kPerRow = COLS / 8;
  constexpr int kRowsPass = THREADS / kPerRow;  // rows a pass of the block
  static_assert(THREADS % kPerRow == 0 && ROWS % kRowsPass == 0,
                "whole rows a pass, whole passes a tile");
  const int r0 = threadIdx.x / kPerRow;
  const int c = threadIdx.x % kPerRow * 8;
  const bool col_ok = c < cols_ok;
#pragma unroll
  for (int u = 0; u < ROWS / kRowsPass; ++u) {
    const int r = r0 + u * kRowsPass;
    const bool ok = col_ok && r < rows_ok;
    ptt_flash::mma::cp_async16(dst + r * (COLS + 8) + c,
                               ok ? src + r * ld + c : src, ok);
  }
}

// acc[i][j] += A[16 i .. 16 i + 15, k0 .. k0 + 16 KSTEPS - 1] .
//              B[0 .. 16 KSTEPS - 1, n0 + 8 j .. n0 + 8 j + 7]
// for a warp: `a` is its first row of a row-major bf16 tile (stride LDA),
// `b` a [k][n] bf16 ring stage (stride LDB).  ldmatrix.x4 loads A for 16
// rows and B for two n8 tiles at once.
template <int MI, int NJ, int KSTEPS, int LDA, int LDB>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][4],
                                         const bf16* a, int k0,
                                         const bf16* b, int n0) {
  static_assert(NJ % 2 == 0, "B fragments come in n8 pairs");
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t af[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      ptt_flash::mma::load_a<LDA>(af[i], a + 16 * i * LDA, k0 + 16 * kk);
#pragma unroll
    for (int np = 0; np < NJ / 2; ++np) {
      uint32_t bf[4];
      ptt_flash::mma::load_b_kn<LDB>(bf, b, 16 * kk, n0 + 16 * np);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        ptt_flash::mma::mma16816(acc[i][2 * np], af[i], bf[0], bf[1]);
        ptt_flash::mma::mma16816(acc[i][2 * np + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

}  // namespace ptt_gemm
