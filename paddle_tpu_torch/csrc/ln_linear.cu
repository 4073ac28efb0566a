// K1: fused pre-LayerNorm + GEMM + bias, out = LN(x) @ W + b.
//
// Replaces: paddle_tpu/ops/fused_block.py `_ln_linear_kernel` (launched by
// `_ln_linear_pallas`), the LN -> QKV projection of every decoder layer.
//
// What bounds it on the H100: at decode (N = 8 rows of h = 768 against a
// 768 x 2304 float32 weight) it is the 7 MB weight read, so bytes; at a
// 512-row prefill bucket it is 1.8 GFLOP of float32 products, which run on
// the CUDA cores (the JAX package keeps these parameters in float32 and
// contracts them at full float32 precision, so the bf16 tensor cores are not
// the matching unit), so operations.
//
// Design: a block owns a 16-row tile.  It computes LN(x) for those rows once,
// in float32, and keeps it in shared memory (16 x 768 x 4 B = 48 KB), so x is
// read once per block and LN(x) never reaches device memory.  It then loops
// over 64-wide output-column tiles, staging 32 x 64 weight slabs through
// shared memory.  On the TPU the column tiles were an inner sequential grid
// axis that reused the scratch; here blocks cannot share state, so the
// column tiles are dealt round-robin to `col_splits` blocks per row tile
// (each recomputes the cheap LN of its 16 rows) until the card is covered.
// Ragged edges in rows and columns are masked, so every shape is taken.
// A simple SIMT kernel: wgmma/TMA pipelines are later work.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(ptt::kThreads)
ln_linear_kernel(const void* x, int x_bf16, const void* w, int w_bf16,
                 const void* b, int b_bf16, const void* g, int g_bf16,
                 const void* beta, int beta_bf16, void* out, int out_bf16,
                 int n, int k, int cols, float eps, int col_splits) {
  extern __shared__ float smem[];
  float* lnx = smem;                          // kRows x k
  float* slab = smem + ptt::kRows * k;        // kDepth x kCols
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ptt::kRows;
  const int rows = min(ptt::kRows, static_cast<int>(n - row0));
  ptt::ln_rows(x, x_bf16, row0, rows, k, g, g_bf16, beta, beta_bf16, eps,
               w_bf16, lnx);
  __syncthreads();

  const int tx = threadIdx.x % ptt::kCols;
  const int ty = threadIdx.x / ptt::kCols;
  const int tiles = (cols + ptt::kCols - 1) / ptt::kCols;
  for (int t = blockIdx.y; t < tiles; t += col_splits) {
    const int col0 = t * ptt::kCols;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    ptt::tile_gemm(lnx, k, w, w_bf16, cols, 0, k, col0, cols, slab, acc);
    const int col = col0 + tx;
    if (col < cols) {
      const float bias = ptt::ld(b, col, b_bf16);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r < rows) ptt::st(out, (row0 + r) * cols + col, acc[i] + bias,
                              out_bf16);
      }
    }
  }
}

}  // namespace

PTT_EXPORT size_t ptt_ln_linear_smem(int k) {
  return sizeof(float) *
         (static_cast<size_t>(ptt::kRows) * k + ptt::kDepth * ptt::kCols);
}

PTT_EXPORT int ptt_ln_linear(const void* x, int x_bf16, const void* w,
                             int w_bf16, const void* b, int b_bf16,
                             const void* g, int g_bf16, const void* beta,
                             int beta_bf16, void* out, int out_bf16, int n,
                             int k, int cols, float eps, int col_splits,
                             void* stream) {
  const size_t smem = ptt_ln_linear_smem(k);
  cudaError_t err = ptt::allow_smem(ln_linear_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + ptt::kRows - 1) / ptt::kRows, col_splits);
  ln_linear_kernel<<<grid, ptt::kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, w, w_bf16, b, b_bf16, g, g_bf16, beta, beta_bf16, out,
      out_bf16, n, k, cols, eps, col_splits);
  return static_cast<int>(cudaGetLastError());
}
