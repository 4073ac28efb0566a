// K2: GEMM with a dropout + residual epilogue,
//   out = r + drop(x @ W + b),
// stored in r's dtype.
//
// Replaces: paddle_tpu/ops/fused_block.py `_linear_residual_kernel`
// (launched by `_linear_residual_pallas`), the attention out-projection plus
// residual add of every decoder layer.  drop is the counter-hash dropout of
// the JAX kernel (`keep` in common.cuh) over the global (row, col) of the
// (n, cols) output, salted by the caller (`_SALT_RESID`): a kept value is
// divided by the float32 1 - p, a dropped one is 0.  Serving and generate run
// it with dropout 0, the training path with the block's hidden dropout; the
// two are separate instantiations, so dropout 0 costs nothing.
//
// What bounds it on the H100: at decode (8 x 768 against a 768 x 768 float32
// weight) the 2.4 MB weight read, so bytes; at a 512-row prefill bucket
// 0.6 GFLOP of float32 products on the CUDA cores, so operations.
//
// Design: a block owns a 16-row tile of x, copied once into shared memory as
// float32, and loops over the 64-wide column tiles dealt to it (column tiles
// are spread round-robin over `col_splits` blocks per row tile so that a
// decode call still covers many SMs).  The epilogue adds the bias and the
// residual in float32 and rounds once to r's dtype, in one output pass: the
// GEMM result never lands in device memory.  Ragged edges are masked.
#include "common.cuh"

namespace {

template <bool kDrop>
__global__ void __launch_bounds__(ptt::kThreads)
linear_residual_kernel(const void* x, int x_bf16, const void* w, int w_bf16,
                       const void* b, int b_bf16, const void* r, int r_bf16,
                       void* out, int n, int k, int cols, int col_splits,
                       ptt::Dropout drop) {
  extern __shared__ float smem[];
  float* xs = smem;                           // kRows x k
  float* slab = smem + ptt::kRows * k;        // kDepth x kCols
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ptt::kRows;
  const int rows = min(ptt::kRows, static_cast<int>(n - row0));
  ptt::load_rows(x, x_bf16, row0, rows, k, xs);
  __syncthreads();

  const int tx = threadIdx.x % ptt::kCols;
  const int ty = threadIdx.x / ptt::kCols;
  const int tiles = (cols + ptt::kCols - 1) / ptt::kCols;
  for (int t = blockIdx.y; t < tiles; t += col_splits) {
    const int col0 = t * ptt::kCols;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    ptt::tile_gemm(xs, k, w, w_bf16, cols, 0, k, col0, cols, slab, acc);
    const int col = col0 + tx;
    if (col < cols) {
      const float bias = ptt::ld(b, col, b_bf16);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = ty * 4 + i;
        if (rr < rows) {
          const int64_t o = (row0 + rr) * cols + col;
          float y = acc[i] + bias;
          if (kDrop) y = drop(y, row0 + rr, col);
          ptt::st(out, o, ptt::ld(r, o, r_bf16) + y, r_bf16);
        }
      }
    }
  }
}

}  // namespace

PTT_EXPORT size_t ptt_linear_residual_smem(int k) {
  return sizeof(float) *
         (static_cast<size_t>(ptt::kRows) * k + ptt::kDepth * ptt::kCols);
}

// Dropout p > 0 takes the dropout instantiation, with the hash's seed and
// salt and keep_div = 1 - p rounded to float32 on the host.
PTT_EXPORT int ptt_linear_residual(const void* x, int x_bf16, const void* w,
                                   int w_bf16, const void* b, int b_bf16,
                                   const void* r, int r_bf16, void* out,
                                   int n, int k, int cols, int col_splits,
                                   unsigned seed, unsigned salt, float p,
                                   float keep_div, void* stream) {
  const size_t smem = ptt_linear_residual_smem(k);
  auto kernel = p > 0.f ? linear_residual_kernel<true>
                        : linear_residual_kernel<false>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + ptt::kRows - 1) / ptt::kRows, col_splits);
  kernel<<<grid, ptt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, w, w_bf16, b, b_bf16, r, r_bf16, out, n, k, cols,
      col_splits, ptt::Dropout{seed, salt, p, keep_div});
  return static_cast<int>(cudaGetLastError());
}
