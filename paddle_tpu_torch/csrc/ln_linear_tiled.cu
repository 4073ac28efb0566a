// K1 for a float32 W at the prefill rows: fused pre-LayerNorm + GEMM +
// bias,
//   out = LN(x) @ W + b,
// stored in W's dtype (float32).
//
// Replaces: paddle_tpu/ops/fused_block.py `_ln_linear_kernel` (launched by
// `_ln_linear_pallas`) for the calls that `ln_linear_route` sends here: a
// float32 W above `_LN_STREAM_MAX_ROWS` rows (serving's prefill buckets of
// 128-512 rows, generate's prefill of 4096; x the bf16 residual stream).
// LN is taken in float32 as `_ln_f32` takes it (the mean, then the mean of
// the squared deviations, rsqrt(var + eps), gain, bias); the products are
// float32 FMA, the JAX kernel's "highest" precision: no TF32.
//
// What bounds it on the H100: operations.  14.5 GFLOP at N=4096 (h = 768,
// 2304 columns) is 0.216 ms at the CUDA cores' 67 TFLOP/s; the bytes (x, W
// and the output, 51 MB) take 0.015 ms.  The SIMT kernel of ln_linear.cu
// gave each thread 4 outputs, so 5 shared-memory loads fed 4 FMAs; it
// staged W one scalar load at a time with no copy in flight during the
// products, and waited on a barrier on each side of every 32-deep slab.
//
// Design: the register-blocked float32 GEMM of tiled.cuh (64 x 128 tiles,
// 8 x 8 a thread, W and x in a 3-stage cp.async ring, the depth split over
// a cluster for small prefills) with its LayerNorm prologue: the block
// first takes its rows' mean and rstd over the whole h, then each thread
// normalises the 8 raw x values it copied of the next slab into the next A
// slab.  LN(x) never reaches device memory.  The epilogue adds b.  Each
// block of a split tile repeats its rows' statistics, which bounds the
// split (`_tiled_splits`).  Measured on the card (PERF.md, findings): a
// 4-stage ring, x staged through registers, 4 blocks an SM (128 registers:
// spills) ran slower.
#include "common.cuh"
#include "tiled.cuh"

namespace {

// T: x's element type.  x's rows are 16-byte aligned (k * sizeof(T) a
// multiple of 16, x 16-byte aligned), so its slabs move in 16-byte chunks.
template <typename T>
__global__ void __launch_bounds__(ptt_tiled::kThreads, 3)
ln_linear_tiled_kernel(const T* x, const float* w, const void* b, int b_bf16,
                       const void* g, int g_bf16, const void* beta,
                       int beta_bf16, float* out, int n, int k, int cols,
                       float eps) {
  ptt_tiled::LayerNorm ln{g, g_bf16, beta, beta_bf16, eps};
  auto bias = [&](int r, int c, float4 v) {
    v.x += ptt::ld(b, c + 0, b_bf16);
    v.y += ptt::ld(b, c + 1, b_bf16);
    v.z += ptt::ld(b, c + 2, b_bf16);
    v.w += ptt::ld(b, c + 3, b_bf16);
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(r) * cols + c) = v;
  };
  ptt_tiled::gemm(x, w, n, k, cols, ln, bias);
}

template <typename T>
cudaError_t launch(const T* x, const float* w, const void* b, int b_bf16,
                   const void* g, int g_bf16, const void* beta, int beta_bf16,
                   float* out, int n, int k, int cols, int cluster, float eps,
                   void* stream) {
  return ptt_tiled::launch(
      ln_linear_tiled_kernel<T>, n, cols, cluster,
      ptt_tiled::smem_bytes<ptt_tiled::LayerNorm>(k), stream, x, w, b,
      b_bf16, g, g_bf16, beta, beta_bf16, out, n, k, cols, eps);
}

}  // namespace

// Dynamic shared memory a block takes at depth k (h).
PTT_EXPORT size_t ptt_ln_linear_tiled_smem(int k) {
  return ptt_tiled::smem_bytes<ptt_tiled::LayerNorm>(k);
}

// (cols / 128 tiles x cluster, n / 64 tiles) blocks, the `cluster` blocks
// of a tile splitting its depth; x (n, k) float32 or bf16 with 16-byte
// aligned rows (k a multiple of 8 covers both), W (k, cols) float32 with
// cols a multiple of 4 and a 16-byte aligned start, out (n, cols) float32.
PTT_EXPORT int ptt_ln_linear_tiled(const void* x, int x_bf16, const float* w,
                                   const void* b, int b_bf16, const void* g,
                                   int g_bf16, const void* beta,
                                   int beta_bf16, float* out, int n, int k,
                                   int cols, int cluster, float eps,
                                   void* stream) {
  if (n <= 0 || k <= 0 || k % 8 || cols <= 0 || cols % 4 || cluster < 1 ||
      cluster > ptt_tiled::kMaxCluster || !ptt_tiled::aligned16(w) ||
      !ptt_tiled::aligned16(x))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      x_bf16 ? launch(static_cast<const __nv_bfloat16*>(x), w, b, b_bf16, g,
                      g_bf16, beta, beta_bf16, out, n, k, cols, cluster, eps,
                      stream)
             : launch(static_cast<const float*>(x), w, b, b_bf16, g, g_bf16,
                      beta, beta_bf16, out, n, k, cols, cluster, eps, stream);
  return static_cast<int>(err);
}
