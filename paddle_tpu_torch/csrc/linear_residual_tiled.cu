// K2 for a float32 W at the prefill rows: GEMM with a dropout + residual
// epilogue,
//   out = r + drop(x @ W + b),
// stored in r's dtype.
//
// Replaces: paddle_tpu/ops/fused_block.py `_linear_residual_kernel`
// (launched by `_linear_residual_pallas`) for the calls that
// `linear_residual_route` sends here: a float32 W above
// `_RESID_STREAM_MAX_ROWS` rows (the attention out-projection of serving's
// prefill buckets of 128-512 rows and of generate's prefill of 4096; x the
// attention output in the cache dtype, float32 or bf16; r the bf16
// residual stream).  drop
// is the counter-hash dropout of the JAX kernel over the global (row,
// col), salted by the caller (`_SALT_RESID`); the products are float32
// FMA, the JAX kernel's "highest" precision: no TF32.
//
// What bounds it on the H100: operations.  4.8 GFLOP at N=4096 (768 x 768)
// is 0.072 ms at the CUDA cores' 67 TFLOP/s; x, W, r and the output (21 MB
// with bf16 x and r) take 0.006 ms.  The SIMT kernel of linear_residual.cu
// gave each thread 4 outputs of a 16-row tile and staged W one scalar load
// at a time, with a barrier on each side of every 32-deep slab.
//
// Design: the register-blocked float32 GEMM of tiled.cuh (64 x 128 tiles,
// 8 x 8 a thread, W and x in a 3-stage cp.async ring, the depth split over
// a cluster where the tiles alone leave the card short of blocks) with the
// raw prologue (x as float32) and the residual epilogue: + b, drop, + r,
// rounded once to r's dtype.  The GEMM result never reaches device memory.
// K3's second half (ffn_tiled.cu) is the same kernel with `_SALT_FFN2`.
#include "common.cuh"
#include "tiled.cuh"

namespace {

// T: x's element type.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(ptt_tiled::kThreads, 3)
linear_residual_tiled_kernel(const T* x, const float* w, const void* b,
                             int b_bf16, const void* r, int r_bf16,
                             void* out, int n, int k, int cols,
                             ptt::Dropout drop) {
  ptt_tiled::Raw raw;
  const ptt_tiled::Residual<kDrop> res{b, b_bf16, r, r_bf16, out, cols,
                                       drop};
  ptt_tiled::gemm(x, w, n, k, cols, raw, res);
}

template <typename T>
cudaError_t launch(const T* x, const float* w, const void* b, int b_bf16,
                   const void* r, int r_bf16, void* out, int n, int k,
                   int cols, int cluster, const ptt::Dropout& drop,
                   void* stream) {
  auto kernel = drop.p > 0.f ? linear_residual_tiled_kernel<T, true>
                             : linear_residual_tiled_kernel<T, false>;
  return ptt_tiled::launch(kernel, n, cols, cluster,
                           ptt_tiled::smem_bytes<ptt_tiled::Raw>(k), stream,
                           x, w, b, b_bf16, r, r_bf16, out, n, k, cols, drop);
}

}  // namespace

// Dynamic shared memory a block takes (any depth).
PTT_EXPORT size_t ptt_linear_residual_tiled_smem() {
  return ptt_tiled::smem_bytes<ptt_tiled::Raw>(0);
}

// (cols / 128 tiles x cluster, n / 64 tiles) blocks, the `cluster` blocks
// of a tile splitting its depth; x (n, k) float32 or bf16 with k a multiple
// of 8 and a 16-byte aligned start, W (k, cols) float32 with cols a
// multiple of 4 and a 16-byte aligned start, r and out (n, cols) in r's
// dtype.  Dropout p > 0 takes the instantiation with it (seed, salt,
// keep_div = 1 - p rounded to float32 on the host).
PTT_EXPORT int ptt_linear_residual_tiled(const void* x, int x_bf16,
                                         const float* w, const void* b,
                                         int b_bf16, const void* r,
                                         int r_bf16, void* out, int n, int k,
                                         int cols, int cluster, unsigned seed,
                                         unsigned salt, float p,
                                         float keep_div, void* stream) {
  if (n <= 0 || k <= 0 || k % 8 || cols <= 0 || cols % 4 || cluster < 1 ||
      cluster > ptt_tiled::kMaxCluster || !ptt_tiled::aligned16(w) ||
      !ptt_tiled::aligned16(x))
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::Dropout drop{seed, salt, p, keep_div};
  const cudaError_t err =
      x_bf16 ? launch(static_cast<const __nv_bfloat16*>(x), w, b, b_bf16, r,
                      r_bf16, out, n, k, cols, cluster, drop, stream)
             : launch(static_cast<const float*>(x), w, b, b_bf16, r, r_bf16,
                      out, n, k, cols, cluster, drop, stream);
  return static_cast<int>(err);
}
