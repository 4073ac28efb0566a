// K1 for a float32 W at a few rows (decode): fused pre-LayerNorm + GEMM +
// bias,
//   out = LN(x) @ W + b,
// stored in W's dtype (float32).
//
// Replaces: paddle_tpu/ops/fused_block.py `_ln_linear_kernel` (launched by
// `_ln_linear_pallas`) for the calls that `ln_linear_route` sends here: a
// float32 W at no more than `_LN_STREAM_MAX_ROWS` rows (the LN -> QKV
// projection of serving's and generate's decode steps, x the bf16 residual
// stream).  LN is taken in float32 as `_ln_f32` takes it: the mean, then
// the mean of the squared deviations, rsqrt(var + eps), gain, bias; the
// products are float32 FMA, the JAX kernel's "highest" precision.
//
// What bounds it on the H100: the 7.08 MB of W at GPT-125M (768 x 2304),
// 2.1 us at 3.35 TB/s; the products (28 MFLOP at 8 rows) take 0.4 us of
// the CUDA cores' 67 TFLOP/s.  The SIMT kernel of ln_linear.cu ran one
// block per 16-row tile dealt ~264 ways over the column tiles, each block
// streaming its columns through one 8 KB slab at a time between two
// barriers: 0.063 ms at 8 rows, slower than its plain version.
//
// Design: the body of K2's weight-streaming kernel (`ptt_stream::gemm`,
// stream.cuh): W cut into column tiles x depth chunks, one chunk a block
// and about one block an SM (at GPT-125M: 22 tiles of 108 columns x
// clusters of 6 chunks of 128 rows, 132 blocks of 55 KB, 128 bulk copies
// of 432 bytes each), the whole chunk in flight at once, the cluster's
// (n, width) partials summed over distributed shared memory in rank order,
// then + b.  What K1 adds is the LN prologue, which runs while W lands:
// each block reads its n rows of x over the whole h (12 KB at 8 x 768
// bf16, from L2 after the first block), each warp 4 rows at once, takes
// every row's mean and variance in float32, and writes LN(x) over its own
// depth slice only into shared memory.  Every rank repeats the same
// statistics, which costs no synchronisation across blocks but is the
// part of the kernel that K2's body does not have: the three passes over a
// row are round trips to memory, 8 loads a lane in flight each (scratch
// builds with 1, 2 or 8 rows a warp, a row held in registers for one pass,
// or its slice kept from the first pass all ran slower; PERF.md,
// findings).  Above 32 rows ln_linear_tiled is faster (the product loop
// here is one warp per 4-column quad).  No scratch, no atomics: a call
// repeats bit for bit.
#include "common.cuh"
#include "stream.cuh"

using ptt_stream::kThreads;
using ptt_stream::kWarps;

namespace {

constexpr int kLnRows = 4;   // rows a warp normalises at once

// LN(x) of rows 0 .. n - 1 (width k) over the depth slice [k0, k0 + kd)
// into xs (rows8(n) rows of stride `depth`, zero from row n on).  Warp w
// takes rows w, w + kWarps, ... kLnRows at a time, their loads in flight
// together; every pass over a row reads it from device memory or L1 again
// (a block has no room for 64 rows of it).
__device__ __forceinline__ void ln_slice(const void* x, int x_bf16, int n,
                                         int k, const void* g, int g_bf16,
                                         const void* beta, int beta_bf16,
                                         float eps, int k0, int kd, int depth,
                                         float* xs) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n8 = ptt_stream::rows8(n);
  for (int base = warp; base < n8; base += kLnRows * kWarps) {
    float mean[kLnRows], rstd[kLnRows];
#pragma unroll
    for (int j = 0; j < kLnRows; ++j) mean[j] = rstd[j] = 0.f;
#pragma unroll 8
    for (int c = lane; c < k; c += 32) {
#pragma unroll
      for (int j = 0; j < kLnRows; ++j) {
        const int r = base + j * kWarps;
        if (r < n) mean[j] += ptt::ld(x, static_cast<int64_t>(r) * k + c,
                                      x_bf16);
      }
    }
#pragma unroll
    for (int j = 0; j < kLnRows; ++j) mean[j] = ptt::warp_sum(mean[j]) / k;
#pragma unroll 8
    for (int c = lane; c < k; c += 32) {
#pragma unroll
      for (int j = 0; j < kLnRows; ++j) {
        const int r = base + j * kWarps;
        if (r < n) {
          const float dv =
              ptt::ld(x, static_cast<int64_t>(r) * k + c, x_bf16) - mean[j];
          rstd[j] += dv * dv;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLnRows; ++j)
      rstd[j] = rsqrtf(ptt::warp_sum(rstd[j]) / k + eps);
#pragma unroll
    for (int j = 0; j < kLnRows; ++j) {
      const int r = base + j * kWarps;
      if (r >= n8) continue;
      float* d = xs + r * depth;
      for (int c = lane; c < kd; c += 32)
        d[c] = r < n ? (ptt::ld(x, static_cast<int64_t>(r) * k + k0 + c,
                                x_bf16) -
                        mean[j]) * rstd[j] * ptt::ld(g, k0 + c, g_bf16) +
                           ptt::ld(beta, k0 + c, beta_bf16)
                     : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ln_linear_stream_kernel(const void* x, int x_bf16, const float* w,
                        const void* b, int b_bf16, const void* g, int g_bf16,
                        const void* beta, int beta_bf16, float* out, int n,
                        int k, int cols, int width, int depth, float eps) {
  auto stage = [&](float* xs, int k0, int kd, int, int, int, int) {
    ln_slice(x, x_bf16, n, k, g, g_bf16, beta, beta_bf16, eps, k0, kd, depth,
             xs);
  };
  auto finish = [&](int rr, int col, float s) {
    out[static_cast<int64_t>(rr) * cols + col] = s + ptt::ld(b, col, b_bf16);
  };
  ptt_stream::gemm(w, n, k, cols, width, depth, stage, finish);
}

}  // namespace

// Dynamic shared memory a block takes for n rows, `width` columns and
// `depth` rows of W (the same count as linear_residual_stream's).
PTT_EXPORT size_t ptt_ln_linear_stream_smem(int n, int width, int depth) {
  return sizeof(float) * ptt_stream::gemm_smem_floats(n, width, depth);
}

// tiles x cluster blocks: column tiles of `width` (a multiple of 4) by
// `cluster` depth chunks of `depth` rows; x (n, k) float32 or bf16, W
// (k, cols) float32, out (n, cols) float32.
PTT_EXPORT int ptt_ln_linear_stream(const void* x, int x_bf16, const float* w,
                                    const void* b, int b_bf16, const void* g,
                                    int g_bf16, const void* beta,
                                    int beta_bf16, float* out, int n, int k,
                                    int cols, int width, int depth,
                                    int cluster, float eps, void* stream) {
  if (n <= 0 || cols % 4 || width % 4 || width <= 0 || depth <= 0 ||
      cluster < 1 || cluster > ptt_stream::kMaxCluster ||
      static_cast<int64_t>(cluster) * depth < k ||
      !ptt_stream::aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ptt_stream::launch_gemm(
      ln_linear_stream_kernel, (cols + width - 1) / width, cluster,
      ptt_ln_linear_stream_smem(n, width, depth), stream, x, x_bf16, w, b,
      b_bf16, g, g_bf16, beta, beta_bf16, out, n, k, cols, width, depth,
      eps));
}
