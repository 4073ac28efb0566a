// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is built on its own (one nvcc per .cu, sm_90a) into a
// shared object with a plain C interface that Python binds through ctypes.
// Each C entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() so that a refused launch surfaces at once.
//
// Operands arrive as untyped pointers with a dtype code (0 = float32,
// 1 = bfloat16): the JAX package hands these kernels float32 parameters next
// to bfloat16 activations, and each operand's type is chosen independently.
// The branch on the code is uniform across a warp.  Arithmetic is float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PTT_EXPORT extern "C" __attribute__((visibility("default")))

namespace ptt {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float ld(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Stores round to nearest even, as a JAX astype(bfloat16) does.
__device__ __forceinline__ void st(void* p, int64_t i, float v, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// The value a store to the given dtype and a load back would give.
__device__ __forceinline__ float round_to(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

// keep(seed, salt, row, col): murmur3-fmix of the four counters, top 24
// bits as a uniform in [0, 1) -- bit-identical to `_keep_mask` of the JAX
// package (paddle_tpu/ops/flash_attention.py:129) in uint32 arithmetic.
// The flash kernels salt with the flattened batch*head index, the
// fused-block epilogues (K2, K3) with their own constants.
__device__ __forceinline__ bool keep(uint32_t seed, uint32_t salt, int row,
                                     int col, float p) {
  uint32_t x = static_cast<uint32_t>(row) * 0x85EBCA6Bu ^
               static_cast<uint32_t>(col) * 0xC2B2AE35u ^ seed ^
               salt * 0x9E3779B1u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  const float u =
      static_cast<float>(static_cast<int>(x >> 8)) * (1.0f / 16777216.0f);
  return u >= p;
}

// Hash dropout of one element as the JAX package's epilogues apply it:
// jnp.where(keep, y / (1 - p), 0), dividing by the float32 `keep_div`
// = 1 - p that the host computed in double precision and rounded.
struct Dropout {
  uint32_t seed;
  uint32_t salt;
  float p;
  float keep_div;
  __device__ __forceinline__ float operator()(float y, int64_t row,
                                              int col) const {
    return keep(seed, salt, static_cast<int>(row), col, p) ? y / keep_div
                                                           : 0.f;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Row-tile GEMM shared by K1, K2 and K3.  A block of kThreads threads owns a
// (kRows, kCols) output tile: thread (tx, ty) = (tid % kCols, tid / kCols)
// accumulates rows ty*4 .. ty*4+3 of column tx.  The A rows already sit in
// shared memory as float32 (stride lda); W is read from device memory in
// (kDepth, kCols) slabs staged through `slab`, coalesced along its columns.
//   acc[i] += sum_{k < klen} A[(ty*4+i)*lda + k] * W[(k0+k)*ldw + col0 + tx]
// Columns at or past ncols and depth past klen read as zero.  Every thread
// of the block must call it (it synchronises).
constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kCols = 64;
constexpr int kDepth = 32;
static_assert(kThreads / kCols * 4 == kRows, "thread layout covers the tile");

__device__ __forceinline__ void tile_gemm(const float* A, int lda,
                                          const void* W, int w_bf16,
                                          int64_t ldw, int64_t k0, int klen,
                                          int col0, int ncols, float* slab,
                                          float acc[4]) {
  const int tid = threadIdx.x;
  const int tx = tid % kCols;
  const int ty = tid / kCols;
  for (int kb = 0; kb < klen; kb += kDepth) {
    for (int i = tid; i < kDepth * kCols; i += kThreads) {
      const int kk = i / kCols;
      const int cc = i % kCols;
      const int gc = col0 + cc;
      slab[i] = (kb + kk < klen && gc < ncols)
                    ? ld(W, (k0 + kb + kk) * ldw + gc, w_bf16)
                    : 0.f;
    }
    __syncthreads();
    const int n = min(kDepth, klen - kb);
    const float* a = A + (ty * 4) * lda + kb;
    for (int kk = 0; kk < n; ++kk) {
      const float wv = slab[kk * kCols + tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(a[i * lda + kk], wv, acc[i]);
    }
    __syncthreads();
  }
}

// LayerNorm of `rows` rows of x (width k) into shared memory as float32, in
// the order of the JAX kernels: mean, then the mean of the squared
// deviations, rsqrt(var + eps), gain, bias.  The result is rounded to the
// GEMM operand dtype (`round_bf16`), as the TPU kernels keep LN(x) in a
// scratch of the weight's dtype.  Rows past `rows` are zero.  One warp per
// row; the caller synchronises afterwards.
__device__ __forceinline__ void ln_rows(const void* x, int x_bf16,
                                        int64_t row0, int rows, int k,
                                        const void* g, int g_bf16,
                                        const void* beta, int beta_bf16,
                                        float eps, int round_bf16,
                                        float* dst) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* d = dst + r * k;
    if (r >= rows) {
      for (int c = lane; c < k; c += 32) d[c] = 0.f;
      continue;
    }
    const int64_t xo = (row0 + r) * k;
    float sum = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float v = ld(x, xo + c, x_bf16);
      d[c] = v;
      sum += v;
    }
    const float mean = warp_sum(sum) / k;
    float sq = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float dv = d[c] - mean;
      sq += dv * dv;
    }
    const float rstd = rsqrtf(warp_sum(sq) / k + eps);
    for (int c = lane; c < k; c += 32) {
      const float y = (d[c] - mean) * rstd * ld(g, c, g_bf16) +
                      ld(beta, c, beta_bf16);
      d[c] = round_to(y, round_bf16);
    }
  }
}

// Rows of x copied into shared memory as float32 (zero past `rows`).
__device__ __forceinline__ void load_rows(const void* x, int x_bf16,
                                          int64_t row0, int rows, int k,
                                          float* dst) {
  for (int i = threadIdx.x; i < kRows * k; i += kThreads) {
    const int r = i / k;
    dst[i] = r < rows ? ld(x, (row0 + r) * k + i % k, x_bf16) : 0.f;
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ptt

PTT_EXPORT const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
