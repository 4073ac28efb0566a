// K3 for float32 weights at the prefill rows: the FFN half of a pre-LN
// decoder block,
//   out = x + drop2(drop1(act(LN(x) @ W1 + b1)) @ W2 + b2),
// act = exact gelu or relu, stored in x's dtype.
//
// Replaces: paddle_tpu/ops/fused_block.py `_ffn_kernel` (launched by
// `_ffn_pallas`) for the calls that `ffn_route` sends here: float32 W1 and
// W2 above `_FFN_STREAM_MAX_ROWS` rows (serving's prefill buckets of
// 128-512 rows, generate's prefill of 4096; x the bf16 residual stream).
// LN in float32 as `_ln_f32` takes it, every product a float32 FMA (the
// JAX kernel's "highest" precision: no TF32).  drop1 and drop2 are the
// counter-hash dropouts of the JAX kernel (`keep` in common.cuh, salts
// `_SALT_FFN1` and `_SALT_FFN2`, one seed): drop1 over the global (row, ffn
// column) of the activation, drop2 over the global (row, column) of the
// finished sum + b2; a kept value is divided by the float32 1 - p.
//
// What bounds it on the H100: operations.  38.7 GFLOP at N=4096 (h = 768,
// ffn = 3072) is 0.577 ms at the CUDA cores' 67 TFLOP/s; x, the weights and
// the output (31 MB) take 0.009 ms.  The SIMT kernel of ffn.cu gave each
// thread 4 outputs of a 16-row tile, so every FMA needed a shared-memory
// load, and each of its 256 row tiles at N=4096 streamed all of W1 and W2
// (4.8 GB a launch) one scalar load at a time.
//
// Design: two launches of the register-blocked float32 GEMM of tiled.cuh
// (64 x 128 tiles, 8 x 8 a thread, 3-stage cp.async ring, the depth split
// over a cluster where the tiles alone leave the card short of blocks).
// The up pass is K1's kernel with another epilogue: the LayerNorm prologue,
// then + b1, act, drop1, stored as the float32 (N, ffn) intermediate in a
// scratch.  The down pass takes that scratch as its A (the raw prologue)
// with the epilogue of K2: + b2, drop2, + x, rounded once to x's dtype.
// The TPU kernel keeps the intermediate on chip; here a row tile's float32
// (64, 3072) activation would take 768 KB, and the scratch costs little: 50
// MB at N=4096 written and read (~0.03 ms at 3.35 TB/s, 5% of the bound),
// 6.3 MB at N=512, which stays in the 50 MB L2.  No atomics: a call
// repeats bit for bit.
#include <math.h>

#include "common.cuh"
#include "tiled.cuh"

namespace {

__device__ __forceinline__ float activate(float v, int act) {
  // act 0: exact gelu, jax.nn.gelu(approximate=False); act 1: relu
  return act == 0 ? 0.5f * v * (1.f + erff(v * 0.70710678118654752f))
                  : fmaxf(v, 0.f);
}

// h = drop1(act(LN(x) @ W1 + b1)) into the float32 (n, ffn) scratch.
// T: x's element type.
template <typename T, bool kDrop1>
__global__ void __launch_bounds__(ptt_tiled::kThreads, 3)
ffn_tiled_up_kernel(const T* x, const float* w1, const void* b1, int b1_bf16,
                    const void* g, int g_bf16, const void* beta,
                    int beta_bf16, float* hbuf, int n, int h, int ffn,
                    float eps, int act, ptt::Dropout drop1) {
  ptt_tiled::LayerNorm ln{g, g_bf16, beta, beta_bf16, eps};
  auto up = [&](int r, int c, float4 v) {
    float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = activate(s[j] + ptt::ld(b1, c + j, b1_bf16), act);
      if (kDrop1) s[j] = drop1(s[j], r, c + j);
    }
    *reinterpret_cast<float4*>(hbuf + static_cast<int64_t>(r) * ffn + c) =
        make_float4(s[0], s[1], s[2], s[3]);
  };
  ptt_tiled::gemm(x, w1, n, h, ffn, ln, up);
}

// out = x + drop2(h @ W2 + b2), in x's dtype.
template <bool kDrop2>
__global__ void __launch_bounds__(ptt_tiled::kThreads, 3)
ffn_tiled_down_kernel(const float* hbuf, const float* w2, const void* b2,
                      int b2_bf16, const void* x, int x_bf16, void* out,
                      int n, int ffn, int h, ptt::Dropout drop2) {
  ptt_tiled::Raw raw;
  const ptt_tiled::Residual<kDrop2> res{b2, b2_bf16, x, x_bf16, out, h,
                                        drop2};
  ptt_tiled::gemm(hbuf, w2, n, ffn, h, raw, res);
}

template <typename T>
cudaError_t up_pass(const T* x, const float* w1, const void* b1, int b1_bf16,
                    const void* g, int g_bf16, const void* beta,
                    int beta_bf16, float* hbuf, int n, int h, int ffn,
                    float eps, int act, int cluster,
                    const ptt::Dropout& drop1, void* stream) {
  const size_t smem = ptt_tiled::smem_bytes<ptt_tiled::LayerNorm>(h);
  auto kernel = drop1.p > 0.f ? ffn_tiled_up_kernel<T, true>
                              : ffn_tiled_up_kernel<T, false>;
  return ptt_tiled::launch(kernel, n, ffn, cluster, smem, stream, x, w1, b1,
                           b1_bf16, g, g_bf16, beta, beta_bf16, hbuf, n, h,
                           ffn, eps, act, drop1);
}

}  // namespace

// Dynamic shared memory a block of the up pass (pass 0: the LayerNorm
// prologue over h) or of the down pass (pass 1) takes.
PTT_EXPORT size_t ptt_ffn_tiled_smem(int h, int pass) {
  return pass == 0 ? ptt_tiled::smem_bytes<ptt_tiled::LayerNorm>(h)
                   : ptt_tiled::smem_bytes<ptt_tiled::Raw>(0);
}

// Two launches on `stream`: the up pass over (ffn / 128 tiles x cluster1,
// n / 64 tiles) blocks into `hbuf` (n, ffn) float32, then the down pass
// over (h / 128 x cluster2, n / 64).  x (n, h) float32 or bf16 with h a
// multiple of 8, W1 (h, ffn) and W2 (ffn, h) float32 with ffn a multiple
// of 4, x, W1, W2 and hbuf 16-byte aligned; out (n, h) in x's dtype.
// Dropout p > 0 takes the instantiation with it (one seed, salts salt1 /
// salt2, keep_div = 1 - p rounded to float32 on the host).
PTT_EXPORT int ptt_ffn_tiled(const void* x, int x_bf16, const float* w1,
                             const void* b1, int b1_bf16, const float* w2,
                             const void* b2, int b2_bf16, const void* g,
                             int g_bf16, const void* beta, int beta_bf16,
                             float* hbuf, void* out, int n, int h, int ffn,
                             float eps, int act, int cluster1, int cluster2,
                             unsigned seed, unsigned salt1, float p1,
                             float keep_div1, unsigned salt2, float p2,
                             float keep_div2, void* stream) {
  using ptt_tiled::aligned16;
  if (n <= 0 || h <= 0 || h % 8 || ffn <= 0 || ffn % 4 || cluster1 < 1 ||
      cluster1 > ptt_tiled::kMaxCluster || cluster2 < 1 ||
      cluster2 > ptt_tiled::kMaxCluster || !aligned16(x) || !aligned16(w1) ||
      !aligned16(w2) || !aligned16(hbuf))
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::Dropout drop1{seed, salt1, p1, keep_div1};
  const ptt::Dropout drop2{seed, salt2, p2, keep_div2};
  cudaError_t err =
      x_bf16 ? up_pass(static_cast<const __nv_bfloat16*>(x), w1, b1, b1_bf16,
                       g, g_bf16, beta, beta_bf16, hbuf, n, h, ffn, eps, act,
                       cluster1, drop1, stream)
             : up_pass(static_cast<const float*>(x), w1, b1, b1_bf16, g,
                       g_bf16, beta, beta_bf16, hbuf, n, h, ffn, eps, act,
                       cluster1, drop1, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto down = p2 > 0.f ? ffn_tiled_down_kernel<true>
                       : ffn_tiled_down_kernel<false>;
  err = ptt_tiled::launch(down, n, h, cluster2,
                          ptt_tiled::smem_bytes<ptt_tiled::Raw>(0), stream,
                          static_cast<const float*>(hbuf), w2, b2, b2_bf16, x,
                          x_bf16, out, n, ffn, h, drop2);
  return static_cast<int>(err);
}
