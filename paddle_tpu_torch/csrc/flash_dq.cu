// Flash-attention backward, dQ: the recompute half that walks the keys seen
// by a tile of query rows,
//   p_ij  = exp(s_ij - lse_i),  pd_ij = keep(i, j) p_ij / (1 - dropout),
//   ds_ij = (pd_ij (dO_i . v_j) - p_ij delta_i) * scale,
//   dQ_i += sum_j ds_ij k_j.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_dq_kernel` (launched by
// `_flash_bwd`), the dQ of every decoder layer's attention in the training
// step with use_pallas_attention.
//
// What bounds it on the H100: operations.  Three (sq x sk x D) products over
// the causal half: at the training shape (B*H = 96, S = 2048, D = 64, bf16)
// 77 GFLOP against about 105 MB of inputs and outputs.
//
// Design: one block per 64-row q tile of one (batch, head), heaviest causal
// tiles first, mirroring the forward: Q, dO, lse and delta stay in shared
// memory; the block walks the kv tiles its rows can see, recomputes the
// scores and dP, writes ds (rounded to k's dtype, as the TPU kernel does)
// into shared memory and accumulates dQ in float32 registers, written once
// at the end in q's dtype.
#include "flash.cuh"

namespace {

using namespace ptt_flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int sq,
                int sk, float scale, int causal, float dropout_p,
                float keep_scale, uint32_t seed) {
  constexpr int ld = D + 4;
  constexpr int kE = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* dss = vs + kTile * ld;           // ds: [query][key]
  float* lse_s = dss + kTile * kLdp;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t qoff = static_cast<int64_t>(bh) * sq * D;
  const int64_t koff = static_cast<int64_t>(bh) * sk * D;
  const int64_t soff = static_cast<int64_t>(bh) * sq;

  load_tile<T, D>(q + qoff, row0, sq, qs);
  load_tile<T, D>(dout + qoff, row0, sq, dos);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int row = row0 + i;
    lse_s[i] = row < sq ? lse[soff + row] : 0.f;
    delta_s[i] = row < sq ? delta[soff + row] : 0.f;
  }

  float dq_acc[4][kE] = {};
  const int tiles = kv_tiles(row0, sq, sk, causal);
  for (int t = 0; t < tiles; ++t) {
    const int col0 = t * kTile;
    __syncthreads();                      // the last tile's reads are done
    load_tile<T, D>(k + koff, col0, sk, ks);
    load_tile<T, D>(v + koff, col0, sk, vs);
    __syncthreads();

    float s[4][4] = {};
    float dp[4][4] = {};
    tile_dot<D>(qs, ks, tx, ty, s);
    tile_dot<D>(dos, vs, tx, ty, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const int row = row0 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const int col = col0 + j;
        const float p = visible(row, col, sq, sk, causal)
                            ? expf(s[r][c] * scale - lse_s[i]) : 0.f;
        float pd = p;
        if (dropout_p > 0.f)
          pd = keep(seed, bh, row, col, dropout_p) ? p * keep_scale : 0.f;
        const float ds = (pd * dp[r][c] - p * delta_s[i]) * scale;
        dss[i * kLdp + j] = round_to<T>(ds);
      }
    }
    __syncthreads();                      // dss is complete
    tile_acc<D>(dss, ks, tx, ty, dq_acc);
  }

  const int e0 = tx * kE;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty + 16 * r;
    if (row >= sq) continue;
    T* o = dq + qoff + static_cast<int64_t>(row) * D + e0;
#pragma unroll
    for (int x = 0; x < kE; ++x) o[x] = from_f<T>(dq_acc[r][x]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int bh, int sq,
           int sk, float scale, int causal, float dropout_p, float keep_scale,
           uint32_t seed, cudaStream_t stream) {
  constexpr size_t smem =
      (4 * kTile * (D + 4) + kTile * kLdp + 2 * kTile) * sizeof(float);
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kTile - 1) / kTile, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), sq, sk, scale, causal, dropout_p, keep_scale,
      seed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             void* dq, int bh, int sq, int sk, float scale, int causal,
             float dropout_p, float keep_scale, uint32_t seed,
             cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                                  scale, causal, dropout_p, keep_scale, seed,
                                  s);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                                  scale, causal, dropout_p, keep_scale, seed,
                                  s);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                                  scale, causal, dropout_p, keep_scale, seed,
                                  s);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dq, bh, sq,
                                    sk, scale, causal, dropout_p, keep_scale,
                                    seed, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

PTT_EXPORT int ptt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int bf16, int bh,
                            int sq, int sk, int d, float scale, int causal,
                            float dropout_p, float keep_scale, unsigned seed,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dq, bh,
                                        sq, sk, scale, causal, dropout_p,
                                        keep_scale, seed, s)
              : dispatch<float>(d, q, k, v, dout, lse, delta, dq, bh, sq, sk,
                                scale, causal, dropout_p, keep_scale, seed,
                                s);
}
