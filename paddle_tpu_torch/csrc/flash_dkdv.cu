// Flash-attention backward, dK and dV: the recompute half that walks the
// query rows seen by a tile of keys,
//   p_ij  = exp(s_ij - lse_i),  pd_ij = keep(i, j) p_ij / (1 - dropout),
//   dV_j += sum_i pd_ij dO_i,
//   ds_ij = (pd_ij (dO_i . v_j) - p_ij delta_i) * scale,
//   dK_j += sum_i ds_ij q_i,
// with delta_i = dO_i . out_i (computed by the caller) and the saved lse, so
// no probability tensor is stored between forward and backward.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_dkdv_kernel` (launched by
// `_flash_bwd`), the dK / dV of every decoder layer's attention in the
// training step with use_pallas_attention.
//
// What bounds it on the H100: operations.  Four (sq x sk x D) products over
// the causal half: at the training shape (B*H = 96, S = 2048, D = 64, bf16)
// 103 GFLOP against about 130 MB of inputs and outputs.
//
// Design: one block per 64-key tile of one (batch, head).  K and V stay in
// shared memory; the block walks every q tile that sees one of its keys
// (the causal skip of the TPU kernel), recomputes the (64, 64) scores and
// dP, writes pd and ds transposed into shared memory and accumulates dK and
// dV in float32 registers.  The TPU kernel accumulated into revisited output
// blocks along a sequential grid axis; here the loop inside the block does,
// so each dK / dV row is written once, with no atomics.  Rounding follows the
// TPU kernel: pd is rounded to dO's dtype for dV, ds to q's dtype for dK, and
// the float32 sums are rounded to the output dtype once at the end.
#include "flash.cuh"

namespace {

using namespace ptt_flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int sq, int sk, float scale,
                  int causal, float dropout_p, float keep_scale,
                  uint32_t seed) {
  constexpr int ld = D + 4;
  constexpr int kE = D / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* dos = qs + kTile * ld;
  float* pdt = dos + kTile * ld;          // pd transposed: [key][query]
  float* dst = pdt + kTile * kLdp;        // ds transposed
  float* lse_s = dst + kTile * kLdp;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t qoff = static_cast<int64_t>(bh) * sq * D;
  const int64_t koff = static_cast<int64_t>(bh) * sk * D;
  const int64_t soff = static_cast<int64_t>(bh) * sq;

  load_tile<T, D>(k + koff, col0, sk, ks);
  load_tile<T, D>(v + koff, col0, sk, vs);

  float dk_acc[4][kE] = {};
  float dv_acc[4][kE] = {};

  // first q tile with a row that sees key col0: (i + 1) * 64 - 1 + sk - sq
  // >= col0
  const int first = causal && col0 - (sk - sq) > 0
                        ? (col0 - (sk - sq)) / kTile : 0;
  const int q_tiles = (sq + kTile - 1) / kTile;
  for (int qt = first; qt < q_tiles; ++qt) {
    const int row0 = qt * kTile;
    __syncthreads();                      // the last tile's reads are done
    load_tile<T, D>(q + qoff, row0, sq, qs);
    load_tile<T, D>(dout + qoff, row0, sq, dos);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int row = row0 + i;
      lse_s[i] = row < sq ? lse[soff + row] : 0.f;
      delta_s[i] = row < sq ? delta[soff + row] : 0.f;
    }
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
        pdt[j * kLdp + i] = round_to<T>(pd);
        dst[j * kLdp + i] = round_to<T>(ds);
      }
    }
    __syncthreads();                      // pdt, dst are complete
    tile_acc<D>(pdt, dos, tx, ty, dv_acc);
    tile_acc<D>(dst, qs, tx, ty, dk_acc);
  }

  const int e0 = tx * kE;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int col = col0 + ty + 16 * r;
    if (col >= sk) continue;
    const int64_t o = koff + static_cast<int64_t>(col) * D + e0;
#pragma unroll
    for (int x = 0; x < kE; ++x) {
      dk[o + x] = from_f<T>(dk_acc[r][x]);
      dv[o + x] = from_f<T>(dv_acc[r][x]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int bh,
           int sq, int sk, float scale, int causal, float dropout_p,
           float keep_scale, uint32_t seed, cudaStream_t stream) {
  constexpr size_t smem =
      (4 * kTile * (D + 4) + 2 * kTile * kLdp + 2 * kTile) * sizeof(float);
  auto kernel = flash_dkdv_kernel<T, D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kTile - 1) / kTile, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, scale, causal,
      dropout_p, keep_scale, seed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             void* dk, void* dv, int bh, int sq, int sk, float scale,
             int causal, float dropout_p, float keep_scale, uint32_t seed,
             cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                  sk, scale, causal, dropout_p, keep_scale,
                                  seed, s);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                  sk, scale, causal, dropout_p, keep_scale,
                                  seed, s);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                  sk, scale, causal, dropout_p, keep_scale,
                                  seed, s);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh,
                                    sq, sk, scale, causal, dropout_p,
                                    keep_scale, seed, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

PTT_EXPORT int ptt_flash_dkdv(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv,
                              int bf16, int bh, int sq, int sk, int d,
                              float scale, int causal, float dropout_p,
                              float keep_scale, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dk, dv,
                                        bh, sq, sk, scale, causal, dropout_p,
                                        keep_scale, seed, s)
              : dispatch<float>(d, q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                sk, scale, causal, dropout_p, keep_scale,
                                seed, s);
}
