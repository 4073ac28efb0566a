// Flash-attention forward: for each (batch, head) and query row i,
//   out[i] = sum_j keep(i, j) p_ij v_j / (l_i (1 - dropout)),
//   p_ij = exp(s_ij - m_i), s_ij = (q_i . k_j) * scale, l_i = sum_j p_ij,
//   lse[i] = m_i + log(l_i),
// over the keys j visible to row i (below sk; when causal, j <= i + sk - sq,
// the bottom-right alignment), without materialising the (sq, sk) scores.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_fwd_kernel` (launched by
// `_flash_fwd`), the attention forward of every decoder layer of the training
// step with use_pallas_attention.
//
// What bounds it on the H100: operations.  Two (sq x sk x D) products over
// the causal half; at the training shape (B*H = 96, S = 2048, D = 64, bf16)
// 51.5 GFLOP against 101 MB of input and output.
//
// Design: one block per 64-row q tile of one (batch, head), heaviest causal
// tiles launched first; it keeps Q in shared memory and walks the kv tiles
// it can see, holding the online-softmax state (m, l and the float32 output
// accumulator) in registers.  The TPU grid carried m, l and acc across its
// sequential kv axis; here the loop inside the block does.  The products
// run on the CUDA cores in float32 (exact products of bf16 inputs, float32
// sums, as the TPU's bf16 MXU pass with float32 accumulation); tensor cores
// (mma / wgmma), TMA and a tile pipeline are later work.  Rounding follows
// the TPU kernel: the score is scaled after the product, masked with -1e30,
// p is rounded to v's dtype before P.V, l sums the undropped p and is
// clamped at 1e-30.  A row that sees no key (sq > sk, causal) gives zeros
// and lse = -1e30.
#include "flash.cuh"

namespace {

using namespace ptt_flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, float scale,
                 int causal, float dropout_p, float keep_prob,
                 uint32_t seed) {
  constexpr int ld = D + 4;
  constexpr int kE = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile * ld;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;            // (64, 64) probabilities

  const int bh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t qoff = static_cast<int64_t>(bh) * sq * D;
  const int64_t koff = static_cast<int64_t>(bh) * sk * D;

  load_tile<T, D>(q + qoff, row0, sq, qs);

  float m[4], l[4], acc[4][kE];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int x = 0; x < kE; ++x) acc[r][x] = 0.f;
  }

  const int tiles = kv_tiles(row0, sq, sk, causal);
  for (int t = 0; t < tiles; ++t) {
    const int col0 = t * kTile;
    __syncthreads();                      // the last tile's reads are done
    load_tile<T, D>(k + koff, col0, sk, ks);
    load_tile<T, D>(v + koff, col0, sk, vs);
    __syncthreads();

    float s[4][4] = {};
    tile_dot<D>(qs, ks, tx, ty, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + tx + 16 * c;
        s[r][c] = visible(row, col, sq, sk, causal) ? s[r][c] * scale
                                                    : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + tx + 16 * c;
        float p = visible(row, col, sq, sk, causal) ? expf(s[r][c] - m_new)
                                                    : 0.f;
        psum += p;
        if (dropout_p > 0.f && !keep(seed, bh, row, col, dropout_p)) p = 0.f;
        ps[(ty + 16 * r) * kLdp + tx + 16 * c] = round_to<T>(p);
      }
      l[r] = alpha * l[r] + row_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int x = 0; x < kE; ++x) acc[r][x] *= alpha;
    }
    __syncthreads();                      // ps is complete
    tile_acc<D>(ps, vs, tx, ty, acc);
  }

  const int e0 = tx * kE;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty + 16 * r;
    if (row >= sq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    const float denom = l_safe * keep_prob;
    T* o = out + qoff + static_cast<int64_t>(row) * D + e0;
#pragma unroll
    for (int x = 0; x < kE; ++x) o[x] = from_f<T>(acc[r][x] / denom);
    if (tx == 0)
      lse[static_cast<int64_t>(bh) * sq + row] = m[r] + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int bh, int sq, int sk, float scale, int causal,
           float dropout_p, float keep_prob, uint32_t seed,
           cudaStream_t stream) {
  constexpr size_t smem = (3 * kTile * (D + 4) + kTile * kLdp) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kTile - 1) / kTile, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, scale,
      causal, dropout_p, keep_prob, seed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out,
             float* lse, int bh, int sq, int sk, float scale, int causal,
             float dropout_p, float keep_prob, uint32_t seed,
             cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, bh, sq, sk, scale,
                                  causal, dropout_p, keep_prob, seed, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, bh, sq, sk, scale,
                                  causal, dropout_p, keep_prob, seed, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, bh, sq, sk, scale,
                                  causal, dropout_p, keep_prob, seed, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, bh, sq, sk, scale,
                                    causal, dropout_p, keep_prob, seed, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

PTT_EXPORT int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, int bf16, int bh, int sq,
                             int sk, int d, float scale, int causal,
                             float dropout_p, float keep_prob, unsigned seed,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, out, lse, bh, sq, sk,
                                        scale, causal, dropout_p, keep_prob,
                                        seed, s)
              : dispatch<float>(d, q, k, v, out, lse, bh, sq, sk, scale,
                                causal, dropout_p, keep_prob, seed, s);
}
