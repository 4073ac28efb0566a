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
// 51.5 GFLOP against 101 MB of input and output, so only the tensor cores
// come near the bound (989 TFLOP/s bf16 against 67 TFLOP/s float32 on the
// CUDA cores), and the exponentials (one per visible score) come next.
//
// bf16 design (flash_fwd_mma): one block of 4 warps per 64-row q tile of one
// (batch, head), each warp owning 16 rows; heaviest causal tiles launched
// first.  Q, K and V sit in shared memory as bf16 (flash_mma.cuh), staged by
// 16-byte cp.async into a two-stage ring, so the next K/V tile streams in
// while the current one is multiplied.  The warp keeps its Q fragments in
// registers, computes its 16 x 64 score tile S = Q K^T with
// mma.sync.m16n8k16 (bf16 products, exact in the float32 accumulator: the
// TPU's bf16 MXU pass with float32 sums), masks and rescales it in
// registers (max and sum over the four lanes of a quad), and feeds the
// probabilities, rounded to bf16 pairs, straight back as the A operand of
// P.V: P never touches shared memory.  Tiles wholly inside the causal
// triangle and inside sk skip the mask.  The exponentials are exp2 of
// scores scaled by scale * log2(e).  The TPU grid carried m, l and acc
// across its sequential kv axis; here the loop inside the block does, with
// no atomics.
//
// float32 design (flash_fwd_kernel, unchanged): the tensor cores have no
// exact float32 product, so float32 inputs keep the SIMT kernel: 64-row
// tiles in shared memory as float32, products as float32 FMAs on the CUDA
// cores.  The dtype alone picks the design.
//
// Rounding follows the TPU kernel in both: the score is scaled after the
// product, masked scores are -1e30, p is rounded to v's dtype before P.V, l
// sums the undropped p and is clamped at 1e-30.  A row that sees no key
// (sq > sk, causal) gives zeros and lse = -1e30.
#include "flash.cuh"
#include "flash_mma.cuh"

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

// bf16: the tensor-core kernel (see the note at the top).
template <int D>
__global__ void __launch_bounds__(mma::kThreads)
flash_fwd_mma(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
              const mma::bf16* __restrict__ v, mma::bf16* __restrict__ out,
              float* __restrict__ lse, int sq, int sk, float scale,
              int causal, float dropout_p, float keep_prob, uint32_t seed) {
  using namespace mma;
  constexpr int ld = D + 8;
  constexpr int kElems = kTile * ld;    // one (64, D) tile
  constexpr int kN8 = kTile / 8;        // n8 score tiles of a warp's rows
  extern __shared__ uint4 smem_fwd[];
  bf16* qs = reinterpret_cast<bf16*>(smem_fwd);
  bf16* kv = qs + kElems;               // stage s: K, then V, at 2 s kElems

  const int bh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  // the accumulator rows of this lane: (c0, c1) and (c2, c3)
  const int rows[2] = {row0 + 16 * warp + lane / 4,
                       row0 + 16 * warp + lane / 4 + 8};
  const int64_t qoff = static_cast<int64_t>(bh) * sq * D;
  const int64_t koff = static_cast<int64_t>(bh) * sk * D;
  const int tiles = kv_tiles(row0, sq, sk, causal);
  const float scale2 = scale * kLog2e;  // scores in log2 units

  load_tile_async<D, kTile>(q + qoff, row0, sq, qs);
  cp_commit();
  if (tiles > 0) {
    load_tile_async<D, kTile>(k + koff, 0, sk, kv);
    load_tile_async<D, kTile>(v + koff, 0, sk, kv + kElems);
  }
  cp_commit();

  float m[2] = {kNegInf, kNegInf};      // running row max (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's share of the row sum
  float acc[D / 8][4] = {};
  uint32_t qf[D / 16][4];

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {                // the next K/V tile streams in
      bf16* nxt = kv + ((t + 1) & 1) * 2 * kElems;
      load_tile_async<D, kTile>(k + koff, (t + 1) * kTile, sk, nxt);
      load_tile_async<D, kTile>(v + koff, (t + 1) * kTile, sk, nxt + kElems);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                    // tile t (and Q) are in
    if (t == 0) load_rows_a<D>(qf, qs + 16 * warp * ld);
    const bf16* ks = kv + (t & 1) * 2 * kElems;
    const bf16* vs = ks + kElems;

    float s[kN8][4] = {};
    gemm_nt<D, kN8>(s, qf, ks);

    const int col0 = t * kTile;
    // every (row, col) of the tile visible: inside sk and, when causal, on
    // or below the diagonal of the tile's first row
    const bool masked = col0 + kTile > sk ||
                        (causal && row0 + (sk - sq) < col0 + kTile - 1);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (masked && !visible(rows[e / 2], col0 + 8 * j + 2 * tq + (e & 1),
                               sq, sk, causal))
          x = -INFINITY;                // p = 0 below, whatever the max
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e / 2]);
        l[e / 2] += p;
        s[j][e] = p;
      }
    if (dropout_p > 0.f) {
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!keep(seed, bh, rows[e / 2], col0 + 8 * j + 2 * tq + (e & 1),
                    dropout_p))
            s[j][e] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < D / 8; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][e] *= alpha[e / 2];
    gemm_pv<D, kN8>(acc, s, vs);        // p rounded to bf16 as the A operand
    __syncthreads();                    // stage t & 1 may be refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = fmaxf(quad_sum(l[h]), 1e-30f);
    const int row = rows[h];
    if (row >= sq) continue;
    const float denom = l_safe * keep_prob;
    bf16* o = out + qoff + static_cast<int64_t>(row) * D + 2 * tq;
#pragma unroll
    for (int x = 0; x < D / 8; ++x)
      *reinterpret_cast<uint32_t*>(o + 8 * x) =
          pack_bf16(acc[x][2 * h] / denom, acc[x][2 * h + 1] / denom);
    if (tq == 0)
      lse[static_cast<int64_t>(bh) * sq + row] =
          m[h] == kNegInf ? kNegInf : m[h] * kLn2 + logf(l_safe);
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

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int bh, int sq, int sk, float scale, int causal,
               float dropout_p, float keep_prob, uint32_t seed,
               cudaStream_t stream) {
  using mma::bf16;
  constexpr size_t smem = 5 * kTile * (D + 8) * sizeof(bf16);  // Q, 2 x K/V
  if (!mma::aligned16(q) || !mma::aligned16(k) || !mma::aligned16(v) ||
      !mma::aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto kernel = flash_fwd_mma<D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kTile - 1) / kTile, bh);
  kernel<<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, sq, sk,
      scale, causal, dropout_p, keep_prob, seed);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(int d, const void* q, const void* k, const void* v,
                 void* out, float* lse, int bh, int sq, int sk, float scale,
                 int causal, float dropout_p, float keep_prob, uint32_t seed,
                 cudaStream_t s) {
  switch (d) {
    case 16: return launch_mma<16>(q, k, v, out, lse, bh, sq, sk, scale,
                                   causal, dropout_p, keep_prob, seed, s);
    case 32: return launch_mma<32>(q, k, v, out, lse, bh, sq, sk, scale,
                                   causal, dropout_p, keep_prob, seed, s);
    case 64: return launch_mma<64>(q, k, v, out, lse, bh, sq, sk, scale,
                                   causal, dropout_p, keep_prob, seed, s);
    case 128: return launch_mma<128>(q, k, v, out, lse, bh, sq, sk, scale,
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
  return bf16 ? dispatch_mma(d, q, k, v, out, lse, bh, sq, sk, scale, causal,
                             dropout_p, keep_prob, seed, s)
              : dispatch<float>(d, q, k, v, out, lse, bh, sq, sk, scale,
                                causal, dropout_p, keep_prob, seed, s);
}
