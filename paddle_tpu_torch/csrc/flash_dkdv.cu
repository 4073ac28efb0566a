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
// 103 GFLOP against about 130 MB of inputs and outputs, so only the tensor
// cores come near the bound.
//
// bf16 design (flash_dkdv_mma): one block of 4 warps per 64-key tile of one
// (batch, head), each warp owning 16 keys; K and V stay in shared memory as
// bf16, and the block walks every q tile that sees one of its keys (the
// causal skip of the TPU kernel), with the next tile's Q, dO, lse and delta
// streaming in by cp.async into a two-stage ring while the current one is
// multiplied.  Each warp computes S^T = K Q^T and dP^T = V dO^T directly
// with mma.sync.m16n8k16 (bf16 products, float32 sums), so P^T, pd^T and
// dS^T come out in the accumulator layout, keys as rows; packed to bf16
// pairs they are the A operands of dV += pd^T dO and dK += dS^T Q straight
// from registers (dO and Q as B through ldmatrix.trans), with no transposed
// copy in shared memory.  The dropout keep bits of a tile sit in one 32-bit
// mask between the two halves.  dK and dV stay in float32 registers and
// each row is written once at the end, so there are no atomics.  At D = 128
// a step takes 32 q rows instead of 64 to keep the registers clear of
// spills.  The TPU kernel accumulated into revisited output blocks along a
// sequential grid axis; here the loop inside the block does.
//
// float32 design (flash_dkdv_kernel, unchanged): the tensor cores have no
// exact float32 product, so float32 inputs keep the SIMT kernel; the dtype
// alone picks the design.
//
// Rounding follows the TPU kernel in both: pd is rounded to dO's dtype for
// dV, ds to q's dtype for dK, and the float32 sums are rounded to the
// output dtype once at the end.
#include "flash.cuh"
#include "flash_mma.cuh"

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

// bf16: the tensor-core kernel (see the note at the top).
template <int D>
__global__ void __launch_bounds__(mma::kThreads)
flash_dkdv_mma(const mma::bf16* __restrict__ q,
               const mma::bf16* __restrict__ k,
               const mma::bf16* __restrict__ v,
               const mma::bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, mma::bf16* __restrict__ dk,
               mma::bf16* __restrict__ dv, int sq, int sk, float scale,
               int causal, float dropout_p, float keep_scale,
               uint32_t seed) {
  using namespace mma;
  constexpr int ld = D + 8;
  constexpr int kBQ = D > 64 ? 32 : 64;  // q rows per step
  constexpr int kN8 = kBQ / 8;           // n8 tiles of a warp's rows
  constexpr int kKV = kTile * ld;        // one (64, D) key tile
  constexpr int kQ = kBQ * ld;           // one (kBQ, D) q tile
  extern __shared__ uint4 smem_bwd[];
  bf16* ks = reinterpret_cast<bf16*>(smem_bwd);
  bf16* vs = ks + kKV;
  bf16* qd = vs + kKV;                   // stage s: Q, then dO, at 2 s kQ
  float* stats = reinterpret_cast<float*>(qd + 4 * kQ);  // lse, delta

  const int bh = blockIdx.y;
  const int col0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  // the accumulator rows (keys) of this lane: (c0, c1) and (c2, c3)
  const int keys[2] = {col0 + 16 * warp + lane / 4,
                       col0 + 16 * warp + lane / 4 + 8};
  const int64_t qoff = static_cast<int64_t>(bh) * sq * D;
  const int64_t koff = static_cast<int64_t>(bh) * sk * D;
  const int64_t soff = static_cast<int64_t>(bh) * sq;
  const float scale2 = scale * kLog2e;

  auto stage_q = [&](int qt, int stage) {
    bf16* dst = qd + 2 * stage * kQ;
    float* st = stats + 2 * stage * kBQ;
    load_tile_async<D, kBQ>(q + qoff, qt * kBQ, sq, dst);
    load_tile_async<D, kBQ>(dout + qoff, qt * kBQ, sq, dst + kQ);
    load_stats_async<kBQ>(lse + soff, qt * kBQ, sq, st);
    load_stats_async<kBQ>(delta + soff, qt * kBQ, sq, st + kBQ);
  };

  // first q tile with a row that sees key col0: row + sk - sq >= col0
  const int first = causal && col0 - (sk - sq) > 0
                        ? (col0 - (sk - sq)) / kBQ : 0;
  const int q_tiles = (sq + kBQ - 1) / kBQ;
  load_tile_async<D, kTile>(k + koff, col0, sk, ks);
  load_tile_async<D, kTile>(v + koff, col0, sk, vs);
  if (first < q_tiles) stage_q(first, 0);
  cp_commit();

  float dk_acc[D / 8][4] = {};
  float dv_acc[D / 8][4] = {};
  for (int qt = first; qt < q_tiles; ++qt) {
    const int stage = (qt - first) & 1;
    if (qt + 1 < q_tiles) {             // the next q tile streams in
      stage_q(qt + 1, stage ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                    // tile qt (and K, V) are in
    const bf16* qs = qd + 2 * stage * kQ;
    const bf16* dos = qs + kQ;
    const float* lse_s = stats + 2 * stage * kBQ;
    const float* delta_s = lse_s + kBQ;
    const int row0 = qt * kBQ;
    const bool masked = row0 + kBQ > sq || col0 + kTile > sk ||
                        (causal && row0 + (sk - sq) < col0 + kTile - 1);

    // P^T = exp(S^T * scale - lse), S^T = K Q^T: keys as rows, the q tile's
    // rows as columns
    float p[kN8][4] = {};
    {
      uint32_t kf[D / 16][4];
      load_rows_a<D>(kf, ks + 16 * warp * ld);
      gemm_nt<D, kN8>(p, kf, qs);
    }
    uint32_t dropped = 0;               // bit 4 j + e: pd[j][e] = 0
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * j + 2 * tq + (e & 1);
        const bool vis = !masked || visible(row0 + i, keys[e / 2], sq, sk,
                                            causal);
        p[j][e] = vis ? exp2f(p[j][e] * scale2 - lse_s[i] * kLog2e) : 0.f;
        if (dropout_p > 0.f &&
            !keep(seed, bh, row0 + i, keys[e / 2], dropout_p))
          dropped |= 1u << (4 * j + e);
      }

    // dV += pd^T dO, pd rounded to bf16 as the A operand
    {
      float pd[kN8][4];
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pd[j][e] = (dropped >> (4 * j + e)) & 1u ? 0.f
                                                    : p[j][e] * keep_scale;
      gemm_pv<D, kN8>(dv_acc, pd, dos);
    }

    // dS^T = (pd^T * dP^T - P^T * delta) * scale, dP^T = V dO^T
    float ds[kN8][4] = {};
    {
      uint32_t vf[D / 16][4];
      load_rows_a<D>(vf, vs + 16 * warp * ld);
      gemm_nt<D, kN8>(ds, vf, dos);
    }
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * j + 2 * tq + (e & 1);
        const float pd = (dropped >> (4 * j + e)) & 1u ? 0.f
                                                        : p[j][e] * keep_scale;
        ds[j][e] = (pd * ds[j][e] - p[j][e] * delta_s[i]) * scale;
      }
    // dK += dS^T Q, ds rounded to bf16 as the A operand
    gemm_pv<D, kN8>(dk_acc, ds, qs);
    __syncthreads();                    // stage may be refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = keys[h];
    if (key >= sk) continue;
    const int64_t o = koff + static_cast<int64_t>(key) * D + 2 * tq;
#pragma unroll
    for (int x = 0; x < D / 8; ++x) {
      *reinterpret_cast<uint32_t*>(dk + o + 8 * x) =
          pack_bf16(dk_acc[x][2 * h], dk_acc[x][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + o + 8 * x) =
          pack_bf16(dv_acc[x][2 * h], dv_acc[x][2 * h + 1]);
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

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int sq, int sk, float scale, int causal,
               float dropout_p, float keep_scale, uint32_t seed,
               cudaStream_t stream) {
  using mma::bf16;
  constexpr int kBQ = D > 64 ? 32 : 64;
  // K, V; two stages of Q, dO, lse, delta
  constexpr size_t smem = (2 * kTile + 4 * kBQ) * (D + 8) * sizeof(bf16) +
                          4 * kBQ * sizeof(float);
  if (!mma::aligned16(q) || !mma::aligned16(k) || !mma::aligned16(v) ||
      !mma::aligned16(dout) || !mma::aligned16(dk) || !mma::aligned16(dv))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto kernel = flash_dkdv_mma<D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kTile - 1) / kTile, bh);
  kernel<<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, scale,
      causal, dropout_p, keep_scale, seed);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(int d, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int bh, int sq, int sk, float scale,
                 int causal, float dropout_p, float keep_scale,
                 uint32_t seed, cudaStream_t s) {
  switch (d) {
    case 16: return launch_mma<16>(q, k, v, dout, lse, delta, dk, dv, bh,
                                   sq, sk, scale, causal, dropout_p,
                                   keep_scale, seed, s);
    case 32: return launch_mma<32>(q, k, v, dout, lse, delta, dk, dv, bh,
                                   sq, sk, scale, causal, dropout_p,
                                   keep_scale, seed, s);
    case 64: return launch_mma<64>(q, k, v, dout, lse, delta, dk, dv, bh,
                                   sq, sk, scale, causal, dropout_p,
                                   keep_scale, seed, s);
    case 128: return launch_mma<128>(q, k, v, dout, lse, delta, dk, dv, bh,
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
  return bf16 ? dispatch_mma(d, q, k, v, dout, lse, delta, dk, dv, bh, sq,
                             sk, scale, causal, dropout_p, keep_scale, seed,
                             s)
              : dispatch<float>(d, q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                sk, scale, causal, dropout_p, keep_scale,
                                seed, s);
}
