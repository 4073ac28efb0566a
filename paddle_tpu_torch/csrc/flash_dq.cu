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
// 77 GFLOP against about 105 MB of inputs and outputs, so only the tensor
// cores come near the bound (989 TFLOP/s bf16 against 67 TFLOP/s float32 on
// the CUDA cores), and the exponentials (one per visible score) come next.
//
// bf16 design (flash_dq_mma): the forward's structure with a second score
// product and no online softmax.  One block of 4 warps per 64-row q tile of
// one (batch, head), each warp owning 16 rows; heaviest causal tiles
// launched first.  Q and dO are staged once by cp.async and kept as
// register fragments; K and V stream through a two-stage cp.async ring of
// bf16 tiles (flash_mma.cuh), so the next tile arrives while the current
// one is multiplied.  S = Q K^T and dP = dO V^T come from mma.sync.m16n8k16
// (bf16 products, exact in the float32 accumulator); p, the dropout hash and
// ds are computed in registers at each accumulator element's global (row,
// column), with this lane's lse and delta for its two rows held in
// registers; ds, packed to bf16 pairs (the TPU kernel's ds.astype(k.dtype)),
// is the A operand of dQ += dS K straight from the accumulators, with K read
// as B by ldmatrix.trans from the tile already in shared memory: no ds tile
// in shared memory.  dQ stays in float32 registers and each row is written
// once at the end, so there are no atomics.  At D = 128 a step takes 32
// keys instead of 64 so that Q and dO fragments, the dQ accumulator and the
// two score tiles fit the registers without spills.  The TPU grid carried
// dQ across its sequential kv axis; here the loop inside the block does.
//
// float32 design (flash_dq_kernel, unchanged): the tensor cores have no
// exact float32 product, so float32 inputs keep the SIMT kernel: Q, dO and
// the K / V tiles in shared memory as float32, products as float32 FMAs,
// ds through a float32 tile in shared memory.  The dtype alone picks the
// design.
//
// Rounding follows the TPU kernel in both: masked scores give p = 0, ds is
// rounded to k's dtype before dS K, the float32 sum is rounded once to q's
// dtype.  A query row that sees no key writes zeros.
#include "flash.cuh"
#include "flash_mma.cuh"

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

// bf16: the tensor-core kernel (see the note at the top).
template <int D>
__global__ void __launch_bounds__(mma::kThreads)
flash_dq_mma(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
             const mma::bf16* __restrict__ v,
             const mma::bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             mma::bf16* __restrict__ dq, int sq, int sk, float scale,
             int causal, float dropout_p, float keep_scale, uint32_t seed) {
  using namespace mma;
  constexpr int ld = D + 8;
  constexpr int kBK = D > 64 ? 32 : 64;  // keys per step
  constexpr int kN8 = kBK / 8;           // n8 score tiles of a warp's rows
  constexpr int kQ = kTile * ld;         // one (64, D) q tile
  constexpr int kKV = kBK * ld;          // one (kBK, D) key tile
  extern __shared__ uint4 smem_dq[];
  bf16* qs = reinterpret_cast<bf16*>(smem_dq);
  bf16* dos = qs + kQ;
  bf16* kv = dos + kQ;                   // stage s: K, then V, at 2 s kKV

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
  const int64_t soff = static_cast<int64_t>(bh) * sq;
  const float scale2 = scale * kLog2e;   // scores in log2 units
  // the keys the tile's rows see end before `end`
  const int end = causal ? min(sk, row0 + kTile + (sk - sq)) : sk;
  const int tiles = end > 0 ? (end + kBK - 1) / kBK : 0;

  load_tile_async<D, kTile>(q + qoff, row0, sq, qs);
  load_tile_async<D, kTile>(dout + qoff, row0, sq, dos);
  cp_commit();
  if (tiles > 0) {
    load_tile_async<D, kBK>(k + koff, 0, sk, kv);
    load_tile_async<D, kBK>(v + koff, 0, sk, kv + kKV);
  }
  cp_commit();
  // lse (log2 units) and delta of this lane's two rows; rows past sq have
  // zero Q and dO, so their ds is 0 and they are not written
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = rows[h] < sq;
    lse2[h] = ok ? lse[soff + rows[h]] * kLog2e : 0.f;
    dlt[h] = ok ? delta[soff + rows[h]] : 0.f;
  }

  float acc[D / 8][4] = {};
  uint32_t qf[D / 16][4], dof[D / 16][4];
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {                // the next K/V tile streams in
      bf16* nxt = kv + ((t + 1) & 1) * 2 * kKV;
      load_tile_async<D, kBK>(k + koff, (t + 1) * kBK, sk, nxt);
      load_tile_async<D, kBK>(v + koff, (t + 1) * kBK, sk, nxt + kKV);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                    // tile t (and Q, dO) are in
    if (t == 0) {
      load_rows_a<D>(qf, qs + 16 * warp * ld);
      load_rows_a<D>(dof, dos + 16 * warp * ld);
    }
    const bf16* ks = kv + (t & 1) * 2 * kKV;
    const bf16* vs = ks + kKV;

    float s[kN8][4] = {};
    float dp[kN8][4] = {};
    gemm_nt<D, kN8>(s, qf, ks);         // S = Q K^T
    gemm_nt<D, kN8>(dp, dof, vs);       // dP = dO V^T

    const int col0 = t * kBK;
    // every (row, col) of the tile visible: inside sk and, when causal, on
    // or below the diagonal of the tile's first row
    const bool masked = col0 + kBK > sk ||
                        (causal && row0 + (sk - sq) < col0 + kBK - 1);
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e / 2];
        const int col = col0 + 8 * j + 2 * tq + (e & 1);
        const bool vis = !masked || visible(row, col, sq, sk, causal);
        const float p = vis ? exp2f(s[j][e] * scale2 - lse2[e / 2]) : 0.f;
        float pd = p;
        if (dropout_p > 0.f)
          pd = keep(seed, bh, row, col, dropout_p) ? p * keep_scale : 0.f;
        s[j][e] = (pd * dp[j][e] - p * dlt[e / 2]) * scale;  // ds
      }
    gemm_pv<D, kN8>(acc, s, ks);        // dQ += dS K, ds rounded to bf16
    __syncthreads();                    // stage t & 1 may be refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= sq) continue;
    bf16* o = dq + qoff + static_cast<int64_t>(row) * D + 2 * tq;
#pragma unroll
    for (int x = 0; x < D / 8; ++x)
      *reinterpret_cast<uint32_t*>(o + 8 * x) =
          pack_bf16(acc[x][2 * h], acc[x][2 * h + 1]);
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

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, int bh,
               int sq, int sk, float scale, int causal, float dropout_p,
               float keep_scale, uint32_t seed, cudaStream_t stream) {
  using mma::bf16;
  constexpr int kBK = D > 64 ? 32 : 64;
  // Q, dO; two stages of K, V
  constexpr size_t smem = (2 * kTile + 4 * kBK) * (D + 8) * sizeof(bf16);
  if (!mma::aligned16(q) || !mma::aligned16(k) || !mma::aligned16(v) ||
      !mma::aligned16(dout) || !mma::aligned16(dq))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto kernel = flash_dq_mma<D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kTile - 1) / kTile, bh);
  kernel<<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), sq, sk, scale, causal, dropout_p,
      keep_scale, seed);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(int d, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int bh, int sq, int sk, float scale, int causal,
                 float dropout_p, float keep_scale, uint32_t seed,
                 cudaStream_t s) {
  switch (d) {
    case 16: return launch_mma<16>(q, k, v, dout, lse, delta, dq, bh, sq,
                                   sk, scale, causal, dropout_p, keep_scale,
                                   seed, s);
    case 32: return launch_mma<32>(q, k, v, dout, lse, delta, dq, bh, sq,
                                   sk, scale, causal, dropout_p, keep_scale,
                                   seed, s);
    case 64: return launch_mma<64>(q, k, v, dout, lse, delta, dq, bh, sq,
                                   sk, scale, causal, dropout_p, keep_scale,
                                   seed, s);
    case 128: return launch_mma<128>(q, k, v, dout, lse, delta, dq, bh, sq,
                                     sk, scale, causal, dropout_p,
                                     keep_scale, seed, s);
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
  return bf16 ? dispatch_mma(d, q, k, v, dout, lse, delta, dq, bh, sq, sk,
                             scale, causal, dropout_p, keep_scale, seed, s)
              : dispatch<float>(d, q, k, v, dout, lse, delta, dq, bh, sq, sk,
                                scale, causal, dropout_p, keep_scale, seed,
                                s);
}
