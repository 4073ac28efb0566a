// K1 on the tensor cores, for bf16 W: fused pre-LayerNorm + GEMM + bias,
//   out = bf16(bf16(LN_f32(x) * g + beta) @ W + b),
// the bias added in float32 and the sum rounded once to W's dtype.
//
// Replaces: paddle_tpu/ops/fused_block.py `_ln_linear_kernel` (launched by
// `_ln_linear_pallas`) where W is bf16: the LN -> QKV projection of the
// fused training step under O1, whose `fused_ln_linear` casts W to bf16.
// The TPU kernel rounds LN(x) to W's dtype in its scratch and contracts
// with float32 sums; a bf16 x bf16 product is exact in float32, so
// mma.sync.m16n8k16 with float32 accumulators computes the same function,
// with the sums in another order.  Float32 weights (serving, generate) keep
// the SIMT kernel of ln_linear.cu; the wrapper picks the kernel from dtypes,
// shapes and addresses (ops/fused_block.py `ln_linear_route`).
//
// What bounds it on the H100: operations.  At the training shape (N = 16384
// rows, h = 768, 2304 columns) the product is 58.0 GFLOP, 0.059 ms at the
// 989 TFLOP/s bf16 peak, against 25-50 MB of x, 3.5 MB of W and 75 MB of
// out (0.031-0.039 ms at 3.35 TB/s).
//
// Design: a block owns a 64-row tile.  It computes LN(x) of those rows once
// (ln_tile, gemm_mma.cuh) into shared memory as bf16, 64 x (h + 8), as the
// TPU kernel fills its scratch at the first column block, and then walks
// the column tiles of 256 dealt to it, streaming W through a four-stage
// ring of 16-byte cp.async copies (32 h-rows x 256 columns a stage).  Its 8
// warps are 2 x 4 warp tiles of 32 rows x 64 columns (64 accumulator floats
// a thread): per 16-deep step a warp issues 2 ldmatrix.x4 for A, 4 for B
// and 16 mma, so shared memory feeds the tensor cores at 0.375 ldmatrix an
// mma (a 32-column warp tile would take 0.5).  The epilogue adds b in
// float32, rounds to bf16 into a staging tile in shared memory and stores
// it in 16-byte chunks, a warp on 512 contiguous bytes of a row.  Shared
// memory a block at h = 768: 99,328 bytes of LN(x), 67,584 of ring, 33,792
// of staging: one block per SM.  Registers a thread at h = 768 (ptxas,
// sm_90a): 156, no spills; chip_smoke.py fails on any spill at h = 768.
// At the training shape it runs at 18% of the bf16 peak (PERF.md).
//
// The column tiles of a row tile are dealt round-robin to `splits` blocks
// (grid y), chosen on the host so that the blocks fill the SMs in whole
// waves (`_mma_splits` in ops/fused_block.py): 1 at N = 16384 (256 blocks,
// each all 9 column tiles), more for few rows; each recomputes the LN of
// its tile.  Every 64-row tile reads all of W from L2: 256 x 3.5 MB = 0.9 GB
// a launch at N = 16384.
//
// Ragged edges: rows at or past n are zero in LN(x) and never stored;
// columns at or past cols (a multiple of 8, so a 16-byte chunk is in or
// out whole) are zero-filled by cp.async and never stored.  No atomics:
// two launches give the same bits.
#include "common.cuh"
#include "flash_mma.cuh"
#include "gemm_mma.cuh"

namespace {

using ptt_flash::mma::bf16;
using ptt_flash::mma::cp_commit;
using ptt_flash::mma::cp_wait;
using ptt_flash::mma::pack_bf16;

constexpr int kBM = 64;                 // rows of a block's tile
constexpr int kBN = 256;                // columns of a column tile
constexpr int kBK = 32;                 // h rows of a ring stage
constexpr int kStages = 4;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWN = 4;                  // warps across the columns
constexpr int kMI = kBM / (kWarps / kWN) / 16;   // m16 tiles of a warp: 2
constexpr int kNJ = kBN / kWN / 8;               // n8 tiles of a warp: 8
constexpr int kLdB = kBN + 8;           // strides (bf16 elements)
constexpr int kStage = kBK * kLdB;

template <int H>
struct Shape {
  static_assert(H % kBK == 0 && H % 32 == 0, "whole stages and LN lanes");
  static constexpr int kLdLn = H + 8;
  static constexpr int kChunks = H / kBK;       // ring stages a column tile
  static constexpr size_t kSmem =
      sizeof(bf16) * (static_cast<size_t>(kBM) * kLdLn + kStages * kStage +
                      kBM * kLdB);
};

// grid (row tiles, splits); blockIdx.y takes column tiles y, y + splits, ...
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
ln_linear_mma_kernel(const void* __restrict__ x, int x_bf16,
                     const bf16* __restrict__ w, const void* __restrict__ b,
                     int b_bf16, const void* __restrict__ g, int g_bf16,
                     const void* __restrict__ beta, int beta_bf16,
                     bf16* __restrict__ out, int n, int cols, float eps) {
  using S = Shape<H>;
  extern __shared__ uint4 smem_ln_linear_mma[];
  bf16* lnx = reinterpret_cast<bf16*>(smem_ln_linear_mma);   // kBM x kLdLn
  bf16* ring = lnx + kBM * S::kLdLn;                          // kStages
  bf16* ostage = ring + kStages * kStage;                     // kBM x kLdB
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int tiles = (cols + kBN - 1) / kBN;
  const int chunks = (tiles - split + splits - 1) / splits * S::kChunks;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / kWN;              // rows 32 wm .. 32 wm + 31
  const int wn = warp % kWN;              // columns 64 wn .. 64 wn + 63
  const int gq = lane / 4;
  const int tq = lane % 4;

  // ring stage q: h rows k0 .. k0 + 31 of column tile q / kChunks of this
  // block
  auto issue = [&](int q) {
    const int col0 = (split + (q / S::kChunks) * splits) * kBN;
    const int k0 = (q % S::kChunks) * kBK;
    ptt_gemm::stage_tile<kBK, kBN, kThreads>(
        ring + (q % kStages) * kStage,
        w + static_cast<int64_t>(k0) * cols + col0, cols, kBK, cols - col0);
  };

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < chunks) issue(q);
    cp_commit();
  }
  ptt_gemm::ln_tile<H, kBM, kWarps>(x, x_bf16, row0, n, g, g_bf16, beta,
                                    beta_bf16, eps, lnx);

  float acc[kMI][kNJ][4];
  for (int q = 0; q < chunks; ++q) {
    cp_wait<kStages - 2>();               // stage q is in (for this thread)
    __syncthreads();                      // ... for all; q - 1 is consumed
    if (q + kStages - 1 < chunks) issue(q + kStages - 1);
    cp_commit();
    const int c = q % S::kChunks;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    ptt_gemm::warp_mma<kMI, kNJ, kBK / 16, S::kLdLn, kLdB>(
        acc, lnx + 16 * kMI * wm * S::kLdLn, c * kBK,
        ring + (q % kStages) * kStage, 8 * kNJ * wn);
    if (c != S::kChunks - 1) continue;

    // the column tile is summed: + b in float32, one rounding to bf16 into
    // the staging tile, then 16-byte stores of the rows and columns in range
    const int col0 = (split + (q / S::kChunks) * splits) * kBN;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int col = 8 * kNJ * wn + 8 * j + 2 * tq;
      const bool ok = col0 + col < cols;  // and col + 1: cols % 8 == 0
      const float b0 = ok ? ptt::ld(b, col0 + col, b_bf16) : 0.f;
      const float b1 = ok ? ptt::ld(b, col0 + col + 1, b_bf16) : 0.f;
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * kMI * wm + 16 * i + gq + 8 * hh;
          *reinterpret_cast<uint32_t*>(ostage + r * kLdB + col) = pack_bf16(
              acc[i][j][2 * hh] + b0, acc[i][j][2 * hh + 1] + b1);
        }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kBM * kBN / 8 / kThreads; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / (kBN / 8);
      const int cc = (i % (kBN / 8)) * 8;
      const int64_t row = row0 + r;
      if (row < n && col0 + cc < cols)
        *reinterpret_cast<uint4*>(out + row * cols + col0 + cc) =
            *reinterpret_cast<const uint4*>(ostage + r * kLdB + cc);
    }
    // the staging tile is written again only after the next column tile's
    // kChunks >= 1 barriers at the top of the loop
  }
  cp_wait<0>();
}

template <int H>
cudaError_t launch(const void* x, int x_bf16, const bf16* w, const void* b,
                   int b_bf16, const void* g, int g_bf16, const void* beta,
                   int beta_bf16, bf16* out, int n, int cols, float eps,
                   int splits, cudaStream_t s) {
  auto kernel = ln_linear_mma_kernel<H>;
  cudaError_t err = ptt::allow_smem(kernel, Shape<H>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBM - 1) / kBM, splits);
  kernel<<<grid, kThreads, Shape<H>::kSmem, s>>>(x, x_bf16, w, b, b_bf16, g,
                                                 g_bf16, beta, beta_bf16, out,
                                                 n, cols, eps);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a block takes at hidden size h (0: no
// instantiation; ops/fused_block.py _MMA_HIDDEN).
PTT_EXPORT size_t ptt_ln_linear_mma_smem(int h) {
  switch (h) {
    case 128: return Shape<128>::kSmem;
    case 768: return Shape<768>::kSmem;
    default: return 0;
  }
}

// x (n, h) float32 or bf16 by its code; w (h, cols) bf16 and out (n, cols)
// bf16, both 16-byte aligned, cols a multiple of 8; b, g, beta float32 or
// bf16 by their codes.  The column tiles of 256 of each 64-row tile are
// dealt to `splits` blocks (1 .. their number).
PTT_EXPORT int ptt_ln_linear_mma(const void* x, int x_bf16, const void* w,
                                 const void* b, int b_bf16, const void* g,
                                 int g_bf16, const void* beta, int beta_bf16,
                                 void* out, int n, int h, int cols, float eps,
                                 int splits, void* stream) {
  const int tiles = (cols + kBN - 1) / kBN;
  if (n <= 0 || cols <= 0 || cols % 8 != 0 || splits < 1 || splits > tiles ||
      ptt_ln_linear_mma_smem(h) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!ptt_flash::mma::aligned16(w) || !ptt_flash::mma::aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* o = static_cast<bf16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 128:
      return static_cast<int>(launch<128>(x, x_bf16, wb, b, b_bf16, g, g_bf16,
                                          beta, beta_bf16, o, n, cols, eps,
                                          splits, s));
    case 768:
      return static_cast<int>(launch<768>(x, x_bf16, wb, b, b_bf16, g, g_bf16,
                                          beta, beta_bf16, o, n, cols, eps,
                                          splits, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
