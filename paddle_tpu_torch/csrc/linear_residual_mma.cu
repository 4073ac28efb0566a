// K2 on the tensor cores, for bf16 x and W: GEMM with a dropout + residual
// epilogue,
//   out = r + drop(x @ W + b),
// summed in float32 and rounded once to r's dtype.
//
// Replaces: paddle_tpu/ops/fused_block.py `_linear_residual_kernel`
// (launched by `_linear_residual_pallas`) where x and W are bf16: the
// attention out-projection plus residual add of the fused training step
// under O1, whose `fused_linear_residual` casts both to bf16.  The TPU
// kernel contracts the bf16 operands with float32 sums; a bf16 x bf16
// product is exact in float32, so mma.sync.m16n8k16 with float32
// accumulators computes the same function, with the sums in another order.
// drop is the counter-hash dropout of the JAX kernel (`ptt::Dropout`,
// common.cuh) over the global (row, col) of the (n, cols) output, salted by
// the caller (`_SALT_RESID`), applied to the float32 x @ W + b before the
// residual: the same dropped elements.  It is a template argument, so
// the p = 0 instantiation holds no hash.  Float32 operands keep the SIMT
// kernel of linear_residual.cu (serving, generate); the wrapper picks the
// kernel on the host (ops/fused_block.py `linear_residual_route`).
//
// What bounds it on the H100: bytes.  At the training shape (N = 16384,
// 768 x 768, bf16 r) it reads 25 MB of x, 25 MB of r and 1.2 MB of W and
// writes 25 MB, 0.023 ms at 3.35 TB/s, against 19.3 GFLOP, 0.020 ms at the
// 989 TFLOP/s bf16 peak.
//
// Design: a tiled GEMM, one 128 x 128 output tile a block (768 tiles at the
// training shape), both operands streamed through a three-stage ring of
// 16-byte cp.async copies (128 rows x 64 of x and 64 x 128 of W a stage);
// the 8 warps are 4 x 2 warp tiles of 32 rows x 64 columns (64 accumulator
// floats a thread, within the 128 registers of two blocks an SM).  Blocks
// of one row tile are adjacent in the grid, so x is read from device memory
// about once and from L2 by the other column tiles.  The epilogue adds b,
// drops and adds r in float32 in the accumulators' layout, parks the sums
// in shared memory (the drained ring) and stores them, rounded once to r's
// dtype, in 16-byte (float32) or 8-byte (bf16) chunks along the rows.
// Shared memory a block: 107,520 bytes, two blocks an SM; registers a
// thread at h = 768 (ptxas, sm_90a): 122 of the 128 that two blocks
// leave, no spills (chip_smoke.py fails on any).  At the training shape
// the dropout instantiation is 25% slower than p = 0 (PERF.md): the
// epilogue's hash and float32 division per element are no longer hidden
// behind the main loop.
//
// Ragged edges: rows of x at or past n and columns of W at or past cols (a
// multiple of 8) are zero-filled by cp.async; they are never stored.  No
// atomics: two launches give the same bits.
#include "common.cuh"
#include "flash_mma.cuh"
#include "gemm_mma.cuh"

namespace {

using ptt_flash::mma::bf16;
using ptt_flash::mma::cp_commit;
using ptt_flash::mma::cp_wait;
using ptt_flash::mma::pack_bf16;

constexpr int kBM = 128;                // output tile
constexpr int kBN = 128;
constexpr int kBK = 64;                 // depth of a ring stage
constexpr int kStages = 3;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWN = 2;                  // warps across the columns
constexpr int kMI = kBM / (kWarps / kWN) / 16;   // m16 tiles of a warp: 2
constexpr int kNJ = kBN / kWN / 8;               // n8 tiles of a warp: 8
constexpr int kLdA = kBK + 8;           // strides (bf16 elements)
constexpr int kLdB = kBN + 8;
constexpr int kLdOut = kBN + 8;         // float32 staging stride
constexpr int kStageA = kBM * kLdA;
constexpr int kStage = kStageA + kBK * kLdB;
constexpr size_t kSmem = sizeof(bf16) * kStages * kStage;
static_assert(sizeof(float) * kBM * kLdOut <= kSmem,
              "the staging tile fits the drained ring");

// grid (column tiles, row tiles)
template <int K, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
linear_residual_mma_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w,
                           const void* __restrict__ b, int b_bf16,
                           const void* __restrict__ r, int r_bf16,
                           void* __restrict__ out, int n, int cols,
                           ptt::Dropout drop) {
  static_assert(K % kBK == 0, "whole ring stages");
  constexpr int kChunks = K / kBK;
  extern __shared__ uint4 smem_linear_residual_mma[];
  bf16* ring = reinterpret_cast<bf16*>(smem_linear_residual_mma);
  const int col0 = blockIdx.x * kBN;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / kWN;              // rows 32 wm .. 32 wm + 31
  const int wn = warp % kWN;              // columns 64 wn .. 64 wn + 63
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int rows_ok = n - row0 < kBM ? static_cast<int>(n - row0) : kBM;

  // ring stage q: depth k0 .. k0 + 63 of the x rows and of the W columns
  auto issue = [&](int q) {
    bf16* stage = ring + (q % kStages) * kStage;
    const int k0 = q * kBK;
    ptt_gemm::stage_tile<kBM, kBK, kThreads>(stage, x + row0 * K + k0, K,
                                             rows_ok, kBK);
    ptt_gemm::stage_tile<kBK, kBN, kThreads>(
        stage + kStageA, w + static_cast<int64_t>(k0) * cols + col0, cols,
        kBK, cols - col0);
  };

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < kChunks) issue(q);
    cp_commit();
  }
  float acc[kMI][kNJ][4] = {};
#pragma unroll 1
  for (int q = 0; q < kChunks; ++q) {
    cp_wait<kStages - 2>();               // stage q is in (for this thread)
    __syncthreads();                      // ... for all; q - 1 is consumed
    if (q + kStages - 1 < kChunks) issue(q + kStages - 1);
    cp_commit();
    const bf16* stage = ring + (q % kStages) * kStage;
    ptt_gemm::warp_mma<kMI, kNJ, kBK / 16, kLdA, kLdB>(
        acc, stage + 16 * kMI * wm * kLdA, 0, stage + kStageA, 8 * kNJ * wn);
  }
  cp_wait<0>();
  __syncthreads();                        // the ring is drained

  // + b, drop, + r in float32, in the accumulators' layout; parked in
  // shared memory, then stored along the rows
  float* sums = reinterpret_cast<float*>(smem_linear_residual_mma);
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int col = 8 * kNJ * wn + 8 * j + 2 * tq;
    const int gc = col0 + col;
    const bool ok = gc < cols;            // and gc + 1: cols % 8 == 0
    const float b0 = ok ? ptt::ld(b, gc, b_bf16) : 0.f;
    const float b1 = ok ? ptt::ld(b, gc + 1, b_bf16) : 0.f;
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = 16 * kMI * wm + 16 * i + gq + 8 * hh;
        const int64_t row = row0 + rr;
        float y0 = acc[i][j][2 * hh] + b0;
        float y1 = acc[i][j][2 * hh + 1] + b1;
        if (kDrop) {
          y0 = drop(y0, row, gc);
          y1 = drop(y1, row, gc + 1);
        }
        if (ok && row < n) {
          const int64_t o = row * cols + gc;
          y0 += ptt::ld(r, o, r_bf16);
          y1 += ptt::ld(r, o + 1, r_bf16);
        }
        *reinterpret_cast<float2*>(sums + rr * kLdOut + col) =
            make_float2(y0, y1);
      }
  }
  __syncthreads();
#pragma unroll 4
  for (int u = 0; u < kBM * kBN / 4 / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int rr = i / (kBN / 4);
    const int cc = (i % (kBN / 4)) * 4;
    const int64_t row = row0 + rr;
    if (row >= n || col0 + cc >= cols) continue;
    const float4 v = *reinterpret_cast<const float4*>(sums + rr * kLdOut + cc);
    const int64_t o = row * cols + col0 + cc;
    if (r_bf16) {
      *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + o) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = v;
    }
  }
}

template <int K, bool kDrop>
cudaError_t launch(const bf16* x, const bf16* w, const void* b, int b_bf16,
                   const void* r, int r_bf16, void* out, int n, int cols,
                   const ptt::Dropout& drop, cudaStream_t s) {
  auto kernel = linear_residual_mma_kernel<K, kDrop>;
  cudaError_t err = ptt::allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((cols + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmem, s>>>(x, w, b, b_bf16, r, r_bf16, out, n,
                                       cols, drop);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch_drop(const bf16* x, const bf16* w, const void* b,
                          int b_bf16, const void* r, int r_bf16, void* out,
                          int n, int cols, const ptt::Dropout& drop,
                          cudaStream_t s) {
  return drop.p > 0.f
             ? launch<K, true>(x, w, b, b_bf16, r, r_bf16, out, n, cols, drop,
                               s)
             : launch<K, false>(x, w, b, b_bf16, r, r_bf16, out, n, cols,
                                drop, s);
}

}  // namespace

// Dynamic shared memory a block takes at depth k (0: no instantiation;
// ops/fused_block.py _MMA_HIDDEN).
PTT_EXPORT size_t ptt_linear_residual_mma_smem(int k) {
  return k == 128 || k == 768 ? kSmem : 0;
}

// x (n, k) and w (k, cols) bf16, 16-byte aligned, cols a multiple of 8; b
// and r float32 or bf16 by their codes; out (n, cols) in r's dtype,
// 16-byte aligned.  Dropout p > 0 takes the dropout instantiation, with the
// hash's seed and salt and keep_div = 1 - p rounded to float32 on the host.
PTT_EXPORT int ptt_linear_residual_mma(const void* x, const void* w,
                                       const void* b, int b_bf16,
                                       const void* r, int r_bf16, void* out,
                                       int n, int k, int cols, unsigned seed,
                                       unsigned salt, float p, float keep_div,
                                       void* stream) {
  if (n <= 0 || cols <= 0 || cols % 8 != 0 ||
      (n + kBM - 1) / kBM > 65535 || ptt_linear_residual_mma_smem(k) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!ptt_flash::mma::aligned16(x) || !ptt_flash::mma::aligned16(w) ||
      !ptt_flash::mma::aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const ptt::Dropout drop{seed, salt, p, keep_div};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 128:
      return static_cast<int>(dispatch_drop<128>(xb, wb, b, b_bf16, r, r_bf16,
                                                 out, n, cols, drop, s));
    case 768:
      return static_cast<int>(dispatch_drop<768>(xb, wb, b, b_bf16, r, r_bf16,
                                                 out, n, cols, drop, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
