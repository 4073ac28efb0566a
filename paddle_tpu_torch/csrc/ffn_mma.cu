// K3 on the tensor cores, for bf16 W1 and W2: the FFN half of a pre-LN
// decoder block in one pass over the ffn width,
//   lnx = bf16(LN_f32(x) * g + beta)
//   hid = bf16(drop1(act(lnx @ W1 + b1)))          act: exact gelu or relu
//   out = x + drop2(sum over the ffn tiles of hid @ W2 + b2), in x's dtype.
//
// Replaces: paddle_tpu/ops/fused_block.py `_ffn_kernel` (launched by
// `_ffn_pallas`) where its weights are bf16: the fused training step under
// O1, whose `fused_ffn_block` casts W1 and W2 to bf16.  The TPU kernel rounds
// LN(x) to W1's dtype before the first product and the activation to W2's
// dtype before the second, and sums both products in float32; a bf16 x bf16
// product is exact in float32, so mma.sync.m16n8k16 with float32
// accumulators computes the same function, with the sums in another order.
// Float32 weights (serving, generate) keep the SIMT kernel of ffn.cu; the
// wrapper picks the kernel from dtypes, shapes and addresses
// (ops/fused_block.py `ffn_route`).
//
// What bounds it on the H100: operations.  At the training shape (N = 16384
// rows, h = 768, ffn = 3072) the two products are 154.6 GFLOP, 0.156 ms at
// the 989 TFLOP/s bf16 peak, against 9.4 MB of weights and 50 MB of x and
// out (0.018 ms at 3.35 TB/s).  Only the tensor cores come near the bound.
//
// Design: a thread-block cluster of two blocks owns a 64-row tile; each
// block holds all 64 rows and half of the h output columns, so the float32
// accumulator of the tile, (64, h), is split across the pair: (64, h / 2)
// in the registers of a block's 8 warps, h / 8 floats a thread (96 at
// h = 768), each warp owning 32 rows x h / 8 columns.  Both blocks compute
// LN(x) of the tile once into shared memory as bf16 (64 x (h + 8);
// ln_tile of gemm_mma.cuh, shared with ln_linear_mma.cu).  Then,
// for each ffn tile of 256 columns, each block computes its half of the
// activation, (64, 128) = LN(x) @ W1[:, its 128 columns] (warp tiles of
// 32 x 32), adds b1, applies act and drop1, rounds to bf16 and stores the
// half into the activation tile of both blocks (its own shared memory and
// its peer's, through distributed shared memory); after a cluster barrier
// each block multiplies the whole (64, 256) activation tile by its half of
// W2's rows, W2[tile, its h / 2 columns], into its accumulator.  The
// (N, ffn) intermediate never reaches device memory, and each half of the
// activation is computed once.  W1 and W2 stream through a three-stage ring
// of 16-byte cp.async copies (W1 in chunks of 64 h-rows x 128 columns, W2
// in chunks of 32 ffn rows x h / 2 columns); ldmatrix feeds the mma
// fragments from shared memory (flash_mma.cuh).
//
// Why a cluster and not a larger row tile: every row tile reads all of W1
// and W2 from L2, (N / 64) x 9.4 MB = 2.4 GB a launch at N = 16384.  A
// single block over 64 rows and all h columns would need 96 accumulator
// floats a thread at 512 threads, within a 128-register cap that the
// activation tile's own accumulators and fragments overflow; 32 rows a
// block would fit but double the L2 traffic.  The pair keeps the 64-row
// tile (half the weights per block, 2.4 GB in all) at 8 warps a block and
// up to 255 registers a thread.  Shared memory a block: 64 x (h + 8) bf16
// LN(x), 64 x 264 bf16 activation tile, 3 ring stages of max(64 x 136,
// 32 x (h / 2 + 8)) bf16: 208,384 bytes at h = 768, one block per SM.
// Registers a thread at h = 768 (ptxas, sm_90a): 254, no spills;
// chip_smoke.py fails on any spill at h = 768.  The accumulators take 128
// of them (96 + the first product's 32).  A 16-warp block (48 + 16
// accumulator floats a thread) was tried and was not faster.  Hidden sizes
// with an instantiation: 128 (gpt_tiny) and 768 (GPT-125M); a width is
// added when a configuration needs it.
//
// Synchronisation between the pair, one cluster barrier phase each way per
// ffn tile: before a block stores its half of tile t into its peer, it
// waits until the peer has finished reading tile t - 1 (and, for t = 0,
// until the peer has started: every block arrives on the barrier as it
// starts); after storing, both blocks arrive and wait, which makes the two
// halves visible before the second product.  The release / acquire
// semantics of barrier.cluster order the stores and loads.
//
// Dropout: drop1 over the global (row, ffn column) of the activation,
// before its rounding to bf16 (a template argument).  drop2 over the global
// (row, column) of the finished sum + b2, never over a partial sum: with
// drop2 on, the wrapper passes the float32 scratch `part` and the finalize
// kernel of ffn.cu (`ffn_finalize_kernel`, one kernel for both K3 routes)
// adds b2, drops and adds x.  The wrapper passes `part` too when the ffn
// tiles are split across several cluster groups (few rows: groups * h <
// ffn).  At the training shape a drop2 instantiation of this kernel's
// epilogue ran 5% slower than the float32 (N, h) round trip through the
// finalize kernel (1.1682 against 1.0986 ms, PERF.md): its main loop was
// scheduled differently, as in ffn.cu.  Both hash the counters of `keep`
// (common.cuh) with the JAX package's salts: the same dropped elements.
//
// Ragged edges: rows at or past N are zero in LN(x) and never stored; W1
// columns and W2 rows at or past ffn are zero-filled by cp.async (ffn a
// multiple of 8, so a 16-byte chunk is in or out whole), and their
// activations are zeroed.  No atomics: two launches give the same bits.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "flash_mma.cuh"
#include "gemm_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using ptt_flash::mma::bf16;
using ptt_flash::mma::cp_async16;
using ptt_flash::mma::cp_commit;
using ptt_flash::mma::cp_wait;
using ptt_flash::mma::load_a;
using ptt_flash::mma::load_b_kn;
using ptt_flash::mma::mma16816;
using ptt_flash::mma::pack_bf16;

constexpr int kBM = 64;                 // rows of a cluster's tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBF = 256;                // ffn columns of a tile
constexpr int kHalfF = kBF / 2;         // of them, a block's first product
constexpr int kK1 = 64;                 // h rows of a staged W1 chunk
constexpr int kK2 = 32;                 // ffn rows of a staged W2 chunk
constexpr int kStages = 3;
constexpr int kLdHid = kBF + 8;         // strides (bf16 elements): rows 16
constexpr int kLdW1 = kHalfF + 8;       // bytes apart in the banks

// Warp tiles.  First product, (64, 128): 2 x kWarps / 2 warps of 32 rows
// x kN1 n8 tiles.  Second product, (64, h / 2): kWM2 x kWN2 warps of
// 16 kM2 rows x kN2 n8 tiles (at h = 768 and 8 warps: 2 x 4 warps of
// 32 rows x 96 columns).  ldmatrix.x4 loads B for two n8 tiles at once.
template <int H>
struct Shape {
  static constexpr int kLdLn = H + 8;
  static constexpr int kHalfH = H / 2;          // output columns of a block
  static constexpr int kLdW2 = kHalfH + 8;
  static constexpr int kWN1 = kWarps / 2;
  static constexpr int kN1 = kHalfF / kWN1 / 8;
  static constexpr int kWN2 =
      kWarps / 2 < kHalfH / 16 ? kWarps / 2 : kHalfH / 16;
  static constexpr int kWM2 = kWarps / kWN2;
  static constexpr int kM2 = kBM / 16 / kWM2;
  static constexpr int kN2 = kHalfH / kWN2 / 8;
  static_assert(H % 128 == 0 && kN1 % 2 == 0 && kN2 % 2 == 0 && kM2 >= 1,
                "a warp's columns are whole 16-column pairs");
  static constexpr int kStage =
      kK1 * kLdW1 > kK2 * kLdW2 ? kK1 * kLdW1 : kK2 * kLdW2;
  static constexpr int kChunks1 = H / kK1;      // W1 chunks of a tile
  static constexpr int kChunks = kChunks1 + kBF / kK2;
  static constexpr size_t kSmem =
      sizeof(bf16) * (static_cast<size_t>(kBM) * kLdLn + kBM * kLdHid +
                      kStages * kStage);
};

__device__ __forceinline__ float activate(float v, int act) {
  // act 0: exact gelu, jax.nn.gelu(approximate=False); act 1: relu
  return act == 0 ? 0.5f * v * (1.f + erff(v * 0.70710678118654752f))
                  : fmaxf(v, 0.f);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Chunk q of a block's sequence into ring stage q % kStages: each of its
// ffn tiles is kChunks1 W1 chunks (h rows k0 .. k0 + 63 of the block's 128
// columns of the tile), then kBF / kK2 W2 chunks (ffn rows of the tile, the
// block's h / 2 columns).  Out-of-range columns / rows are zero-filled.
template <int H>
__device__ __forceinline__ void issue_chunk(int q, int group, int groups,
                                            int rank, int ffn,
                                            const bf16* __restrict__ w1,
                                            const bf16* __restrict__ w2,
                                            bf16* ring) {
  using S = Shape<H>;
  const int tile = group + (q / S::kChunks) * groups;
  const int c = q % S::kChunks;
  bf16* dst = ring + (q % kStages) * S::kStage;
  if (c < S::kChunks1) {
    constexpr int kPerRow = kHalfF / 8;
    const int k0 = c * kK1;
    const int f0 = tile * kBF + rank * kHalfF;
    for (int i = threadIdx.x; i < kK1 * kPerRow; i += kThreads) {
      const int r = i / kPerRow;
      const int f = f0 + (i % kPerRow) * 8;
      const bool ok = f < ffn;
      cp_async16(dst + r * kLdW1 + (i % kPerRow) * 8,
                 w1 + (ok ? static_cast<int64_t>(k0 + r) * ffn + f : 0), ok);
    }
  } else {
    constexpr int kPerRow = S::kHalfH / 8;
    const int f0 = tile * kBF + (c - S::kChunks1) * kK2;
    const int c0 = rank * S::kHalfH;
    for (int i = threadIdx.x; i < kK2 * kPerRow; i += kThreads) {
      const int r = i / kPerRow;
      const int cc = (i % kPerRow) * 8;
      const bool ok = f0 + r < ffn;
      cp_async16(dst + r * S::kLdW2 + cc,
                 w2 + (ok ? static_cast<int64_t>(f0 + r) * H + c0 + cc : 0),
                 ok);
    }
  }
}

// Launched in clusters of two blocks along x (the pair of a row tile); y
// is the row tile, z the group.  With `part` null the block stores
// out = x + sum + b2 for its half of the columns; otherwise it stores its
// group's float32 sum to part[group] for the finalize kernel.
template <int H, bool kDrop1>
__global__ void __launch_bounds__(kThreads, 1)
ffn_mma_kernel(const void* __restrict__ x, int x_bf16,
               const bf16* __restrict__ w1, const void* __restrict__ b1,
               int b1_bf16, const bf16* __restrict__ w2,
               const void* __restrict__ b2, int b2_bf16,
               const void* __restrict__ g, int g_bf16,
               const void* __restrict__ beta, int beta_bf16,
               float* __restrict__ part, void* __restrict__ out, int n,
               int ffn, float eps, int act, ptt::Dropout drop1) {
  using S = Shape<H>;
  extern __shared__ uint4 smem_ffn_mma[];
  bf16* lnx = reinterpret_cast<bf16*>(smem_ffn_mma);   // kBM x kLdLn
  bf16* hid = lnx + kBM * S::kLdLn;                     // kBM x kLdHid
  bf16* ring = hid + kBM * kLdHid;                      // kStages x kStage
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  bf16* hid_peer = cluster.map_shared_rank(hid, rank ^ 1);
  // this block has started: its peer may store into its shared memory once
  // both have arrived here (the wait precedes the first remote store)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int group = blockIdx.z;
  const int groups = gridDim.z;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm1 = warp / S::kWN1;         // first product: rows 32 wm1
  const int wn1 = warp % S::kWN1;
  const int wm2 = warp / S::kWN2;         // second: rows 16 kM2 wm2
  const int wn2 = warp % S::kWN2;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int tiles = (ffn + kBF - 1) / kBF;
  const int chunks = (tiles - group + groups - 1) / groups * S::kChunks;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < chunks) issue_chunk<H>(q, group, groups, rank, ffn, w1, w2, ring);
    cp_commit();
  }
  ptt_gemm::ln_tile<H, kBM, kWarps>(x, x_bf16, row0, n, g, g_bf16, beta,
                                    beta_bf16, eps, lnx);

  float acc1[2][S::kN1][4];
  float acc2[S::kM2][S::kN2][4] = {};
  for (int q = 0; q < chunks; ++q) {
    cp_wait<kStages - 2>();               // chunk q is in (for this thread)
    __syncthreads();                      // ... for all; q - 1 is consumed
    if (q + kStages - 1 < chunks)
      issue_chunk<H>(q + kStages - 1, group, groups, rank, ffn, w1, w2, ring);
    cp_commit();
    const bf16* stage = ring + (q % kStages) * S::kStage;
    const int c = q % S::kChunks;
    const int tile = group + (q / S::kChunks) * groups;
    if (c < S::kChunks1) {
      // the first product: acc1 += LN(x)[:, k0:k0+64] @ W1 chunk
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < S::kN1; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc1[i][j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kK1 / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load_a<S::kLdLn>(a[i], lnx + (32 * wm1 + 16 * i) * S::kLdLn,
                           c * kK1 + 16 * kk);
#pragma unroll
        for (int np = 0; np < S::kN1 / 2; ++np) {
          uint32_t b[4];
          load_b_kn<kLdW1>(b, stage, 16 * kk, 8 * S::kN1 * wn1 + 16 * np);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma16816(acc1[i][2 * np], a[i], b[0], b[1]);
            mma16816(acc1[i][2 * np + 1], a[i], b[2], b[3]);
          }
        }
      }
      if (c == S::kChunks1 - 1) {
        // the activation tile: + b1, act, drop1, bf16, into both blocks
        cluster_wait();                   // the peer is done with tile - 1
#pragma unroll
        for (int j = 0; j < S::kN1; ++j) {
          const int col = rank * kHalfF + 8 * S::kN1 * wn1 + 8 * j + 2 * tq;
          const int f = tile * kBF + col;
          const float bias0 = f < ffn ? ptt::ld(b1, f, b1_bf16) : 0.f;
          const float bias1 = f + 1 < ffn ? ptt::ld(b1, f + 1, b1_bf16) : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = 32 * wm1 + 16 * i + gq + 8 * hh;
              float v0 = activate(acc1[i][j][2 * hh] + bias0, act);
              float v1 = activate(acc1[i][j][2 * hh + 1] + bias1, act);
              if (kDrop1) {
                v0 = drop1(v0, row0 + r, f);
                v1 = drop1(v1, row0 + r, f + 1);
              }
              const uint32_t p =
                  pack_bf16(f < ffn ? v0 : 0.f, f + 1 < ffn ? v1 : 0.f);
              *reinterpret_cast<uint32_t*>(hid + r * kLdHid + col) = p;
              *reinterpret_cast<uint32_t*>(hid_peer + r * kLdHid + col) = p;
            }
        }
        cluster_arrive();                 // both halves stored ...
        cluster_wait();                   // ... and visible
      }
    } else {
      // the second product: acc2 += hid[:, k0:k0+32] @ W2 chunk
      const int k0 = (c - S::kChunks1) * kK2;
#pragma unroll
      for (int kk = 0; kk < kK2 / 16; ++kk) {
        uint32_t a[S::kM2][4];
#pragma unroll
        for (int i = 0; i < S::kM2; ++i)
          load_a<kLdHid>(a[i], hid + (16 * S::kM2 * wm2 + 16 * i) * kLdHid,
                         k0 + 16 * kk);
#pragma unroll
        for (int np = 0; np < S::kN2 / 2; ++np) {
          uint32_t b[4];
          load_b_kn<S::kLdW2>(b, stage, 16 * kk, 8 * S::kN2 * wn2 + 16 * np);
#pragma unroll
          for (int i = 0; i < S::kM2; ++i) {
            mma16816(acc2[i][2 * np], a[i], b[0], b[1]);
            mma16816(acc2[i][2 * np + 1], a[i], b[2], b[3]);
          }
        }
      }
      // done reading this tile's activations (no arrival after the last:
      // nothing waits on it)
      if (c == S::kChunks - 1 && q + 1 < chunks) cluster_arrive();
    }
  }
  cp_wait<0>();

  const int col0 = rank * S::kHalfH + 8 * S::kN2 * wn2 + 2 * tq;
#pragma unroll
  for (int i = 0; i < S::kM2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t row = row0 + 16 * S::kM2 * wm2 + 16 * i + gq + 8 * hh;
      if (row >= n) continue;
#pragma unroll
      for (int j = 0; j < S::kN2; ++j) {
        const int col = col0 + 8 * j;
        const int64_t o = row * H + col;
        float y0 = acc2[i][j][2 * hh];
        float y1 = acc2[i][j][2 * hh + 1];
        if (part != nullptr) {
          *reinterpret_cast<float2*>(
              part + static_cast<int64_t>(group) * n * H + o) =
              make_float2(y0, y1);
          continue;
        }
        y0 += ptt::ld(b2, col, b2_bf16);
        y1 += ptt::ld(b2, col + 1, b2_bf16);
        ptt::st(out, o, ptt::ld(x, o, x_bf16) + y0, x_bf16);
        ptt::st(out, o + 1, ptt::ld(x, o + 1, x_bf16) + y1, x_bf16);
      }
    }
}

struct Args {
  const void* x;
  int x_bf16;
  const bf16* w1;
  const void* b1;
  int b1_bf16;
  const bf16* w2;
  const void* b2;
  int b2_bf16;
  const void* g;
  int g_bf16;
  const void* beta;
  int beta_bf16;
  float* part;
  void* out;
  int n;
  int ffn;
  float eps;
  int act;
  int groups;
  ptt::Dropout drop1;
};

template <int H, bool kDrop1>
cudaError_t launch(const Args& a, cudaStream_t s) {
  auto kernel = ffn_mma_kernel<H, kDrop1>;
  cudaError_t err = ptt::allow_smem(kernel, Shape<H>::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, (a.n + kBM - 1) / kBM, a.groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Shape<H>::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a.x, a.x_bf16, a.w1, a.b1,
                           a.b1_bf16, a.w2, a.b2, a.b2_bf16, a.g, a.g_bf16,
                           a.beta, a.beta_bf16, a.part, a.out, a.n, a.ffn,
                           a.eps, a.act, a.drop1);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int H>
cudaError_t dispatch_drop1(const Args& a, cudaStream_t s) {
  return a.drop1.p > 0.f ? launch<H, true>(a, s) : launch<H, false>(a, s);
}

// The hidden sizes with an instantiation (ops/fused_block.py _MMA_HIDDEN).
cudaError_t dispatch(int h, const Args& a, cudaStream_t s) {
  switch (h) {
    case 128: return dispatch_drop1<128>(a, s);
    case 768: return dispatch_drop1<768>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory a block takes at hidden size h (0: no
// instantiation).
PTT_EXPORT size_t ptt_ffn_mma_smem(int h) {
  switch (h) {
    case 128: return Shape<128>::kSmem;
    case 768: return Shape<768>::kSmem;
    default: return 0;
  }
}

// w1 (h, ffn) and w2 (ffn, h) in bf16, 16-byte aligned, ffn a multiple of
// 8; the other operands float32 or bf16 by their codes.  `part` holds
// groups x n x h floats; it must be given when groups > 1 and may be given
// with one group.  With `part` the kernel stores its float32 sums there and
// the caller finishes with ffn.cu's ptt_ffn_finalize (b2, dropout2, x).
// Dropout p1 > 0 takes the instantiation with drop1 (seed, salt1,
// keep_div1 = 1 - p1 rounded to float32 on the host).
PTT_EXPORT int ptt_ffn_mma(const void* x, int x_bf16, const void* w1,
                           const void* b1, int b1_bf16, const void* w2,
                           const void* b2, int b2_bf16, const void* g,
                           int g_bf16, const void* beta, int beta_bf16,
                           float* part, void* out, int n, int h, int ffn,
                           float eps, int act, int groups, unsigned seed,
                           unsigned salt1, float p1, float keep_div1,
                           void* stream) {
  const int tiles = (ffn + kBF - 1) / kBF;
  if (n <= 0 || ffn <= 0 || ffn % 8 != 0 || groups < 1 || groups > tiles ||
      (groups > 1 && part == nullptr) || ptt_ffn_mma_smem(h) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!ptt_flash::mma::aligned16(w1) || !ptt_flash::mma::aligned16(w2))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{x, x_bf16, static_cast<const bf16*>(w1), b1, b1_bf16,
               static_cast<const bf16*>(w2), b2, b2_bf16, g, g_bf16, beta,
               beta_bf16, part, out, n, ffn, eps, act, groups,
               ptt::Dropout{seed, salt1, p1, keep_div1}};
  return static_cast<int>(dispatch(h, a, static_cast<cudaStream_t>(stream)));
}
