// K1 for a float32 W at the prefill rows: fused pre-LayerNorm + GEMM +
// bias,
//   out = LN(x) @ W + b,
// stored in W's dtype (float32).
//
// Replaces: paddle_tpu/ops/fused_block.py `_ln_linear_kernel` (launched by
// `_ln_linear_pallas`) for the calls that `ln_linear_route` sends here: a
// float32 W above `_LN_STREAM_MAX_ROWS` rows (serving's prefill buckets of
// 128-512 rows, generate's prefill of 4096; x the bf16 residual stream).
// LN is taken in float32 as `_ln_f32` takes it (the mean, then the mean of
// the squared deviations, rsqrt(var + eps), gain, bias); the products are
// float32 FMA, the JAX kernel's "highest" precision: no TF32.
//
// What bounds it on the H100: operations.  14.5 GFLOP at N=4096 (h = 768,
// 2304 columns) is 0.216 ms at the CUDA cores' 67 TFLOP/s; the bytes (x, W
// and the output, 51 MB) take 0.015 ms.  The SIMT kernel of ln_linear.cu
// gave each thread 4 outputs, so 5 shared-memory loads fed 4 FMAs; it
// staged W one scalar load at a time with no copy in flight during the
// products, and waited on a barrier on each side of every 32-deep slab.
//
// Design: a standard register-blocked float32 GEMM with an LN prologue.
// A block of 128 threads owns a 64 x 128 output tile, a thread 8 x 8 of it
// (two 4-row and two 4-column quads, so its operands are 4 float4 loads
// from shared memory for 64 FMAs); three blocks an SM (155 registers a
// thread).  W and x move in 16-deep slabs through a 3-stage cp.async ring
// of 16-byte copies, two slabs in flight while the products of a third
// run, one barrier a slab.  A float32 LN tile of 64 x 768 would take
// 196 KB, so LN(x) is never held whole: the block first takes its rows'
// mean and rstd in float32 over the whole h into shared memory (a warp 16
// rows, 8 loads a lane a row in flight, while the first slabs land), then
// each thread normalises the 8 raw x values it copied of the next slab
// (x gain + bias, both staged in shared memory) into the next transposed A
// slab after the current slab's products.  LN(x) never reaches device
// memory.  Ragged rows, columns and depth read as zero and are not stored.
// Where the tiles alone would leave the card short of blocks (serving's
// prefill buckets), the wrapper splits the depth over a cluster of
// `cluster` blocks a tile whose partials are summed through distributed
// shared memory in rank order; each block repeats its rows' statistics,
// which bounds the split (`_tiled_splits`).  No atomics: a call repeats bit
// for bit.  No wgmma and no TMA: this is float32 on the CUDA cores.
// Measured on the card (PERF.md, findings): a 4-stage ring, x staged
// through registers, 4 blocks an SM (128 registers: spills) ran slower.
#include <cooperative_groups.h>

#include "common.cuh"
#include "flash_mma.cuh"   // cp_async16, cp_commit, cp_wait; to_f

namespace cg = cooperative_groups;
using ptt_flash::mma::cp_async16;
using ptt_flash::mma::cp_commit;
using ptt_flash::to_f;
using ptt_flash::mma::cp_wait;

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 64;       // rows a tile
constexpr int kBN = 128;      // columns a tile
constexpr int kBK = 16;       // depth a slab
constexpr int kStages = 3;    // slabs of W and x in the ring
constexpr int kMaxCluster = 8;
constexpr int kStatRows = kBM / (kThreads / 32);   // rows a warp's LN stats
// shared memory, in floats: the W ring, two transposed A slabs, each row's
// mean and rstd, the raw x ring (sized for float32 x), then g and beta (k
// each); after the products the W ring and the A slabs hold the block's
// (64, 128) partial when the depth is split
constexpr int kRing = kStages * kBK * kBN;
constexpr int kASlab = kBK * kBM;
constexpr int kXSlab = kBM * kBK;
constexpr int kFixedFloats = kRing + 2 * kASlab + 2 * kBM + kStages * kXSlab;
static_assert(kRing + 2 * kASlab >= kBM * kBN, "the partial fits");
static_assert(kThreads * 4 * 4 == kBK * kBN, "4 W chunks a thread a slab");
static_assert(kThreads * 8 == kBM * kBK, "8 x values a thread a slab");

__host__ __device__ inline size_t smem_floats(int k) {
  return kFixedFloats + 2 * static_cast<size_t>(k);
}

// T: x's element type.  x's rows are 16-byte aligned (k * sizeof(T) a
// multiple of 16, x 16-byte aligned), so its slabs move in 16-byte chunks.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
ln_linear_tiled_kernel(const T* x, const float* w, const void* b, int b_bf16,
                       const void* g, int g_bf16, const void* beta,
                       int beta_bf16, float* out, int n, int k, int cols,
                       float eps) {
  constexpr int kChunk = 16 / sizeof(T);    // x values a 16-byte copy
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                       // kStages x kBK x kBN
  float* as = ring + kRing;                 // 2 x kBK x kBM, k-major
  float* mean_s = as + 2 * kASlab;          // kBM
  float* rstd_s = mean_s + kBM;             // kBM
  T* xraw = reinterpret_cast<T*>(rstd_s + kBM);   // kStages x kBM x kBK
  float* g_s = rstd_s + kBM + kStages * kXSlab;   // k
  float* b_s = g_s + k;                           // k
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / csize) * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // the rank's depth [k_lo, k_hi) in whole slabs
  const int per = ((k + kBK - 1) / kBK + csize - 1) / csize;
  const int k_lo = min(k, crank * per * kBK);
  const int k_hi = min(k, k_lo + per * kBK);
  const int slabs = (k_hi - k_lo + kBK - 1) / kBK;

  // this thread's x values of a slab: 8 consecutive k of row xr
  const int xr = tid % kBM;
  const int xk = (tid / kBM) * 8;
  const bool row_ok = m0 + xr < n;
  const T* xrow = x + static_cast<int64_t>(row_ok ? m0 + xr : 0) * k;

  // slab s of W (16 rows x 32 chunks of 16 bytes, 4 a thread) and of x
  // (64 rows x 16 k: this thread's 8 values) into ring stage s % kStages,
  // one commit group; rows past k_hi or n and columns past cols are zero
  auto load = [&](int s) {
    if (s < slabs) {
      float* wd = ring + (s % kStages) * kBK * kBN;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int chunk = tid + i * kThreads;
        const int kk = chunk / (kBN / 4);
        const int c = (chunk % (kBN / 4)) * 4;
        const int gk = k_lo + s * kBK + kk;
        const bool ok = gk < k_hi && n0 + c < cols;
        cp_async16(wd + kk * kBN + c,
                   ok ? w + static_cast<int64_t>(gk) * cols + n0 + c : w, ok);
      }
      T* xd = xraw + (s % kStages) * kXSlab + xr * kBK;
#pragma unroll
      for (int j = 0; j < 8; j += kChunk) {
        const int gk = k_lo + s * kBK + xk + j;
        const bool ok = row_ok && gk < k_hi;
        cp_async16(xd + xk + j, ok ? xrow + gk : x, ok);
      }
    }
    cp_commit();
  };
  load(0);
  load(1);

  // g and beta as float32, and each row's mean and rstd over the whole h:
  // warp w rows w + 4j, the loads of its 16 rows in flight together
  for (int c = tid; c < k; c += kThreads) {
    g_s[c] = ptt::ld(g, c, g_bf16);
    b_s[c] = ptt::ld(beta, c, beta_bf16);
  }
  {
    float sum[kStatRows], sq[kStatRows];
#pragma unroll
    for (int j = 0; j < kStatRows; ++j) sum[j] = sq[j] = 0.f;
#pragma unroll 8
    for (int c = lane; c < k; c += 32) {
#pragma unroll
      for (int j = 0; j < kStatRows; ++j) {
        const int r = m0 + warp + 4 * j;
        if (r < n) sum[j] += to_f(x[static_cast<int64_t>(r) * k + c]);
      }
    }
#pragma unroll
    for (int j = 0; j < kStatRows; ++j) sum[j] = ptt::warp_sum(sum[j]) / k;
#pragma unroll 8
    for (int c = lane; c < k; c += 32) {
#pragma unroll
      for (int j = 0; j < kStatRows; ++j) {
        const int r = m0 + warp + 4 * j;
        if (r < n) {
          const float dv = to_f(x[static_cast<int64_t>(r) * k + c]) -
                           sum[j];
          sq[j] += dv * dv;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kStatRows; ++j) {
      const float rstd = rsqrtf(ptt::warp_sum(sq[j]) / k + eps);
      if (lane == 0) {
        mean_s[warp + 4 * j] = sum[j];
        rstd_s[warp + 4 * j] = rstd;
      }
    }
  }
  __syncthreads();
  const float mean = mean_s[xr];
  const float rstd = rstd_s[xr];

  // LN(x) of this thread's 8 raw values of slab s (its own copies: visible
  // to it once its groups have landed) into A slab `buf`, transposed
  auto store_a = [&](int buf, int s) {
    const int k0 = k_lo + s * kBK + xk;
    const T* src = xraw + (s % kStages) * kXSlab + xr * kBK + xk;
    float* dst = as + buf * kASlab + xk * kBM + xr;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j * kBM] = row_ok && k0 + j < k_hi
                         ? (to_f(src[j]) - mean) * rstd * g_s[k0 + j] +
                               b_s[k0 + j]
                         : 0.f;
  };
  cp_wait<1>();      // this thread's copies of slab 0 have landed
  if (slabs > 0) store_a(0, 0);
  __syncthreads();

  // thread (ty, tx): rows ty * 4 + {0..3} and 32 + ty * 4 + {0..3},
  // columns tx * 4 + {0..3} and 64 + tx * 4 + {0..3}
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < slabs; ++s) {
    load(s + 2);                   // into the stage slab s - 1 left
    const float* a_s = as + (s % 2) * kASlab;
    const float* w_s = ring + (s % kStages) * kBK * kBN;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * kBM +
                                                         ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * kBM +
                                                         32 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(w_s + kk * kBN +
                                                         tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(w_s + kk * kBN +
                                                         64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    cp_wait<1>();                  // this thread's copies of slab s + 1
    if (s + 1 < slabs) store_a((s + 1) % 2, s + 1);
    __syncthreads();
  }

  auto row_of = [&](int i) { return (i < 4 ? 0 : 32) + ty * 4 + i % 4; };
  auto col_of = [&](int q) { return (q == 0 ? 0 : 64) + tx * 4; };
  if (csize == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + row_of(i);
      if (r >= n) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = n0 + col_of(q);
        if (c >= cols) continue;
        float4 v;
        v.x = acc[i][4 * q + 0] + ptt::ld(b, c + 0, b_bf16);
        v.y = acc[i][4 * q + 1] + ptt::ld(b, c + 1, b_bf16);
        v.z = acc[i][4 * q + 2] + ptt::ld(b, c + 2, b_bf16);
        v.w = acc[i][4 * q + 3] + ptt::ld(b, c + 3, b_bf16);
        *reinterpret_cast<float4*>(out + static_cast<int64_t>(r) * cols +
                                   c) = v;
      }
    }
    return;
  }

  // The depth split over the cluster: each rank's partial into its shared
  // memory (the drained W ring and A slabs), then rank q sums its slice of
  // the tile's float4s over the ranks in order, + b.  The first barrier
  // also orders every peer's start before the reads.
  cp_wait<0>();
  float* part = smem;                       // kBM x kBN
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      *reinterpret_cast<float4*>(part + row_of(i) * kBN + col_of(q)) =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                      acc[i][4 * q + 3]);
  cluster.sync();
  constexpr int kQuads = kBM * kBN / 4;
  const int span = (kQuads + csize - 1) / csize;
  const int e_hi = min(kQuads, (crank + 1) * span);
  for (int e = crank * span + tid; e < e_hi; e += kThreads) {
    const int r = m0 + e / (kBN / 4);
    const int c = n0 + (e % (kBN / 4)) * 4;
    float4 v[kMaxCluster];   // every rank's load in flight, then the sum
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < csize)
        v[q] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q))[e];
    if (r >= n || c >= cols) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < csize) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    s.x += ptt::ld(b, c + 0, b_bf16);
    s.y += ptt::ld(b, c + 1, b_bf16);
    s.z += ptt::ld(b, c + 2, b_bf16);
    s.w += ptt::ld(b, c + 3, b_bf16);
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(r) * cols + c) = s;
  }
  cluster.sync();   // no block leaves while a peer still reads its partial
}

template <typename T>
cudaError_t launch(const T* x, const float* w, const void* b, int b_bf16,
                   const void* g, int g_bf16, const void* beta, int beta_bf16,
                   float* out, int n, int k, int cols, int cluster, float eps,
                   void* stream) {
  const size_t smem = sizeof(float) * smem_floats(k);
  cudaError_t err = ptt::allow_smem(ln_linear_tiled_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((cols + kBN - 1) / kBN * cluster, (n + kBM - 1) / kBM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ln_linear_tiled_kernel<T>, x, w, b, b_bf16,
                           g, g_bf16, beta, beta_bf16, out, n, k, cols, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a block takes at depth k (h).
PTT_EXPORT size_t ptt_ln_linear_tiled_smem(int k) {
  return sizeof(float) * smem_floats(k);
}

// (cols / 128 tiles x cluster, n / 64 tiles) blocks, the `cluster` blocks
// of a tile splitting its depth; x (n, k) float32 or bf16 with 16-byte
// aligned rows (k a multiple of 8 covers both), W (k, cols) float32 with
// cols a multiple of 4 and a 16-byte aligned start, out (n, cols) float32.
PTT_EXPORT int ptt_ln_linear_tiled(const void* x, int x_bf16, const float* w,
                                   const void* b, int b_bf16, const void* g,
                                   int g_bf16, const void* beta,
                                   int beta_bf16, float* out, int n, int k,
                                   int cols, int cluster, float eps,
                                   void* stream) {
  if (n <= 0 || k <= 0 || k % 8 || cols <= 0 || cols % 4 || cluster < 1 ||
      cluster > kMaxCluster || (reinterpret_cast<uintptr_t>(w) & 15) ||
      (reinterpret_cast<uintptr_t>(x) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      x_bf16 ? launch(static_cast<const __nv_bfloat16*>(x), w, b, b_bf16, g,
                      g_bf16, beta, beta_bf16, out, n, k, cols, cluster, eps,
                      stream)
             : launch(static_cast<const float*>(x), w, b, b_bf16, g, g_bf16,
                      beta, beta_bf16, out, n, k, cols, cluster, eps, stream);
  return static_cast<int>(err);
}
