// The register-blocked float32 GEMM body of the fused block's kernels on
// float32 weights at the prefill rows (ln_linear_tiled.cu, ffn_tiled.cu,
// linear_residual_tiled.cu):
//   out tile = epilogue(prologue(A) @ W),
// A (n, k) float32 or bf16, W (k, cols) float32, every product a float32
// FMA (no TF32: the JAX kernels' "highest" precision).
//
// A block of 128 threads owns a 64 x 128 output tile, a thread 8 x 8 of it
// (two 4-row and two 4-column quads, so its operands are 4 float4 loads
// from shared memory for 64 FMAs); three blocks an SM.  W and A move in
// 16-deep slabs through a 3-stage cp.async ring of 16-byte copies, two
// slabs in flight while the products of a third run, one barrier a slab.
// Each thread turns the 8 raw A values it copied of the next slab into the
// next transposed A slab after the current slab's products, through the
// kernel's prologue: `LayerNorm` (the rows' statistics first, then x gain +
// bias) or `Raw` (the value as float32).  Ragged rows, columns and depth
// read as zero and are not stored.  The `cluster` blocks of a thread-block
// cluster split each tile's depth; their partials are summed through
// distributed shared memory in rank order.  The epilogue receives every
// finished float32 sum of a (row, 4 columns) quad once, in a fixed order of
// additions: a call repeats bit for bit (no atomics).  No wgmma and no
// TMA: this is float32 on the CUDA cores.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "flash_mma.cuh"   // cp_async16, cp_commit, cp_wait; to_f

namespace ptt_tiled {

namespace cg = cooperative_groups;
using ptt_flash::mma::cp_async16;
using ptt_flash::mma::cp_commit;
using ptt_flash::mma::cp_wait;
using ptt_flash::to_f;

constexpr int kThreads = 128;
constexpr int kBM = 64;       // rows a tile
constexpr int kBN = 128;      // columns a tile
constexpr int kBK = 16;       // depth a slab
constexpr int kStages = 3;    // slabs of W and A in the ring
constexpr int kMaxCluster = 8;
// shared memory, in floats: the W ring, two transposed A slabs and the raw
// A ring (sized for float32 A), then the prologue's own; after the products
// the W ring and the A slabs hold the block's (64, 128) partial when the
// depth is split
constexpr int kRing = kStages * kBK * kBN;
constexpr int kASlab = kBK * kBM;
constexpr int kXSlab = kBM * kBK;
constexpr int kBodyFloats = kRing + 2 * kASlab + kStages * kXSlab;
static_assert(kRing + 2 * kASlab >= kBM * kBN, "the partial fits");
static_assert(kThreads * 4 * 4 == kBK * kBN, "4 W chunks a thread a slab");
static_assert(kThreads * 8 == kBM * kBK, "8 A values a thread a slab");

// A as it is, in float32.
struct Raw {
  __host__ __device__ static size_t floats(int) { return 0; }
  template <typename T>
  __device__ void prepare(const T*, float*, int, int, int) {}
  __device__ void row(int) {}
  __device__ float operator()(float v, int) const { return v; }
};

// LN(x) in float32, as `_ln_f32` of the port takes it: the mean, then the
// mean of the squared deviations, rsqrt(var + eps), gain, bias.  A float32
// LN tile of 64 x 768 would take 196 KB, so LN(x) is never held whole:
// `prepare` stages g and beta as float32 and takes each row's mean and
// rstd over the whole h (a warp 16 rows, their loads in flight together)
// while the first slabs land.
struct LayerNorm {
  static constexpr int kStatRows = kBM / (kThreads / 32);   // rows a warp
  const void* g;
  int g_bf16;
  const void* beta;
  int beta_bf16;
  float eps;
  float* g_s = nullptr;
  float* b_s = nullptr;
  float* mean_s = nullptr;
  float* rstd_s = nullptr;
  float mean = 0.f;
  float rstd = 0.f;

  // each row's mean and rstd, then g and beta (k each)
  __host__ __device__ static size_t floats(int k) {
    return 2 * kBM + 2 * static_cast<size_t>(k);
  }

  template <typename T>
  __device__ void prepare(const T* x, float* extra, int m0, int n, int k) {
    mean_s = extra;
    rstd_s = mean_s + kBM;
    g_s = rstd_s + kBM;
    b_s = g_s + k;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int c = tid; c < k; c += kThreads) {
      g_s[c] = ptt::ld(g, c, g_bf16);
      b_s[c] = ptt::ld(beta, c, beta_bf16);
    }
    // warp w rows w + 4j
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
      const float rs = rsqrtf(ptt::warp_sum(sq[j]) / k + eps);
      if (lane == 0) {
        mean_s[warp + 4 * j] = sum[j];
        rstd_s[warp + 4 * j] = rs;
      }
    }
  }

  __device__ void row(int r) {
    mean = mean_s[r];
    rstd = rstd_s[r];
  }

  __device__ float operator()(float v, int gk) const {
    return (v - mean) * rstd * g_s[gk] + b_s[gk];
  }
};

// The epilogue of K2 and of K3's second half: out = r + drop(sum + b) over
// the global (row, col), in float32 with one rounding to r's dtype.
template <bool kDrop>
struct Residual {
  const void* b;
  int b_bf16;
  const void* r;
  int r_bf16;
  void* out;
  int cols;
  ptt::Dropout drop;

  __device__ void operator()(int row, int c, float4 v) const {
    const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float y = s[j] + ptt::ld(b, c + j, b_bf16);
      if (kDrop) y = drop(y, row, c + j);
      const int64_t o = static_cast<int64_t>(row) * cols + c + j;
      ptt::st(out, o, ptt::ld(r, o, r_bf16) + y, r_bf16);
    }
  }
};

// Dynamic shared memory of a block whose prologue is P, at depth k.
template <typename P>
__host__ __device__ inline size_t smem_bytes(int k) {
  return sizeof(float) * (kBodyFloats + P::floats(k));
}

// The tile of block (blockIdx.x / cluster, blockIdx.y): A (n, k) of T with
// 16-byte aligned rows (k * sizeof(T) a multiple of 16), W (k, cols) with
// cols a multiple of 4 and a 16-byte aligned start.  `pro` turns a raw A
// value into the product's operand; epi(row, col, float4 sum) gets each
// quad of columns col .. col + 3 of a row below n once.  Every thread of
// the block calls it, with `smem_bytes<Prologue>(k)` of dynamic shared
// memory.
template <typename T, typename Prologue, typename Epilogue>
__device__ __forceinline__ void gemm(const T* x, const float* w, int n,
                                     int k, int cols, Prologue& pro,
                                     const Epilogue& epi) {
  constexpr int kChunk = 16 / sizeof(T);    // A values a 16-byte copy
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                       // kStages x kBK x kBN
  float* as = ring + kRing;                 // 2 x kBK x kBM, k-major
  T* xraw = reinterpret_cast<T*>(as + 2 * kASlab);   // kStages x kBM x kBK
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / csize) * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;

  // the rank's depth [k_lo, k_hi) in whole slabs
  const int per = ((k + kBK - 1) / kBK + csize - 1) / csize;
  const int k_lo = min(k, crank * per * kBK);
  const int k_hi = min(k, k_lo + per * kBK);
  const int slabs = (k_hi - k_lo + kBK - 1) / kBK;

  // this thread's A values of a slab: 8 consecutive k of row xr
  const int xr = tid % kBM;
  const int xk = (tid / kBM) * 8;
  const bool row_ok = m0 + xr < n;
  const T* xrow = x + static_cast<int64_t>(row_ok ? m0 + xr : 0) * k;

  // slab s of W (16 rows x 32 chunks of 16 bytes, 4 a thread) and of A
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
  pro.prepare(x, smem + kBodyFloats, m0, n, k);
  __syncthreads();
  pro.row(xr);

  // the prologue of this thread's 8 raw values of slab s (its own copies:
  // visible to it once its groups have landed) into A slab `buf`,
  // transposed
  auto store_a = [&](int buf, int s) {
    const int k0 = k_lo + s * kBK + xk;
    const T* src = xraw + (s % kStages) * kXSlab + xr * kBK + xk;
    float* dst = as + buf * kASlab + xk * kBM + xr;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j * kBM] = row_ok && k0 + j < k_hi ? pro(to_f(src[j]), k0 + j)
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
        epi(r, c, make_float4(acc[i][4 * q + 0], acc[i][4 * q + 1],
                              acc[i][4 * q + 2], acc[i][4 * q + 3]));
      }
    }
    return;
  }

  // The depth split over the cluster: each rank's partial into its shared
  // memory (the drained W ring and A slabs), then rank q sums its slice of
  // the tile's float4s over the ranks in order.  The first barrier also
  // orders every peer's start before the reads.
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
    epi(r, c, s);
  }
  cluster.sync();   // no block leaves while a peer still reads its partial
}

// Launch `kernel` over (cols / kBN tiles x cluster, n / kBM tiles) blocks,
// the `cluster` blocks of a tile a thread-block cluster splitting its
// depth, with `smem` bytes of dynamic shared memory each.
template <typename Kernel, typename... Args>
inline cudaError_t launch(Kernel kernel, int n, int cols, int cluster,
                          size_t smem, void* stream, Args... args) {
  cudaError_t err = ptt::allow_smem(kernel, smem);
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
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace ptt_tiled
