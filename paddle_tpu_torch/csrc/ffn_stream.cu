// K3 for float32 weights at a few rows (decode): the FFN half of a pre-LN
// decoder block,
//   out = x + drop2(drop1(act(LN(x) @ W1 + b1)) @ W2 + b2),
// act = exact gelu or relu, stored in x's dtype.
//
// Replaces: paddle_tpu/ops/fused_block.py `_ffn_kernel` (launched by
// `_ffn_pallas`) for the calls that `ffn_route` sends here: float32 W1 and
// W2 and at most `_FFN_STREAM_MAX_ROWS` rows (serving's and generate's
// decode steps).  drop1 is the counter-hash dropout of the JAX kernel over the
// global (row, ffn column) of the activation (salt `_SALT_FFN1`); drop2,
// over the global (row, column) of the finished sum + b2, is applied by
// ffn.cu's finalize kernel, which the wrapper launches after this one.
//
// What bounds it on the H100: the 18.9 MB of W1 and W2 at GPT-125M (h =
// 768, ffn = 3072), 5.6 us at 3.35 TB/s; the products (75 MFLOP at 8 rows)
// take ~1.1 us of the CUDA cores' 67 TFLOP/s.  So the kernel has one job:
// keep HBM busy.  The SIMT kernel of ffn.cu ran 48 blocks at 8 rows, each
// with one 8 KB slab in flight between two barriers: ~160 GB/s.
//
// Design: the ffn columns are dealt `per` (a multiple of 4, at most 32) to
// a block, about one block per SM, in thread-block clusters of `cluster`
// blocks.  A block owns W1's columns and W2's rows of its ffn slice, so its
// first product needs no reduction: per = 24-28 at GPT-125M is 147-172 KB
// of W1 and W2, and the block puts all of that share in flight by bulk
// copies of the copy engine (cp.async.bulk) completing on eight mbarriers:
// a copy a W1 row, in four stages along h, then, once W1's first stage has
// landed, W2's contiguous rows in four copies (W1 is needed first).  LN(x)
// of up to 8 rows is computed while the bytes arrive.  Each warp owns one
// quad of the block's ffn columns; its lanes walk h, each keeping 8 rows x
// 4 columns of sums, and a butterfly across the lanes leaves each lane one
// finished (row, column): + b1, act, drop1, into shared memory.  Then every
// thread owns a quad of the h output columns and multiplies the activation
// by W2's rows stage by stage as they land.  The (8, h) partials of a
// cluster are summed through distributed shared memory, rank q summing
// column slice q over the ranks in rank order, and each cluster stores one
// float32 (rows, h) partial to the scratch, which ffn.cu's finalize kernel
// sums in a fixed order before b2, drop2 and x.  Blocks of more than 8
// rows walk them 8 at a time with W resident.
//
// What builds of other designs showed on the H100 (PERF.md, findings): one
// 16-byte cp.async a thread instead of the bulk copies ran as fast; W2
// issued with W1 instead of after its first stage ran slower; W1 as four
// tiles of a 2-d tensor map was slower still (the copy engine walks a
// tile's 112-byte rows no faster than separate copies, and x's loads then
// queue behind the whole share); LN(x) before the copies was no faster.
// Why not clusters that split W1's depth (W1 rows of 896 bytes, 8x fewer
// copies): a block that owns whole W1 columns needs no reduction before
// the activation, where that design adds a cluster barrier and a DSMEM
// pass like the two at this kernel's end (not built).
//
// No atomics: the lane, rank and group sums run in a fixed order, so a call
// repeats bit for bit.  The wrapper keeps the scratch under 5% of the
// weight bytes (groups * rows * 10 < ffn), which bounds the groups and so
// the rows a launch; it walks more rows in several launches.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "stream.cuh"

namespace cg = cooperative_groups;
using ptt_stream::kRows;
using ptt_stream::kThreads;

namespace {

constexpr int kStages1 = 4;   // stages (mbarriers) of W1, along h
constexpr int kStages2 = 4;   // stages of W2, along its rows
constexpr int kMaxPer = 4 * ptt_stream::kWarps;   // one quad a warp
constexpr int kMaxCluster = 8;                     // portable

__device__ __forceinline__ float activate(float v, int act) {
  // act 0: exact gelu, jax.nn.gelu(approximate=False); act 1: relu
  return act == 0 ? 0.5f * v * (1.f + erff(v * 0.70710678118654752f))
                  : fmaxf(v, 0.f);
}

constexpr int kMaxH = 4 * kThreads;   // a thread owns a quad of h

// LN of rows row0 .. row0 + 7 of x (width h) into dst as float32, one warp
// a row, in the order of the JAX kernels: mean, the mean of the squared
// deviations, rsqrt(var + eps), gain, bias.  Rows at or past `rows` are
// zero.  Not rounded: W1 is float32.
__device__ __forceinline__ void ln_rows8(const void* x, int x_bf16, int row0,
                                         int rows, int h, const void* g,
                                         int g_bf16, const void* beta,
                                         int beta_bf16, float eps,
                                         float* dst) {
  const int r = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* d = dst + r * h;
  if (r >= rows) {
    for (int c = lane; c < h; c += 32) d[c] = 0.f;
    return;
  }
  const int64_t xo = static_cast<int64_t>(row0 + r) * h;
  float sum = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float v = ptt::ld(x, xo + c, x_bf16);
    d[c] = v;
    sum += v;
  }
  const float mean = ptt::warp_sum(sum) / h;
  float sq = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float dv = d[c] - mean;
    sq += dv * dv;
  }
  const float rstd = rsqrtf(ptt::warp_sum(sq) / h + eps);
  for (int c = lane; c < h; c += 32)
    d[c] = (d[c] - mean) * rstd * ptt::ld(g, c, g_bf16) +
           ptt::ld(beta, c, beta_bf16);
}

__host__ __device__ inline size_t smem_floats(int h, int per) {
  return static_cast<size_t>(h) * per                             // W1
         + static_cast<size_t>(per) * h                           // W2
         + static_cast<size_t>(kRows) * h     // LN(x), then the partial
         + static_cast<size_t>(per) * kRows;  // the activation
}

// x: the launch's n rows (n <= the wrapper's rows a launch); part: groups x
// n x h floats; row_base: x's first row in the caller's tensor, for drop1.
template <bool kDrop1>
__global__ void __launch_bounds__(kThreads, 1)
ffn_stream_kernel(const void* x, int x_bf16, const float* w1, const void* b1,
                  int b1_bf16, const float* w2, const void* g, int g_bf16,
                  const void* beta, int beta_bf16, float* part, int n,
                  int row_base, int h, int ffn, int per, float eps, int act,
                  ptt::Dropout drop1) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                      // h x per: W1[:, f0 : f0 + per]
  float* w2s = w1s + h * per;             // per x h: W2[f0 : f0 + per, :]
  float* xs = w2s + per * h;              // kRows x h
  float* hs = xs + kRows * h;             // per x kRows, transposed
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int64_t group = blockIdx.x / csize;
  const int f0 = blockIdx.x * per;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quads = per / 4;
  const int h4 = h / 4;

  // The share in flight at once, by the copy engine: W1 in kStages1
  // stages along h (a bulk copy a row of its valid columns: the other
  // columns' products are masked), W2 in kStages2 stages of its contiguous
  // rows, issued once W1's first stage has landed (W1 is needed first, and
  // lands sooner without W2 beside it); W2's rows past ffn are zeroed.
  __shared__ __align__(8) uint64_t bars[kStages1 + kStages2];
  const int valid = max(0, min(per, ffn - f0));   // a multiple of 4
  const int box_rows = h / kStages1;
  if (tid == 0) {
    for (int s = 0; s < kStages1 + kStages2; ++s)
      ptt_stream::mbar_init(&bars[s]);
    ptt_stream::mbar_fence_init();
    for (int s = 0; s < kStages1; ++s)
      ptt_stream::mbar_expect(&bars[s], box_rows * valid * 4);
    for (int s = 0; s < kStages2; ++s)
      ptt_stream::mbar_expect(
          &bars[kStages1 + s],
          max(0, min((s + 1) * per / kStages2, valid) - s * per / kStages2) *
              h * 4);
  }
  __syncthreads();   // every stage's bytes expected before any can land
  if (valid > 0)
    for (int k = tid; k < h; k += kThreads)
      ptt_stream::bulk_copy(w1s + k * per,
                            w1 + static_cast<int64_t>(k) * ffn + f0,
                            valid * 4, &bars[k / box_rows]);
  for (int i = valid * h + tid; i < per * h; i += kThreads) w2s[i] = 0.f;

  for (int row0 = 0; row0 < n; row0 += kRows) {
    const int rows = min(kRows, n - row0);
    ln_rows8(x, x_bf16, row0, rows, h, g, g_bf16, beta, beta_bf16, eps, xs);
    __syncthreads();

    // h_tile = drop1(act(LN(x) @ W1[:, f0 : f0 + per] + b1)), W1's stages
    // as they land (the waits return at once after the first 8 rows)
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int s = 0; s < kStages1; ++s) {
      ptt_stream::mbar_wait(&bars[s]);
      if (s == 0 && row0 == 0 && tid == 0 && valid > 0) {
        for (int t = 0; t < kStages2; ++t) {
          const int r_lo = t * per / kStages2;
          const int r_hi = min((t + 1) * per / kStages2, valid);
          if (r_hi > r_lo)
            ptt_stream::bulk_copy(w2s + r_lo * h,
                                  w2 + static_cast<int64_t>(f0 + r_lo) * h,
                                  (r_hi - r_lo) * h * 4, &bars[kStages1 + t]);
        }
      }
      if (warp < quads)
        ptt_stream::quad_products(xs, h, w1s + 4 * warp, per,
                                  s * box_rows, (s + 1) * box_rows, acc);
    }
    if (warp < quads) {
      const float v = ptt_stream::lane_sums(acc);
      const int r = lane / 4;
      const int f = 4 * warp + lane % 4;
      float hv = 0.f;
      if (f0 + f < ffn) {
        hv = activate(v + ptt::ld(b1, f0 + f, b1_bf16), act);
        if (kDrop1) hv = drop1(hv, row_base + row0 + r, f0 + f);
      }
      hs[f * kRows + r] = hv;
    }
    __syncthreads();

    // partial = h_tile @ W2[f0 : f0 + per, :], a quad of columns a thread
    float acc2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc2[i] = 0.f;
    for (int s = 0; s < kStages2; ++s) {
      ptt_stream::mbar_wait(&bars[kStages1 + s]);
      if (tid < h4) {
        for (int f = s * per / kStages2; f < (s + 1) * per / kStages2;
             ++f) {
          const float4 wv =
              *reinterpret_cast<const float4*>(w2s + f * h + 4 * tid);
          const float4 a_lo = *reinterpret_cast<const float4*>(hs + f * kRows);
          const float4 a_hi =
              *reinterpret_cast<const float4*>(hs + f * kRows + 4);
          const float a[kRows] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                                  a_hi.x, a_hi.y, a_hi.z, a_hi.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc2[r * 4 + 0] = fmaf(a[r], wv.x, acc2[r * 4 + 0]);
            acc2[r * 4 + 1] = fmaf(a[r], wv.y, acc2[r * 4 + 1]);
            acc2[r * 4 + 2] = fmaf(a[r], wv.z, acc2[r * 4 + 2]);
            acc2[r * 4 + 3] = fmaf(a[r], wv.w, acc2[r * 4 + 3]);
          }
        }
      }
    }
    // every read of LN(x) is behind the barrier above: xs takes the
    // partial
    if (tid < h4) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        *reinterpret_cast<float4*>(xs + r * h + 4 * tid) =
            make_float4(acc2[r * 4 + 0], acc2[r * 4 + 1], acc2[r * 4 + 2],
                        acc2[r * 4 + 3]);
    }

    // The cluster's sum: rank q sums column quads [q * span, ...) of every
    // rank's partial through distributed shared memory, in rank order.
    // The first barrier also orders every peer's start before the reads.
    cluster.sync();
    const int span = (h4 + csize - 1) / csize;
    const int c_lo = crank * span;
    const int width = max(0, min(span, h4 - c_lo));
    for (int i = tid; i < rows * width; i += kThreads) {
      const int r = i / width;
      const int c = 4 * (c_lo + i % width);
      float4 v[kMaxCluster];   // every rank's load in flight, then the sum
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < csize)
          v[q] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(xs, q) + r * h + c);
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < csize) {
          sum.x += v[q].x;
          sum.y += v[q].y;
          sum.z += v[q].z;
          sum.w += v[q].w;
        }
      }
      *reinterpret_cast<float4*>(
          part + (group * n + row0 + r) * static_cast<int64_t>(h) + c) = sum;
    }
    // no block rewrites xs, or leaves, while a peer still reads it
    cluster.sync();
  }
}

using StreamKernel = decltype(&ffn_stream_kernel<false>);

}  // namespace

// Dynamic shared memory a block takes at width h with `per` ffn columns.
PTT_EXPORT size_t ptt_ffn_stream_smem(int h, int per) {
  return sizeof(float) * smem_floats(h, per);
}

// How many clusters of `cluster` blocks, one block an SM (the most shared
// memory a block may have), the card holds at once; into *clusters.
PTT_EXPORT int ptt_ffn_stream_resident(int cluster, int* clusters) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  StreamKernel kernel = ffn_stream_kernel<false>;
  cudaFuncAttributes attrs;
  err = cudaFuncGetAttributes(&attrs, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  smem_max -= static_cast<int>(attrs.sharedSizeBytes);   // the mbarriers
  err = ptt::allow_smem(kernel, smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_max;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  *clusters = 0;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();   // a size the card refuses holds no cluster
    *clusters = 0;
  }
  return static_cast<int>(cudaGetLastError());
}

// The main kernel over n rows (n > 0) of x: groups x cluster blocks of
// `per` ffn columns each, writing groups x n x h float32 partials to
// `part`.  drop1 with p1 > 0 takes the instantiation with it (one seed,
// salt1, keep_div1 = 1 - p1 rounded to float32 on the host).  ffn.cu's
// ptt_ffn_finalize then adds the groups, b2, drop2 and x.
PTT_EXPORT int ptt_ffn_stream(const void* x, int x_bf16, const float* w1,
                              const void* b1, int b1_bf16, const float* w2,
                              const void* g, int g_bf16, const void* beta,
                              int beta_bf16, float* part, int n, int row_base,
                              int h, int ffn, int per, int cluster,
                              int groups, float eps, int act, unsigned seed,
                              unsigned salt1, float p1, float keep_div1,
                              void* stream) {
  if (n <= 0 || h % 4 || ffn % 4 || per % 4 || per <= 0 || per > kMaxPer ||
      kMaxH < h || cluster < 1 || cluster > kMaxCluster ||
      groups < 1 || static_cast<int64_t>(groups) * cluster * per < ffn ||
      !ptt_stream::aligned16(w1) || !ptt_stream::aligned16(w2) ||
      !ptt_stream::aligned16(part))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ptt_ffn_stream_smem(h, per);
  StreamKernel kernel =
      p1 > 0.f ? ffn_stream_kernel<true> : ffn_stream_kernel<false>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(groups * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, x_bf16, w1, b1, b1_bf16, w2, g,
                           g_bf16, beta, beta_bf16, part, n, row_base, h, ffn,
                           per, eps, act,
                           ptt::Dropout{seed, salt1, p1, keep_div1});
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
