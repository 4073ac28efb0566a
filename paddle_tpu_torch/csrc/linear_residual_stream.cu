// K2 for float32 weights at a few rows (decode): GEMM with a dropout +
// residual epilogue,
//   out = r + drop(x @ W + b),
// stored in r's dtype.
//
// Replaces: paddle_tpu/ops/fused_block.py `_linear_residual_kernel`
// (launched by `_linear_residual_pallas`) for the calls that
// `linear_residual_route` sends here: a float32 W and at most
// `_STREAM_MAX_ROWS` rows (the attention out-projection of serving's and
// generate's decode steps, x the float32 attention output, r the bf16
// residual).  drop is the counter-hash dropout of the JAX kernel over the
// global (row, col), salted by the caller (`_SALT_RESID`).
//
// What bounds it on the H100: the 2.36 MB of W at GPT-125M (768 x 768),
// 0.7 us at 3.35 TB/s; the products (9.4 MFLOP at 8 rows) take 0.14 us.
// The SIMT kernel of linear_residual.cu ran 12 blocks at 8 rows, each
// streaming its column tile through one 8 KB slab at a time: ~34 GB/s.
//
// Design: W is cut into (depth x width) chunks, `width` columns (a multiple
// of 4, 32 or more where cols allows: rows of 128 bytes and more) by `depth`
// rows, about one chunk a block and one block an SM; the `cluster` blocks
// of a column tile form a thread-block cluster, rank q owning depth chunk q.
// A block puts its whole chunk in flight at once, a bulk copy of the copy
// engine (cp.async.bulk) a row (18 KB at GPT-125M: 128 rows x 36 columns),
// loads
// x's rows over its depth as float32 and fetches its epilogue's residual
// into L2 meanwhile, then each warp takes a quad of the tile's columns, its
// lanes walking the depth with 8 rows x 4 columns of sums each, summed
// across the lanes by a butterfly in a fixed order.  The cluster adds its
// ranks' (n, width) partials through distributed shared memory in rank
// order, each rank a slice of the tile's elements, and applies b, drop and
// r in float32 with one rounding to r's dtype: one kernel, no scratch, no
// atomics, so a call repeats bit for bit.
#include <cooperative_groups.h>

#include "common.cuh"
#include "stream.cuh"

namespace cg = cooperative_groups;
using ptt_stream::kRows;
using ptt_stream::kThreads;
using ptt_stream::kWarps;

namespace {

constexpr int kMaxCluster = 8;   // portable

__host__ __device__ inline int rows8(int n) {
  return (n + kRows - 1) / kRows * kRows;
}

__host__ __device__ inline size_t smem_floats(int n, int width, int depth) {
  return static_cast<size_t>(depth) * width                     // W
         + static_cast<size_t>(rows8(n)) * depth                // x
         + static_cast<size_t>(n) * width;                      // the partial
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
linear_residual_stream_kernel(const void* x, int x_bf16, const float* w,
                              const void* b, int b_bf16, const void* r,
                              int r_bf16, void* out, int n, int k, int cols,
                              int width, int depth, ptt::Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int n8 = rows8(n);
  float* ws = smem;                   // depth x width: W[k0 : +kd, c0 : +cw]
  float* xs = ws + depth * width;     // n8 x depth: x[:, k0 : k0 + kd]
  float* ps = xs + n8 * depth;        // n x width: the rank's partial
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int c0 = (blockIdx.x / csize) * width;
  const int k0 = crank * depth;
  const int kd = max(0, min(depth, k - k0));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quads = width / 4;

  // The chunk in flight at once, by the copy engine: a bulk copy a row of
  // its valid columns (a multiple of 4; the others' products are never
  // read), on one mbarrier.  Meanwhile x's rows over the rank's depth as
  // float32, and the residual and bias this rank's epilogue will read
  // fetched into L2.
  __shared__ __align__(8) uint64_t bar;
  const int cw = min(width, cols - c0);
  const int total = n * cw;
  const int span = (total + csize - 1) / csize;
  const int e_lo = crank * span;
  const int e_hi = min(total, e_lo + span);
  if (tid == 0) {
    ptt_stream::mbar_init(&bar);
    ptt_stream::mbar_fence_init();
    ptt_stream::mbar_expect(&bar, kd * cw * 4);
  }
  __syncthreads();   // the bytes expected before any can land
  for (int kk = tid; kk < kd; kk += kThreads)
    ptt_stream::bulk_copy(ws + kk * width,
                          w + static_cast<int64_t>(k0 + kk) * cols + c0,
                          cw * 4, &bar);
  if (e_hi > e_lo) {
    const char* rb = static_cast<const char*>(r);
    for (int rr = e_lo / cw + tid; rr <= (e_hi - 1) / cw; rr += kThreads)
      ptt_stream::prefetch_l2(
          rb + (static_cast<int64_t>(rr) * cols + c0) * (r_bf16 ? 2 : 4));
    if (tid == 0)
      ptt_stream::prefetch_l2(static_cast<const char*>(b) +
                              c0 * (b_bf16 ? 2 : 4));
  }
  for (int i = tid; i < n8 * kd; i += kThreads) {
    const int rr = i / kd;
    const int kk = i % kd;
    xs[rr * depth + kk] =
        rr < n ? ptt::ld(x, static_cast<int64_t>(rr) * k + k0 + kk, x_bf16)
               : 0.f;
  }
  __syncthreads();
  ptt_stream::mbar_wait(&bar);

  for (int row0 = 0; row0 < n; row0 += kRows) {
    for (int q = warp; q < quads; q += kWarps) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      ptt_stream::quad_products(xs + row0 * depth, depth, ws + 4 * q, width,
                                0, kd, acc);
      const float v = ptt_stream::lane_sums(acc);
      const int rr = row0 + lane / 4;
      if (rr < n) ps[rr * width + 4 * q + lane % 4] = v;
    }
  }

  // The cluster's sum, rank q over its slice of the tile's elements, the
  // ranks in order; the first barrier also orders every peer's start
  // before the reads.
  cluster.sync();
  for (int e = e_lo + tid; e < e_hi; e += kThreads) {
    const int rr = e / cw;
    const int c = e % cw;
    float v[kMaxCluster];   // every rank's load in flight, then the sum
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < csize) v[q] = cluster.map_shared_rank(ps, q)[rr * width + c];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < csize) s += v[q];
    float y = s + ptt::ld(b, c0 + c, b_bf16);
    if (kDrop) y = drop(y, rr, c0 + c);
    const int64_t o = static_cast<int64_t>(rr) * cols + c0 + c;
    ptt::st(out, o, ptt::ld(r, o, r_bf16) + y, r_bf16);
  }
  cluster.sync();   // no block leaves while a peer still reads its partial
}

}  // namespace

// Dynamic shared memory a block takes for n rows, `width` columns and
// `depth` rows of W.
PTT_EXPORT size_t ptt_linear_residual_stream_smem(int n, int width,
                                                  int depth) {
  return sizeof(float) * smem_floats(n, width, depth);
}

// tiles x cluster blocks: column tiles of `width` (a multiple of 4) by
// `cluster` depth chunks of `depth` rows.  Dropout p > 0 takes the
// instantiation with it (seed, salt, keep_div = 1 - p rounded to float32
// on the host).
PTT_EXPORT int ptt_linear_residual_stream(const void* x, int x_bf16,
                                          const float* w, const void* b,
                                          int b_bf16, const void* r,
                                          int r_bf16, void* out, int n, int k,
                                          int cols, int width, int depth,
                                          int cluster, unsigned seed,
                                          unsigned salt, float p,
                                          float keep_div, void* stream) {
  if (n <= 0 || cols % 4 || width % 4 || width <= 0 || depth <= 0 ||
      cluster < 1 || cluster > kMaxCluster ||
      static_cast<int64_t>(cluster) * depth < k ||
      !ptt_stream::aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ptt_linear_residual_stream_smem(n, width, depth);
  auto kernel = p > 0.f ? linear_residual_stream_kernel<true>
                        : linear_residual_stream_kernel<false>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (cols + width - 1) / width;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(tiles * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, x_bf16, w, b, b_bf16, r,
                           r_bf16, out, n, k, cols, width, depth,
                           ptt::Dropout{seed, salt, p, keep_div});
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
