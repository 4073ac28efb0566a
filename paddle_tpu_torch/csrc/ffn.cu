// K3: the FFN half of a pre-LN decoder block in one pass over the ffn width,
//   out = x + drop2(drop1(act(LN(x) @ W1 + b1)) @ W2 + b2),
// act = exact gelu or relu, stored in x's dtype.
//
// Replaces: paddle_tpu/ops/fused_block.py `_ffn_kernel` (launched by
// `_ffn_pallas`).  drop1 and drop2 are the counter-hash dropouts of the JAX
// kernel (`keep` in common.cuh, salts `_SALT_FFN1` and `_SALT_FFN2`, one
// seed): drop1 over the global (row, ffn column) of the activation, before
// its rounding to W2's dtype; drop2 over the global (row, column) of the
// finished sum + b2, never over a partial sum.  A kept value is divided by
// the float32 1 - p, a dropped one is 0.  Serving and generate run it with
// dropout 0, the training path with drop2 only.  drop1 is a template
// argument of the main kernel.  drop2 lives in the finalize kernel alone:
// with drop2 on, even one group stores its float32 sum and the finalize
// kernel adds b2, drops and adds x.  In the main kernel's epilogue drop2
// slowed K3 at the training shape by 13% (the compiler scheduled the main
// loop differently); the float32 (N, h) round trip costs far less
// (PERF.md, the kernel table).
//
// What bounds it on the H100: at decode (8 rows, h = 768, ffn = 3072) the
// 18.9 MB of float32 W1 and W2, so bytes; at a 512-row prefill bucket
// 4.8 GFLOP of float32 products on the CUDA cores, so operations.
//
// Design: a block owns a 16-row tile.  It computes LN(x) once into shared
// memory and keeps a float32 (16, h) accumulator there too (2 x 48 KB at
// h = 768, above the default 48 KB, so the launch opts in).  It walks its
// ffn tiles of 64: h_tile = act(LN(x) @ W1[:, tile] + b1[tile]) lives only
// in shared memory, then acc += h_tile @ W2[tile, :].  The (N, ffn)
// intermediate never reaches device memory.
//
// On the TPU the ffn tiles were a sequential grid axis accumulating into one
// scratch; here a single block per row tile would leave a decode call on one
// SM, so the ffn tiles are dealt round-robin to `groups x cluster` blocks per
// row tile.  The `cluster` blocks of a group form a thread-block cluster and
// add their accumulators through distributed shared memory: block rank q of
// the cluster sums column slice q over the ranks in a fixed order.  With one
// group (GPT-125M on the H100: prefill buckets of 256 rows and more) and
// drop2 off it adds b2 and the residual and stores the output directly:
// nothing but x, the weights and out touches device memory.  With more
// groups (decode), or with drop2, each group stores its float32 (N, h) sum
// to a scratch and a second small kernel adds the groups in a fixed order,
// then b2, drop2 and the residual.  The wrapper keeps groups * h < ffn, so
// that scratch is always smaller than the (N, ffn) float32 intermediate it
// stands in for (at decode, 3 groups: 74 KB written and read, against
// 18.9 MB of weights).  No atomics: results repeat exactly from run to run.
#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kFfnTile = ptt::kCols;   // ffn columns per tile
constexpr int kMaxCluster = 16;        // non-portable size; 8 is portable

__device__ __forceinline__ float activate(float v, int act) {
  // act 0: exact gelu, jax.nn.gelu(approximate=False); act 1: relu
  return act == 0 ? 0.5f * v * (1.f + erff(v * 0.70710678118654752f))
                  : fmaxf(v, 0.f);
}

// With `part` null the one group stores out = x + sum + b2; otherwise each
// group stores its sum to `part` for the finalize kernel.
template <bool kDrop1>
__global__ void __launch_bounds__(ptt::kThreads)
ffn_kernel(const void* x, int x_bf16, const void* w1, int w1_bf16,
           const void* b1, int b1_bf16, const void* w2, int w2_bf16,
           const void* b2, int b2_bf16, const void* g, int g_bf16,
           const void* beta, int beta_bf16, float* part, void* out, int n,
           int h, int ffn, float eps, int act, ptt::Dropout drop1) {
  extern __shared__ float smem[];
  float* lnx = smem;                                  // kRows x h
  float* acc = lnx + ptt::kRows * h;                  // kRows x h
  float* ht = acc + ptt::kRows * h;                   // kRows x kFfnTile
  float* slab = ht + ptt::kRows * kFfnTile;           // kDepth x kCols
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int splits = gridDim.y;                       // groups x csize
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ptt::kRows;
  const int rows = min(ptt::kRows, static_cast<int>(n - row0));
  const int tx = threadIdx.x % ptt::kCols;
  const int ty = threadIdx.x / ptt::kCols;

  ptt::ln_rows(x, x_bf16, row0, rows, h, g, g_bf16, beta, beta_bf16, eps,
               w1_bf16, lnx);
  // each thread owns the accumulator cells (ty*4+i, c0+tx) for every c0
  for (int c0 = 0; c0 < h; c0 += ptt::kCols) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c0 + tx < h) acc[(ty * 4 + i) * h + c0 + tx] = 0.f;
  }
  __syncthreads();

  const int tiles = (ffn + kFfnTile - 1) / kFfnTile;
  for (int t = blockIdx.y; t < tiles; t += splits) {
    const int f0 = t * kFfnTile;
    // h_tile = drop1(act(LN(x) @ W1[:, f0:f0+64] + b1)), rounded to W2's
    // dtype as the TPU kernel casts it before the second product
    float a1[4] = {0.f, 0.f, 0.f, 0.f};
    ptt::tile_gemm(lnx, h, w1, w1_bf16, ffn, 0, h, f0, ffn, slab, a1);
    const int f = f0 + tx;
    const float bias1 = f < ffn ? ptt::ld(b1, f, b1_bf16) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = activate(a1[i] + bias1, act);
      if (kDrop1) v = drop1(v, row0 + ty * 4 + i, f);
      ht[(ty * 4 + i) * kFfnTile + tx] =
          f < ffn ? ptt::round_to(v, w2_bf16) : 0.f;
    }
    __syncthreads();
    // acc += h_tile @ W2[f0:f0+64, :]
    const int depth = min(kFfnTile, ffn - f0);
    for (int c0 = 0; c0 < h; c0 += ptt::kCols) {
      float a2[4] = {0.f, 0.f, 0.f, 0.f};
      ptt::tile_gemm(ht, kFfnTile, w2, w2_bf16, h, f0, depth, c0, h, slab,
                     a2);
      if (c0 + tx < h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[(ty * 4 + i) * h + c0 + tx] += a2[i];
      }
    }
  }

  // The cluster's sum: rank q reads column slice q of every peer's
  // accumulator through distributed shared memory, in rank order.
  cluster.sync();
  const int span = (h + csize - 1) / csize;
  const int c_lo = crank * span;
  const int width = max(0, min(span, h - c_lo));
  const int64_t group = blockIdx.y / csize;
  const bool last = part == nullptr;
  for (int i = threadIdx.x; i < rows * width; i += ptt::kThreads) {
    const int r = i / width;
    const int c = c_lo + i % width;
    float s = 0.f;
    for (int q = 0; q < csize; ++q)
      s += cluster.map_shared_rank(acc, q)[r * h + c];
    const int64_t o = (row0 + r) * h + c;
    if (last) {
      ptt::st(out, o, ptt::ld(x, o, x_bf16) + (s + ptt::ld(b2, c, b2_bf16)),
              x_bf16);
    } else {
      part[group * n * h + o] = s;
    }
  }
  cluster.sync();   // no block leaves while a peer still reads its smem
}

// out = x + drop2(sum over groups of the partials + b2), the groups summed
// in a fixed order; drop2's row is row0 + the row in `part`.  It finishes
// every K3 route: this file's kernel, the tensor-core kernel of ffn_mma.cu
// and the weight-streaming kernel of ffn_stream.cu (those two through
// ptt_ffn_finalize).
template <bool kDrop2>
__global__ void ffn_finalize_kernel(const float* part, int groups,
                                    const void* x, int x_bf16, const void* b2,
                                    int b2_bf16, void* out, int n, int h,
                                    int row0, ptt::Dropout drop2) {
  const int64_t total = static_cast<int64_t>(n) * h;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int gi = 0; gi < groups; ++gi) s += part[gi * total + i];
    float y = s + ptt::ld(b2, i % h, b2_bf16);
    if (kDrop2) y = drop2(y, row0 + i / h, static_cast<int>(i % h));
    ptt::st(out, i, ptt::ld(x, i, x_bf16) + y, x_bf16);
  }
}

cudaLaunchConfig_t launch_config(dim3 grid, size_t smem, int cluster,
                                 cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(ptt::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = cluster;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t finalize(const float* part, int groups, const void* x,
                     int x_bf16, const void* b2, int b2_bf16, void* out,
                     int n, int h, int row0, const ptt::Dropout& drop2,
                     cudaStream_t s) {
  const int64_t total = static_cast<int64_t>(n) * h;
  const int blocks =
      static_cast<int>(std::min<int64_t>((total + 255) / 256, 4096));
  auto kernel = drop2.p > 0.f ? ffn_finalize_kernel<true>
                              : ffn_finalize_kernel<false>;
  kernel<<<blocks, 256, 0, s>>>(part, groups, x, x_bf16, b2, b2_bf16, out, n,
                                h, row0, drop2);
  return cudaGetLastError();
}

using FfnKernel = decltype(&ffn_kernel<false>);

cudaError_t prepare(FfnKernel kernel, size_t smem) {
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

PTT_EXPORT size_t ptt_ffn_smem(int h) {
  return sizeof(float) * (2 * static_cast<size_t>(ptt::kRows) * h +
                          ptt::kRows * kFfnTile + ptt::kDepth * ptt::kCols);
}

// The largest cluster (a power of two up to 16) whose blocks, with the
// shared memory that h needs, the card can hold at once; into *cluster.
// Asked of the dropout-free instantiation: the others take the same shared
// memory and threads.
PTT_EXPORT int ptt_ffn_max_cluster(int h, int* cluster) {
  const size_t smem = ptt_ffn_smem(h);
  FfnKernel kernel = ffn_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *cluster = 1;
  for (int c = kMaxCluster; c > 1; c >>= 1) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(dim3(1, c), smem, c, 0, &attr);
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) ==
            cudaSuccess &&
        active > 0) {
      *cluster = c;
      break;
    }
    cudaGetLastError();   // a size the card refuses is not an error here
  }
  return static_cast<int>(cudaGetLastError());
}

// `part` holds groups x n x h floats; it must be given when groups > 1 or
// p2 > 0, and is null otherwise.  Dropout p1 > 0 takes the instantiation
// with drop1, p2 > 0 the finalize kernel's with drop2 (one seed, salts
// salt1 / salt2, keep_div = 1 - p rounded to float32 on the host).
PTT_EXPORT int ptt_ffn(const void* x, int x_bf16, const void* w1,
                       int w1_bf16, const void* b1, int b1_bf16,
                       const void* w2, int w2_bf16, const void* b2,
                       int b2_bf16, const void* g, int g_bf16,
                       const void* beta, int beta_bf16, float* part,
                       void* out, int n, int h, int ffn, float eps, int act,
                       int groups, int cluster, unsigned seed,
                       unsigned salt1, float p1, float keep_div1,
                       unsigned salt2, float p2, float keep_div2,
                       void* stream) {
  const size_t smem = ptt_ffn_smem(h);
  const ptt::Dropout drop1{seed, salt1, p1, keep_div1};
  const ptt::Dropout drop2{seed, salt2, p2, keep_div2};
  if ((groups > 1 || p2 > 0.f) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  FfnKernel kernel = p1 > 0.f ? ffn_kernel<true> : ffn_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  const dim3 grid((n + ptt::kRows - 1) / ptt::kRows, groups * cluster);
  cudaLaunchConfig_t cfg = launch_config(grid, smem, cluster, s, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, x, x_bf16, w1, w1_bf16, b1,
                           b1_bf16, w2, w2_bf16, b2, b2_bf16, g, g_bf16, beta,
                           beta_bf16, part, out, n, h, ffn, eps, act, drop1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  return static_cast<int>(
      finalize(part, groups, x, x_bf16, b2, b2_bf16, out, n, h, 0, drop2, s));
}

// The finalize kernel alone, for the tensor-core K3 (ffn_mma.cu) and the
// weight-streaming K3 (ffn_stream.cu), whose main kernels stored groups x n
// x h float32 sums to `part`: out = x + drop2(the groups' sum + b2),
// dropout2 as in ptt_ffn over rows row0 .. row0 + n - 1 of the caller's
// tensor (x and out point at row row0).
PTT_EXPORT int ptt_ffn_finalize(const float* part, int groups, const void* x,
                                int x_bf16, const void* b2, int b2_bf16,
                                void* out, int n, int h, int row0,
                                unsigned seed, unsigned salt2, float p2,
                                float keep_div2, void* stream) {
  if (part == nullptr || groups < 1 || n <= 0 || h <= 0 || row0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(finalize(part, groups, x, x_bf16, b2, b2_bf16,
                                   out, n, h, row0,
                                   ptt::Dropout{seed, salt2, p2, keep_div2},
                                   static_cast<cudaStream_t>(stream)));
}
