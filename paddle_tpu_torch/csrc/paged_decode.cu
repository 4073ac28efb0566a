// Ragged paged-attention decode: one query token per sequence against its
// KV context, gathered through a block table and cut at seq_lens[b],
//   out[b, h] = softmax(q[b, h] . K[b, :, h]^T * scale) . V[b, :, h].
//
// Replaces: paddle_tpu/inference/paged_attention.py `_paged_decode_kernel`
// (launched by `paged_attention_pallas`), the decode attention of every
// decoder layer in the serving engine.
//
// What bounds it on the H100: bytes.  Each (row, head) reads its context's
// K and V once (bf16 pages, 2 x len x 64 x 2 B) and does 4 FLOPs per byte
// pair, far below the card's operations-per-byte balance.
//
// Design.  The TPU kernel took the block table and lengths by scalar
// prefetch and stepped a sequential grid axis over KV blocks.  Here the
// table range of one (row, head) is split across a thread-block cluster of
// `splits` blocks, block rank r taking table entries [r per, (r + 1) per).
// The split depends on the table width and the block size alone (at most
// kMaxSplits blocks, and at least kMinChunk positions a block), never on
// the lengths, so one launch shape (and one captured graph) fits every
// step: at the serving shape (64 entries of 16 positions) 4 blocks of 16
// entries, 8 x 12 x 4 = 384 blocks for 132 SMs.  A block copies its table
// entries into shared memory once per page (kTable entries at a time),
// cut at the row's length, so the page loads that follow depend on a
// shared-memory read, not on a global one per position.  A head row of a
// page is read by W lanes (W = the row's 16-byte vectors, rounded up to a
// power of two, at most 32: 8 at d = 64 in bf16), so a warp reads 32 / W
// positions with coalesced 16-byte loads; lane c keeps the q slice of its
// vectors in registers, the score is reduced over the W lanes by shuffles,
// and the same lane multiplies the same slice of the value row.  Each row
// group takes every G-th position of the block's range (G = row groups of
// the block) and issues the K and V loads of kUnroll positions before it
// uses any of them, then updates its own online softmax (m, l and a
// float32 accumulator of its slice).  The loads are streaming
// (evict-first): the pages are read once a step.  The row groups of a warp
// are combined by shuffles, and every warp pushes its state into block
// rank 0's shared memory through distributed shared memory.  A block's
// shared memory may be written by a peer only once the block has started,
// so every block arrives on the cluster barrier (relaxed) as it starts and
// waits on it just before its first remote store.  After a second cluster
// barrier, which makes the pushed states visible, rank 0 combines them in
// a fixed order and the other blocks leave.  A block whose range starts at
// or past the length reads nothing (not even its table entries) and pushes
// (m = -inf, l = 0); every block passes both barriers.  Only positions
// below the length are read, so the pad sentinel row of the pages and the
// unused table entries never are.  One launch, no atomics: the same inputs
// give the same bits on every launch.
// Rounding follows the TPU kernel: the score is scaled after the float32
// product, l sums the unrounded p and is clamped at 1e-30 (a row of length
// 0 gives zeros), p is rounded to the page dtype before P.V (each row group
// against its own running max; the combine rescales by exp(m_w - m), so the
// relative rounding stays 2^-9).  q and the pages each take float32 or
// bf16; accumulation is float32; the output takes q's dtype.
#include <cooperative_groups.h>

#include "decode.cuh"

namespace cg = cooperative_groups;
using namespace ptt_decode;

namespace {

// The decode kernel's constants (csrc/flash_decode.cu, chosen there by
// `python -m paddle_tpu_torch.sweep_decode`): 4 blocks of 4 warps per
// (row, head), 5 positions per row group in flight.
constexpr int kWarps = 4;
constexpr int kUnroll = 5;         // positions of a row group in flight
constexpr int kMaxHeadDim = 256;
constexpr int kMaxSplits = 4;      // blocks per cluster at most
constexpr int kMinChunk = 64;      // positions a block takes at least
constexpr int kTable = 64;         // table entries staged at a time

// The split of a table of `max_blocks` entries of `block_size` positions:
// `splits` blocks of `per` entries each (the last may take fewer, none
// takes 0).
void split_for(int max_blocks, int block_size, int* splits, int* per) {
  if (max_blocks <= 0) {
    *splits = 1;
    *per = 0;
    return;
  }
  const int64_t cap = static_cast<int64_t>(max_blocks) * block_size;
  int64_t s = cap / kMinChunk;
  s = s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s);
  *per = static_cast<int>((max_blocks + s - 1) / s);
  *splits = (max_blocks + *per - 1) / *per;
}

// NVP: the 16-byte vectors of a head row (D / E of them), rounded up to a
// power of two; vectors at or past nv = D / E are skipped.  Launched as
// clusters of `splits` blocks along x: grid (heads * splits, batch).
template <typename QT, typename KT, int NVP>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
                    const KT* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, QT* __restrict__ out,
                    int heads, int d, int max_blocks, int block_size,
                    int per, float scale) {
  constexpr int E = Vec<KT>::kElems;       // elements per 16-byte vector
  constexpr int W = NVP < 32 ? NVP : 32;   // lanes per head row
  constexpr int R = 32 / W;                // positions per warp step
  constexpr int G = kWarps * R;            // row groups of the block
  constexpr int VPL = NVP / W;             // vectors per lane
  constexpr int DP = NVP * E;              // the padded head dimension
  // rank 0's: the softmax state of every warp of the cluster, pushed by
  // the warps through distributed shared memory
  __shared__ __align__(16) float sacc[kMaxSplits * kWarps][DP];
  __shared__ float sm[kMaxSplits * kWarps];
  __shared__ float sl[kMaxSplits * kWarps];
  __shared__ int stab[kTable];             // this block's table entries

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / splits;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane / W;
  const int c = lane % W;
  const int nv = d / E;
  const int64_t qo = (static_cast<int64_t>(b) * heads + h) * d;
  // this block has started: peers may write its shared memory once they
  // have waited on this phase (relaxed, it orders no memory access)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int len = min(max(__ldg(seq_lens + b), 0), max_blocks * block_size);
  float qv[VPL][E];                        // q over this lane's vectors
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int vec = c + u * W;
    load_q<QT, E>(q + qo + vec * E, vec < nv, qv[u]);
  }

  const int* table = block_tables + static_cast<int64_t>(b) * max_blocks;
  const int64_t row_stride = static_cast<int64_t>(heads) * d;
  const KT* kb = k_pages + static_cast<int64_t>(h) * d;
  const KT* vb = v_pages + static_cast<int64_t>(h) * d;
  const int begin = rank * per * block_size;
  const int end = min(begin + per * block_size, len);

  float acc[VPL][E];
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[u][e] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // block-uniform trip count: a tile of kTable pages at a time
  for (int t0 = begin; t0 < end; t0 += kTable * block_size) {
    const int t1 = min(t0 + kTable * block_size, end);
    const int pages = (t1 - t0 + block_size - 1) / block_size;
    __syncthreads();                       // the last tile's reads are done
    const int* tt = table + t0 / block_size;
    for (int i = threadIdx.x; i < pages; i += blockDim.x)
      stab[i] = __ldg(tt + i);
    __syncthreads();
    // warp-uniform trip count: row group r of warp w takes positions
    // base + r + i G, i < kUnroll
    for (int base = t0 + warp * R; base < t1; base += G * kUnroll) {
      uint4 kr[kUnroll][VPL], vr[kUnroll][VPL];
      bool valid[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int pos = base + r + i * G;
        valid[i] = pos < t1;
        int64_t row = 0;
        if (valid[i]) {
          const int page = (pos - t0) / block_size;
          row = static_cast<int64_t>(stab[page]) * block_size +
                (pos - t0 - page * block_size);
        }
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int vec = c + u * W;
          const int64_t o = row * row_stride + vec * E;
          const bool ok = valid[i] && vec < nv;
          kr[i][u] = ok ? __ldcs(reinterpret_cast<const uint4*>(kb + o))
                        : make_uint4(0, 0, 0, 0);
          vr[i][u] = ok ? __ldcs(reinterpret_cast<const uint4*>(vb + o))
                        : make_uint4(0, 0, 0, 0);
        }
      }
      online_step<KT, W, VPL, kUnroll>(kr, vr, valid, qv, scale, m, l, acc);
    }
  }
  cluster_combine<kWarps, W, VPL, E, DP>(m, l, acc, sacc, sm, sl, out + qo,
                                         d);
}

template <typename QT, typename KT, int NVP>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* lens, void* out, int batch, int heads, int d,
           int max_blocks, int block_size, float scale, cudaStream_t stream) {
  int splits, per;
  split_for(max_blocks, block_size, &splits, &per);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads * splits, batch);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_decode_kernel<QT, KT, NVP>, static_cast<const QT*>(q),
      static_cast<const KT*>(k), static_cast<const KT*>(v), tables, lens,
      static_cast<QT*>(out), heads, d, max_blocks, block_size, per, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int dispatch(const void* q, const void* k, const void* v, const int* tables,
             const int* lens, void* out, int batch, int heads, int d,
             int max_blocks, int block_size, float scale, cudaStream_t s) {
  constexpr int E = Vec<KT>::kElems;
  const int nv = d / E;
#define PTT_PAGED_LAUNCH(NVP)                                              \
  return launch<QT, KT, NVP>(q, k, v, tables, lens, out, batch, heads, d, \
                             max_blocks, block_size, scale, s)
  if (nv <= 2) PTT_PAGED_LAUNCH(2);
  if (nv <= 4) PTT_PAGED_LAUNCH(4);
  if (nv <= 8) PTT_PAGED_LAUNCH(8);
  if (nv <= 16) PTT_PAGED_LAUNCH(16);
  if constexpr (E == 8) {                  // bf16: d <= 256 is 32 vectors
    PTT_PAGED_LAUNCH(32);
  } else {
    if (nv <= 32) PTT_PAGED_LAUNCH(32);
    PTT_PAGED_LAUNCH(64);
  }
#undef PTT_PAGED_LAUNCH
}

}  // namespace

// The cluster split of a block table `max_blocks` entries wide: the blocks
// per (row, head) and the table entries each takes (the last may take
// fewer).  It depends on the table width and the block size alone.
PTT_EXPORT int ptt_paged_decode_split(int max_blocks, int block_size,
                                      int* splits, int* per) {
  split_for(max_blocks, block_size, splits, per);
  return 0;
}

// q (batch, heads, d) and out in q's dtype; pages (slots + 1, heads, d) in
// the page dtype; tables (batch, max_blocks) and lens (batch,) int32 on the
// device.  d a multiple of 8 in [16, 256]; q and the pages 16-byte aligned
// (the caller checks).
PTT_EXPORT int ptt_paged_decode(const void* q, int q_bf16, const void* k,
                                const void* v, int kv_bf16, const int* tables,
                                const int* lens, void* out, int batch,
                                int heads, int d, int max_blocks,
                                int block_size, float scale, void* stream) {
  if (d % 8 != 0 || d < 16 || d > kMaxHeadDim || batch > 65535 ||
      block_size < 1 ||
      static_cast<int64_t>(max_blocks) * block_size > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16) {
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, tables, lens, out, batch, heads, d, max_blocks, block_size,
        scale, s);
  }
  if (q_bf16) {
    return dispatch<__nv_bfloat16, float>(q, k, v, tables, lens, out, batch,
                                          heads, d, max_blocks, block_size,
                                          scale, s);
  }
  if (kv_bf16) {
    return dispatch<float, __nv_bfloat16>(q, k, v, tables, lens, out, batch,
                                          heads, d, max_blocks, block_size,
                                          scale, s);
  }
  return dispatch<float, float>(q, k, v, tables, lens, out, batch, heads, d,
                                max_blocks, block_size, scale, s);
}
