// Decode attention against a fixed-capacity KV cache: for each (batch, head)
// and each of the sq query rows,
//   out[i] = sum_{j < n} p_ij v_j / l_i,  p_ij = exp(s_ij - m_i),
//   s_ij = (q_i . k_j) * scale,  l_i = sum_j p_ij,
// where n, the number of cache positions that hold real entries, is read
// from device memory and clamped to [0, L].  No mask inside the query block
// (as in the TPU kernel); a length of 0 gives zeros.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_decode_kernel` (launched by
// `flash_attention_kvcache`), the single-token attention of every decoder
// layer in `GPTForCausalLM.generate`, unfused (`use_pallas_attention`) and
// fused (`fused_attention_block_kvcache`).
//
// What bounds it on the H100: bytes.  Every (batch, head) reads n rows of K
// and V once (2 x n x D x 2 B in bf16) and does 4 FLOPs per pair of cache
// elements; at the generate shape (B*H = 96, D = 64, n ~ 576) that is 14 MB,
// 4.2 us at 3.35 TB/s.  With sq <= 2 query rows this is a matrix-vector
// product: the tensor cores would idle on it, so the kernel is SIMT and its
// design is about keeping enough bytes in flight on every SM.
//
// Design.  The TPU kernel's trip count came from a traced scalar, so one
// compiled program served every position; here the length is read from a
// device int32, so one CUDA graph of the decode step serves every position.
// The cache of one (batch*head, query row) is split across a thread-block
// cluster of `splits` blocks, block rank r taking positions [r chunk,
// (r + 1) chunk).  The split depends on the capacity alone (at most
// kMaxSplits blocks, and at least kMinChunk positions a block), never on
// the length, so the captured launch fits every length: at the generate
// shape (L = 640) 4 blocks of 160 positions, 384 blocks for 132 SMs.
// Inside a block, a cache row is read by W lanes (W = the row's 16-byte
// vectors, rounded up to a power of two, at most 32: 8 at D = 64 in bf16),
// so a warp reads 32 / W consecutive rows with coalesced 16-byte loads;
// lane c keeps the q slice of its vectors in registers, the row's score is
// reduced over its W lanes by shuffles, and the same lane then multiplies
// the same slice of the value row.  Each row group takes every G-th row of
// the block's range (G = row groups of the block) and issues the K and V
// loads of kUnroll rows before it uses any of them, then updates its own
// online softmax (m, l and a float32 accumulator of its slice).  The loads
// are streaming (evict-first): the cache is read once a step, and its
// lines should not push out what L2 holds for the rest of the step.  The
// row groups of a warp are combined by shuffles, and every warp pushes its
// state into block rank 0's shared memory through distributed shared
// memory.  A block's shared memory may be written by a peer only once the
// block has started, so every block arrives on the cluster barrier (relaxed)
// as it starts and waits on it just before its first remote store, by when
// every peer has long arrived.  After a second cluster barrier, which makes
// the pushed states visible, rank 0 combines them in a fixed order and the
// other blocks leave.  A block whose range starts at or past the length
// reads nothing and pushes (m = -inf, l = 0); every block passes both
// barriers.  One launch, no atomics: the same inputs give the same bits on
// every launch and replay.
// Rounding follows the TPU kernel: the score is scaled after the float32
// product, l sums the unrounded p and is clamped at 1e-30, p is rounded to
// the cache dtype before P.V (each row group against its own running max;
// the combine rescales by exp(m_w - m), so the relative rounding stays
// 2^-9).  q and the cache each take float32 or bf16; accumulation is
// float32; the output takes q's dtype.
#include <cooperative_groups.h>

#include "decode.cuh"

namespace cg = cooperative_groups;
using namespace ptt_decode;

namespace {

// Chosen by `python -m paddle_tpu_torch.sweep_decode`, which builds this
// file with each constant varied and times it at the generate shape (its
// rows are in PERF.md, section 6): 4 blocks of 4 warps per (batch*head,
// query row), 5 rows per row group in flight.
constexpr int kWarps = 4;
constexpr int kUnroll = 5;         // rows of a row group in flight at once
constexpr int kMaxHeadDim = 256;
constexpr int kMaxSplits = 4;      // blocks per cluster at most
constexpr int kMinChunk = 64;      // cache positions a block takes at least

// The splits of a cache of `cap` positions and the positions of each.
__host__ __device__ __forceinline__ int splits_for(int cap) {
  const int s = cap / kMinChunk;
  return s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s);
}

// NVP: the 16-byte vectors of a head row (D / E of them), rounded up to a
// power of two; vectors at or past nv = D / E are skipped.  Launched as
// clusters of `splits` blocks along x: grid (bh * splits, sq).
template <typename QT, typename KT, int NVP>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const int* __restrict__ len_ptr,
                    QT* __restrict__ out, int sq, int cap, int d, int chunk,
                    float scale) {
  constexpr int E = Vec<KT>::kElems;       // elements per 16-byte vector
  constexpr int W = NVP < 32 ? NVP : 32;   // lanes per cache row
  constexpr int R = 32 / W;                // rows per warp step
  constexpr int G = kWarps * R;            // row groups of the block
  constexpr int VPL = NVP / W;             // vectors per lane
  constexpr int DP = NVP * E;              // the padded head dimension
  // rank 0's: the softmax state of every warp of the cluster, pushed by
  // the warps through distributed shared memory
  __shared__ __align__(16) float sacc[kMaxSplits * kWarps][DP];
  __shared__ float sm[kMaxSplits * kWarps];
  __shared__ float sl[kMaxSplits * kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / splits;
  const int row = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane / W;
  const int c = lane % W;
  const int nv = d / E;
  const int64_t qo = (static_cast<int64_t>(bh) * sq + row) * d;
  // this block has started: peers may write its shared memory once they
  // have waited on this phase (relaxed, it orders no memory access)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int len = min(max(__ldg(len_ptr), 0), cap);
  float qv[VPL][E];                        // q over this lane's vectors
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int vec = c + u * W;
    load_q<QT, E>(q + qo + vec * E, vec < nv, qv[u]);
  }

  const int hi = min((rank + 1) * chunk, len);
  const KT* kb = k + static_cast<int64_t>(bh) * cap * d;
  const KT* vb = v + static_cast<int64_t>(bh) * cap * d;

  float acc[VPL][E];
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[u][e] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // warp-uniform trip count: row group r of warp w takes rows
  // base + r + i G, i < kUnroll
  for (int base = rank * chunk + warp * R; base < hi; base += G * kUnroll) {
    uint4 kr[kUnroll][VPL], vr[kUnroll][VPL];
    bool valid[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int pos = base + r + i * G;
      valid[i] = pos < hi;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int vec = c + u * W;
        const int64_t o = static_cast<int64_t>(pos) * d + vec * E;
        const bool ok = valid[i] && vec < nv;
        kr[i][u] = ok ? __ldcs(reinterpret_cast<const uint4*>(kb + o))
                      : make_uint4(0, 0, 0, 0);
        vr[i][u] = ok ? __ldcs(reinterpret_cast<const uint4*>(vb + o))
                      : make_uint4(0, 0, 0, 0);
      }
    }
    online_step<KT, W, VPL, kUnroll>(kr, vr, valid, qv, scale, m, l, acc);
  }
  cluster_combine<kWarps, W, VPL, E, DP>(m, l, acc, sacc, sm, sl, out + qo,
                                         d);
}

template <typename QT, typename KT, int NVP>
int launch(const void* q, const void* k, const void* v, const int* len,
           void* out, int bh, int sq, int cap, int d, float scale,
           cudaStream_t stream) {
  const int splits = splits_for(cap);
  const int chunk = (cap + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh * splits, sq);
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
      &cfg, flash_decode_kernel<QT, KT, NVP>, static_cast<const QT*>(q),
      static_cast<const KT*>(k), static_cast<const KT*>(v), len,
      static_cast<QT*>(out), sq, cap, d, chunk, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int dispatch(const void* q, const void* k, const void* v, const int* len,
             void* out, int bh, int sq, int cap, int d, float scale,
             cudaStream_t s) {
  constexpr int E = Vec<KT>::kElems;
  const int nv = d / E;
  if (nv <= 2) return launch<QT, KT, 2>(q, k, v, len, out, bh, sq, cap, d,
                                        scale, s);
  if (nv <= 4) return launch<QT, KT, 4>(q, k, v, len, out, bh, sq, cap, d,
                                        scale, s);
  if (nv <= 8) return launch<QT, KT, 8>(q, k, v, len, out, bh, sq, cap, d,
                                        scale, s);
  if (nv <= 16) return launch<QT, KT, 16>(q, k, v, len, out, bh, sq, cap, d,
                                          scale, s);
  if constexpr (E == 8) {                  // bf16: d <= 256 is 32 vectors
    return launch<QT, KT, 32>(q, k, v, len, out, bh, sq, cap, d, scale, s);
  } else {
    if (nv <= 32) return launch<QT, KT, 32>(q, k, v, len, out, bh, sq, cap,
                                            d, scale, s);
    return launch<QT, KT, 64>(q, k, v, len, out, bh, sq, cap, d, scale, s);
  }
}

}  // namespace

// The cluster split of a cache of `cap` positions: the blocks per (batch
// * head, query row) and the positions each takes (the last may take
// fewer).  It depends on the capacity alone.
PTT_EXPORT int ptt_flash_decode_split(int cap, int* splits, int* chunk) {
  *splits = splits_for(cap);
  *chunk = (cap + *splits - 1) / *splits;
  return 0;
}

// q (bh, sq, d) and out in q's dtype; k / v (bh, cap, d) in the cache dtype;
// len one int32 on the device.  d a multiple of 8 in [16, 256]; every
// pointer 16-byte aligned (the caller checks).
PTT_EXPORT int ptt_flash_decode(const void* q, int q_bf16, const void* k,
                                const void* v, int kv_bf16, const int* len,
                                void* out, int bh, int sq, int cap, int d,
                                float scale, void* stream) {
  if (d % 8 != 0 || d < 16 || d > kMaxHeadDim || sq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16) {
    return dispatch<__nv_bfloat16, __nv_bfloat16>(q, k, v, len, out, bh, sq,
                                                  cap, d, scale, s);
  }
  if (q_bf16) {
    return dispatch<__nv_bfloat16, float>(q, k, v, len, out, bh, sq, cap, d,
                                          scale, s);
  }
  if (kv_bf16) {
    return dispatch<float, __nv_bfloat16>(q, k, v, len, out, bh, sq, cap, d,
                                          scale, s);
  }
  return dispatch<float, float>(q, k, v, len, out, bh, sq, cap, d, scale, s);
}
