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
// Design: one warp per (batch row, head).  The TPU kernel took the block
// table and lengths by scalar prefetch and stepped a sequential grid axis
// over KV blocks; here the warp reads its own table entries and loops over
// its context 32 positions at a time.  Lane j computes the score of position
// base + j over the whole head dimension (q sits in shared memory), the warp
// reduces the chunk's max and sum for the online softmax in float32, then
// every lane accumulates its d/32 output elements over the chunk's 32 value
// rows (lanes read one value row together, coalesced).  p is rounded to the
// page dtype before the PV product, as the TPU kernel does.  Only positions
// below seq_lens[b] are read, so the pad sentinel row of the pages never is;
// a row with length 0 writes zeros (the divide is guarded by 1e-30).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxHeadDim = 256;
constexpr int kPerLane = kMaxHeadDim / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(32)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
                    const KT* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, QT* __restrict__ out,
                    int heads, int head_dim, int max_blocks, int block_size,
                    float scale) {
  __shared__ float qs[kMaxHeadDim];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const int64_t qo = (static_cast<int64_t>(b) * heads + h) * head_dim;
  for (int i = lane; i < head_dim; i += 32) qs[i] = to_f(q[qo + i]);
  __syncwarp();

  const int len = seq_lens[b];
  const int* table = block_tables + static_cast<int64_t>(b) * max_blocks;
  const int64_t slot_stride = static_cast<int64_t>(heads) * head_dim;
  const int64_t head_off = static_cast<int64_t>(h) * head_dim;
  float acc[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) acc[e] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int base = 0; base < len; base += 32) {
    const int pos = base + lane;
    const bool valid = pos < len;
    int64_t slot = 0;
    float s = -INFINITY;
    if (valid) {
      slot = static_cast<int64_t>(table[pos / block_size]) * block_size +
             pos % block_size;
      const KT* krow = k_pages + slot * slot_stride + head_off;
      float dot = 0.f;
      for (int i = 0; i < head_dim; ++i) dot = fmaf(qs[i], to_f(krow[i]), dot);
      s = dot * scale;
    }
    // lane 0 is always valid inside the loop, so m_new is finite
    const float m_new = fmaxf(m, ptt::warp_max(s));
    const float p = valid ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + ptt::warp_sum(p);
    const float pv = to_f(from_f<KT>(p));   // p in the page dtype for PV
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[e] *= alpha;
    const int count = min(32, len - base);
    for (int j = 0; j < count; ++j) {
      const float pj = __shfl_sync(ptt::kFullMask, pv, j);
      const long long sj = __shfl_sync(ptt::kFullMask,
                                       static_cast<long long>(slot), j);
      const KT* vrow = v_pages + sj * slot_stride + head_off;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const int i = lane + 32 * e;
        if (i < head_dim) acc[e] = fmaf(pj, to_f(vrow[i]), acc[e]);
      }
    }
    m = m_new;
  }

  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int i = lane + 32 * e;
    if (i < head_dim) out[qo + i] = from_f<QT>(acc[e] / denom);
  }
}

template <typename QT, typename KT>
void launch(const void* q, const void* k, const void* v, const int* tables,
            const int* lens, void* out, int batch, int heads, int head_dim,
            int max_blocks, int block_size, float scale,
            cudaStream_t stream) {
  const dim3 grid(heads, batch);
  paged_decode_kernel<QT, KT><<<grid, 32, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), tables, lens, static_cast<QT*>(out), heads,
      head_dim, max_blocks, block_size, scale);
}

}  // namespace

PTT_EXPORT int ptt_paged_decode(const void* q, int q_bf16, const void* k,
                                const void* v, int kv_bf16, const int* tables,
                                const int* lens, void* out, int batch,
                                int heads, int head_dim, int max_blocks,
                                int block_size, float scale, void* stream) {
  if (head_dim > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, tables, lens, out, batch,
                                         heads, head_dim, max_blocks,
                                         block_size, scale, s);
  } else if (q_bf16) {
    launch<__nv_bfloat16, float>(q, k, v, tables, lens, out, batch, heads,
                                 head_dim, max_blocks, block_size, scale, s);
  } else if (kv_bf16) {
    launch<float, __nv_bfloat16>(q, k, v, tables, lens, out, batch, heads,
                                 head_dim, max_blocks, block_size, scale, s);
  } else {
    launch<float, float>(q, k, v, tables, lens, out, batch, heads, head_dim,
                         max_blocks, block_size, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
