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
// 4.2 us at 3.35 TB/s.
//
// Design.  The TPU kernel's trip count came from a traced scalar, so one
// compiled program served every position; here the length is read from a
// device int32, so one CUDA graph of the decode step serves every position.
// One block of kWarps warps per (batch*head, query row).  The TPU grid ran
// (batch*head) programs, each looping over the cache in blocks; here the
// warps of a block take 32-position chunks in turn (warp w the chunks
// w, w + kWarps, ...), each keeping its own online softmax (m, l and a
// float32 accumulator), and the block combines the warps' states in shared
// memory at the end: the KV range is split inside a block, with no second
// pass.  In a chunk, lane j scores position base + j over the whole head
// dimension (q sits in shared memory as float32; K rows are read as 16-byte
// vectors), the warp reduces the chunk's max and sum, then the value rows
// are read as 16-byte vectors by W lanes each (W = the row's vectors,
// rounded up to a power of two, at most 32), 32 / W rows at a time, and the
// row groups are summed by shuffles at the end.  Only positions below n are
// read.  Rounding follows the TPU kernel: the score is scaled after the
// float32 product, l sums the unrounded p and is clamped at 1e-30, p is
// rounded to the cache dtype before P.V.  q and the cache each take float32
// or bf16; accumulation is float32; the output takes q's dtype.  With
// B*H = 96 blocks for 132 SMs, split-KV across blocks (a combine pass) is
// the next step toward the bound.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxHeadDim = 256;

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

// One 16-byte vector of KT (8 bf16 or 4 float) widened to float32.
template <typename KT>
struct Vec {
  static constexpr int kElems = 16 / static_cast<int>(sizeof(KT));
  float f[kElems];
};

template <typename KT>
__device__ __forceinline__ Vec<KT> load_vec(const KT* p) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  Vec<KT> out;
  if constexpr (sizeof(KT) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      out.f[2 * i] = t.x;
      out.f[2 * i + 1] = t.y;
    }
  } else {
    out.f[0] = __uint_as_float(raw.x);
    out.f[1] = __uint_as_float(raw.y);
    out.f[2] = __uint_as_float(raw.z);
    out.f[3] = __uint_as_float(raw.w);
  }
  return out;
}

// NVP: the 16-byte vectors of a head row (D / E of them), rounded up to a
// power of two; vectors at or past nv = D / E are skipped.
template <typename QT, typename KT, int NVP>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const int* __restrict__ len_ptr,
                    QT* __restrict__ out, int sq, int cap, int d,
                    float scale) {
  constexpr int E = Vec<KT>::kElems;       // elements per 16-byte vector
  constexpr int W = NVP < 32 ? NVP : 32;   // lanes per value row
  constexpr int R = 32 / W;                // value rows per warp step
  constexpr int VPL = NVP / W;             // vectors per lane in P.V
  constexpr int DP = NVP * E;              // the padded head dimension
  __shared__ __align__(16) float qs[DP];
  __shared__ __align__(16) float wacc[kWarps][DP];
  __shared__ float wm[kWarps];
  __shared__ float wl[kWarps];

  const int bh = blockIdx.x;
  const int row = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nv = d / E;
  const int64_t qo = (static_cast<int64_t>(bh) * sq + row) * d;
  for (int i = threadIdx.x; i < DP; i += blockDim.x) {
    qs[i] = i < d ? to_f(q[qo + i]) : 0.f;
  }
  __syncthreads();

  const int len = min(max(*len_ptr, 0), cap);
  const KT* kb = k + static_cast<int64_t>(bh) * cap * d;
  const KT* vb = v + static_cast<int64_t>(bh) * cap * d;
  const int r = lane / W;
  const int c = lane % W;

  float acc[VPL][E];
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[u][e] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int base = warp * 32; base < len; base += kWarps * 32) {
    const int pos = base + lane;
    float s = -INFINITY;
    if (pos < len) {
      const KT* krow = kb + static_cast<int64_t>(pos) * d;
      float dot = 0.f;
#pragma unroll 8
      for (int j = 0; j < NVP; ++j) {
        if (j < nv) {
          const Vec<KT> kv = load_vec(krow + j * E);
          const float4* qv = reinterpret_cast<const float4*>(qs + j * E);
#pragma unroll
          for (int e4 = 0; e4 < E / 4; ++e4) {
            const float4 qq = qv[e4];
            dot = fmaf(qq.x, kv.f[4 * e4], dot);
            dot = fmaf(qq.y, kv.f[4 * e4 + 1], dot);
            dot = fmaf(qq.z, kv.f[4 * e4 + 2], dot);
            dot = fmaf(qq.w, kv.f[4 * e4 + 3], dot);
          }
        }
      }
      s = dot * scale;
    }
    // lane 0 is always valid inside the loop, so m_new is finite
    const float m_new = fmaxf(m, ptt::warp_max(s));
    const float p = pos < len ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + ptt::warp_sum(p);
    const float pr = to_f(from_f<KT>(p));   // p in the cache dtype for P.V
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[u][e] *= alpha;
    }
    const int count = min(32, len - base);
#pragma unroll
    for (int t = 0; t < 32 / R; ++t) {
      const int j = t * R + r;               // row of the chunk
      const float pj = __shfl_sync(ptt::kFullMask, pr, j);
      if (j < count) {
        const KT* vrow = vb + static_cast<int64_t>(base + j) * d;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int vec = c + u * W;
          if (vec < nv) {
            const Vec<KT> vv = load_vec(vrow + vec * E);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[u][e] = fmaf(pj, vv.f[e], acc[u][e]);
          }
        }
      }
    }
    m = m_new;
  }

  // sum the R row groups of the warp (lanes c, c + W, c + 2W, ...)
#pragma unroll
  for (int off = W; off < 32; off <<= 1) {
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[u][e] += __shfl_xor_sync(ptt::kFullMask, acc[u][e], off);
      }
    }
  }
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  if (r == 0) {
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
#pragma unroll
      for (int e = 0; e < E; ++e) wacc[warp][(c + u * W) * E + e] = acc[u][e];
    }
  }
  __syncthreads();

  // combine the warps' online-softmax states; a warp that saw no position
  // has m = -inf and weighs exp(-inf) = 0; with no position at all the
  // output is 0 (0 / 1e-30), as the TPU kernel's empty loop gives
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w]);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float o = 0.f;
    float lsum = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(wm[w] - mx);
        lsum = fmaf(wl[w], f, lsum);
        o = fmaf(wacc[w][i], f, o);
      }
    }
    out[qo + i] = from_f<QT>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename QT, typename KT, int NVP>
void launch(const void* q, const void* k, const void* v, const int* len,
            void* out, int bh, int sq, int cap, int d, float scale,
            cudaStream_t stream) {
  const dim3 grid(bh, sq);
  flash_decode_kernel<QT, KT, NVP><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), len, static_cast<QT*>(out), sq, cap, d,
      scale);
}

template <typename QT, typename KT>
int dispatch(const void* q, const void* k, const void* v, const int* len,
             void* out, int bh, int sq, int cap, int d, float scale,
             cudaStream_t s) {
  constexpr int E = Vec<KT>::kElems;
  const int nv = d / E;
  if (nv <= 2) {
    launch<QT, KT, 2>(q, k, v, len, out, bh, sq, cap, d, scale, s);
  } else if (nv <= 4) {
    launch<QT, KT, 4>(q, k, v, len, out, bh, sq, cap, d, scale, s);
  } else if (nv <= 8) {
    launch<QT, KT, 8>(q, k, v, len, out, bh, sq, cap, d, scale, s);
  } else if (nv <= 16) {
    launch<QT, KT, 16>(q, k, v, len, out, bh, sq, cap, d, scale, s);
  } else if (nv <= 32) {
    launch<QT, KT, 32>(q, k, v, len, out, bh, sq, cap, d, scale, s);
  } else {
    launch<QT, KT, 64>(q, k, v, len, out, bh, sq, cap, d, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
