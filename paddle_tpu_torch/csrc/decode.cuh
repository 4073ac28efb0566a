// Shared pieces of the two single-query decode kernels (flash_decode.cu over
// a fixed-shape cache, paged_decode.cu over block-tabled pages): typed
// 16-byte vectors, the online-softmax update of one row group over kU
// key/value rows, and the cluster combine.
//
// Both kernels read a head row with W lanes (W = the row's 16-byte vectors,
// rounded up to a power of two, at most 32), so a warp covers R = 32 / W
// rows per load, and keep per lane VPL vectors of E elements: the q slice
// in registers, and a row group's running max m, sum l and float32
// accumulator acc of its slice.  The length is read on the device and the
// key range of a (row, head) is split across a thread-block cluster whose
// block rank 0 combines every warp's state.
//
// Rounding follows the TPU kernels: the score is scaled after the float32
// product, l sums the unrounded p, p is rounded to the key/value dtype
// before P.V (each row group against its own running max; the combine
// rescales by exp(m_w - m), so the relative rounding stays 2^-9), and the
// divide is clamped at 1e-30, so a range with no position gives zeros.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace ptt_decode {

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
__device__ __forceinline__ Vec<KT> widen(uint4 raw) {
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

// E consecutive elements of q (16-byte aligned: q is, and d is a multiple
// of 8) widened to float32, or zeros when !ok.
template <typename QT, int E>
__device__ __forceinline__ void load_q(const QT* p, bool ok, float (&o)[E]) {
  constexpr int kVecs = E * static_cast<int>(sizeof(QT)) / 16;
  if constexpr (kVecs >= 1) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const uint4 raw = ok ? __ldg(reinterpret_cast<const uint4*>(p) + j)
                           : make_uint4(0, 0, 0, 0);
      const Vec<QT> w = widen<QT>(raw);
#pragma unroll
      for (int e = 0; e < Vec<QT>::kElems; ++e)
        o[j * Vec<QT>::kElems + e] = w.f[e];
    }
  } else {                   // 4 bf16 beside a float32 cache's vector
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = ok ? to_f(p[e]) : 0.f;
  }
}

// The weight exp(m - mx) of a softmax state with running max m against a
// larger max mx; 0 for a state that saw no position (m = -inf), whatever mx.
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

// One online-softmax step of a row group over the kU rows whose K and V
// vectors this lane loaded (kr, vr; rows with !valid[i] are skipped):
// scores reduced over the W lanes of a row by shuffles, then m, l and acc
// updated.  Every lane of the warp must call it.
template <typename KT, int W, int VPL, int kU>
__device__ __forceinline__ void online_step(
    const uint4 (&kr)[kU][VPL], const uint4 (&vr)[kU][VPL],
    const bool (&valid)[kU], const float (&qv)[VPL][Vec<KT>::kElems],
    float scale, float& m, float& l, float (&acc)[VPL][Vec<KT>::kElems]) {
  constexpr int E = Vec<KT>::kElems;
  float s[kU];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kU; ++i) {
    float dot = 0.f;
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const Vec<KT> kv = widen<KT>(kr[i][u]);
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qv[u][e], kv.f[e], dot);
    }
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1)
      dot += __shfl_xor_sync(ptt::kFullMask, dot, o);
    s[i] = valid[i] ? dot * scale : -INFINITY;
    mx = fmaxf(mx, s[i]);
  }
  const float m_new = fmaxf(m, mx);
  const float alpha = weight(m, m_new);   // the state so far is 0 at -inf
  l *= alpha;
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[u][e] *= alpha;
  }
#pragma unroll
  for (int i = 0; i < kU; ++i) {
    const float p = s[i] == -INFINITY ? 0.f : expf(s[i] - m_new);
    l += p;
    const float pr = to_f(from_f<KT>(p));  // p in the K/V dtype for P.V
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const Vec<KT> vv = widen<KT>(vr[i][u]);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[u][e] = fmaf(pr, vv.f[e], acc[u][e]);
    }
  }
  m = m_new;
}

// The cluster combine.  The R row groups of each warp are combined by
// shuffles, and each warp pushes its state into block rank 0's slot
// rank * kWarps + warp (sm, sl and sacc, rank 0's shared memory, with
// room for every warp of the cluster) through distributed shared memory.
// A block's shared memory may be written by a peer only once the block has
// started: every block must have arrived (relaxed) on the cluster barrier
// as it started, and this waits on that barrier before the first remote
// store.  After a second cluster barrier, which makes the pushed states
// visible, rank 0 combines them in slot order into out[0, d) and the other
// blocks return.  Every thread of every block must call it.
template <int kWarps, int W, int VPL, int E, int DP, typename QT>
__device__ __forceinline__ void cluster_combine(
    float m, float l, float (&acc)[VPL][E], float (*sacc)[DP], float* sm,
    float* sl, QT* out, int d) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane / W;
  const int c = lane % W;
  // combine the R row groups of the warp (lanes c, c + W, c + 2W, ...)
#pragma unroll
  for (int off = W; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(ptt::kFullMask, m, off);
    const float lo = __shfl_xor_sync(ptt::kFullMask, l, off);
    const float mn = fmaxf(m, mo);
    const float fa = weight(m, mn);
    const float fb = weight(mo, mn);
    l = l * fa + lo * fb;
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(ptt::kFullMask, acc[u][e], off);
        acc[u][e] = acc[u][e] * fa + ao * fb;
      }
    }
    m = mn;
  }
  // every block of the cluster has started (rank 0's shared memory can be
  // written); then push this warp's state.  The second cluster barrier
  // (release / acquire) makes it visible to rank 0
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int slot = rank * kWarps + warp;
  if (lane == 0) {
    cluster.map_shared_rank(sm, 0)[slot] = m;
    cluster.map_shared_rank(sl, 0)[slot] = l;
  }
  if (r == 0) {
    float* dst = cluster.map_shared_rank(&sacc[slot][0], 0);
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      float4* d4 = reinterpret_cast<float4*>(dst + (c + u * W) * E);
#pragma unroll
      for (int j = 0; j < E / 4; ++j)
        d4[j] = make_float4(acc[u][4 * j], acc[u][4 * j + 1],
                            acc[u][4 * j + 2], acc[u][4 * j + 3]);
    }
  }
  cluster.sync();
  if (rank != 0) return;

  // rank 0 combines the warps' states in slot order (a warp that saw no
  // position has m = -inf and weighs 0); with no position at all the
  // output is 0 (0 / 1e-30), as the TPU kernels' empty loops give
  const int slots = splits * kWarps;
  float mx = -INFINITY;
  for (int w = 0; w < slots; ++w) mx = fmaxf(mx, sm[w]);
  __syncthreads();                         // every thread has read sm
  if (threadIdx.x < slots) sm[threadIdx.x] = weight(sm[threadIdx.x], mx);
  __syncthreads();                         // sm holds the weights
  float lsum = 0.f;
  for (int w = 0; w < slots; ++w) lsum = fmaf(sl[w], sm[w], lsum);
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float o = 0.f;
    for (int w = 0; w < slots; ++w) o = fmaf(sacc[w][i], sm[w], o);
    out[i] = from_f<QT>(o * inv);
  }
}

}  // namespace ptt_decode
