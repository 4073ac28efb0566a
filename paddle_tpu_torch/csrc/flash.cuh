// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_dkdv.cu, flash_dq.cu): tile shapes, typed loads and the 64 x 64
// score tile every kernel recomputes.  The counter-hash dropout mask `keep`
// is in common.cuh, shared with the fused-block kernels.
//
// Layout: q (BH, sq, D), k / v (BH, sk, D), contiguous, one dtype T for all
// of them (float or bf16); per-row statistics lse / delta (BH, sq) float32.
// A block of kThreads threads owns one 64-row tile of one (batch, head) and
// loops over the other axis itself: Hopper blocks run in no order, so
// nothing is carried between blocks and no atomics are needed (results
// repeat exactly run to run).
//
// Tiles sit in shared memory as float32 rows of stride D + 4 (16-byte
// aligned rows, consecutive rows four banks apart).  Thread (tx, ty) =
// (tid % 16, tid / 16) owns the score entries (i, j) = (ty + 16 r,
// tx + 16 c), r, c < 4: the 16 threads of a row live in one half-warp, so a
// row's max and sum reduce by shuffles, and the strided columns keep a
// quarter-warp's float4 reads of K on distinct banks.  For the products
// that contract over the tile (P.V, dS.K, P^T.dO, dS^T.Q) the thread owns
// rows ty + 16 r and the D / 16 contiguous columns from tx * D / 16.
//
// The bf16 forward, dK/dV and dQ kernels take only the mask, the dropout
// hash and the tile walk from here; their tensor-core tiles and fragments
// are in flash_mma.cuh.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace ptt_flash {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kLdp = kTile + 4;       // stride of a (64, 64) tile
constexpr float kNegInf = -1e30f;     // the TPU kernels' mask value

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
// The value a store to T and a load back give (round to nearest even).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

using ptt::keep;

// Rows row0 .. row0 + 63 of a (n, D) matrix into shared memory as float32
// (stride D + 4); rows at or past n read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int row0, int n, float* dst) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    const int g = row0 + r;
    dst[r * (D + 4) + c] =
        g < n ? to_f(src[static_cast<int64_t>(g) * D + c]) : 0.f;
  }
}

// N consecutive floats of shared memory (16-byte aligned for N % 4 == 0,
// 8-byte for N == 2).
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      o[i] = t.x;
      o[i + 1] = t.y;
      o[i + 2] = t.z;
      o[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x;
    o[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// acc[r][c] += sum_e A[(ty + 16 r), e] * B[(tx + 16 c), e] over the D
// columns of two (64, D) tiles: the score tile's product (Q K^T or dO V^T).
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int tx, int ty, float (&acc)[4][4]) {
  constexpr int ld = D + 4;
#pragma unroll 4
  for (int e = 0; e < D; e += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (ty + 16 * r) * ld + e);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * ld + e);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = dot4(a[r], b[c], acc[r][c]);
  }
}

// acc[r][x] += sum_j P[(ty + 16 r), j] * B[j, e0 + x] over the 64 columns
// of a (64, 64) tile P (stride kLdp) and the rows of a (64, D) tile B: the
// products that contract over a tile (P.V, dS.K, and with P stored
// transposed, P^T.dO and dS^T.Q).
template <int D>
__device__ __forceinline__ void tile_acc(const float* P, const float* B,
                                         int tx, int ty,
                                         float (&acc)[4][D / 16]) {
  constexpr int ld = D + 4;
  constexpr int kE = D / 16;
  const int e0 = tx * kE;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 pr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pr[r] = *reinterpret_cast<const float4*>(P + (ty + 16 * r) * kLdp + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float bv[kE];
      lds<kE>(B + (j + jj) * ld + e0, bv);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = comp(pr[r], jj);
#pragma unroll
        for (int x = 0; x < kE; ++x) acc[r][x] = fmaf(p, bv[x], acc[r][x]);
      }
    }
  }
}

// Sum / max over the 16 threads (one half-warp) that share a row.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(ptt::kFullMask, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(ptt::kFullMask, v, o));
  return v;
}

// Whether (row, col) takes part: inside both lengths and, when causal, on
// or below the bottom-right aligned diagonal (offset = sk - sq).
__device__ __forceinline__ bool visible(int row, int col, int sq, int sk,
                                        int causal) {
  return row < sq && col < sk && (!causal || row + (sk - sq) >= col);
}

// The kv tiles a q tile starting at row0 visits: those holding a real key
// and, when causal, a key on or below the diagonal of one of its rows.
__device__ __forceinline__ int kv_tiles(int row0, int sq, int sk,
                                        int causal) {
  const int end = causal ? min(sk, row0 + kTile + (sk - sq)) : sk;
  return end > 0 ? (end + kTile - 1) / kTile : 0;
}

}  // namespace ptt_flash
