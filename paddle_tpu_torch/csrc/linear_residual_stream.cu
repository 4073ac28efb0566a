// K2 for float32 weights at a few rows (decode): GEMM with a dropout +
// residual epilogue,
//   out = r + drop(x @ W + b),
// stored in r's dtype.
//
// Replaces: paddle_tpu/ops/fused_block.py `_linear_residual_kernel`
// (launched by `_linear_residual_pallas`) for the calls that
// `linear_residual_route` sends here: a float32 W and at most
// `_RESID_STREAM_MAX_ROWS` rows (the attention out-projection of serving's
// and generate's decode steps, x the float32 attention output, r the bf16
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
// atomics, so a call repeats bit for bit.  That body is `ptt_stream::gemm`
// (stream.cuh), which K1's ln_linear_stream.cu shares with its own
// prologue and epilogue.
#include "common.cuh"
#include "stream.cuh"

using ptt_stream::kThreads;

namespace {

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
linear_residual_stream_kernel(const void* x, int x_bf16, const float* w,
                              const void* b, int b_bf16, const void* r,
                              int r_bf16, void* out, int n, int k, int cols,
                              int width, int depth, ptt::Dropout drop) {
  const int tid = threadIdx.x;
  // x's rows over the rank's depth as float32, and the residual and bias
  // this rank's epilogue will read fetched into L2 meanwhile
  auto stage = [&](float* xs, int k0, int kd, int c0, int cw, int e_lo,
                   int e_hi) {
    if (e_hi > e_lo) {
      const char* rb = static_cast<const char*>(r);
      for (int rr = e_lo / cw + tid; rr <= (e_hi - 1) / cw; rr += kThreads)
        ptt_stream::prefetch_l2(
            rb + (static_cast<int64_t>(rr) * cols + c0) * (r_bf16 ? 2 : 4));
      if (tid == 0)
        ptt_stream::prefetch_l2(static_cast<const char*>(b) +
                                c0 * (b_bf16 ? 2 : 4));
    }
    const int n8 = ptt_stream::rows8(n);
    for (int i = tid; i < n8 * kd; i += kThreads) {
      const int rr = i / kd;
      const int kk = i % kd;
      xs[rr * depth + kk] =
          rr < n ? ptt::ld(x, static_cast<int64_t>(rr) * k + k0 + kk, x_bf16)
                 : 0.f;
    }
  };
  auto finish = [&](int rr, int col, float s) {
    float y = s + ptt::ld(b, col, b_bf16);
    if (kDrop) y = drop(y, rr, col);
    const int64_t o = static_cast<int64_t>(rr) * cols + col;
    ptt::st(out, o, ptt::ld(r, o, r_bf16) + y, r_bf16);
  };
  ptt_stream::gemm(w, n, k, cols, width, depth, stage, finish);
}

}  // namespace

// Dynamic shared memory a block takes for n rows, `width` columns and
// `depth` rows of W.
PTT_EXPORT size_t ptt_linear_residual_stream_smem(int n, int width,
                                                  int depth) {
  return sizeof(float) * ptt_stream::gemm_smem_floats(n, width, depth);
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
      cluster < 1 || cluster > ptt_stream::kMaxCluster ||
      static_cast<int64_t>(cluster) * depth < k ||
      !ptt_stream::aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = p > 0.f ? linear_residual_stream_kernel<true>
                        : linear_residual_stream_kernel<false>;
  return static_cast<int>(ptt_stream::launch_gemm(
      kernel, (cols + width - 1) / width, cluster,
      ptt_linear_residual_stream_smem(n, width, depth), stream, x, x_bf16, w,
      b, b_bf16, r, r_bf16, out, n, k, cols, width, depth,
      ptt::Dropout{seed, salt, p, keep_div}));
}
