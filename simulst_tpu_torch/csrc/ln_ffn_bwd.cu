// The LN-FFN backward for Hopper (ffn.cuh says what it computes and how).
#include "ffn.cuh"

namespace {

// ---------------------------------------------------------------------------
// LN-FFN backward
// ---------------------------------------------------------------------------

// dx = inv (gg - mean(gg) - xhat mean(gg xhat)) + dy with gg = dn gamma,
// the means over the first d_real columns (a padded column's gg is zero);
// xn is overwritten with dn xhat (the per-row terms of dgamma)
template <typename T, int kDim>
__global__ void __launch_bounds__(kRowThreads)
    ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                       const float* __restrict__ stats,
                       const float* __restrict__ dn, const T* __restrict__ dy,
                       T* __restrict__ dx, float* __restrict__ xn,
                       int n_rows, int d_real) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const float mean = stats[2 * row], inv = stats[2 * row + 1];
  float xh[kDim / 32], gg[kDim / 32];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kDim / 32; ++i) {
    const size_t off = (size_t)row * kDim + lane + 32 * i;
    xh[i] = (to_f32(x[off]) - mean) * inv;
    const float d = dn[off];
    gg[i] = d * ln_g[lane + 32 * i];
    s1 += gg[i];
    s2 += gg[i] * xh[i];
    xn[off] = d * xh[i];
  }
  const float m1 = simulst::warp_sum(s1) / d_real;
  const float m2 = simulst::warp_sum(s2) / d_real;
#pragma unroll
  for (int i = 0; i < kDim / 32; ++i) {
    const size_t off = (size_t)row * kDim + lane + 32 * i;
    dx[off] = from_f32<T>(inv * (gg[i] - m1 - xh[i] * m2) + to_f32(dy[off]));
  }
}

struct F32Store {
  float* y;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    y[(size_t)m * ld + n] = v;
  }
};

template <typename T, int kAct>
int launch_ln_ffn_bwd(const void* x_, const void* g_, const void* be_,
                      const void* w1_, const void* b1_, const void* w2_,
                      const void* dy_, void* dx_, float* grads, float* xn,
                      float* stats, float* u, float* du, float* g, float* dn,
                      float* partial, int n, int d, int hidden, int splits,
                      int d_real, int hidden_real, Dropout act_drop,
                      Dropout out_drop, cudaStream_t s) {
  using simulst::RowMajor;
  using simulst::Transposed;
  using Store = simulst::PartialStore<TagLnFfnBwd>;
  const T* x = static_cast<const T*>(x_);
  const float* ln_g = static_cast<const float*>(g_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* w2 = static_cast<const T*>(w2_);
  const T* dy = static_cast<const T*>(dy_);
  // grads / partial layout:
  // [dW1 (d, hidden) | dW2 (hidden, d) | db1 | db2 | dgamma | dbeta]
  const size_t o_dw2 = (size_t)d * hidden, o_db1 = 2 * o_dw2,
               o_db2 = o_db1 + hidden, o_dg = o_db2 + d, o_dbe = o_dg + d,
               len = o_dbe + d;
  const int row_blocks = simulst::ceil_div(n, kRowThreads / 32);
  FFN_DIM_DISPATCH(d, {
    ln_rows_kernel<T, kD><<<row_blocks, kRowThreads, 0, s>>>(
        x, ln_g, static_cast<const float*>(be_), xn, stats, n, d_real);
    break;
  });
  SIMULST_TRY(cudaGetLastError());
  SIMULST_TRY(
      (simulst::drop_grad<T>(dy, g, n, d, d_real, out_drop, 1, 0, 0, s)));
  SIMULST_TRY((simulst::tile_product<128>(
      n, hidden, d, 1, RowMajor<float>{xn, d}, RowMajor<T>{w1, hidden},
      BiasStore<T, TagLnFfnBwd>{u, static_cast<const T*>(b1_), hidden}, s)));
  SIMULST_TRY((simulst::tile_product<128, true>(
      n, hidden, d, 1, RowMajor<float>{g, d}, Transposed<T>{w2, d},
      HiddenGradStore<T, kAct, TagLnFfnBwd>{u, du, hidden, hidden_real,
                                            act_drop},
      s)));
  // N = d: 128 x 64 tiles, so that the grid spreads over the SMs
  SIMULST_TRY((simulst::tile_product<64>(
      n, d, hidden, 1, RowMajor<float>{du, hidden}, Transposed<T>{w1, hidden},
      F32Store{dn, d}, s)));
  // dW1 and dW2 (K = rows in `splits` slices) in one launch
  SIMULST_TRY((simulst::tile_product_pair<64>(
      simulst::tile_problem<64>(d, hidden, n, splits, Transposed<float>{xn, d},
                                RowMajor<float>{du, hidden},
                                Store{partial, len, 0, hidden}),
      simulst::tile_problem<64>(hidden, d, n, splits,
                                Transposed<float>{u, hidden},
                                RowMajor<float>{g, d},
                                Store{partial, len, o_dw2, d}),
      s)));
  SIMULST_TRY(simulst::colsum_partial(du, n, hidden, splits, partial, len,
                                      o_db1, s));
  SIMULST_TRY(simulst::colsum_partial(g, n, d, splits, partial, len, o_db2, s));
  FFN_DIM_DISPATCH(d, {
    ln_bwd_rows_kernel<T, kD><<<row_blocks, kRowThreads, 0, s>>>(
        x, ln_g, stats, dn, dy, static_cast<T*>(dx_), xn, n, d_real);
    break;
  });
  SIMULST_TRY(cudaGetLastError());
  SIMULST_TRY(simulst::colsum_partial(xn, n, d, splits, partial, len, o_dg,
                                      s));
  SIMULST_TRY(simulst::colsum_partial(dn, n, d, splits, partial, len, o_dbe,
                                      s));
  return (int)simulst::sum_splits(partial, splits, len, grads, s);
}

}  // namespace

// The backward of simulst_ffn with ln_res = 1 (ln_g, ln_b fp32): dx
// (n_rows, dim) of `dtype` and grads = [dW1 (dim, hidden) | dW2 (hidden, dim) | db1 (hidden) |
// db2 (dim) | dgamma (dim) | dbeta (dim)] in fp32.  Scratch, all fp32: xn,
// g and dn (n_rows, dim), stats (n_rows, 2), u and du (n_rows, hidden),
// partial (splits, len(grads)) zero-filled.  dim_real and hidden_real as
// simulst_ffn's (LN's statistics and row means, the dropout sites'
// offsets).  Returns a cudaError_t.
extern "C" int simulst_ln_ffn_bwd(int dtype, int act, const void* x,
                                  const void* ln_g, const void* ln_b,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* dy, void* dx,
                                  void* grads, void* xn, void* stats, void* u,
                                  void* du, void* g, void* dn, void* partial,
                                  int n_rows, int dim, int hidden, int splits,
                                  int dim_real, int hidden_real,
                                  unsigned long long seed, int act_on,
                                  unsigned act_threshold, float act_inv_keep,
                                  int out_on, unsigned out_threshold,
                                  float out_inv_keep, void* stream) {
  if (!ffn_dim_ok(dim) || n_rows <= 0 || splits <= 0 || hidden <= 0 ||
      hidden % kChunk != 0 || act < kGelu || act > kTanh ||
      !ffn_real_ok(dim, hidden, dim_real, hidden_real))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout act_drop{seed, act_threshold, act_inv_keep, act_on};
  const Dropout out_drop{seed, out_threshold, out_inv_keep, out_on};
  float *gr = static_cast<float*>(grads), *xf = static_cast<float*>(xn),
        *st = static_cast<float*>(stats), *uf = static_cast<float*>(u),
        *duf = static_cast<float*>(du), *gf = static_cast<float*>(g),
        *dnf = static_cast<float*>(dn), *pf = static_cast<float*>(partial);
  FFN_ACT_DISPATCH(act, SIMULST_DISPATCH(dtype, return launch_ln_ffn_bwd<scalar_t, kA>(
                              x, ln_g, ln_b, w1, b1, w2, dy, dx, gr, xf, st,
                              uf, duf, gf, dnf, pf, n_rows, dim, hidden,
                              splits, dim_real, hidden_real, act_drop,
                              out_drop, s)));
}
