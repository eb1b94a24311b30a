// The LN-FFN backward for Hopper (ffn.cuh says what it computes and how).
#include "ffn.cuh"

namespace {

// ---------------------------------------------------------------------------
// LN-FFN backward
// ---------------------------------------------------------------------------

// dx = inv (gg - mean(gg) - xhat mean(gg xhat)) + dy with gg = dn gamma,
// the means over the first d_real columns (a padded column's gg is zero);
// dn is overwritten with dn xhat (the per-row terms of dgamma)
template <typename T, int kDim>
__global__ void __launch_bounds__(kRowThreads)
    ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                       const float* __restrict__ stats, float* dn,
                       const T* __restrict__ dy, T* __restrict__ dx,
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
    dn[off] = d * xh[i];
  }
  const float m1 = simulst::warp_sum(s1) / d_real;
  const float m2 = simulst::warp_sum(s2) / d_real;
#pragma unroll
  for (int i = 0; i < kDim / 32; ++i) {
    const size_t off = (size_t)row * kDim + lane + 32 * i;
    dx[off] = from_f32<T>(inv * (gg[i] - m1 - xh[i] * m2) + to_f32(dy[off]));
  }
}

// ln_bwd_rows_kernel at a width above kMaxDim: the row read twice (the
// two sums, then dx and dn xhat), lane l taking columns l, l + 32, ...
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    ln_bwd_rows_wide_kernel(const T* __restrict__ x,
                            const float* __restrict__ ln_g,
                            const float* __restrict__ stats, float* dn,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            int n_rows, int dim, int d_real) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const float mean = stats[2 * row], inv = stats[2 * row + 1];
  const size_t base = (size_t)row * dim;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < dim; c += 32) {
    const float gg = dn[base + c] * ln_g[c];
    s1 += gg;
    s2 += gg * ((to_f32(x[base + c]) - mean) * inv);
  }
  const float m1 = simulst::warp_sum(s1) / d_real;
  const float m2 = simulst::warp_sum(s2) / d_real;
  for (int c = lane; c < dim; c += 32) {
    const float xh = (to_f32(x[base + c]) - mean) * inv;
    const float d = dn[base + c], gg = d * ln_g[c];
    dx[base + c] =
        from_f32<T>(inv * (gg - m1 - xh * m2) + to_f32(dy[base + c]));
    dn[base + c] = d * xh;
  }
}

// LN's backward row pass over n_rows rows of width dim: registers up to
// kMaxDim, the walking variant above; returns a cudaError_t
template <typename T>
int launch_ln_bwd_rows(const T* x, const float* ln_g, const float* stats,
                       float* dn, const T* dy, T* dx, int n_rows, int dim,
                       int d_real, cudaStream_t s) {
  const int blocks = simulst::ceil_div(n_rows, kRowThreads / 32);
  if (dim > kMaxDim) {
    ln_bwd_rows_wide_kernel<T><<<blocks, kRowThreads, 0, s>>>(
        x, ln_g, stats, dn, dy, dx, n_rows, dim, d_real);
    return (int)cudaGetLastError();
  }
  FFN_DIM_DISPATCH(dim, {
    ln_bwd_rows_kernel<T, kD><<<blocks, kRowThreads, 0, s>>>(
        x, ln_g, stats, dn, dy, dx, n_rows, d_real);
    return (int)cudaGetLastError();
  });
}

// T the activation dtype: the intermediates that feed a product (xn, g,
// h_d, du) are T, so that in bf16 every product runs on the tensor cores
// (simulst::product), dh through the fp32 buffer `dh` and the hidden
// gradient a pass of its own, as the FFN backward's; in fp32 h_d
// overwrites u (hd == u) and dh is unused
template <typename T, int kAct>
int launch_ln_ffn_bwd(const void* x_, const void* g_, const void* be_,
                      const void* w1_, const void* b1_, const void* w2_,
                      const void* dy_, void* dx_, float* grads, T* xn,
                      float* stats, float* u, T* hd, T* du, T* g, float* dn,
                      float* dh, float* partial, int n, int d, int hidden,
                      int splits, int d_real, int hidden_real,
                      Dropout act_drop, Dropout out_drop, cudaStream_t s) {
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
  SIMULST_TRY((cudaError_t)launch_ln_rows<T>(
      x, ln_g, static_cast<const float*>(be_), xn, stats, n, d, d_real, s));
  SIMULST_TRY((simulst::drop_grad<T, T>(dy, g, n, d, d_real, out_drop, 1, 0,
                                        0, s)));
  SIMULST_TRY((simulst::product<128>(
      n, hidden, d, 1, RowMajor<T>{xn, d}, RowMajor<T>{w1, hidden},
      BiasStore<T, TagLnFfnBwd>{u, static_cast<const T*>(b1_), hidden}, s)));
  if constexpr (std::is_same<T, float>::value) {
    SIMULST_TRY((simulst::tile_product<128, true>(
        n, hidden, d, 1, RowMajor<T>{g, d}, Transposed<T>{w2, d},
        HiddenGradStore<kAct, TagLnFfnBwd>{u, hd, du, hidden, hidden_real,
                                           act_drop},
        s)));
  } else {
    SIMULST_TRY((simulst::product<128>(
        n, hidden, d, 1, RowMajor<T>{g, d}, Transposed<T>{w2, d},
        F32Store<TagLnFfnBwd>{dh, hidden}, s)));
    SIMULST_TRY((launch_hidden_grad<T, kAct>(u, dh, hd, du, n, hidden,
                                             hidden_real, act_drop, s)));
  }
  // N = d: 128 x 64 tiles, so that the grid spreads over the SMs
  SIMULST_TRY((simulst::product<64>(n, d, hidden, 1,
                                    RowMajor<T>{du, hidden},
                                    Transposed<T>{w1, hidden},
                                    F32Store<TagLnFfnBwd>{dn, d}, s)));
  // dW1 and dW2 (K = rows in `splits` slices): one launch on the CUDA
  // cores, two on the tensor cores
  const auto dw1 = simulst::tile_problem<64>(d, hidden, n, splits,
                                             Transposed<T>{xn, d},
                                             RowMajor<T>{du, hidden},
                                             Store{partial, len, 0, hidden});
  const auto dw2 = simulst::tile_problem<64>(hidden, d, n, splits,
                                             Transposed<T>{hd, hidden},
                                             RowMajor<T>{g, d},
                                             Store{partial, len, o_dw2, d});
  if constexpr (std::is_same<T, float>::value) {
    SIMULST_TRY((simulst::tile_product_pair<64>(dw1, dw2, s)));
  } else {
    SIMULST_TRY((simulst::product<64>(d, hidden, n, splits, dw1.a, dw1.b,
                                      dw1.store, s)));
    SIMULST_TRY((simulst::product<64>(hidden, d, n, splits, dw2.a, dw2.b,
                                      dw2.store, s)));
  }
  // the column sums: 8 row lanes in fp32 (its bits), 32 in bf16
  constexpr int kLanes = std::is_same<T, float>::value ? 8 : 32;
  SIMULST_TRY(simulst::colsum_partial<kLanes>(du, n, hidden, splits, partial,
                                              len, o_db1, s));
  SIMULST_TRY(simulst::colsum_partial<kLanes>(g, n, d, splits, partial, len,
                                              o_db2, s));
  // dbeta from dn before the row pass turns dn into dn xhat (dgamma's)
  SIMULST_TRY(simulst::colsum_partial<kLanes>(dn, n, d, splits, partial, len,
                                              o_dbe, s));
  SIMULST_TRY((cudaError_t)launch_ln_bwd_rows<T>(
      x, ln_g, stats, dn, dy, static_cast<T*>(dx_), n, d, d_real, s));
  SIMULST_TRY(simulst::colsum_partial<kLanes>(dn, n, d, splits, partial, len,
                                              o_dg, s));
  return (int)simulst::sum_splits(partial, splits, len, grads, s);
}

}  // namespace

// The backward of simulst_ffn with ln_res = 1 (ln_g, ln_b fp32): dx
// (n_rows, dim) of `dtype` and grads = [dW1 (dim, hidden) | dW2 (hidden, dim) | db1 (hidden) |
// db2 (dim) | dgamma (dim) | dbeta (dim)] in fp32.  Scratch: xn and g
// (n_rows, dim) and du, hd (n_rows, hidden) of `dtype`; dn (n_rows, dim),
// stats (n_rows, 2), u (n_rows, hidden) and partial (splits, len(grads)),
// zero-filled, fp32; dh (n_rows, hidden) fp32 in bf16 (unused in fp32,
// where hd may be u: h_d overwrites it).  In bf16 the five products run on
// the tensor cores (wgmma.cuh).  dim_real and hidden_real as simulst_ffn's
// (LN's statistics and row means, the dropout sites' offsets).  Returns a
// cudaError_t.
extern "C" int simulst_ln_ffn_bwd(int dtype, int act, const void* x,
                                  const void* ln_g, const void* ln_b,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* dy, void* dx,
                                  void* grads, void* xn, void* stats, void* u,
                                  void* hd, void* du, void* g, void* dn,
                                  void* dh, void* partial, int n_rows,
                                  int dim, int hidden, int splits,
                                  int dim_real, int hidden_real,
                                  unsigned long long seed, int act_on,
                                  unsigned act_threshold,
                                  float act_inv_keep, int out_on,
                                  unsigned out_threshold, float out_inv_keep,
                                  void* stream) {
  if (!ffn_dim_ok(dim) || n_rows <= 0 || splits <= 0 || hidden <= 0 ||
      hidden % kChunk != 0 || act < kGelu || act > kTanh ||
      !ffn_real_ok(dim, hidden, dim_real, hidden_real) ||
      (dtype == simulst::kBF16 && dh == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout act_drop{seed, act_threshold, act_inv_keep, act_on};
  const Dropout out_drop{seed, out_threshold, out_inv_keep, out_on};
  float *gr = static_cast<float*>(grads), *st = static_cast<float*>(stats),
        *uf = static_cast<float*>(u), *dnf = static_cast<float*>(dn),
        *dhf = static_cast<float*>(dh), *pf = static_cast<float*>(partial);
  FFN_ACT_DISPATCH(act, SIMULST_DISPATCH(dtype, return launch_ln_ffn_bwd<scalar_t, kA>(
                              x, ln_g, ln_b, w1, b1, w2, dy, dx, gr,
                              static_cast<scalar_t*>(xn), st, uf,
                              static_cast<scalar_t*>(hd),
                              static_cast<scalar_t*>(du),
                              static_cast<scalar_t*>(g), dnf, dhf, pf, n_rows,
                              dim, hidden, splits, dim_real, hidden_real,
                              act_drop, out_drop, s)));
}
