// The FFN backward for Hopper (ffn.cuh says what it computes and how).
#include "ffn.cuh"

namespace {

template <typename T>
struct CastStore {
  T* y;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    y[(size_t)m * ld + n] = from_f32<T>(v);
  }
};

template <typename T, int kAct>
int launch_ffn_bwd(const void* x_, const void* w1_, const void* b1_,
                   const void* w2_, const void* dy, void* dx_, float* grads,
                   float* u, float* du, float* g, float* partial, int n,
                   int d, int hidden, int splits, int d_real,
                   int hidden_real, Dropout act_drop, Dropout out_drop,
                   cudaStream_t s) {
  using simulst::RowMajor;
  using simulst::Transposed;
  using Store = simulst::PartialStore<TagFfnBwd>;
  const T* x = static_cast<const T*>(x_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* w2 = static_cast<const T*>(w2_);
  // grads / partial layout: [dW1 (d, hidden) | dW2 (hidden, d) | db1 | db2]
  const size_t len = 2 * (size_t)d * hidden + hidden + d;
  const size_t o_dw2 = (size_t)d * hidden, o_db1 = 2 * o_dw2,
               o_db2 = o_db1 + hidden;
  SIMULST_TRY(
      (simulst::drop_grad<T>(dy, g, n, d, d_real, out_drop, 1, 0, 0, s)));
  SIMULST_TRY((simulst::tile_product<128>(
      n, hidden, d, 1, RowMajor<T>{x, d}, RowMajor<T>{w1, hidden},
      BiasStore<T, TagFfnBwd>{u, static_cast<const T*>(b1_), hidden}, s)));
  SIMULST_TRY((simulst::tile_product<128, true>(
      n, hidden, d, 1, RowMajor<float>{g, d}, Transposed<T>{w2, d},
      HiddenGradStore<T, kAct, TagFfnBwd>{u, u, du, hidden, hidden_real,
                                          act_drop},
      s)));
  // N = d: 128 x 64 tiles, so that the grid spreads over the SMs
  SIMULST_TRY((simulst::tile_product<64>(
      n, d, hidden, 1, RowMajor<float>{du, hidden}, Transposed<T>{w1, hidden},
      CastStore<T>{static_cast<T*>(dx_), d}, s)));
  // dW1 and dW2 (K = rows in `splits` slices) in one launch
  SIMULST_TRY((simulst::tile_product_pair<64>(
      simulst::tile_problem<64>(d, hidden, n, splits, Transposed<T>{x, d},
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
  return (int)simulst::sum_splits(partial, splits, len, grads, s);
}

}  // namespace

// The backward of simulst_ffn (ln_res = 0): dx (n_rows, dim) of `dtype` and
// grads = [dW1 (dim, hidden) | dW2 (hidden, dim) | db1 (hidden) | db2 (dim)]
// in fp32.  Scratch, all fp32: u and du (n_rows, hidden), g (n_rows, dim),
// partial (splits, len(grads)) zero-filled.  dim_real and hidden_real as
// simulst_ffn's (the dropout sites' offsets).  Returns a cudaError_t.
extern "C" int simulst_ffn_bwd(int dtype, int act, const void* x,
                               const void* w1, const void* b1, const void* w2,
                               const void* dy, void* dx, void* grads, void* u,
                               void* du, void* g, void* partial, int n_rows,
                               int dim, int hidden, int splits,
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
  float *gr = static_cast<float*>(grads), *uf = static_cast<float*>(u),
        *duf = static_cast<float*>(du), *gf = static_cast<float*>(g),
        *pf = static_cast<float*>(partial);
  FFN_ACT_DISPATCH(act, SIMULST_DISPATCH(dtype, return launch_ffn_bwd<scalar_t, kA>(
                              x, w1, b1, w2, dy, dx, gr, uf, duf, gf, pf,
                              n_rows, dim, hidden, splits, dim_real,
                              hidden_real, act_drop, out_drop, s)));
}
