// The FFN backward for Hopper (ffn.cuh says what it computes and how).
//
// In bf16 its five products run on the tensor cores (simulst::product),
// with g, du and h_d bf16 buffers and u and the partials fp32, as the
// LN-FFN backward's.  The hidden-gradient epilogue (act'(u), act(u), the
// hidden site's Philox draw and two stores an element) does not ride on
// the product there: the product stores dh = g W2^T in fp32 and
// launch_hidden_grad's pass, at full occupancy, reads u and dh and writes
// du and h_d (ffn.cuh).  dh makes one more round trip through device
// memory (2 x 19 MB at asr-train's 2,304 decoder rows).  fp32 keeps the
// fused epilogue on tile_product, whose bits it fixes.
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

// T the activation dtype: g, du and h_d are T (bf16: every product on the
// tensor cores, dh through the fp32 buffer `dh`); in fp32 h_d overwrites u
// (hd == u) and dh is unused
template <typename T, int kAct>
int launch_ffn_bwd(const void* x_, const void* w1_, const void* b1_,
                   const void* w2_, const void* dy, void* dx_, float* grads,
                   float* u, T* hd, T* du, T* g, float* dh, float* partial,
                   int n, int d, int hidden, int splits, int d_real,
                   int hidden_real, Dropout act_drop, Dropout out_drop,
                   cudaStream_t s) {
  using simulst::RowMajor;
  using simulst::Transposed;
  using Store = simulst::PartialStore<TagFfnBwd>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  const T* x = static_cast<const T*>(x_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* w2 = static_cast<const T*>(w2_);
  // grads / partial layout: [dW1 (d, hidden) | dW2 (hidden, d) | db1 | db2]
  const size_t len = 2 * (size_t)d * hidden + hidden + d;
  const size_t o_dw2 = (size_t)d * hidden, o_db1 = 2 * o_dw2,
               o_db2 = o_db1 + hidden;
  SIMULST_TRY(
      (simulst::drop_grad<T, T>(dy, g, n, d, d_real, out_drop, 1, 0, 0, s)));
  SIMULST_TRY((simulst::product<128>(
      n, hidden, d, 1, RowMajor<T>{x, d}, RowMajor<T>{w1, hidden},
      BiasStore<T, TagFfnBwd>{u, static_cast<const T*>(b1_), hidden}, s)));
  if constexpr (kF32) {
    SIMULST_TRY((simulst::tile_product<128, true>(
        n, hidden, d, 1, RowMajor<T>{g, d}, Transposed<T>{w2, d},
        HiddenGradStore<kAct, TagFfnBwd>{u, hd, du, hidden, hidden_real,
                                         act_drop},
        s)));
  } else {
    SIMULST_TRY((simulst::product<128>(
        n, hidden, d, 1, RowMajor<T>{g, d}, Transposed<T>{w2, d},
        F32Store<TagFfnBwd>{dh, hidden}, s)));
    SIMULST_TRY((launch_hidden_grad<T, kAct>(u, dh, hd, du, n, hidden,
                                             hidden_real, act_drop, s)));
  }
  // N = d: 128 x 64 tiles, so that the grid spreads over the SMs
  SIMULST_TRY((simulst::product<64>(
      n, d, hidden, 1, RowMajor<T>{du, hidden}, Transposed<T>{w1, hidden},
      CastStore<T>{static_cast<T*>(dx_), d}, s)));
  // dW1 and dW2 (K = rows in `splits` slices): one launch on the CUDA
  // cores, two on the tensor cores
  const auto dw1 = simulst::tile_problem<64>(d, hidden, n, splits,
                                             Transposed<T>{x, d},
                                             RowMajor<T>{du, hidden},
                                             Store{partial, len, 0, hidden});
  const auto dw2 = simulst::tile_problem<64>(hidden, d, n, splits,
                                             Transposed<T>{hd, hidden},
                                             RowMajor<T>{g, d},
                                             Store{partial, len, o_dw2, d});
  if constexpr (kF32) {
    SIMULST_TRY((simulst::tile_product_pair<64>(dw1, dw2, s)));
  } else {
    SIMULST_TRY((simulst::product<64>(d, hidden, n, splits, dw1.a, dw1.b,
                                      dw1.store, s)));
    SIMULST_TRY((simulst::product<64>(hidden, d, n, splits, dw2.a, dw2.b,
                                      dw2.store, s)));
  }
  // the column sums: 8 row lanes in fp32 (its bits), 32 in bf16
  constexpr int kLanes = kF32 ? 8 : 32;
  SIMULST_TRY(simulst::colsum_partial<kLanes>(du, n, hidden, splits, partial,
                                              len, o_db1, s));
  SIMULST_TRY(simulst::colsum_partial<kLanes>(g, n, d, splits, partial, len,
                                              o_db2, s));
  return (int)simulst::sum_splits(partial, splits, len, grads, s);
}

}  // namespace

// The backward of simulst_ffn (ln_res = 0): dx (n_rows, dim) of `dtype` and
// grads = [dW1 (dim, hidden) | dW2 (hidden, dim) | db1 (hidden) | db2 (dim)]
// in fp32.  Scratch: u (n_rows, hidden) fp32; hd, du (n_rows, hidden) and g
// (n_rows, dim) of `dtype`; dh (n_rows, hidden) fp32 in bf16 (unused in
// fp32, where hd may be u: h_d overwrites it); partial (splits,
// len(grads)) fp32, zero-filled.  In bf16 the five products run on the
// tensor cores (wgmma.cuh), and x, w1, w2 start on a 16-byte boundary.
// dim_real and hidden_real as simulst_ffn's (the dropout sites' offsets).
// Returns a cudaError_t.
extern "C" int simulst_ffn_bwd(int dtype, int act, const void* x,
                               const void* w1, const void* b1, const void* w2,
                               const void* dy, void* dx, void* grads, void* u,
                               void* hd, void* du, void* g, void* dh,
                               void* partial, int n_rows, int dim, int hidden,
                               int splits, int dim_real, int hidden_real,
                               unsigned long long seed, int act_on,
                               unsigned act_threshold, float act_inv_keep,
                               int out_on, unsigned out_threshold,
                               float out_inv_keep, void* stream) {
  if (!ffn_dim_ok(dim) || n_rows <= 0 || splits <= 0 || hidden <= 0 ||
      hidden % kChunk != 0 || act < kGelu || act > kTanh ||
      !ffn_real_ok(dim, hidden, dim_real, hidden_real) ||
      (dtype == simulst::kBF16 && dh == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout act_drop{seed, act_threshold, act_inv_keep, act_on};
  const Dropout out_drop{seed, out_threshold, out_inv_keep, out_on};
  float *gr = static_cast<float*>(grads), *uf = static_cast<float*>(u),
        *dhf = static_cast<float*>(dh), *pf = static_cast<float*>(partial);
  FFN_ACT_DISPATCH(act, SIMULST_DISPATCH(dtype, return launch_ffn_bwd<scalar_t, kA>(
                              x, w1, b1, w2, dy, dx, gr, uf,
                              static_cast<scalar_t*>(hd),
                              static_cast<scalar_t*>(du),
                              static_cast<scalar_t*>(g), dhf, pf, n_rows,
                              dim, hidden, splits, dim_real, hidden_real,
                              act_drop, out_drop, s)));
}
