// Fused projection with dropout and a gated residual for Hopper, forward and
// backward:
//   y = res + drop(h @ W + b)  on rows with row % period < res_rows (every
//   row when period == 0), and y = h @ W + b on the others, which ignore
//   `res`.
//
// Replaces the Pallas kernels simulst_tpu/ops/linear_res_pallas.py
// `fused_linear_drop_res` (_fwd_kernel and _bwd_kernel): the Emformer
// attention out-projection epilogue, where each group of G segments has
// period = G*(rc+seg+1) query rows and its trailing G summary rows take
// the plain projection, and the decoder's attention epilogues (period 0).
//
// What bounds it on the H100: at the MT decoder shape (8192 x 256 x 256,
// 1.07 GFLOP forward, 2.1 GFLOP backward) it is a small fp32 matrix product
// on the CUDA cores plus one read of h and res and one write of y (about
// 25 MB in fp32).  The forward tiles the output 64 x 64 per block (4 x 4
// per thread, K in steps of 32 through shared memory) and folds bias,
// dropout, residual gate and the cast into the store, so the projection
// never makes a separate round trip through device memory before the
// residual add.  Dropout draws Philox bits keyed by (seed, row * D_out +
// column).  The backward materialises du = drop(dy) on residual rows once
// (fp32), then runs dh = du W^T (128 x 64 tiles: N = D_in = 256 spreads
// over the SMs) and dW = h^T du (K = rows, split across blocks into fp32
// partials) as common.cuh tile_products, and db as column sums of du; one
// pass adds the partials, so dW and db are summed in fp32 without atomics.
// dW's K slices are ops/linear_res.py's (k_splits of its 64 x 64 tiles):
// they fix its bits.  d(res) is dy on residual rows and is formed by the
// caller, as in the JAX package's _flr_bwd.
#include "common.cuh"

namespace {

using simulst::Dropout;
using simulst::from_f32;
using simulst::to_f32;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(kThreads)
    linear_res_kernel(const T* __restrict__ h, const T* __restrict__ w,
                      const T* __restrict__ b, const T* __restrict__ res,
                      T* __restrict__ y, int n_rows, int din, int dout,
                      int period, int res_rows, Dropout drop) {
  __shared__ float as[kBK][kBM + 4];  // h tile, transposed: as[k][m]
  __shared__ float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < din; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int m = idx / kBK, k = idx % kBK;
      const int row = row0 + m;
      as[k][m] = row < n_rows ? to_f32(h[(size_t)row * din + k0 + k]) : 0.f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int k = idx / kBN, c = idx % kBN;
      bs[k][c] = to_f32(w[(size_t)(k0 + k) * dout + col0 + c]);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
    const bool is_res = period == 0 || (row % period) < res_rows;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      const size_t off = (size_t)row * dout + col;
      float u = acc[i][j] + to_f32(b[col]);
      if (is_res) u = u * drop.scale(off, 0) + to_f32(res[off]);
      y[off] = from_f32<T>(u);
    }
  }
}

template <typename T>
int launch_linear_res(const void* h, const void* w, const void* b,
                      const void* res, void* y, int n_rows, int din, int dout,
                      int period, int res_rows, Dropout drop,
                      cudaStream_t stream) {
  const dim3 grid(simulst::ceil_div(n_rows, kBM), dout / kBN);
  linear_res_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const T*>(res), static_cast<T*>(y),
      n_rows, din, dout, period, res_rows, drop);
  return (int)cudaGetLastError();
}

// the caller tag of the backward's store functors, so that a profile tells
// its tile_products from the FFN backwards'
struct TagLinearResBwd {};

template <typename T, class Caller>
struct CastStore {
  T* y;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    y[(size_t)m * ld + n] = from_f32<T>(v);
  }
};

template <typename T>
int launch_linear_res_bwd(const void* h_, const void* w_, const void* dy,
                          void* dh, float* grads, float* du, float* partial,
                          int n, int din, int dout, int period, int res_rows,
                          int splits, Dropout drop, cudaStream_t s) {
  using simulst::RowMajor;
  using simulst::Transposed;
  const T* h = static_cast<const T*>(h_);
  const T* w = static_cast<const T*>(w_);
  // grads / partial layout: [dW (din, dout) | db (dout)]
  const size_t len = (size_t)din * dout + dout;
  SIMULST_TRY((simulst::drop_grad<T>(dy, du, n, dout, drop, 0, period,
                                     res_rows, s)));
  SIMULST_TRY((simulst::tile_product<64>(
      n, din, dout, 1, RowMajor<float>{du, dout}, Transposed<T>{w, dout},
      CastStore<T, TagLinearResBwd>{static_cast<T*>(dh), din}, s)));
  SIMULST_TRY((simulst::tile_product<64>(
      din, dout, n, splits, Transposed<T>{h, din}, RowMajor<float>{du, dout},
      simulst::PartialStore<TagLinearResBwd>{partial, len, 0, dout}, s)));
  SIMULST_TRY(simulst::colsum_partial(du, n, dout, splits, partial, len,
                                      (size_t)din * dout, s));
  return (int)simulst::sum_splits(partial, splits, len, grads, s);
}

}  // namespace

// h: (n_rows, din); w: (din, dout); b: (dout,); res, y: (n_rows, dout), all
// of `dtype`.  din % 32 == 0 and dout % 64 == 0; dropout on residual rows
// when dropout != 0.  Returns a cudaError_t.
extern "C" int simulst_linear_res(int dtype, const void* h, const void* w,
                                  const void* b, const void* res, void* y,
                                  int n_rows, int din, int dout, int period,
                                  int res_rows, int dropout,
                                  unsigned long long seed, unsigned threshold,
                                  float inv_keep, void* stream) {
  if (n_rows <= 0 || din % kBK != 0 || dout % kBN != 0 || period < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, inv_keep, dropout};
  SIMULST_DISPATCH(dtype, return launch_linear_res<scalar_t>(
                              h, w, b, res, y, n_rows, din, dout, period,
                              res_rows, drop, s));
}

// The backward of simulst_linear_res: dh (n_rows, din) of `dtype` and
// grads = [dW (din, dout) | db (dout)] in fp32 from h, w and dy (n_rows,
// dout).  Scratch, fp32: du (n_rows, dout) and partial (splits, len(grads))
// zero-filled.  h and w start on a 16-byte boundary and din, dout are
// multiples of 4 (tile_product's loads).  Returns a cudaError_t.
extern "C" int simulst_linear_res_bwd(int dtype, const void* h, const void* w,
                                      const void* dy, void* dh, void* grads,
                                      void* du, void* partial, int n_rows,
                                      int din, int dout, int period,
                                      int res_rows, int splits, int dropout,
                                      unsigned long long seed,
                                      unsigned threshold, float inv_keep,
                                      void* stream) {
  if (n_rows <= 0 || din <= 0 || dout <= 0 || period < 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, inv_keep, dropout};
  SIMULST_DISPATCH(dtype, return launch_linear_res_bwd<scalar_t>(
                              h, w, dy, dh, static_cast<float*>(grads),
                              static_cast<float*>(du),
                              static_cast<float*>(partial), n_rows, din, dout,
                              period, res_rows, splits, drop, s));
}
