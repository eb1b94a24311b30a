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
// 25 MB in fp32).  The forward has three paths, which give the same bits
// (each output is one fmaf chain from 0 over k ascending, then the same
// epilogue expression) and which ops/linear_res.py:fwd_plan picks by row
// count:
//  - from TILED_MIN_ROWS rows, common.cuh's tile_product (one K slice;
//    128 x 64 output tiles, 128 x 128 from WIDE_MIN_ROWS, where the
//    narrower tiles would leave a second wave almost empty) with a store
//    functor that folds bias, dropout, residual gate and the cast into the
//    store, so the projection never makes a separate round trip through
//    device memory before the residual add.  ptxas: 153 and 127 registers
//    (bf16 157 and 127), no spills;
//  - below it (the decoder step's 40 rows, the streaming step's 1), a
//    row kernel that spreads the output columns over many blocks: one
//    output per thread, 8 rows x 32 columns per block, h and W staged 64 k
//    at a time through a two-stage cp.async ring (h rows broadcast from
//    shared memory), so that 40 rows take 40 blocks instead of 4.  ptxas:
//    48 registers (bf16 40), no spills.
// In bf16 (replacing linear_res_pallas.py `_fwd_call`'s bf16 dots, bf16
// operands with fp32 sums on the TPU's matrix unit) both tiled paths run
// the product on wgmma.cuh's wgmma_product: 12,800 x 256 x 256 (the
// Emformer out-projection at asr-train) is 1.7 GFLOP, under 0.002 ms at
// 989 TFLOP/s, so the bytes of h, res and y bound it (0.006 ms), and the
// CUDA-core product over widened bf16 (0.068 ms) lost to torch.matmul.
// The product goes to an fp32 scratch u, and the epilogue (bias, dropout,
// the gated residual, the cast) runs as a pass of its own at full
// occupancy, `linear_res_epilogue_kernel`: folded into wgmma_product's
// store, at its 16 consumer warps an SM, the same epilogue took longer
// (PERF.md, row 4).  The row kernel stays below TILED_MIN_ROWS, where the
// bytes of W bound it.  bf16 tiled paths and their plain version agree
// within bf16 tolerance, not bit for bit.
// Dropout draws Philox bits keyed by (seed, row * D_out + column).  The
// kernels take any width (the row kernel stages W and h 64 k at a time,
// the tile_products tile any shape); a D_in and a D_out that are not
// multiples of 32 and 64 reach the kernels zero-padded to the
// next multiples of 32 and 64 (ops/linear_res.py), with the real D_out
// beside the padded one for the dropout offsets (common.cuh
// unpadded_offset); padded columns of W, b and res are zero, so the real
// outputs are those of the unpadded call.  The
// backward materialises du = drop(dy) on residual rows once (rounded to
// the activation dtype, as the JAX kernel rounds it before its dots, and
// stored in it), then runs dh = du W^T (N = D_in = 256: 128 x 64 tiles on
// the CUDA cores, so that the grid spreads over the SMs) and dW = h^T du
// (K = rows, split across blocks into fp32 partials) as products, and db
// as column sums of du; one pass adds the partials, so dW and db are
// summed in fp32 without atomics.  In fp32 both products run on
// common.cuh's tile_product; in bf16 on wgmma.cuh's wgmma_product
// (simulst::product: bf16 operands on the tensor cores, fp32 sums; about
// 3.4 GFLOP at the Emformer's 12,800 rows, 0.0034 ms at 989 TFLOP/s, so
// the bytes of h, dy and dh bound it), with 32 row lanes in db's column
// sums.  dW's K slices are ops/linear_res.py's (k_splits of its 64 x 64
// tiles): in fp32 slices of ceil(ceil(rows / k_splits) / 32) * 32 rows,
// which fix its bits; wgmma_product rounds a slice up to its 64-row k
// tile, ceil(ceil(rows / k_splits) / 64) * 64 rows, so in bf16 the last
// slices may be shorter, or absent with their partials left zero (the
// wrapper zero-fills them).  d(res) is dy on residual rows and is formed
// by the caller, as in the JAX package's _flr_bwd.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using simulst::Dropout;
using simulst::from_f32;
using simulst::stage4;
using simulst::to_f32;

constexpr int kBK = 32;   // D_in must be a multiple
constexpr int kBN = 64;   // D_out must be a multiple

// the forward's paths (ops/linear_res.py FWD_PATHS)
constexpr int kPathRows = 0;
constexpr int kPathTiled = 1;   // tile_product<64>: 128 x 64 output tiles
constexpr int kPathWide = 2;    // tile_product<128>: 128 x 128

// y of one output (row, col) from its product acc: bias, then on residual
// rows (row % period < res_rows, every row when period == 0) dropout at
// mask offset `moff` and the residual res[off]; rounded to T
template <typename T>
__device__ __forceinline__ T linear_res_out(float acc, int row, int col,
                                            const T* __restrict__ b,
                                            const T* __restrict__ res,
                                            size_t off, size_t moff,
                                            int period, int res_rows,
                                            const Dropout& drop) {
  const bool is_res = period == 0 || (row % period) < res_rows;
  float u = acc + to_f32(b[col]);
  if (is_res) u = u * drop.scale(moff, 0) + to_f32(res[off]);
  return from_f32<T>(u);
}

// the callers' tags of the store functors, so that a profile tells the
// forward's tile_product from the backward's and the FFN's
struct TagLinearResFwd {};
struct TagLinearResBwd {};

// kPadded: D_out is padded, and the mask offsets are those of rows
// dout_real wide; else they are the outputs' own (the code of an unpadded
// call stays that of a kernel without padding)
template <typename T, class Caller, bool kPadded>
struct ResidualStore {
  const T* b;
  const T* res;
  T* y;
  int dout, dout_real, period, res_rows;
  Dropout drop;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    const size_t off = (size_t)m * dout + n;
    y[off] = linear_res_out(v, m, n, b, res, off,
                            kPadded ? (size_t)m * dout_real + n : off, period,
                            res_rows, drop);
  }
};

// ---------------------------------------------------------------------------
// the row kernel: grid (D_out / 32, ceil(rows / 8)), 256 threads
// ---------------------------------------------------------------------------
// Thread (r, c) = (tid / 32, tid % 32) computes output (row0 + r, col0 + c)
// as one chain over k; a warp shares its row, so its h reads are
// broadcasts and its W reads 32 neighbouring floats.
constexpr int kRowRows = 8;
constexpr int kRowCols = 32;
constexpr int kRowK = 64;                          // k per ring stage
constexpr int kRowThreads = kRowRows * kRowCols;   // one output each
constexpr int kRowHLd = kRowK + 4;

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    linear_res_rows_kernel(const T* __restrict__ h, const T* __restrict__ w,
                           const T* __restrict__ b, const T* __restrict__ res,
                           T* __restrict__ y, int n_rows, int din, int dout,
                           int dout_real, int period, int res_rows,
                           Dropout drop) {
  __shared__ __align__(16) float ws[2][kRowK][kRowCols];
  __shared__ __align__(16) float hs[2][kRowRows][kRowHLd];
  const int c = threadIdx.x % kRowCols, r = threadIdx.x / kRowCols;
  const int col0 = blockIdx.x * kRowCols, row0 = blockIdx.y * kRowRows;
  const int rows = min(kRowRows, n_rows - row0);
  const int steps = (din + kRowK - 1) / kRowK;
  auto load = [&](int step) {
    const int k0 = step * kRowK, k_len = min(kRowK, din - k0);
    for (int idx = threadIdx.x; idx < kRowK * kRowCols / 4;
         idx += kRowThreads) {
      const int k = idx / (kRowCols / 4), cc = idx % (kRowCols / 4) * 4;
      const bool ok = k < k_len;
      stage4(&ws[step % 2][k][cc],
             w + (ok ? (size_t)(k0 + k) * dout + col0 + cc : 0), ok);
    }
    for (int idx = threadIdx.x; idx < kRowRows * kRowK / 4;
         idx += kRowThreads) {
      const int rr = idx / (kRowK / 4), kk = idx % (kRowK / 4) * 4;
      const bool ok = rr < rows && kk < k_len;
      stage4(&hs[step % 2][rr][kk],
             h + (ok ? (size_t)(row0 + rr) * din + k0 + kk : 0), ok);
    }
  };

  float acc = 0.f;
  load(0);
  simulst::async_commit();
  for (int step = 0; step < steps; ++step) {
    simulst::async_wait<0>();
    __syncthreads();   // step's stage is in; step - 1's is free
    if (step + 1 < steps) load(step + 1);
    simulst::async_commit();
    const int k_len = min(kRowK, din - step * kRowK);
    const float* hr = hs[step % 2][r];
    const float(*wk)[kRowCols] = ws[step % 2];
    if (r < rows) {   // warp-uniform
#pragma unroll 4
      for (int k = 0; k < k_len; k += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hr + k);
        acc = fmaf(hv.x, wk[k][c], acc);
        acc = fmaf(hv.y, wk[k + 1][c], acc);
        acc = fmaf(hv.z, wk[k + 2][c], acc);
        acc = fmaf(hv.w, wk[k + 3][c], acc);
      }
    }
  }
  if (r < rows) {
    const size_t off = (size_t)(row0 + r) * dout + col0 + c;
    y[off] = linear_res_out(acc, row0 + r, col0 + c, b, res, off,
                            (size_t)(row0 + r) * dout_real + col0 + c, period,
                            res_rows, drop);
  }
}

// the bf16 tiled paths' product, h W, into the fp32 scratch u (Caller: the
// tag that names the product's caller in its kernel's name)
template <class Caller>
struct ProductStore {
  float* u;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    u[(size_t)m * ld + n] = v;
  }
  // columns n and n + 1 at once (wgmma_product's epilogue)
  __device__ __forceinline__ void pair(int m, int n, int, float v0,
                                       float v1) const {
    simulst::store_pair(u + (size_t)m * ld + n, v0, v1);
  }
};

// the bf16 tiled paths' epilogue, a pass of its own over wgmma_product's
// fp32 product u: y = linear_res_out of row blockIdx.x, 4 columns a
// thread (blockIdx.y: 1024 columns a block), the mask at the offsets of
// rows dout_real wide.  dout is a multiple of 4.
template <typename T>
__global__ void __launch_bounds__(256)
    linear_res_epilogue_kernel(const float* __restrict__ u,
                               const T* __restrict__ b,
                               const T* __restrict__ res, T* __restrict__ y,
                               int dout, int dout_real, int period,
                               int res_rows, Dropout drop) {
  const int col = 4 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (col >= dout) return;
  const int row = blockIdx.x;
  const size_t off = (size_t)row * dout + col;
  const size_t moff = (size_t)row * dout_real + col;
  const float4 u4 = *reinterpret_cast<const float4*>(u + off);
  const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
  float out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = to_f32(linear_res_out(uv[j], row, col + j, b, res, off + j,
                                   moff + j, period, res_rows, drop));
  simulst::store_pair(y + off, out[0], out[1]);
  simulst::store_pair(y + off + 2, out[2], out[3]);
}

template <typename T>
int launch_linear_res(const void* h_, const void* w_, const void* b_,
                      const void* res_, void* y_, float* u, int n_rows,
                      int din, int dout, int dout_real, int period,
                      int res_rows, int path, Dropout drop,
                      cudaStream_t stream) {
  using simulst::RowMajor;
  const T* h = static_cast<const T*>(h_);
  const T* w = static_cast<const T*>(w_);
  const T* b = static_cast<const T*>(b_);
  const T* res = static_cast<const T*>(res_);
  T* y = static_cast<T*>(y_);
  if (path == kPathRows) {
    const dim3 grid(dout / kRowCols, simulst::ceil_div(n_rows, kRowRows));
    linear_res_rows_kernel<T><<<grid, kRowThreads, 0, stream>>>(
        h, w, b, res, y, n_rows, din, dout, dout_real, period, res_rows,
        drop);
    return (int)cudaGetLastError();
  }
  if (path != kPathTiled && path != kPathWide)
    return (int)cudaErrorInvalidValue;
  const RowMajor<T> a{h, din}, bw{w, dout};
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // both tiled paths: the product on the tensor cores into u, then the
    // epilogue at full occupancy
    if (u == nullptr) return (int)cudaErrorInvalidValue;
    SIMULST_TRY(simulst::wgmma_product(n_rows, dout, din, 1, a, bw,
                                       ProductStore<TagLinearResFwd>{u, dout}, stream));
    linear_res_epilogue_kernel<T>
        <<<dim3(n_rows, simulst::ceil_div(dout, 1024)), 256, 0, stream>>>(
            u, b, res, y, dout, dout_real, period, res_rows, drop);
    return (int)cudaGetLastError();
  } else {
    if (dout_real != dout) {   // a padded call: its tiled paths on 128 x 64
      const ResidualStore<T, TagLinearResFwd, true> padded{
          b, res, y, dout, dout_real, period, res_rows, drop};
      return (int)simulst::tile_product<64>(n_rows, dout, din, 1, a, bw,
                                            padded, stream);
    }
    const ResidualStore<T, TagLinearResFwd, false> store{
        b, res, y, dout, dout_real, period, res_rows, drop};
    if (path == kPathTiled)
      return (int)simulst::tile_product<64>(n_rows, dout, din, 1, a, bw,
                                            store, stream);
    return (int)simulst::tile_product<128>(n_rows, dout, din, 1, a, bw,
                                           store, stream);
  }
}

template <typename T, class Caller>
struct CastStore {
  T* y;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    y[(size_t)m * ld + n] = from_f32<T>(v);
  }
};

// du is T: in bf16 both products run on the tensor cores
template <typename T>
int launch_linear_res_bwd(const void* h_, const void* w_, const void* dy,
                          void* dh, float* grads, T* du, float* partial,
                          int n, int din, int dout, int dout_real,
                          int period, int res_rows, int splits, Dropout drop,
                          cudaStream_t s) {
  using simulst::RowMajor;
  using simulst::Transposed;
  const T* h = static_cast<const T*>(h_);
  const T* w = static_cast<const T*>(w_);
  // grads / partial layout: [dW (din, dout) | db (dout)]
  const size_t len = (size_t)din * dout + dout;
  SIMULST_TRY((simulst::drop_grad<T, T>(dy, du, n, dout, dout_real, drop, 0,
                                        period, res_rows, s)));
  SIMULST_TRY((simulst::product<64>(
      n, din, dout, 1, RowMajor<T>{du, dout}, Transposed<T>{w, dout},
      CastStore<T, TagLinearResBwd>{static_cast<T*>(dh), din}, s)));
  SIMULST_TRY((simulst::product<64>(
      din, dout, n, splits, Transposed<T>{h, din}, RowMajor<T>{du, dout},
      simulst::PartialStore<TagLinearResBwd>{partial, len, 0, dout}, s)));
  // the column sums: 8 row lanes in fp32 (its bits), 32 in bf16
  constexpr int kLanes = std::is_same<T, float>::value ? 8 : 32;
  SIMULST_TRY(simulst::colsum_partial<kLanes>(du, n, dout, splits, partial,
                                              len, (size_t)din * dout, s));
  return (int)simulst::sum_splits(partial, splits, len, grads, s);
}

}  // namespace

// h: (n_rows, din); w: (din, dout); b: (dout,); res, y: (n_rows, dout), all
// of `dtype`; h and w start on a 16-byte boundary.  din % 32 == 0 and
// dout % 64 == 0; dout_real: the D_out of a call zero-padded to dout (dout
// itself when nothing is padded; less than 64 below it), the row length
// of the dropout offsets; dropout on residual rows when dropout != 0.  path: the
// row kernel (0), the tiled product with 128 x 64 tiles (1) or 128 x 128
// (2, 128 x 64 when padded), as ops/linear_res.py:fwd_plan picks; in fp32
// all give the same bits.  In bf16 paths 1 and 2 both run the product on
// the tensor cores into u, an fp32 scratch (n_rows, dout), then the
// epilogue pass; u is not read on path 0 or in fp32 (null there).
// Returns a cudaError_t.
extern "C" int simulst_linear_res(int dtype, const void* h, const void* w,
                                  const void* b, const void* res, void* y,
                                  void* u, int n_rows, int din, int dout,
                                  int dout_real, int period, int res_rows,
                                  int path, int dropout,
                                  unsigned long long seed, unsigned threshold,
                                  float inv_keep, void* stream) {
  if (n_rows <= 0 || din % kBK != 0 || dout % kBN != 0 || period < 0 ||
      dout_real <= dout - kBN || dout_real > dout ||
      reinterpret_cast<size_t>(h) % 16 != 0 ||
      reinterpret_cast<size_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, inv_keep, dropout};
  SIMULST_DISPATCH(dtype, return launch_linear_res<scalar_t>(
                              h, w, b, res, y, static_cast<float*>(u),
                              n_rows, din, dout, dout_real, period, res_rows,
                              path, drop, s));
}

// The backward of simulst_linear_res: dh (n_rows, din) of `dtype` and
// grads = [dW (din, dout) | db (dout)] in fp32 from h, w and dy (n_rows,
// dout).  Scratch: du (n_rows, dout) of `dtype` and partial (splits,
// len(grads)) fp32, zero-filled.  h and w start on a 16-byte boundary and
// din, dout are multiples of 8 (the products' loads; bf16: TMA's);
// dout_real as simulst_linear_res's (at most dout).  Returns a
// cudaError_t.
extern "C" int simulst_linear_res_bwd(int dtype, const void* h, const void* w,
                                      const void* dy, void* dh, void* grads,
                                      void* du, void* partial, int n_rows,
                                      int din, int dout, int dout_real,
                                      int period, int res_rows, int splits,
                                      int dropout,
                                      unsigned long long seed,
                                      unsigned threshold, float inv_keep,
                                      void* stream) {
  if (n_rows <= 0 || din <= 0 || dout <= 0 || period < 0 || splits <= 0 ||
      dout_real <= 0 || dout_real > dout)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, inv_keep, dropout};
  SIMULST_DISPATCH(dtype, return launch_linear_res_bwd<scalar_t>(
                              h, w, dy, dh, static_cast<float*>(grads),
                              static_cast<scalar_t*>(du),
                              static_cast<float*>(partial), n_rows, din, dout,
                              dout_real, period, res_rows, splits, drop, s));
}
