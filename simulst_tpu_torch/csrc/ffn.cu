// Fused position-wise FFN for Hopper, forward and backward:
//   y = [x +] drop_o(fc2(drop_a(act(fc1([LN](x))))))
//
// Replaces the Pallas kernels simulst_tpu/ops/ffn_pallas.py
// `fused_ln_ffn_res` (_ln_ffn_fwd_kernel and _ln_ffn_bwd_kernel; the Emformer
// pos_ff block with its pre-LN and residual) and `fused_ffn` (_fwd_kernel
// and _bwd_kernel; the decoder FFN), each with gelu, relu, silu or tanh
// (the JAX package takes silu and tanh to XLA) and both dropouts.  One
// forward entry serves both: the LN prologue and the residual epilogue are
// template flags.  The LN parameters are fp32 whatever the activation dtype,
// as the JAX package passes them, and their gradients come back in fp32.
//
// What bounds it on the H100: at the training and offline shapes (3072 to
// 12,288 rows x 256 x 2048) it is compute, 6.4 GFLOP per 3072 rows, run
// here on the CUDA cores in fp32 (TF32 tensor cores would miss the fp32
// tolerance); at the streaming and decoder shapes (1..40 rows) it is
// reading W1 and W2 (2 x 2 MB in fp32).  So the forward has two paths, which
// give the same bits; the wrapper picks one by the row count
// (ops/ffn.py slice_plan):
//  - few rows: one fused kernel keeps the (rows x 2048) hidden out of
//    device memory, as the TPU kernel did: a block owns a 32-row tile,
//    normalises it once into shared memory, then walks its share of the
//    hidden in 64-column chunks, computing drop_a(act(x W1[:, c] + b1)) into
//    shared memory and accumulating h_c W2[c, :] into fp32 registers.  So
//    that a few rows still spread over the SMs, the hidden is split across
//    `splits` blocks (grid.y);
//  - many rows: the LN row pass (ln_res 1), then two tile_products
//    (common.cuh: 128-row tiles, 8 x 8 outputs per thread, cp.async): the
//    hidden product writes h = drop_a(act(x W1 + b1)) to device memory, and
//    the output product h W2 sums the same `splits` slices of the hidden.
//    The hidden makes one round trip through device memory (2 x 100 MB at
//    12,288 rows, about 0.06 ms at 3.35 TB/s): the price of tiles that
//    read each weight tile once per 128 rows instead of once per 32.
// Either path writes an fp32 partial (rows x 256) per split, and a second
// small kernel sums the partials in order and adds b2, the output dropout
// and the residual.  Each output is one fmaf chain over k ascending within
// its split, in both paths, so they agree bit for bit.  GELU is the exact
// erf form (the TPU kernel used tanh only because Mosaic has no erf).
// Dropout draws Philox bits keyed by (seed, row * hidden + column) for the
// hidden (stream 0) and (seed, row * 256 + column) for the output (stream 1).
//
// The backwards (training: the MT decoder FFN at 8192 rows, the Emformer
// LN-FFN at 12,288 rows, x 256 x 2048: 43-64 GFLOP, so compute) recompute
// the hidden and both masks and run as five fp32 tile_products with fused
// epilogues:
//   u  = x W1 + b1                                 (the recompute)
//   dh = g W2^T, g = drop_o(dy); epilogue du = dh act'(u) m_a, and u is
//        overwritten with h_d = act(u) m_a
//   dx = du W1^T
//   dW1 = x^T du, dW2 = h_d^T g                    (K = rows, split across
//                                                   blocks, fp32 partials)
// plus column sums for db1 and db2 and one pass that adds the partials, so
// every weight gradient is summed in fp32 without atomics.  u and du make
// one round trip through device memory (2 x 64 MB at the MT shape, about an
// eighth of the compute bound).  The LN-FFN backward adds two row passes
// around the products: the first normalises x into an fp32 buffer (the fc1
// input, rounded to the activation dtype, and each row's mean and 1/sigma);
// the product du W1^T then yields dnormed in fp32, and the second row pass
// takes LN's backward along each row (two warp reductions: mean(dnormed
// gamma) and mean(dnormed gamma xhat)), adds the residual's dy and writes
// dx; it also leaves dnormed xhat in the first buffer, whose column sums
// (split like the weight products) give dgamma, and those of dnormed dbeta.
//
// Every store functor of a tile_product names its caller (a tag type), so
// that a profile's kernel names tell the forward's products and those of
// the two backwards apart.
#include "common.cuh"

namespace {

using simulst::Dropout;
using simulst::from_f32;
using simulst::gelu_erf;
using simulst::round_to;
using simulst::to_f32;

constexpr int kDim = 256;      // model width the kernel is built for
constexpr int kRows = 32;      // rows per block
constexpr int kChunk = 64;     // hidden columns per inner chunk
constexpr int kThreads = 256;  // 8 warps; warp w owns rows 4w .. 4w+3
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr size_t kSmemBytes =
    (size_t)(kRows * kDim + kRows * kChunk + kDim * kChunk) * sizeof(float);

static_assert(kRowsPerWarp == 4, "thread tiling assumes 4 rows per warp");
static_assert(kChunk == 64, "thread tiling assumes 2 hidden columns per lane");

// activation codes passed from Python (ops/ffn.py ACTIVATION_CODES)
constexpr int kGelu = 0;
constexpr int kRelu = 1;
constexpr int kSilu = 2;
constexpr int kTanh = 3;

template <int kAct>
__device__ __forceinline__ float act_fn(float u) {
  if (kAct == kSilu) return u / (1.0f + expf(-u));  // u sigmoid(u)
  if (kAct == kTanh) return tanhf(u);
  return kAct == kRelu ? fmaxf(u, 0.f) : gelu_erf(u);
}

// d act / du; relu' is 1 where u > 0, as jax.nn.relu's gradient
template <int kAct>
__device__ __forceinline__ float act_grad(float u) {
  if (kAct == kRelu) return u > 0.f ? 1.f : 0.f;
  if (kAct == kSilu) {
    const float sg = 1.0f / (1.0f + expf(-u));
    return sg * (1.0f + u * (1.0f - sg));
  }
  if (kAct == kTanh) {
    const float t = tanhf(u);
    return 1.0f - t * t;
  }
  return 0.5f * (1.0f + erff(u * 0.7071067811865476f)) +
         u * 0.3989422804014327f * expf(-0.5f * u * u);
}

// runs the statement with kA bound to the activation code `act` as a
// constant; an unknown code returns cudaErrorInvalidValue
#define FFN_ACT_DISPATCH(act, ...)                          \
  switch (act) {                                            \
    case kGelu: { constexpr int kA = kGelu; __VA_ARGS__; }  \
    case kRelu: { constexpr int kA = kRelu; __VA_ARGS__; }  \
    case kSilu: { constexpr int kA = kSilu; __VA_ARGS__; }  \
    case kTanh: { constexpr int kA = kTanh; __VA_ARGS__; }  \
    default: return (int)cudaErrorInvalidValue;             \
  }

template <typename T, bool kLayerNorm, int kAct>
__global__ void __launch_bounds__(kThreads)
    ffn_partial_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                       const float* __restrict__ ln_b, const T* __restrict__ w1,
                       const T* __restrict__ b1, const T* __restrict__ w2,
                       float* __restrict__ partial, int n_rows, int hidden,
                       int hidden_per_split, Dropout act_drop) {
  extern __shared__ float smem[];
  float* xs = smem;                  // [kRows][kDim] fc1 input, rounded to T
  float* hs = xs + kRows * kDim;     // [kRows][kChunk] drop_a(act(u)), rounded to T
  float* wb = hs + kRows * kChunk;   // W1 chunk [kDim][kChunk], then W2 chunk
                                     // [kChunk][kDim]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int h_begin = blockIdx.y * hidden_per_split;

  // prologue: LayerNorm in fp32 (statistics over the full row, eps 1e-5)
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = row0 + r;
    float v[kDim / 32];
#pragma unroll
    for (int i = 0; i < kDim / 32; ++i)
      v[i] = row < n_rows ? to_f32(x[(size_t)row * kDim + lane + 32 * i]) : 0.f;
    if (kLayerNorm) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kDim / 32; ++i) s += v[i];
      const float mean = simulst::warp_sum(s) / kDim;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < kDim / 32; ++i) {
        const float c = v[i] - mean;
        q += c * c;
      }
      const float inv = rsqrtf(simulst::warp_sum(q) / kDim + 1e-5f);
#pragma unroll
      for (int i = 0; i < kDim / 32; ++i) {
        const int col = lane + 32 * i;
        v[i] = (v[i] - mean) * inv * ln_g[col] + ln_b[col];
      }
    }
#pragma unroll
    for (int i = 0; i < kDim / 32; ++i)
      xs[r * kDim + lane + 32 * i] = round_to<T>(v[i]);
  }

  const int r_base = warp * kRowsPerWarp;
  float acc[kRowsPerWarp][kDim / 32];  // rows r_base+r, cols lane + 32 j
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < kDim / 32; ++j) acc[r][j] = 0.f;

  for (int h0 = h_begin; h0 < h_begin + hidden_per_split; h0 += kChunk) {
    __syncthreads();  // xs written (first chunk); wb free (later chunks)
    for (int idx = tid; idx < kDim * kChunk; idx += kThreads) {
      const int k = idx / kChunk, c = idx % kChunk;
      wb[idx] = to_f32(w1[(size_t)k * hidden + h0 + c]);
    }
    __syncthreads();

    float u[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) u[r][0] = u[r][1] = 0.f;
    for (int k = 0; k < kDim; ++k) {
      const float w_a = wb[k * kChunk + lane];
      const float w_b = wb[k * kChunk + lane + 32];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float a = xs[(r_base + r) * kDim + k];
        u[r][0] = fmaf(a, w_a, u[r][0]);
        u[r][1] = fmaf(a, w_b, u[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const float uu = u[r][j] + to_f32(b1[h0 + c]);
        const size_t off = (size_t)(row0 + r_base + r) * hidden + h0 + c;
        hs[(r_base + r) * kChunk + c] =
            round_to<T>(act_fn<kAct>(uu) * act_drop.scale(off, 0));
      }
    __syncthreads();  // hs complete; wb free

    for (int idx = tid; idx < kChunk * kDim; idx += kThreads) {
      const int k = idx / kDim, c = idx % kDim;
      wb[idx] = to_f32(w2[(size_t)(h0 + k) * kDim + c]);
    }
    __syncthreads();

    for (int k = 0; k < kChunk; ++k) {
      float a[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) a[r] = hs[(r_base + r) * kChunk + k];
#pragma unroll
      for (int j = 0; j < kDim / 32; ++j) {
        const float b = wb[k * kDim + lane + 32 * j];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r][j] = fmaf(a[r], b, acc[r][j]);
      }
    }
  }

  float* out = partial + (size_t)blockIdx.y * n_rows * kDim;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r_base + r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < kDim / 32; ++j)
      out[(size_t)row * kDim + lane + 32 * j] = acc[r][j];
  }
}

// y = drop_o(sum of the split partials + b2) [+ x], residual added in fp32
template <typename T, bool kResidual>
__global__ void ffn_epilogue_kernel(const float* __restrict__ partial,
                                    int splits, const T* __restrict__ b2,
                                    const T* __restrict__ x, T* __restrict__ y,
                                    int n_rows, Dropout out_drop) {
  const size_t total = (size_t)n_rows * kDim;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[sp * total + idx];
  s += to_f32(b2[idx % kDim]);
  s *= out_drop.scale(idx, 1);
  if (kResidual) s += to_f32(x[idx]);
  y[idx] = from_f32<T>(s);
}

constexpr int kRowThreads = 256;   // one warp per row, 8 rows per block

// xn = round_T(LN(x) gamma + beta) in fp32 (the expression of
// ffn_partial_kernel's prologue), stats = (mean, 1/sigma) per row unless null
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, float* __restrict__ xn,
                   float* __restrict__ stats, int n_rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  float v[kDim / 32];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kDim / 32; ++i) {
    v[i] = to_f32(x[(size_t)row * kDim + lane + 32 * i]);
    s += v[i];
  }
  const float mean = simulst::warp_sum(s) / kDim;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kDim / 32; ++i) {
    const float c = v[i] - mean;
    q += c * c;
  }
  const float inv = rsqrtf(simulst::warp_sum(q) / kDim + 1e-5f);
#pragma unroll
  for (int i = 0; i < kDim / 32; ++i) {
    const int col = lane + 32 * i;
    xn[(size_t)row * kDim + col] =
        round_to<T>((v[i] - mean) * inv * ln_g[col] + ln_b[col]);
  }
  if (stats != nullptr && lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = inv;
  }
}

// callers of the tile_products, the tags of their shared store functors
struct TagFfnFwd {};
struct TagFfnBwd {};
struct TagLnFfnBwd {};

// h = round_T(act(acc + b1) m_a) into the fp32 hidden buffer: the fused
// kernel's hidden chunk, for the whole hidden
template <typename T, int kAct>
struct HiddenStore {
  float* h;
  const T* b1;
  int hidden;
  Dropout act_drop;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    const size_t off = (size_t)m * hidden + n;
    const float uu = v + to_f32(b1[n]);
    h[off] = round_to<T>(act_fn<kAct>(uu) * act_drop.scale(off, 0));
  }
};

// h == nullptr: the fused row-block kernel; else the LN row pass into xn
// (kLayerNorm), the hidden product into h and the output product into the
// split partials.  Then the epilogue.
template <typename T, bool kLayerNorm, int kAct>
int launch_ffn(const void* x_, const void* ln_g_, const void* ln_b_,
               const void* w1_, const void* b1_, const void* w2_,
               const void* b2, void* y, float* partial, float* xn, float* h,
               int n_rows, int hidden, int splits, Dropout act_drop,
               Dropout out_drop, cudaStream_t stream) {
  using simulst::RowMajor;
  const T* x = static_cast<const T*>(x_);
  const float* ln_g = static_cast<const float*>(ln_g_);
  const float* ln_b = static_cast<const float*>(ln_b_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* b1 = static_cast<const T*>(b1_);
  const T* w2 = static_cast<const T*>(w2_);
  if (h == nullptr) {
    auto partial_kernel = ffn_partial_kernel<T, kLayerNorm, kAct>;
    SIMULST_TRY(cudaFuncSetAttribute(
        partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes));
    const dim3 grid(simulst::ceil_div(n_rows, kRows), splits);
    partial_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
        x, ln_g, ln_b, w1, b1, w2, partial, n_rows, hidden, hidden / splits,
        act_drop);
    SIMULST_TRY(cudaGetLastError());
  } else {
    const HiddenStore<T, kAct> store{h, b1, hidden, act_drop};
    if constexpr (kLayerNorm) {
      ln_rows_kernel<T><<<simulst::ceil_div(n_rows, kRowThreads / 32),
                          kRowThreads, 0, stream>>>(x, ln_g, ln_b, xn,
                                                    nullptr, n_rows);
      SIMULST_TRY(cudaGetLastError());
      SIMULST_TRY((simulst::tile_product<128, true>(
          n_rows, hidden, kDim, 1, RowMajor<float>{xn, kDim},
          RowMajor<T>{w1, hidden}, store, stream)));
    } else {
      SIMULST_TRY((simulst::tile_product<128, true>(
          n_rows, hidden, kDim, 1, RowMajor<T>{x, kDim},
          RowMajor<T>{w1, hidden}, store, stream)));
    }
    // the fused kernel's hidden splits, as K slices: the same sums
    SIMULST_TRY((simulst::tile_product<64>(
        n_rows, kDim, hidden, splits, RowMajor<float>{h, hidden},
        RowMajor<T>{w2, kDim},
        simulst::PartialStore<TagFfnFwd>{partial, (size_t)n_rows * kDim, 0,
                                         kDim},
        stream)));
  }
  const int total = n_rows * kDim;
  ffn_epilogue_kernel<T, kLayerNorm>
      <<<simulst::ceil_div(total, 256), 256, 0, stream>>>(
          partial, splits, static_cast<const T*>(b2), x, static_cast<T*>(y),
          n_rows, out_drop);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// u = acc + b1 into the fp32 hidden buffer
template <typename T, class Caller>
struct BiasStore {
  float* u;
  const T* b1;
  int hidden;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    u[(size_t)m * hidden + n] = v + to_f32(b1[n]);
  }
};

// dh -> du = round_T(dh act'(u) m_a); u -> h_d = round_T(act(u) m_a)
template <typename T, int kAct, class Caller>
struct HiddenGradStore {
  float* u;   // in: u, out: h_d
  float* du;
  int hidden;
  Dropout act_drop;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    const size_t off = (size_t)m * hidden + n;
    const float uu = u[off];
    const float mult = act_drop.scale(off, 0);
    du[off] = round_to<T>(v * act_grad<kAct>(uu) * mult);
    u[off] = round_to<T>(act_fn<kAct>(uu) * mult);
  }
};

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
                   int hidden, int splits, Dropout act_drop, Dropout out_drop,
                   cudaStream_t s) {
  using simulst::RowMajor;
  using simulst::Transposed;
  using Store = simulst::PartialStore<TagFfnBwd>;
  const T* x = static_cast<const T*>(x_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* w2 = static_cast<const T*>(w2_);
  const int d = kDim;
  // grads / partial layout: [dW1 (d, hidden) | dW2 (hidden, d) | db1 | db2]
  const size_t len = 2 * (size_t)d * hidden + hidden + d;
  const size_t o_dw2 = (size_t)d * hidden, o_db1 = 2 * o_dw2,
               o_db2 = o_db1 + hidden;
  SIMULST_TRY((simulst::drop_grad<T>(dy, g, n, d, out_drop, 1, 0, 0, s)));
  SIMULST_TRY((simulst::tile_product<128>(
      n, hidden, d, 1, RowMajor<T>{x, d}, RowMajor<T>{w1, hidden},
      BiasStore<T, TagFfnBwd>{u, static_cast<const T*>(b1_), hidden}, s)));
  SIMULST_TRY((simulst::tile_product<128, true>(
      n, hidden, d, 1, RowMajor<float>{g, d}, Transposed<T>{w2, d},
      HiddenGradStore<T, kAct, TagFfnBwd>{u, du, hidden, act_drop}, s)));
  // N = 256: 128 x 64 tiles, so that the grid spreads over the SMs
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


// ---------------------------------------------------------------------------
// LN-FFN backward
// ---------------------------------------------------------------------------

// dx = inv (gg - mean(gg) - xhat mean(gg xhat)) + dy with gg = dn gamma;
// xn is overwritten with dn xhat (the per-row terms of dgamma)
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                       const float* __restrict__ stats,
                       const float* __restrict__ dn, const T* __restrict__ dy,
                       T* __restrict__ dx, float* __restrict__ xn,
                       int n_rows) {
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
  const float m1 = simulst::warp_sum(s1) / kDim;
  const float m2 = simulst::warp_sum(s2) / kDim;
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
                      float* partial, int n, int hidden, int splits,
                      Dropout act_drop, Dropout out_drop, cudaStream_t s) {
  using simulst::RowMajor;
  using simulst::Transposed;
  using Store = simulst::PartialStore<TagLnFfnBwd>;
  const T* x = static_cast<const T*>(x_);
  const float* ln_g = static_cast<const float*>(g_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* w2 = static_cast<const T*>(w2_);
  const T* dy = static_cast<const T*>(dy_);
  const int d = kDim;
  // grads / partial layout:
  // [dW1 (d, hidden) | dW2 (hidden, d) | db1 | db2 | dgamma | dbeta]
  const size_t o_dw2 = (size_t)d * hidden, o_db1 = 2 * o_dw2,
               o_db2 = o_db1 + hidden, o_dg = o_db2 + d, o_dbe = o_dg + d,
               len = o_dbe + d;
  const int row_blocks = simulst::ceil_div(n, kRowThreads / 32);
  ln_rows_kernel<T><<<row_blocks, kRowThreads, 0, s>>>(
      x, ln_g, static_cast<const float*>(be_), xn, stats, n);
  SIMULST_TRY(cudaGetLastError());
  SIMULST_TRY((simulst::drop_grad<T>(dy, g, n, d, out_drop, 1, 0, 0, s)));
  SIMULST_TRY((simulst::tile_product<128>(
      n, hidden, d, 1, RowMajor<float>{xn, d}, RowMajor<T>{w1, hidden},
      BiasStore<T, TagLnFfnBwd>{u, static_cast<const T*>(b1_), hidden}, s)));
  SIMULST_TRY((simulst::tile_product<128, true>(
      n, hidden, d, 1, RowMajor<float>{g, d}, Transposed<T>{w2, d},
      HiddenGradStore<T, kAct, TagLnFfnBwd>{u, du, hidden, act_drop}, s)));
  // N = 256: 128 x 64 tiles, so that the grid spreads over the SMs
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
  ln_bwd_rows_kernel<T><<<row_blocks, kRowThreads, 0, s>>>(
      x, ln_g, stats, dn, dy, static_cast<T*>(dx_), xn, n);
  SIMULST_TRY(cudaGetLastError());
  SIMULST_TRY(simulst::colsum_partial(xn, n, d, splits, partial, len, o_dg,
                                      s));
  SIMULST_TRY(simulst::colsum_partial(dn, n, d, splits, partial, len, o_dbe,
                                      s));
  return (int)simulst::sum_splits(partial, splits, len, grads, s);
}

}  // namespace

// ln_res = 1: y = x + drop_o(fc2(drop_a(act(fc1(LN(x))))))
//             (fused_ln_ffn_res)
// ln_res = 0: y = drop_o(fc2(drop_a(act(fc1(x)))))  (fused_ffn; ln_g/ln_b
//             unused)
// x, y: (n_rows, dim); w1: (dim, hidden); w2: (hidden, dim), all of `dtype`;
// ln_g, ln_b: (dim) fp32 whatever `dtype` (the LN is computed in fp32);
// partial: fp32 scratch of (splits, n_rows, dim); act 0 gelu, 1 relu,
// 2 silu, 3 tanh; each dropout site is on when its flag is set.  h null: the fused row-block
// kernel; else the tiled path, with fp32 scratch h (n_rows, hidden) and, for
// ln_res = 1, xn (n_rows, dim), and x, w1, w2 16-byte aligned.  Both paths
// give the same bits.  Returns a cudaError_t.
extern "C" int simulst_ffn(int dtype, int ln_res, int act, const void* x,
                           const void* ln_g, const void* ln_b, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           void* y, void* partial, void* xn, void* h,
                           int n_rows, int dim, int hidden, int splits,
                           unsigned long long seed, int act_on,
                           unsigned act_threshold, float act_inv_keep,
                           int out_on, unsigned out_threshold,
                           float out_inv_keep, void* stream) {
  if (dim != kDim || n_rows <= 0 || splits <= 0 ||
      hidden % (splits * kChunk) != 0 || act < kGelu || act > kTanh ||
      (h != nullptr && ln_res && xn == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *p = static_cast<float*>(partial), *xf = static_cast<float*>(xn),
        *hf = static_cast<float*>(h);
  const Dropout act_drop{seed, act_threshold, act_inv_keep, act_on};
  const Dropout out_drop{seed, out_threshold, out_inv_keep, out_on};
  if (ln_res) {
    FFN_ACT_DISPATCH(act, SIMULST_DISPATCH(dtype, return launch_ffn<scalar_t, true, kA>(
                                x, ln_g, ln_b, w1, b1, w2, b2, y, p, xf, hf,
                                n_rows, hidden, splits, act_drop, out_drop, s)));
  }
  FFN_ACT_DISPATCH(act, SIMULST_DISPATCH(dtype, return launch_ffn<scalar_t, false, kA>(
                              x, ln_g, ln_b, w1, b1, w2, b2, y, p, xf, hf,
                              n_rows, hidden, splits, act_drop, out_drop, s)));
}

// The backward of simulst_ffn (ln_res = 0): dx (n_rows, dim) of `dtype` and
// grads = [dW1 (dim, hidden) | dW2 (hidden, dim) | db1 (hidden) | db2 (dim)]
// in fp32.  Scratch, all fp32: u and du (n_rows, hidden), g (n_rows, dim),
// partial (splits, len(grads)) zero-filled.  Returns a cudaError_t.
extern "C" int simulst_ffn_bwd(int dtype, int act, const void* x,
                               const void* w1, const void* b1, const void* w2,
                               const void* dy, void* dx, void* grads, void* u,
                               void* du, void* g, void* partial, int n_rows,
                               int dim, int hidden, int splits,
                               unsigned long long seed, int act_on,
                               unsigned act_threshold, float act_inv_keep,
                               int out_on, unsigned out_threshold,
                               float out_inv_keep, void* stream) {
  if (dim != kDim || n_rows <= 0 || splits <= 0 || hidden <= 0 ||
      act < kGelu || act > kTanh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout act_drop{seed, act_threshold, act_inv_keep, act_on};
  const Dropout out_drop{seed, out_threshold, out_inv_keep, out_on};
  float *gr = static_cast<float*>(grads), *uf = static_cast<float*>(u),
        *duf = static_cast<float*>(du), *gf = static_cast<float*>(g),
        *pf = static_cast<float*>(partial);
  FFN_ACT_DISPATCH(act, SIMULST_DISPATCH(dtype, return launch_ffn_bwd<scalar_t, kA>(
                              x, w1, b1, w2, dy, dx, gr, uf, duf, gf, pf,
                              n_rows, hidden, splits, act_drop, out_drop, s)));
}

// The backward of simulst_ffn with ln_res = 1 (ln_g, ln_b fp32): dx
// (n_rows, dim) of `dtype` and grads = [dW1 (dim, hidden) | dW2 (hidden, dim) | db1 (hidden) |
// db2 (dim) | dgamma (dim) | dbeta (dim)] in fp32.  Scratch, all fp32: xn,
// g and dn (n_rows, dim), stats (n_rows, 2), u and du (n_rows, hidden),
// partial (splits, len(grads)) zero-filled.  Returns a cudaError_t.
extern "C" int simulst_ln_ffn_bwd(int dtype, int act, const void* x,
                                  const void* ln_g, const void* ln_b,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* dy, void* dx,
                                  void* grads, void* xn, void* stats, void* u,
                                  void* du, void* g, void* dn, void* partial,
                                  int n_rows, int dim, int hidden, int splits,
                                  unsigned long long seed, int act_on,
                                  unsigned act_threshold, float act_inv_keep,
                                  int out_on, unsigned out_threshold,
                                  float out_inv_keep, void* stream) {
  if (dim != kDim || n_rows <= 0 || splits <= 0 || hidden <= 0 ||
      act < kGelu || act > kTanh)
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
                              uf, duf, gf, dnf, pf, n_rows, hidden, splits,
                              act_drop, out_drop, s)));
}
