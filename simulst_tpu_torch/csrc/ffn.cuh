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
// Either path writes an fp32 partial (rows x D) per split, and a second
// small kernel sums the partials in order and adds b2, the output dropout
// and the residual.  Each output is one fmaf chain over k ascending within
// its split, in both paths, so they agree bit for bit.  GELU is the exact
// erf form (the TPU kernel used tanh only because Mosaic has no erf).
// Dropout draws Philox bits keyed by (seed, row * hidden + column) for the
// hidden (stream 0) and (seed, row * D + column) for the output (stream 1).
//
// Widths: D is any multiple of 64 and the hidden any multiple of 64.  The
// row kernels and the fused kernel keep a row's columns in registers, so
// they are templates on D: the row kernels for every multiple of 64 up to
// kMaxDim (1024), the fused kernel for 64, 128, 256 and 512 (its 32-row
// tile and W1 / W2 chunks take 200 KB of shared memory at 512).  Above
// kMaxDim the row kernels walk a row 32 columns a lane at a time, reading
// it again for each of their passes (ln_rows_wide_kernel,
// ln_bwd_rows_wide_kernel: correct, not tuned); the tile_products and
// wgmma_products take any width.  At widths without a fused kernel the
// forward runs its tiled path at every row count (same bits in fp32).
// Any other D and hidden reach the kernels zero-padded to the next
// multiple of 64 (ops/ffn.py), with the real widths beside the padded
// ones: LN's mean and variance and its backward's row means are over the
// real D (a padded column adds nothing to them), and both dropout sites
// draw the unpadded offsets (common.cuh unpadded_offset).  The padded
// columns stay zero through every step (zero LN parameters, zero weights
// and biases, act(0) = 0 for every activation), so the real columns are
// those of the unpadded call.
//
// bf16: the tiled path's products and the five of each backward run on
// wgmma.cuh's wgmma_product (simulst::product picks it for two bf16
// operands), bf16 operands on the tensor cores with fp32 sums, and the
// intermediates that feed a product (the fc1 input xn, the hidden h /
// h_d, g and du) are bf16 buffers: the JAX kernels round each of them to
// the activation dtype before its dot, as the plain versions do, so
// storing them as bf16 changes no value.  The LN statistics, dn, the
// pre-activation u and the partials stay fp32.  The fp32 path and the
// fused row-block kernel stay on tile_product and the CUDA cores.  In
// bf16 the tiled and fused forwards therefore agree within bf16
// tolerance, not bit for bit.
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
//
// ffn.cuh holds what the forward (ffn.cu) and the two backwards
// (ffn_bwd.cu, ln_ffn_bwd.cu) share; the three build as separate
// translation units, compiled in parallel.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using simulst::Dropout;
using simulst::from_f32;
using simulst::gelu_erf;
using simulst::round_to;
using simulst::to_f32;

// model widths: every multiple of kDimStep; the row kernels hold a row in
// registers up to kMaxDim (launch_ln_rows) and walk it above; the fused
// row-block kernel is built for the widths of ffn.cu's
// FFN_FUSED_DIM_DISPATCH (its shared memory grows with the width: 200 KB
// at 512) (ops/ffn.py DIM_STEP, FUSED_DIMS)
constexpr int kDimStep = 64;
constexpr int kMaxDim = 1024;
constexpr int kRows = 32;      // rows per block
constexpr int kChunk = 64;     // hidden columns per inner chunk
constexpr int kThreads = 256;  // 8 warps; warp w owns rows 4w .. 4w+3
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;
// runs the statement with kD bound to the model width `dim` as a constant,
// for every width kDimStep to kMaxDim (the row kernels' registered
// variants); another width returns cudaErrorInvalidValue
#define FFN_DIM_DISPATCH(dim, ...)                       \
  switch (dim) {                                         \
    case 64: { constexpr int kD = 64; __VA_ARGS__; }     \
    case 128: { constexpr int kD = 128; __VA_ARGS__; }   \
    case 192: { constexpr int kD = 192; __VA_ARGS__; }   \
    case 256: { constexpr int kD = 256; __VA_ARGS__; }   \
    case 320: { constexpr int kD = 320; __VA_ARGS__; }   \
    case 384: { constexpr int kD = 384; __VA_ARGS__; }   \
    case 448: { constexpr int kD = 448; __VA_ARGS__; }   \
    case 512: { constexpr int kD = 512; __VA_ARGS__; }   \
    case 576: { constexpr int kD = 576; __VA_ARGS__; }   \
    case 640: { constexpr int kD = 640; __VA_ARGS__; }   \
    case 704: { constexpr int kD = 704; __VA_ARGS__; }   \
    case 768: { constexpr int kD = 768; __VA_ARGS__; }   \
    case 832: { constexpr int kD = 832; __VA_ARGS__; }   \
    case 896: { constexpr int kD = 896; __VA_ARGS__; }   \
    case 960: { constexpr int kD = 960; __VA_ARGS__; }   \
    case 1024: { constexpr int kD = 1024; __VA_ARGS__; } \
    default: return (int)cudaErrorInvalidValue;          \
  }

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

constexpr int kRowThreads = 256;   // one warp per row, 8 rows per block

// xn = LN(x) gamma + beta rounded to T (the expression of
// ffn_partial_kernel's prologue), stats = (mean, 1/sigma) per row unless
// null; the statistics over the first d_real columns (the rest padding)
template <typename T, int kDim>
__global__ void __launch_bounds__(kRowThreads)
    ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, T* __restrict__ xn,
                   float* __restrict__ stats, int n_rows, int d_real) {
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
  const float mean = simulst::warp_sum(s) / d_real;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kDim / 32; ++i) {
    const float c = lane + 32 * i < d_real ? v[i] - mean : 0.f;
    q += c * c;
  }
  const float inv = rsqrtf(simulst::warp_sum(q) / d_real + 1e-5f);
#pragma unroll
  for (int i = 0; i < kDim / 32; ++i) {
    const int col = lane + 32 * i;
    xn[(size_t)row * kDim + col] =
        from_f32<T>((v[i] - mean) * inv * ln_g[col] + ln_b[col]);
  }
  if (stats != nullptr && lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = inv;
  }
}

// ln_rows_kernel at a width above kMaxDim: the row read three times (sum,
// centred squares, output), lane l taking columns l, l + 32, ...
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    ln_rows_wide_kernel(const T* __restrict__ x,
                        const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, T* __restrict__ xn,
                        float* __restrict__ stats, int n_rows, int dim,
                        int d_real) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const T* xr = x + (size_t)row * dim;
  float s = 0.f;
  for (int c = lane; c < dim; c += 32) s += to_f32(xr[c]);
  const float mean = simulst::warp_sum(s) / d_real;
  float q = 0.f;
  for (int c = lane; c < d_real; c += 32) {
    const float v = to_f32(xr[c]) - mean;
    q += v * v;
  }
  const float inv = rsqrtf(simulst::warp_sum(q) / d_real + 1e-5f);
  for (int c = lane; c < dim; c += 32)
    xn[(size_t)row * dim + c] =
        from_f32<T>((to_f32(xr[c]) - mean) * inv * ln_g[c] + ln_b[c]);
  if (stats != nullptr && lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = inv;
  }
}

// the LN row pass over n_rows rows of width dim: registers up to kMaxDim,
// the walking variant above; returns a cudaError_t
template <typename T>
int launch_ln_rows(const T* x, const float* ln_g, const float* ln_b, T* xn,
                   float* stats, int n_rows, int dim, int d_real,
                   cudaStream_t s) {
  const int blocks = simulst::ceil_div(n_rows, kRowThreads / 32);
  if (dim > kMaxDim) {
    ln_rows_wide_kernel<T><<<blocks, kRowThreads, 0, s>>>(
        x, ln_g, ln_b, xn, stats, n_rows, dim, d_real);
    return (int)cudaGetLastError();
  }
  FFN_DIM_DISPATCH(dim, {
    ln_rows_kernel<T, kD><<<blocks, kRowThreads, 0, s>>>(
        x, ln_g, ln_b, xn, stats, n_rows, d_real);
    return (int)cudaGetLastError();
  });
}

// callers of the tile_products, the tags of their shared store functors
struct TagFfnFwd {};
struct TagFfnBwd {};
struct TagLnFfnBwd {};

// u = acc + b1 into the fp32 hidden buffer
template <typename T, class Caller>
struct BiasStore {
  float* u;
  const T* b1;
  int hidden;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    u[(size_t)m * hidden + n] = v + to_f32(b1[n]);
  }
  // columns n and n + 1 at once (wgmma_product's epilogue)
  __device__ __forceinline__ void pair(int m, int n, int, float v0,
                                       float v1) const {
    simulst::store_pair(u + (size_t)m * hidden + n, v0 + to_f32(b1[n]),
                        v1 + to_f32(b1[n + 1]));
  }
};

// the product itself into an fp32 buffer (the LN-FFN backward's dn, the
// bf16 backwards' dh)
template <class Caller>
struct F32Store {
  float* y;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    y[(size_t)m * ld + n] = v;
  }
  // columns n and n + 1 at once (wgmma_product's epilogue)
  __device__ __forceinline__ void pair(int m, int n, int, float v0,
                                       float v1) const {
    simulst::store_pair(y + (size_t)m * ld + n, v0, v1);
  }
};

// the fp32 backwards' hidden gradient fused into tile_product's store: dh
// -> du = dh act'(u) m_a and h_d = act(u) m_a, the mask at the offsets of
// a hidden hidden_real wide.  hd may be u itself (u is overwritten with
// h_d)
template <int kAct, class Caller>
struct HiddenGradStore {
  const float* u;
  float* hd;
  float* du;
  int hidden, hidden_real;
  Dropout act_drop;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    const size_t off = (size_t)m * hidden + n;
    const float uu = u[off];
    const float mult = act_drop.scale((size_t)m * hidden_real + n, 0);
    du[off] = v * act_grad<kAct>(uu) * mult;
    hd[off] = act_fn<kAct>(uu) * mult;
  }
};

// the bf16 backwards' hidden gradient, a pass of its own after their dh
// product on the tensor cores: du = round_T(dh act'(u) m_a) and h_d =
// round_T(act(u) m_a) of row blockIdx.x from u and dh (both fp32), 4
// columns a thread (blockIdx.y: 1024 columns a block), HiddenGradStore's
// expressions in its order.  In wgmma_product's store, at its 16 warps an
// SM, the same work took about 3x as long (PERF.md).  hidden is a
// multiple of 4.
template <typename T, int kAct>
__global__ void __launch_bounds__(256)
    hidden_grad_kernel(const float* __restrict__ u,
                       const float* __restrict__ dh, T* __restrict__ hd,
                       T* __restrict__ du, int hidden, int hidden_real,
                       Dropout act_drop) {
  const int col = 4 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (col >= hidden) return;
  const size_t off = (size_t)blockIdx.x * hidden + col;
  const size_t moff = (size_t)blockIdx.x * hidden_real + col;
  const float4 u4 = *reinterpret_cast<const float4*>(u + off);
  const float4 g4 = *reinterpret_cast<const float4*>(dh + off);
  const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
  const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
  float dv[4], hv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float m = act_drop.scale(moff + j, 0);
    dv[j] = round_to<T>(gv[j] * act_grad<kAct>(uv[j]) * m);
    hv[j] = round_to<T>(act_fn<kAct>(uv[j]) * m);
  }
  simulst::store_pair(du + off, dv[0], dv[1]);
  simulst::store_pair(du + off + 2, dv[2], dv[3]);
  simulst::store_pair(hd + off, hv[0], hv[1]);
  simulst::store_pair(hd + off + 2, hv[2], hv[3]);
}

// hidden_grad_kernel over n rows; returns a cudaError_t
template <typename T, int kAct>
cudaError_t launch_hidden_grad(const float* u, const float* dh, T* hd, T* du,
                               int n, int hidden, int hidden_real,
                               Dropout act_drop, cudaStream_t s) {
  hidden_grad_kernel<T, kAct>
      <<<dim3(n, simulst::ceil_div(hidden, 1024)), 256, 0, s>>>(
          u, dh, hd, du, hidden, hidden_real, act_drop);
  return cudaGetLastError();
}

inline bool ffn_dim_ok(int dim) {
  return dim >= kDimStep && dim % kDimStep == 0;
}

// the real widths of a padded call: at most the padded ones, and less than
// one step below them
inline bool ffn_real_ok(int dim, int hidden, int dim_real, int hidden_real) {
  return dim_real > dim - kDimStep && dim_real <= dim &&
         hidden_real > hidden - kChunk && hidden_real <= hidden &&
         dim_real > 0 && hidden_real > 0;
}

}  // namespace
