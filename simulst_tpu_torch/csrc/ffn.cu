// The FFN forward for Hopper: the fused row-block kernel, the tiled path
// and the epilogue (ffn.cuh says what they compute and how).
#include "ffn.cuh"

namespace {

template <int kDim>
constexpr size_t fused_smem_bytes() {
  return (size_t)(kRows * kDim + kRows * kChunk + kDim * kChunk) *
         sizeof(float);
}

// runs the statement with kD bound to the model width `dim` as a constant;
// a width the fused kernel is not built for returns cudaErrorInvalidValue
#define FFN_FUSED_DIM_DISPATCH(dim, ...)                 \
  switch (dim) {                                         \
    case 64: { constexpr int kD = 64; __VA_ARGS__; }     \
    case 128: { constexpr int kD = 128; __VA_ARGS__; }   \
    case 256: { constexpr int kD = 256; __VA_ARGS__; }   \
    case 512: { constexpr int kD = 512; __VA_ARGS__; }   \
    default: return (int)cudaErrorInvalidValue;          \
  }

template <typename T, bool kLayerNorm, int kAct, int kDim>
__global__ void __launch_bounds__(kThreads)
    ffn_partial_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                       const float* __restrict__ ln_b, const T* __restrict__ w1,
                       const T* __restrict__ b1, const T* __restrict__ w2,
                       float* __restrict__ partial, int n_rows, int hidden,
                       int hidden_per_split, int d_real, int hidden_real,
                       Dropout act_drop) {
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

  // prologue: LayerNorm in fp32 (statistics over the row's d_real real
  // columns, eps 1e-5)
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
        const size_t off =
            (size_t)(row0 + r_base + r) * hidden_real + h0 + c;
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

// y = drop_o(sum of the split partials + b2) [+ x], residual added in fp32;
// the mask at the offsets of rows d_real wide
template <typename T, bool kResidual>
__global__ void ffn_epilogue_kernel(const float* __restrict__ partial,
                                    int splits, const T* __restrict__ b2,
                                    const T* __restrict__ x, T* __restrict__ y,
                                    int n_rows, int dim, int d_real,
                                    Dropout out_drop) {
  const size_t total = (size_t)n_rows * dim;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[sp * total + idx];
  s += to_f32(b2[idx % dim]);
  s *= out_drop.scale(simulst::unpadded_offset(idx, dim, d_real), 1);
  if (kResidual) s += to_f32(x[idx]);
  y[idx] = from_f32<T>(s);
}

// h = act(acc + b1) m_a rounded to T: the fused kernel's hidden chunk,
// for the whole hidden (the mask at the offsets of a hidden hidden_real
// wide)
template <typename T, int kAct>
struct HiddenStore {
  T* h;
  const T* b1;
  int hidden, hidden_real;
  Dropout act_drop;
  __device__ __forceinline__ void operator()(int m, int n, int, float v) const {
    const size_t off = (size_t)m * hidden + n;
    const float uu = v + to_f32(b1[n]);
    h[off] = from_f32<T>(act_fn<kAct>(uu) *
                         act_drop.scale((size_t)m * hidden_real + n, 0));
  }
  // columns n and n + 1 at once (wgmma_product's epilogue)
  __device__ __forceinline__ void pair(int m, int n, int, float v0,
                                       float v1) const {
    const size_t moff = (size_t)m * hidden_real + n;
    simulst::store_pair(
        h + (size_t)m * hidden + n,
        act_fn<kAct>(v0 + to_f32(b1[n])) * act_drop.scale(moff, 0),
        act_fn<kAct>(v1 + to_f32(b1[n + 1])) * act_drop.scale(moff + 1, 0));
  }
};

// h == nullptr: the fused row-block kernel (a width of
// FFN_FUSED_DIM_DISPATCH); else the LN row pass into xn (kLayerNorm), the
// hidden product into h and the output product into the split partials,
// on simulst::product (bf16: the tensor cores).  Then the epilogue.
template <typename T, bool kLayerNorm, int kAct>
int launch_ffn(const void* x_, const void* ln_g_, const void* ln_b_,
               const void* w1_, const void* b1_, const void* w2_,
               const void* b2, void* y, float* partial, T* xn, T* h,
               int n_rows, int dim, int hidden, int splits, int dim_real,
               int hidden_real, Dropout act_drop, Dropout out_drop,
               cudaStream_t stream) {
  using simulst::RowMajor;
  const T* x = static_cast<const T*>(x_);
  const float* ln_g = static_cast<const float*>(ln_g_);
  const float* ln_b = static_cast<const float*>(ln_b_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* b1 = static_cast<const T*>(b1_);
  const T* w2 = static_cast<const T*>(w2_);
  if (h == nullptr) {
    FFN_FUSED_DIM_DISPATCH(dim, {
      auto partial_kernel = ffn_partial_kernel<T, kLayerNorm, kAct, kD>;
      constexpr size_t smem = fused_smem_bytes<kD>();
      SIMULST_TRY(cudaFuncSetAttribute(
          partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem));
      const dim3 grid(simulst::ceil_div(n_rows, kRows), splits);
      partial_kernel<<<grid, kThreads, smem, stream>>>(
          x, ln_g, ln_b, w1, b1, w2, partial, n_rows, hidden,
          hidden / splits, dim_real, hidden_real, act_drop);
      SIMULST_TRY(cudaGetLastError());
      break;
    });
  } else {
    const HiddenStore<T, kAct> store{h, b1, hidden, hidden_real, act_drop};
    if constexpr (kLayerNorm) {
      SIMULST_TRY((cudaError_t)launch_ln_rows<T>(
          x, ln_g, ln_b, xn, nullptr, n_rows, dim, dim_real, stream));
      SIMULST_TRY((simulst::product<128, true>(n_rows, hidden, dim, 1,
                                                   RowMajor<T>{xn, dim},
                                                   RowMajor<T>{w1, hidden},
                                                   store, stream)));
    } else {
      SIMULST_TRY((simulst::product<128, true>(n_rows, hidden, dim, 1,
                                                   RowMajor<T>{x, dim},
                                                   RowMajor<T>{w1, hidden},
                                                   store, stream)));
    }
    // the fused kernel's hidden splits, as K slices: the same sums
    SIMULST_TRY((simulst::product<64>(
        n_rows, dim, hidden, splits, RowMajor<T>{h, hidden},
        RowMajor<T>{w2, dim},
        simulst::PartialStore<TagFfnFwd>{partial, (size_t)n_rows * dim, 0,
                                         dim},
        stream)));
  }
  const int total = n_rows * dim;
  ffn_epilogue_kernel<T, kLayerNorm>
      <<<simulst::ceil_div(total, 256), 256, 0, stream>>>(
          partial, splits, static_cast<const T*>(b2), x, static_cast<T*>(y),
          n_rows, dim, dim_real, out_drop);
  return (int)cudaGetLastError();
}

}  // namespace

// ln_res = 1: y = x + drop_o(fc2(drop_a(act(fc1(LN(x))))))
//             (fused_ln_ffn_res)
// ln_res = 0: y = drop_o(fc2(drop_a(act(fc1(x)))))  (fused_ffn; ln_g/ln_b
//             unused)
// x, y: (n_rows, dim); w1: (dim, hidden); w2: (hidden, dim), all of `dtype`,
// dim and hidden multiples of 64;
// ln_g, ln_b: (dim) fp32 whatever `dtype` (the LN is computed in fp32);
// partial: fp32 scratch of (splits, n_rows, dim); act 0 gelu, 1 relu,
// 2 silu, 3 tanh; each dropout site is on when its flag is set.  h null: the fused row-block
// kernel (dim 64, 128, 256 or 512); else the tiled path, with scratch of
// `dtype` h (n_rows, hidden) and, for ln_res = 1, xn (n_rows, dim), and x,
// w1, w2 16-byte aligned.  In fp32 both paths give the same bits; in bf16
// the tiled path's products run on the tensor cores (wgmma.cuh), within
// bf16 tolerance of the fused kernel.  dim_real and hidden_real: the
// widths of a call zero-padded to dim and hidden (equal to them when
// nothing is padded; less than 64 below them), over which LN takes its
// statistics and the dropout sites their offsets.  Returns a cudaError_t.
extern "C" int simulst_ffn(int dtype, int ln_res, int act, const void* x,
                           const void* ln_g, const void* ln_b, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           void* y, void* partial, void* xn, void* h,
                           int n_rows, int dim, int hidden, int splits,
                           int dim_real, int hidden_real,
                           unsigned long long seed, int act_on,
                           unsigned act_threshold, float act_inv_keep,
                           int out_on, unsigned out_threshold,
                           float out_inv_keep, void* stream) {
  if (!ffn_dim_ok(dim) || n_rows <= 0 || splits <= 0 || hidden <= 0 ||
      hidden % (splits * kChunk) != 0 || act < kGelu || act > kTanh ||
      (h != nullptr && ln_res && xn == nullptr) ||
      !ffn_real_ok(dim, hidden, dim_real, hidden_real))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  const Dropout act_drop{seed, act_threshold, act_inv_keep, act_on};
  const Dropout out_drop{seed, out_threshold, out_inv_keep, out_on};
  if (ln_res) {
    FFN_ACT_DISPATCH(act, SIMULST_DISPATCH(dtype, return launch_ffn<scalar_t, true, kA>(
                                x, ln_g, ln_b, w1, b1, w2, b2, y, p,
                                static_cast<scalar_t*>(xn),
                                static_cast<scalar_t*>(h),
                                n_rows, dim, hidden, splits, dim_real,
                                hidden_real, act_drop, out_drop, s)));
  }
  FFN_ACT_DISPATCH(act, SIMULST_DISPATCH(dtype, return launch_ffn<scalar_t, false, kA>(
                              x, ln_g, ln_b, w1, b1, w2, b2, y, p,
                              static_cast<scalar_t*>(xn),
                              static_cast<scalar_t*>(h),
                              n_rows, dim, hidden, splits, dim_real,
                              hidden_real, act_drop, out_drop, s)));
}
