// Shared helpers for the simulst_tpu_torch kernels (sm_90a, plain C ABI).
//
// Every kernel reads fp32 or bf16 activations, converts to fp32 on load and
// accumulates in fp32.  `round_to<T>` rounds an fp32 value through T where
// the JAX package casts an intermediate to the activation dtype, so the
// bf16 kernels and their plain PyTorch versions round at the same places.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace simulst {

// dtype codes passed from Python (ops/_build.py DTYPE_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// exact GELU, torch.nn.GELU's default: 0.5 u (1 + erf(u / sqrt 2))
__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.7071067811865476f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// dropout masks: Philox4x32-10 keyed by (seed, element offset)
// ---------------------------------------------------------------------------
// Counter (offset lo, offset hi, stream, 0), key (seed lo, seed hi); the
// first output word is the draw.  ops/philox.py computes the same bits in
// torch, so a kernel and its plain version drop the same elements and a
// backward regenerates its forward's mask.  `stream` separates two masks of
// one call (the FFN's hidden and output dropout).
__device__ __forceinline__ unsigned philox_bits(unsigned long long seed,
                                                unsigned long long offset,
                                                unsigned stream) {
  unsigned c0 = (unsigned)offset, c1 = (unsigned)(offset >> 32), c2 = stream,
           c3 = 0u;
  unsigned k0 = (unsigned)seed, k1 = (unsigned)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

// One dropout site of a call: the multiplier is 1/keep where the draw is
// below `threshold` (= round(keep * 2^32)), 0 where it is dropped, and 1
// everywhere when the site is off.
struct Dropout {
  unsigned long long seed;
  unsigned threshold;
  float inv_keep;
  int on;

  __device__ __forceinline__ float scale(unsigned long long offset,
                                         unsigned stream) const {
    if (!on) return 1.f;
    return philox_bits(seed, offset, stream) < threshold ? inv_keep : 0.f;
  }
};

// ---------------------------------------------------------------------------
// a plain fp32 tiled matrix product for the backward passes
// ---------------------------------------------------------------------------
// C(m, n) = sum_k A(m, k) B(k, n) over the z-th slice of K (grid.z), handed
// to store(m, n, z, value).  A, B and store are functors, so transposes,
// dropout multipliers and epilogues cost no extra pass.  64 x 64 output tile
// per block, K in steps of 32 through shared memory, 4 x 4 outputs per
// thread on the CUDA cores.  kAMFast / kBNFast say which index of A / B is
// contiguous in memory, so that the tile loads coalesce.
constexpr int kGemmBM = 64;
constexpr int kGemmBN = 64;
constexpr int kGemmBK = 32;
constexpr int kGemmThreads = 256;

template <bool kAMFast, bool kBNFast, class A, class B, class Store>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(int M, int N, int K, int k_chunk, A a, B b, Store store) {
  __shared__ float as[kGemmBK][kGemmBM + 1];
  __shared__ float bs[kGemmBK][kGemmBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kGemmBM;
  const int n0 = blockIdx.y * kGemmBN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kGemmBK) {
    for (int idx = tid; idx < kGemmBM * kGemmBK; idx += kGemmThreads) {
      const int m = kAMFast ? idx % kGemmBM : idx / kGemmBK;
      const int k = kAMFast ? idx / kGemmBM : idx % kGemmBK;
      const int gm = m0 + m, gk = k0 + k;
      as[k][m] = (gm < M && gk < k_end) ? a(gm, gk) : 0.f;
    }
    for (int idx = tid; idx < kGemmBN * kGemmBK; idx += kGemmThreads) {
      const int n = kBNFast ? idx % kGemmBN : idx / kGemmBK;
      const int k = kBNFast ? idx / kGemmBN : idx % kGemmBK;
      const int gn = n0 + n, gk = k0 + k;
      bs[k][n] = (gn < N && gk < k_end) ? b(gk, gn) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kGemmBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) store(m, n, (int)blockIdx.z, acc[i][j]);
    }
  }
}

// Launch gemm_kernel with K cut into `splits` slices (a multiple of the K
// step each); returns cudaGetLastError().
template <bool kAMFast, bool kBNFast, class A, class B, class Store>
cudaError_t gemm(int M, int N, int K, int splits, A a, B b, Store store,
                 cudaStream_t stream) {
  const int k_chunk = ceil_div(ceil_div(K, splits), kGemmBK) * kGemmBK;
  const dim3 grid(ceil_div(M, kGemmBM), ceil_div(N, kGemmBN),
                  ceil_div(K, k_chunk));
  gemm_kernel<kAMFast, kBNFast>
      <<<grid, kGemmThreads, 0, stream>>>(M, N, K, k_chunk, a, b, store);
  return cudaGetLastError();
}

// element (r, c) of a row-major matrix with leading dimension ld
template <typename T>
struct RowMajor {
  const T* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return to_f32(p[(size_t)r * ld + c]);
  }
};

// element (r, c) of the transpose of a row-major matrix: p[c][r]
template <typename T>
struct Transposed {
  const T* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return to_f32(p[(size_t)c * ld + r]);
  }
};

// fp32 partial of split z at p[z * split_stride + offset + m * ld + n]
struct PartialStore {
  float* p;
  size_t split_stride;
  size_t offset;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, int z,
                                             float v) const {
    p[(size_t)z * split_stride + offset + (size_t)m * ld + n] = v;
  }
};

// Column sums of an fp32 row-major (rows, cols) matrix, one partial per row
// split: out[z * split_stride + offset + c] = sum of rows in split z.
// Block (32, 8), grid (ceil(cols / 32), splits).
static __global__ void colsum_partial_kernel(const float* __restrict__ src, int rows,
                                      int cols, int rows_per_split,
                                      float* __restrict__ out,
                                      size_t split_stride, size_t offset) {
  __shared__ float part[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  float s = 0.f;
  if (c < cols)
    for (int r = r_begin + threadIdx.y; r < r_end; r += 8)
      s += src[(size_t)r * cols + c];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][threadIdx.x];
    out[(size_t)blockIdx.y * split_stride + offset + c] = t;
  }
}

static inline cudaError_t colsum_partial(const float* src, int rows, int cols,
                                  int splits, float* out, size_t split_stride,
                                  size_t offset, cudaStream_t stream) {
  const int per = ceil_div(rows, splits);
  colsum_partial_kernel<<<dim3(ceil_div(cols, 32), splits), dim3(32, 8), 0,
                          stream>>>(src, rows, cols, per, out, split_stride,
                                    offset);
  return cudaGetLastError();
}

// out[i] = sum over z of partial[z * len + i], i < len
static __global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  int splits, size_t len,
                                  float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * len + i];
  out[i] = s;
}

static inline cudaError_t sum_splits(const float* partial, int splits, size_t len,
                              float* out, cudaStream_t stream) {
  sum_splits_kernel<<<(unsigned)((len + 255) / 256), 256, 0, stream>>>(
      partial, splits, len, out);
  return cudaGetLastError();
}

// g[i] = round_T(dy[i] * mult) with mult the dropout multiplier of element
// i (offset i, `stream`) on gated rows (row % period < res_rows, or every
// row when period == 0) and 1 elsewhere; g is fp32.  The upstream gradient
// of a dropout site, materialised once for the products that read it.
template <typename T>
__global__ void drop_grad_kernel(const T* __restrict__ dy,
                                 float* __restrict__ g, int rows, int cols,
                                 Dropout drop, unsigned stream, int period,
                                 int res_rows) {
  const size_t total = (size_t)rows * cols;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int row = (int)(i / cols);
  const bool gated = period == 0 || row % period < res_rows;
  const float m = gated ? drop.scale(i, stream) : 1.f;
  g[i] = round_to<T>(to_f32(dy[i]) * m);
}

template <typename T>
cudaError_t drop_grad(const void* dy, float* g, int rows, int cols,
                      Dropout drop, unsigned stream, int period, int res_rows,
                      cudaStream_t s) {
  const size_t total = (size_t)rows * cols;
  drop_grad_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(dy), g, rows, cols, drop, stream, period,
      res_rows);
  return cudaGetLastError();
}

}  // namespace simulst

// Return from the enclosing function if a CUDA call reported an error.
#define SIMULST_TRY(expr)                                 \
  do {                                                    \
    const cudaError_t simulst_err_ = (expr);              \
    if (simulst_err_ != cudaSuccess) return (int)simulst_err_; \
  } while (0)

// Dispatch a templated launch statement on the Python dtype code (variadic:
// the statement may hold commas); unknown codes report
// cudaErrorInvalidValue to the caller.
#define SIMULST_DISPATCH(dtype, ...)                     \
  do {                                                   \
    if ((dtype) == simulst::kF32) {                      \
      using scalar_t = float;                            \
      __VA_ARGS__;                                       \
    } else if ((dtype) == simulst::kBF16) {              \
      using scalar_t = __nv_bfloat16;                    \
      __VA_ARGS__;                                       \
    } else {                                             \
      return static_cast<int>(cudaErrorInvalidValue);    \
    }                                                    \
  } while (0)
