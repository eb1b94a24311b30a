// Weight gradient of the grouped causal conv-pos for Hopper.
//
// Replaces the Pallas kernel simulst_tpu/ops/conv_pos_pallas.py
// `convpos_wgrad_pallas` (_wgrad_kernel), reached through the conv-pos
// custom VJP (simulst_tpu/nn/conv.py _grouped_conv_fast_wgrad).  The
// forward and the data gradient stay ordinary convolutions, as they stay
// XLA in the JAX package.  For tap k, group gr and channels of 16:
//
//   dw[o, ci, k] = sum over (b, t) of xp[b, t + k, gr*16 + ci] dy[b, t, o]
//
// for output channel o of group gr (xp the left-padded input (B, T+K-1, D),
// dy (B, T, D)); dw in torch's (D, 16, K) conv layout, fp32.
//
// What bounds it on the H100: 2 B T K D 16 operations (4.3 GFLOP at 32 x
// 256 frames, 64 taps, D 256), about 64 us on the fp32 CUDA cores; the
// inputs (17 MB) are read from L2 many times over.  The TPU kernel formed
// each tap's dense (D, D) product on the MXU and masked its block diagonal
// away, 16x the work; here only the 16 diagonal 16 x 16 blocks are
// computed.  A block owns (group, 16 taps, a slice of the batch) and 256
// threads, one per (tap, output channel), each summing its 16 input
// channels in fp32 registers over time tiles of dy and xp staged in shared
// memory.  The batch slices write fp32 partials that a second kernel adds
// in a fixed order and transposes into the conv layout: no atomics.
#include "common.cuh"

namespace {

using simulst::to_f32;

constexpr int kCg = 16;      // channels per group the kernel is built for
constexpr int kTaps = 16;    // taps per block
constexpr int kTile = 64;    // time steps per shared-memory tile
constexpr int kThreads = kTaps * kCg;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    convpos_wgrad_kernel(const T* __restrict__ xp, const T* __restrict__ dy,
                         float* __restrict__ partial, int batch, int t_out,
                         int taps, int dim, int batch_per_split) {
  __shared__ float dys[kTile][kCg];
  __shared__ float xs[kTile + kTaps - 1][kCg];
  const int grp = blockIdx.x;
  const int k0 = blockIdx.y * kTaps;
  const int b_begin = blockIdx.z * batch_per_split;
  const int b_end = min(batch, b_begin + batch_per_split);
  const int kk = threadIdx.x / kCg;    // tap within the block
  const int o = threadIdx.x % kCg;     // output channel within the group
  const int t_in = t_out + taps - 1;
  const int ch0 = grp * kCg;

  float acc[kCg];
#pragma unroll
  for (int ci = 0; ci < kCg; ++ci) acc[ci] = 0.f;

  for (int b = b_begin; b < b_end; ++b) {
    const size_t x_base = (size_t)b * t_in * dim + ch0;
    const size_t y_base = (size_t)b * t_out * dim + ch0;
    for (int t0 = 0; t0 < t_out; t0 += kTile) {
      for (int idx = threadIdx.x; idx < kTile * kCg; idx += kThreads) {
        const int t = idx / kCg, c = idx % kCg;
        dys[t][c] = t0 + t < t_out
                        ? to_f32(dy[y_base + (size_t)(t0 + t) * dim + c])
                        : 0.f;
      }
      for (int idx = threadIdx.x; idx < (kTile + kTaps - 1) * kCg;
           idx += kThreads) {
        const int i = idx / kCg, c = idx % kCg;
        const int row = t0 + k0 + i;
        xs[i][c] = row < t_in
                       ? to_f32(xp[x_base + (size_t)row * dim + c])
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < kTile; ++t) {
        const float g = dys[t][o];
        const float* xr = xs[t + kk];
#pragma unroll
        for (int ci = 0; ci < kCg; ++ci) acc[ci] = fmaf(xr[ci], g, acc[ci]);
      }
      __syncthreads();
    }
  }
  const int k = k0 + kk;
  if (k >= taps) return;
  // partial[split][k][ci][channel]
  float* out = partial + ((size_t)blockIdx.z * taps + k) * kCg * dim;
#pragma unroll
  for (int ci = 0; ci < kCg; ++ci) out[(size_t)ci * dim + ch0 + o] = acc[ci];
}

// dw[o][ci][k] = sum over splits (in order) of partial[z][k][ci][o]
__global__ void convpos_wgrad_sum_kernel(const float* __restrict__ partial,
                                         float* __restrict__ dw, int splits,
                                         int taps, int dim) {
  const size_t total = (size_t)dim * kCg * taps;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int k = (int)(idx % taps);
  const int ci = (int)((idx / taps) % kCg);
  const int o = (int)(idx / ((size_t)taps * kCg));
  const size_t split_len = (size_t)taps * kCg * dim;
  float s = 0.f;
  for (int z = 0; z < splits; ++z)
    s += partial[z * split_len + ((size_t)k * kCg + ci) * dim + o];
  dw[idx] = s;
}

template <typename T>
int launch_wgrad(const void* xp, const void* dy, float* dw, float* partial,
                 int batch, int t_out, int taps, int dim, int splits,
                 cudaStream_t s) {
  const int per = simulst::ceil_div(batch, splits);
  const dim3 grid(dim / kCg, simulst::ceil_div(taps, kTaps),
                  simulst::ceil_div(batch, per));
  convpos_wgrad_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(xp), static_cast<const T*>(dy), partial, batch,
      t_out, taps, dim, per);
  SIMULST_TRY(cudaGetLastError());
  const size_t total = (size_t)dim * kCg * taps;
  convpos_wgrad_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      partial, dw, (int)grid.z, taps, dim);
  return (int)cudaGetLastError();
}

}  // namespace

// xp: (batch, t_out + taps - 1, dim) left-padded conv input; dy: (batch,
// t_out, dim), both of `dtype`; groups = dim / 16.  dw: (dim, 16, taps)
// fp32; partial: fp32 scratch (splits, taps, 16, dim).  Returns a
// cudaError_t.
extern "C" int simulst_convpos_wgrad(int dtype, const void* xp,
                                     const void* dy, void* dw, void* partial,
                                     int batch, int t_out, int taps, int dim,
                                     int groups, int splits, void* stream) {
  if (batch <= 0 || t_out <= 0 || taps <= 0 || groups <= 0 ||
      dim != groups * kCg || splits <= 0 || splits > batch)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SIMULST_DISPATCH(dtype, return launch_wgrad<scalar_t>(
                              xp, dy, static_cast<float*>(dw),
                              static_cast<float*>(partial), batch, t_out,
                              taps, dim, splits, s));
}
