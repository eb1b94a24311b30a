// Weight gradient of the grouped causal conv-pos for Hopper.
//
// Replaces the Pallas kernel simulst_tpu/ops/conv_pos_pallas.py
// `convpos_wgrad_pallas` (_wgrad_kernel), reached through the conv-pos
// custom VJP (simulst_tpu/nn/conv.py _grouped_conv_fast_wgrad).  The
// forward and the data gradient stay ordinary convolutions, as they stay
// XLA in the JAX package.  For tap k, group gr and cg channels a group:
//
//   dw[o, ci, k] = sum over (b, t) of xp[b, t + k, gr*cg + ci] dy[b, t, o]
//
// for output channel o of group gr (xp the left-padded input (B, T+K-1, D),
// dy (B, T, D)); dw in torch's (D, cg, K) conv layout, fp32.  cg is any
// multiple of 4 (s2t_transformer_convpos: D / 16 groups, 4 to 64 channels
// at D 64 to 1024, and more above; the grid holds ceil(cg / 16)^2 slices a
// group, whatever cg) or 1 (a depthwise conv).
//
// What bounds it on the H100: 2 B T K D 16 operations (4.3 GFLOP at 32 x
// 256 frames, 64 taps, D 256), about 64 us on the fp32 CUDA cores; the
// inputs (17 MB) are read from L2 a few times over.  The TPU kernel formed
// each tap's dense (D, D) product on the MXU and masked its block diagonal
// away, 16x the work; here only the 16 diagonal 16 x 16 blocks are
// computed.
//
// Design: a block owns (group, a 16 x 16 slice of its (output, input)
// channel block, 64 taps, a slice of the batch); each thread a register
// tile of Kr taps x Or output channels x Cr input channels.  A group of cg
// channels has ceil(cg / 16)^2 slices; channels past cg are staged as zeros
// and not stored (at cg 16, the ASR model's, one slice, nothing padded).  A
// time step reads the step's Or dy values and one new x row of Cr values
// from shared memory, one vector load each, into a window of the Kr x rows
// its taps need: Kr Or Cr fused multiply-adds for two loads.  The loop is
// unrolled by Kr, so the window turns by renaming registers.  Tiles of 64
// time steps of dy and x (with the taps' 63 rows of halo) come by cp.async
// into a ring of two stages, the next tile's copies in flight while the
// block works on this one: one barrier per tile.
//
// The sums are bit for bit the first design's: each output starts at 0 and
// takes fmaf(x, dy, acc) over b ascending within its batch slice, t
// ascending within b; steps past T multiply a zero dy (x + 0 = x, the
// accumulator never being -0) and stop at the next multiple of Kr.  The
// batch slices write fp32 partials in dw's layout, which a second kernel
// adds in slice order from 0: no atomics.
//
// cg 1 (depthwise) has its own kernel: a block owns 32 channels x 64 taps
// of a batch slice, a thread one channel and 8 taps, over the same tiles of
// 64 time steps; each output is the same fmaf chain over (b, t).
#include "common.cuh"

namespace {

constexpr int kCg = 16;       // output and input channels of a block's slice
constexpr int kTapBlock = 64;  // taps per block
constexpr int kTile = 64;      // time steps per shared-memory tile
constexpr int kRows = kTile + kTapBlock - 1;  // x rows a tile's steps read

// a thread's register tile: Kr taps x Or output x Cr input channels (on
// the H100 at the ASR shape 4 x 4 x 4 ran as fast as 8 x 4 x 2 and 8 x 2 x
// 4, and faster than the tiles of 32 accumulators, 512 threads a block)
constexpr int Kr = 4, Or = 4, Cr = 4;
constexpr int kThreads = (kTapBlock / Kr) * (kCg / Or) * (kCg / Cr);
static_assert(kTile % Kr == 0 && kTapBlock % Kr == 0, "whole windows");

// four consecutive fp32 values of shared memory (16-byte aligned)
__device__ __forceinline__ void lds(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

// partial[split][o][ci][k], dw's layout per batch slice
// kCgFixed: the channels a group as a constant (16, whose block is one
// unpadded slice: its offsets and checks fold away), or 0 for cg_arg
template <typename T, int kCgFixed>
__global__ void __launch_bounds__(kThreads, 1)
    convpos_wgrad_kernel(const T* __restrict__ xp, const T* __restrict__ dy,
                         float* __restrict__ partial, int batch, int t_out,
                         int taps, int dim, int cg_arg, int batch_per_split) {
  const int cg = kCgFixed ? kCgFixed : cg_arg;
  __shared__ __align__(16) float dys[2][kTile][kCg];
  __shared__ __align__(16) float xs[2][kRows][kCg];
  const int slices = (cg + kCg - 1) / kCg;   // per side of a group's block
  const int grp = blockIdx.x / (slices * slices);
  const int so = blockIdx.x / slices % slices * kCg;  // output channel slice
  const int si = blockIdx.x % slices * kCg;           // input channel slice
  const int b_begin = blockIdx.y * batch_per_split;
  const int b_end = min(batch, b_begin + batch_per_split);
  const int k_base = blockIdx.z * kTapBlock;
  const int tid = threadIdx.x;
  const int c0 = tid % (kCg / Cr) * Cr;              // first input channel
  const int o0 = tid / (kCg / Cr) % (kCg / Or) * Or;  // first output channel
  const int kl = tid / ((kCg / Cr) * (kCg / Or)) * Kr;  // first tap, in block
  const int t_in = t_out + taps - 1;
  const int ych0 = grp * cg + so, xch0 = grp * cg + si;
  const int ycols = min(kCg, cg - so), xcols = min(kCg, cg - si);
  const int tiles_per_b = (t_out + kTile - 1) / kTile;
  const int n_tiles = max(b_end - b_begin, 0) * tiles_per_b;

  // tile i (example b_begin + i / tiles_per_b, steps from t0) into stage
  // buf: dy rows t0.., x rows t0 + k_base..; zeros past the ends
  auto stage = [&](int i, int buf) {
    const int b = b_begin + i / tiles_per_b, t0 = i % tiles_per_b * kTile;
    const T* yb = dy + (size_t)b * t_out * dim + ych0;
    const T* xb = xp + (size_t)b * t_in * dim + xch0;
    for (int q = tid; q < kTile * kCg / 4; q += kThreads) {
      const int r = q / (kCg / 4), c = q % (kCg / 4) * 4;
      const bool ok = t0 + r < t_out && c < ycols;
      simulst::stage4(&dys[buf][r][c], ok ? yb + (size_t)(t0 + r) * dim + c
                                          : yb, ok);
    }
    for (int q = tid; q < kRows * kCg / 4; q += kThreads) {
      const int r = q / (kCg / 4), c = q % (kCg / 4) * 4;
      const int row = t0 + k_base + r;
      const bool ok = row < t_in && c < xcols;
      simulst::stage4(&xs[buf][r][c], ok ? xb + (size_t)row * dim + c : xb,
                      ok);
    }
    simulst::async_commit();
  };

  float acc[Kr][Or][Cr];
#pragma unroll
  for (int kk = 0; kk < Kr; ++kk)
#pragma unroll
    for (int oi = 0; oi < Or; ++oi)
#pragma unroll
      for (int ci = 0; ci < Cr; ++ci) acc[kk][oi][ci] = 0.f;

  if (n_tiles > 0) stage(0, 0);
  for (int i = 0; i < n_tiles; ++i) {
    simulst::async_wait<0>();
    __syncthreads();
    if (i + 1 < n_tiles) stage(i + 1, (i + 1) & 1);
    const float(*xr)[kCg] = xs[i & 1];
    const float(*yr)[kCg] = dys[i & 1];
    const int steps = min(kTile, t_out - i % tiles_per_b * kTile);
    // the window: x row kl + tt + j + kk (tap kk at step tt + j) in
    // xw[(j + kk) % Kr]
    float xw[Kr][Cr];
#pragma unroll
    for (int j = 0; j < Kr - 1; ++j) lds(xw[j], &xr[kl + j][c0]);
    for (int tt = 0; tt < steps; tt += Kr) {
#pragma unroll
      for (int j = 0; j < Kr; ++j) {
        lds(xw[(j + Kr - 1) % Kr], &xr[kl + tt + j + Kr - 1][c0]);
        float g[Or];
        lds(g, &yr[tt + j][o0]);
#pragma unroll
        for (int kk = 0; kk < Kr; ++kk)
#pragma unroll
          for (int oi = 0; oi < Or; ++oi)
#pragma unroll
            for (int ci = 0; ci < Cr; ++ci)
              acc[kk][oi][ci] =
                  fmaf(xw[(j + kk) % Kr][ci], g[oi], acc[kk][oi][ci]);
      }
    }
  }

  float* out = partial + (size_t)blockIdx.y * dim * cg * taps;
  const int k0 = k_base + kl;
#pragma unroll
  for (int oi = 0; oi < Or; ++oi)
#pragma unroll
    for (int ci = 0; ci < Cr; ++ci) {
      if (o0 + oi >= ycols || c0 + ci >= xcols) continue;
      float* row = out + ((size_t)(ych0 + o0 + oi) * cg + si + c0 + ci) * taps;
      if (taps % 4 == 0) {  // a float4, 16-byte aligned
        if (k0 < taps)
          *reinterpret_cast<float4*>(row + k0) =
              make_float4(acc[0][oi][ci], acc[1][oi][ci], acc[2][oi][ci],
                          acc[3][oi][ci]);
      } else {
#pragma unroll
        for (int kk = 0; kk < Kr; ++kk)
          if (k0 + kk < taps) row[k0 + kk] = acc[kk][oi][ci];
      }
    }
}

// cg 1: partial[split][c][k] = sum over the slice's (b, t) of xp[b, t + k, c]
// dy[b, t, c].  Block (32 channels, 64 taps): thread (c, kq) owns channel
// c and taps 8 kq .. 8 kq + 7; tiles of 64 steps of dy and their 127 x
// rows through shared memory, as the grouped kernel's.
constexpr int kDwChannels = 32;
constexpr int kDwTaps = 8;   // taps per thread
constexpr int kDwThreads = kDwChannels * (kTapBlock / kDwTaps);

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    convpos_wgrad_depthwise_kernel(const T* __restrict__ xp,
                                   const T* __restrict__ dy,
                                   float* __restrict__ partial, int batch,
                                   int t_out, int taps, int dim,
                                   int batch_per_split) {
  __shared__ float dys[kTile][kDwChannels];
  __shared__ float xs[kRows][kDwChannels];
  const int c = threadIdx.x % kDwChannels;
  const int kl = threadIdx.x / kDwChannels * kDwTaps;
  const int ch = blockIdx.x * kDwChannels + c;
  const int k_base = blockIdx.z * kTapBlock;
  const int b_begin = blockIdx.y * batch_per_split;
  const int b_end = min(batch, b_begin + batch_per_split);
  const int t_in = t_out + taps - 1;
  float acc[kDwTaps];
#pragma unroll
  for (int kk = 0; kk < kDwTaps; ++kk) acc[kk] = 0.f;
  for (int b = b_begin; b < b_end; ++b)
    for (int t0 = 0; t0 < t_out; t0 += kTile) {
      __syncthreads();   // the previous tile is read
      for (int q = threadIdx.x; q < kTile * kDwChannels; q += kDwThreads) {
        const int r = q / kDwChannels, cc = blockIdx.x * kDwChannels +
                                             q % kDwChannels;
        dys[r][q % kDwChannels] =
            t0 + r < t_out && cc < dim
                ? simulst::to_f32(dy[((size_t)b * t_out + t0 + r) * dim + cc])
                : 0.f;
      }
      for (int q = threadIdx.x; q < kRows * kDwChannels; q += kDwThreads) {
        const int r = q / kDwChannels, cc = blockIdx.x * kDwChannels +
                                             q % kDwChannels;
        const int row = t0 + k_base + r;
        xs[r][q % kDwChannels] =
            row < t_in && cc < dim
                ? simulst::to_f32(xp[((size_t)b * t_in + row) * dim + cc])
                : 0.f;
      }
      __syncthreads();
      const int steps = min(kTile, t_out - t0);
      for (int tt = 0; tt < steps; ++tt) {
        const float g = dys[tt][c];
#pragma unroll
        for (int kk = 0; kk < kDwTaps; ++kk)
          acc[kk] = fmaf(xs[tt + kl + kk][c], g, acc[kk]);
      }
    }
  if (ch >= dim) return;
  float* row = partial + (size_t)blockIdx.y * dim * taps + (size_t)ch * taps;
#pragma unroll
  for (int kk = 0; kk < kDwTaps; ++kk)
    if (k_base + kl + kk < taps) row[k_base + kl + kk] = acc[kk];
}

// dw = sum over splits (in order, from 0) of partial[z], 4 values a thread
__global__ void convpos_wgrad_sum_kernel(const float4* __restrict__ partial,
                                         float4* __restrict__ dw, int splits,
                                         size_t total4) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total4) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float4 p = __ldg(partial + z * total4 + idx);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  dw[idx] = s;
}

template <typename T>
int launch_wgrad(const void* xp, const void* dy, float* dw, float* partial,
                 int batch, int t_out, int taps, int dim, int groups,
                 int splits, cudaStream_t s) {
  const int per = simulst::ceil_div(batch, splits);
  const int cg = dim / groups;
  const int n_splits = simulst::ceil_div(batch, per);
  const int tap_blocks = simulst::ceil_div(taps, kTapBlock);
  if (cg == 1) {
    convpos_wgrad_depthwise_kernel<T>
        <<<dim3(simulst::ceil_div(dim, kDwChannels), n_splits, tap_blocks),
           kDwThreads, 0, s>>>(static_cast<const T*>(xp),
                               static_cast<const T*>(dy), partial, batch,
                               t_out, taps, dim, per);
  } else {
    const int slices = simulst::ceil_div(cg, kCg);
    const dim3 grid(groups * slices * slices, n_splits, tap_blocks);
    auto kernel = cg == kCg ? convpos_wgrad_kernel<T, kCg>
                            : convpos_wgrad_kernel<T, 0>;
    kernel<<<grid, kThreads, 0, s>>>(static_cast<const T*>(xp),
                                     static_cast<const T*>(dy), partial,
                                     batch, t_out, taps, dim, cg, per);
  }
  SIMULST_TRY(cudaGetLastError());
  const size_t total4 = (size_t)dim * cg * taps / 4;  // dim: 64 a step
  convpos_wgrad_sum_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, s>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(dw),
      n_splits, total4);
  return (int)cudaGetLastError();
}

}  // namespace

// xp: (batch, t_out + taps - 1, dim) left-padded conv input; dy: (batch,
// t_out, dim), both of `dtype`, 16-byte aligned; cg = dim / groups a
// multiple of 4 or 1, dim * cg * taps a multiple of 4.  dw: (dim, cg, taps)
// fp32; partial: fp32 scratch (splits, dim, cg, taps).  Returns a
// cudaError_t.
extern "C" int simulst_convpos_wgrad(int dtype, const void* xp,
                                     const void* dy, void* dw, void* partial,
                                     int batch, int t_out, int taps, int dim,
                                     int groups, int splits, void* stream) {
  if (batch <= 0 || t_out <= 0 || taps <= 0 || groups <= 0 ||
      dim % groups != 0 || splits <= 0 || splits > batch)
    return (int)cudaErrorInvalidValue;
  const int cg = dim / groups;
  if ((cg != 1 && cg % 4 != 0) || (size_t)dim * cg * taps % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SIMULST_DISPATCH(dtype, return launch_wgrad<scalar_t>(
                              xp, dy, static_cast<float*>(dw),
                              static_cast<float*>(partial), batch, t_out,
                              taps, dim, groups, splits, s));
}
