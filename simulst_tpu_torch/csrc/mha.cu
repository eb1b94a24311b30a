// Fused multi-head attention core for Hopper, forward and backward: the
// attention after the q/k/v projections and before out_proj.
//
//   out[b, q, h] = sum_k drop(softmax_k(q_h . k_h / sqrt(hd) + mask)) v_h
//
// Replaces the Pallas kernels simulst_tpu/ops/mha_pallas.py `fused_mha`
// (_fwd_kernel via _fwd_call, _bwd_kernel via _bwd_call): the decoder's
// causal self-attention and cross-attention and the MT encoder's
// self-attention.  Heads are 64-column slices of D, so no head transpose is
// ever written; the key mask is an int32 (B, Tk) row plus an optional
// causal rule; dropout on the probabilities draws Philox bits keyed by
// (seed, ((b H + h) Tq + q) Tk + k), so the backward regenerates the mask.
//
// What bounds it on the H100: at the MT shape (B 64, Tq = Tk = 128, D 256,
// 4 heads) the forward is 2 products of 64 x 4 x 128 x 128 x 64, about
// 1.07 GFLOP (16 us at the fp32 CUDA-core peak), and reads 25 MB.  The
// design is flash-attention's: one block per (64-row q tile, head, batch
// row) walks 64-key tiles through shared memory with a running max and sum,
// so the (Tq, Tk) probabilities never reach device memory; the forward
// keeps the per-row log-sum-exp as the backward's residual.  The backward
// runs one kernel per 64-key tile (dK, dV, walking the q tiles) and one per
// 64-row q tile (dQ, walking the k tiles), so nothing is summed across
// blocks and no atomics are needed.  A query row that sees no key returns
// exact zeros (as the JAX kernel's -1e9 bias with its 1e-30 denominator
// does); the TPU kernel's exp(min(s, 80)) clamp is not copied: the running
// max keeps every exponent <= 0.  Products run in fp32 on the CUDA cores.
#include <math.h>

#include "common.cuh"

namespace {

using simulst::Dropout;
using simulst::from_f32;
using simulst::round_to;
using simulst::to_f32;

constexpr int kHD = 64;       // head dim the kernels are built for
constexpr int kTile = 64;     // query rows / keys per tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 tile entries each
constexpr int kLd = kHD + 1;  // padded shared row: row and column reads
                              // both avoid bank conflicts
constexpr int kTileFloats = kTile * kLd;

struct Geometry {
  int Tq, Tk, H, causal;
  float scale;
  __device__ __forceinline__ int D() const { return H * kHD; }
};

// sums / maxima over the 16 lanes that share a row (one half-warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows [r0, r0 + 64) of head h of a (B, T, D) tensor into a padded tile
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int r0, int T_len, int D, int h) {
  for (int idx = threadIdx.x; idx < kTile * kHD; idx += kThreads) {
    const int r = idx / kHD, d = idx % kHD;
    const int row = r0 + r;
    dst[r * kLd + d] =
        row < T_len ? to_f32(src[((size_t)b * T_len + row) * D + h * kHD + d])
                    : 0.f;
  }
}

// key-valid flags of keys [k0, k0 + 64)
__device__ __forceinline__ void load_key_flags(int* flags, const int* kmask,
                                               int b, int k0, int Tk) {
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    const int k = k0 + c;
    flags[c] = k < Tk && kmask[(size_t)b * Tk + k] != 0;
  }
}

// s[i][j] = sum_d x[r_i][d] y[c_j][d], rows r_i = ty + 16 i of tile x, rows
// c_j = tx + 16 j of tile y
__device__ __forceinline__ void tile_dots(const float* x, const float* y,
                                          float s[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kHD; ++d) {
    float a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = x[(ty + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = y[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
  }
}

__device__ __forceinline__ bool visible(const Geometry& g, const int* kflags,
                                        int q, int k, int c) {
  return q < g.Tq && kflags[c] && (!g.causal || k <= q);
}

__device__ __forceinline__ unsigned long long prob_offset(const Geometry& g,
                                                          int b, int h, int q,
                                                          int k) {
  return (((unsigned long long)b * g.H + h) * g.Tq + q) * g.Tk + k;
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(Tq / 64), H, B)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ kmask,
                   T* __restrict__ out, float* __restrict__ lse, Geometry g,
                   Dropout drop) {
  extern __shared__ float smem[];
  float* qs = smem;               // q tile
  float* ks = qs + kTileFloats;   // k tile, then the tile's probabilities
  float* vs = ks + kTileFloats;   // v tile
  __shared__ int kflags[kTile];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int D = g.D();

  load_tile(qs, q, b, q0, g.Tq, D, h);
  float m_run[4], l_run[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int k_end = g.causal ? min(g.Tk, q0 + kTile) : g.Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's probabilities and v are read
    load_tile(ks, k, b, k0, g.Tk, D, h);
    load_tile(vs, v, b, k0, g.Tk, D, h);
    load_key_flags(kflags, kmask, b, k0, g.Tk);
    __syncthreads();
    float s[4][4];
    tile_dots(qs, ks, s);
    __syncthreads();  // ks is overwritten with probabilities below
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = visible(g, kflags, qr, k0 + c, c) ? s[i][j] * g.scale
                                                    : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      // rows with nothing visible yet keep m = -inf, p = 0 and acc = 0
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        psum += p;
        const float pd =
            p == 0.f ? 0.f : p * drop.scale(prob_offset(g, b, h, qr, k0 + c), 0);
        ks[(ty + 16 * i) * kLd + c] = round_to<T>(pd);
      }
      l_run[i] = l_run[i] * alpha + row_sum(psum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      float p[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ks[(ty + 16 * i) * kLd + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = vs[c * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= g.Tq) continue;
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[((size_t)b * g.Tq + qr) * D + h * kHD + tx + 16 * j] =
          from_f32<T>(acc[i][j] * inv);
    if (tx == 0)
      lse[((size_t)b * g.H + h) * g.Tq + qr] =
          l_run[i] > 0.f ? m_run[i] + logf(l_run[i]) : INFINITY;
  }
}

// delta[r] = sum_d dout[r, h, d] out[r, h, d] and lse of rows [q0, q0 + 64):
// the softmax backward's row term sum_k p dp (= dO . O, dropout included)
template <typename T>
__device__ __forceinline__ void load_row_terms(float* delta, float* lse_s,
                                               const T* out, const T* dout,
                                               const float* lse, int b, int h,
                                               int q0, const Geometry& g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = g.D();
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int qr = q0 + r;
    float s = 0.f;
    if (qr < g.Tq) {
      const size_t base = ((size_t)b * g.Tq + qr) * D + h * kHD;
      s = to_f32(dout[base + lane]) * to_f32(out[base + lane]) +
          to_f32(dout[base + lane + 32]) * to_f32(out[base + lane + 32]);
    }
    s = simulst::warp_sum(s);
    if (lane == 0) {
      delta[r] = s;
      lse_s[r] = qr < g.Tq ? lse[((size_t)b * g.H + h) * g.Tq + qr] : INFINITY;
    }
  }
}

// p and dS of one (q tile, k tile) pair, q rows ty + 16 i, keys tx + 16 j:
// p = exp(s - lse) where visible; pd = p * mult; dS = p (dp - delta) scale
// with dp = (dO . v) * mult.  Both are rounded to T where the JAX kernel
// casts them.
template <typename T>
__device__ __forceinline__ void probs_and_dscores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const int* kflags, const float* delta, const float* lse_s, int b, int h,
    int q0, int k0, const Geometry& g, const Dropout& drop, float pd[4][4],
    float ds[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dpd[4][4];
  tile_dots(qs, ks, s);
  tile_dots(dos, vs, dpd);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qr = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float p = 0.f, mult = 1.f;
      if (visible(g, kflags, qr, k0 + c, c)) {
        p = expf(s[i][j] * g.scale - lse_s[r]);
        mult = drop.scale(prob_offset(g, b, h, qr, k0 + c), 0);
      }
      pd[i][j] = round_to<T>(p * mult);
      ds[i][j] = round_to<T>(p * (dpd[i][j] * mult - delta[r]) * g.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: grid (ceil(Tk / 64), H, B)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kmask,
                        const T* __restrict__ out, const float* __restrict__ lse,
                        const T* __restrict__ dout, T* __restrict__ dk,
                        T* __restrict__ dv, Geometry g, Dropout drop) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTileFloats;
  float* qs = vs + kTileFloats;
  float* dos = qs + kTileFloats;
  float* ps = dos + kTileFloats;   // dropped probabilities [q][k]
  float* dss = ps + kTileFloats;   // score gradients [q][k]
  __shared__ int kflags[kTile];
  __shared__ float delta[kTile], lse_s[kTile];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int D = g.D();

  load_tile(ks, k, b, k0, g.Tk, D, h);
  load_tile(vs, v, b, k0, g.Tk, D, h);
  load_key_flags(kflags, kmask, b, k0, g.Tk);
  float dk_acc[4][4], dv_acc[4][4];  // keys ty + 16 i, dims tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: q tiles that end before k0 see none of these keys
  const int q_begin = g.causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_begin; q0 < g.Tq; q0 += kTile) {
    __syncthreads();  // the previous q tile's ps / dss / qs / dos are read
    load_tile(qs, q, b, q0, g.Tq, D, h);
    load_tile(dos, dout, b, q0, g.Tq, D, h);
    load_row_terms(delta, lse_s, out, dout, lse, b, h, q0, g);
    __syncthreads();
    float pd[4][4], ds[4][4];
    probs_and_dscores<T>(qs, dos, ks, vs, kflags, delta, lse_s, b, h, q0, k0,
                         g, drop, pd, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty + 16 * i) * kLd + tx + 16 * j] = pd[i][j];
        dss[(ty + 16 * i) * kLd + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dV[k][d] += sum_q pd[q][k] dO[q][d];  dK[k][d] += sum_q dS[q][k] Q[q][d]
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pv[4], sv[4], dov[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[r * kLd + ty + 16 * i];
        sv[i] = dss[r * kLd + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dov[j] = dos[r * kLd + tx + 16 * j];
        qv[j] = qs[r * kLd + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= g.Tk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t off = ((size_t)b * g.Tk + kr) * D + h * kHD + tx + 16 * j;
      dk[off] = from_f32<T>(dk_acc[i][j]);
      dv[off] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dQ: grid (ceil(Tq / 64), H, B)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kmask,
                      const T* __restrict__ out, const float* __restrict__ lse,
                      const T* __restrict__ dout, T* __restrict__ dq,
                      Geometry g, Dropout drop) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTileFloats;
  float* ks = dos + kTileFloats;
  float* vs = ks + kTileFloats;
  float* dss = vs + kTileFloats;
  __shared__ int kflags[kTile];
  __shared__ float delta[kTile], lse_s[kTile];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int D = g.D();

  load_tile(qs, q, b, q0, g.Tq, D, h);
  load_tile(dos, dout, b, q0, g.Tq, D, h);
  load_row_terms(delta, lse_s, out, dout, lse, b, h, q0, g);
  float dq_acc[4][4];  // q rows ty + 16 i, dims tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq_acc[i][j] = 0.f;

  const int k_end = g.causal ? min(g.Tk, q0 + kTile) : g.Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous k tile and its dS are read
    load_tile(ks, k, b, k0, g.Tk, D, h);
    load_tile(vs, v, b, k0, g.Tk, D, h);
    load_key_flags(kflags, kmask, b, k0, g.Tk);
    __syncthreads();
    float pd[4][4], ds[4][4];
    probs_and_dscores<T>(qs, dos, ks, vs, kflags, delta, lse_s, b, h, q0, k0,
                         g, drop, pd, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kLd + tx + 16 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      float sv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dss[(ty + 16 * i) * kLd + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[c * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dq_acc[i][j] = fmaf(sv[i], kv[j], dq_acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= g.Tq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[((size_t)b * g.Tq + qr) * D + h * kHD + tx + 16 * j] =
          from_f32<T>(dq_acc[i][j]);
  }
}

constexpr size_t kFwdSmem = 3 * kTileFloats * sizeof(float);
constexpr size_t kDkdvSmem = 6 * kTileFloats * sizeof(float);
constexpr size_t kDqSmem = 5 * kTileFloats * sizeof(float);

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Geometry make_geometry(int Tq, int Tk, int H, int causal) {
  return Geometry{Tq, Tk, H, causal, 1.0f / sqrtf((float)kHD)};
}

Dropout make_dropout(int on, unsigned long long seed, unsigned threshold,
                     float inv_keep) {
  return Dropout{seed, threshold, inv_keep, on};
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const int* kmask,
               void* out, float* lse, int B, int Tq, int Tk, int H,
               int causal, Dropout drop, cudaStream_t s) {
  SIMULST_TRY(allow_smem(mha_fwd_kernel<T>, kFwdSmem));
  const dim3 grid(simulst::ceil_div(Tq, kTile), H, B);
  mha_fwd_kernel<T><<<grid, kThreads, kFwdSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kmask, static_cast<T*>(out), lse,
      make_geometry(Tq, Tk, H, causal), drop);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const int* kmask,
               const void* out, const float* lse, const void* dout, void* dq,
               void* dk, void* dv, int B, int Tq, int Tk, int H, int causal,
               Dropout drop, cudaStream_t s) {
  const Geometry g = make_geometry(Tq, Tk, H, causal);
  SIMULST_TRY(allow_smem(mha_bwd_dkdv_kernel<T>, kDkdvSmem));
  SIMULST_TRY(allow_smem(mha_bwd_dq_kernel<T>, kDqSmem));
  mha_bwd_dkdv_kernel<T>
      <<<dim3(simulst::ceil_div(Tk, kTile), H, B), kThreads, kDkdvSmem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), kmask, static_cast<const T*>(out), lse,
          static_cast<const T*>(dout), static_cast<T*>(dk),
          static_cast<T*>(dv), g, drop);
  SIMULST_TRY(cudaGetLastError());
  mha_bwd_dq_kernel<T>
      <<<dim3(simulst::ceil_div(Tq, kTile), H, B), kThreads, kDqSmem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), kmask, static_cast<const T*>(out), lse,
          static_cast<const T*>(dout), static_cast<T*>(dq), g, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Tq, D); k, v: (B, Tk, D), all of `dtype`, D = heads * 64;
// kmask: (B, Tk) int32; out: (B, Tq, D); lse: (B, heads, Tq) fp32.
// Dropout on the probabilities when dropout != 0.  Returns a cudaError_t.
extern "C" int simulst_mha_fwd(int dtype, const void* q, const void* k,
                               const void* v, const void* kmask, void* out,
                               void* lse, int B, int Tq, int Tk, int D,
                               int heads, int causal, int dropout,
                               unsigned long long seed, unsigned threshold,
                               float inv_keep, void* stream) {
  if (D != heads * kHD || B <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(dropout, seed, threshold, inv_keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SIMULST_DISPATCH(dtype, return launch_fwd<scalar_t>(
                              q, k, v, static_cast<const int*>(kmask), out,
                              static_cast<float*>(lse), B, Tq, Tk, heads,
                              causal, drop, s));
}

// The backward of simulst_mha_fwd: dq (B, Tq, D), dk and dv (B, Tk, D) from
// the forward's inputs, its out and lse, and dout (B, Tq, D).
extern "C" int simulst_mha_bwd(int dtype, const void* q, const void* k,
                               const void* v, const void* kmask,
                               const void* out, const void* lse,
                               const void* dout, void* dq, void* dk, void* dv,
                               int B, int Tq, int Tk, int D, int heads,
                               int causal, int dropout, unsigned long long seed,
                               unsigned threshold, float inv_keep,
                               void* stream) {
  if (D != heads * kHD || B <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(dropout, seed, threshold, inv_keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SIMULST_DISPATCH(dtype, return launch_bwd<scalar_t>(
                              q, k, v, static_cast<const int*>(kmask), out,
                              static_cast<const float*>(lse), dout, dq, dk,
                              dv, B, Tq, Tk, heads, causal, drop, s));
}
