// Fused multi-head attention core for Hopper, forward and backward: the
// attention after the q/k/v projections and before out_proj.
//
//   out[b, q, h] = sum_k drop(softmax_k(q_h . k_h / sqrt(hd) + mask)) v_h
//
// Replaces the Pallas kernels simulst_tpu/ops/mha_pallas.py `fused_mha`
// (_fwd_kernel via _fwd_call, _bwd_kernel via _bwd_call): the decoder's
// causal self-attention and cross-attention and the MT encoder's
// self-attention.  Heads are hd-column slices of D, so no head transpose is
// ever written; the key mask is an int32 (B, Tk) row plus an optional
// causal rule; dropout on the probabilities draws Philox bits keyed by
// (seed, ((b H + h) Tq + q) Tk + k), so the backward regenerates the mask.
//
// What bounds it on the H100: at the MT shape (B 64, Tq = Tk = 128, D 256,
// 4 heads) the forward is 2 products of 64 x 4 x 128 x 128 x 64, about
// 1.07 GFLOP (16 us at the fp32 CUDA-core peak), and reads 25 MB; at the
// decoder step (Tq = 1 over 256 encoder frames, B 40) it reads K and V
// (21 MB) for 0.02 GFLOP.  The design is flash-attention's: a block walks
// 64-key tiles through shared memory with a running max and sum, so the
// (Tq, Tk) probabilities never reach device memory; the forward keeps the
// per-row log-sum-exp as the backward's residual.  It has two kernels
// with the same sums (below): one per 64-row q tile for training, one per
// few q rows of a head for decoding.  The backward
// (about 2 GFLOP at the MT shape, causal: 30 us at the peak) runs a row
// pass for delta = dO . O, one kernel per 64-key tile (dK, dV, walking the
// q tiles; it also writes dS to an fp32 scratch) and one per 64-row q tile
// (dQ = dS K, walking the k tiles), so nothing is summed across blocks and
// no atomics are needed.  A query row that sees no key returns
// exact zeros (as the JAX kernel's -1e9 bias with its 1e-30 denominator
// does); the TPU kernel's exp(min(s, 80)) clamp is not copied: the running
// max keeps every exponent <= 0.  Products run in fp32 on the CUDA cores.
//
// Head dims: any multiple of 8.  Up to 128 the kernels are templates on
// the staged head dim kHD, 64 or 128 (the next at or above hd): a head's
// rows are staged into kHD-wide shared tiles whose features past hd are
// zero-filled, so every dot product over d adds exact zeros past hd, and
// only the hd real features of an output are stored.  At hd 64 and 128
// nothing is padded.  kHD 128 doubles each thread's outputs along d (two
// 64-feature column blocks); its blocks take more shared memory (one block
// per SM instead of two).  Any other head dim reaches the kernels
// zero-padded to the next multiple of 8 (ops/mha.py), with the real head
// dim beside it for the scale 1 / sqrt(hd): the padded features add exact
// zeros to every score, and their outputs (zero) are sliced away.  Above
// 128 (a 256-wide staged tile would not fit a block's shared memory with
// the ring) the "wide" kernels run instead, correct rather than fast: one
// block per query row of a head, which reads q . k and dO . v from device
// memory one key a thread and walks the output features 128 at a time
// (forward: the softmax's max, then its sum, then the output, the scores
// recomputed in each pass; backward: a row pass writes dS and the dropped
// probabilities to fp32 scratch and dQ, a key-row pass sums dK and dV over
// the query rows ascending).  Their sums are not the tiled kernels' (no
// other path exists above 128 to agree with).
#include <math.h>

#include "common.cuh"

namespace {

using simulst::Dropout;
using simulst::from_f32;
using simulst::round_to;
using simulst::to_f32;

constexpr int kTile = 64;     // query rows / keys per tile
constexpr int kMaxHD = 128;   // staged head dims up to it; wide kernels above
constexpr int kHDStep = 8;

struct Geometry {
  int Tq, Tk, H, causal;
  int hd;        // the head dim; features [hd, kHD) of a staged row are 0
  float scale;
};

// the head dim of a kernel staged kHD wide: kHD itself unless it pads the
// head (kPad), so that an unpadded head's offsets fold to constants
template <int kHD, bool kPad>
__device__ __forceinline__ int head_dim_of(const Geometry& g) {
  return kPad ? g.hd : kHD;
}

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

// key-valid flags of keys [k0, k0 + 64)
__device__ __forceinline__ void load_key_flags(int* flags, const int* kmask,
                                               int b, int k0, int Tk) {
  for (int c = threadIdx.x; c < kTile; c += blockDim.x) {
    const int k = k0 + c;
    flags[c] = k < Tk && kmask[(size_t)b * Tk + k] != 0;
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
// backward
// ---------------------------------------------------------------------------
// Three kernels, each output summed as the first design summed it, so that
// the results are bit for bit the same:
//  - delta: delta[b, h, q] = sum_d dO . O, the softmax backward's row term
//    (dropout included), once per row (B H Tq rows, one warp each);
//  - dK / dV: grid (ceil(Tk / 64), H, B), 256 threads in two groups of
//    128, walking the q tiles.  Per q tile, group 0 computes s = Q K^T and
//    the probabilities while group 1 computes dp = dO V^T; then group 0
//    forms the dropped probabilities P and group 1 dS, which also goes to a
//    scratch (B, H, Tq, Tk64) for the dQ kernel; then group 0 adds P^T dO
//    into dV and group 1 dS^T Q into dK: four 64 x 64 x 64 products per
//    (q tile, k tile) pair;
//  - dQ: grid (ceil(Tq / 64), H, B), 128 threads, dQ = dS K over the k
//    tiles from the scratch through a two-stage cp.async ring: one product
//    per pair, as s, dp and dS are computed once, in the dK / dV kernel.
// Every product gives each thread 8 x 4 outputs per 64 features (kHD / 64
// column blocks) and reads its operands as float4 from rows padded by 4
// floats (68 at kHD 64: 16-byte aligned, and eight neighbouring rows on
// eight distinct bank groups): three 16-byte shared reads per 32 FMAs.  The shared tiles hold fp32 (bf16 widened exactly on
// load); fp32 tiles arrive by 16-byte cp.async, bf16 through registers.
// The dK / dV kernel's six tiles (104 KB, and 4 KB of dropout codes) let
// two blocks share an SM: one block's loads overlap the other's products
// (a ring would not fit; its q loop runs 1-2 times at the path's shapes).
// Each pair's dropout multiplier is drawn once, half of them by each group
// (a pair's ten Philox rounds cost about as many issue slots as its 256
// FMAs).
// a (q, k) tile's row stride, and a head tile's (kTile rows of kHD
// features); at kHD 64 the two are the same
constexpr int kPLd = kTile + 4;
constexpr int kProbTile = kTile * kPLd;
template <int kHD>
__host__ __device__ constexpr int head_ld() { return kHD + 4; }
template <int kHD>
__host__ __device__ constexpr int head_tile() { return kTile * head_ld<kHD>(); }
constexpr int kGroup = 128;   // threads per product: 8 x 16, 8 x 4 outputs each

// rows [0, 64) of a (rows, kCols) tile of T, row r at src + r ld, into fp32
// dst[r (kCols + 4) + c]; rows >= valid and columns >= cols are zero.
// fp32 by cp.async (the caller commits and waits), bf16 through registers.
template <int kN, int kCols, typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           size_t ld, int valid,
                                           int cols = kCols) {
  const int t = threadIdx.x % kN;
#pragma unroll
  for (int q = 0; q < kTile * kCols / 4 / kN; ++q) {
    const int idx = t + q * kN, r = idx / (kCols / 4),
              c = idx % (kCols / 4) * 4;
    const bool ok = r < valid && c < cols;
    simulst::stage4(dst + r * (kCols + 4) + c,
                    src + (ok ? (size_t)r * ld + c : 0), ok);
  }
}

// s[i][j] = sum_d x[r_i][d] y[c_j][d] for d ascending, rows r_i = tr +
// (64 / kR) i of head tile x, rows c_j = tc + 16 j of head tile y; rows
// r_i >= n are left 0
template <int kR, int kHD>
__device__ __forceinline__ void row_dots(const float* x, const float* y,
                                         int n, int tr, int tc,
                                         float (&s)[kR][4]) {
  constexpr int kStride = kTile / kR, kBwdLd = head_ld<kHD>();
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kHD; d += 4) {
    float4 yv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      yv[j] = *reinterpret_cast<const float4*>(y + (tc + 16 * j) * kBwdLd + d);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (tr + kStride * i >= n) break;
      const float4 xv = *reinterpret_cast<const float4*>(
          x + (tr + kStride * i) * kBwdLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(xv.x, yv[j].x, s[i][j]);
        s[i][j] = fmaf(xv.y, yv[j].y, s[i][j]);
        s[i][j] = fmaf(xv.z, yv[j].z, s[i][j]);
        s[i][j] = fmaf(xv.w, yv[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][4 cb + j] += sum_r a[r][8 tr + i] b[r][64 cb + 4 tc + j] for r
// ascending over rows [r0, n) of (q, k) tile a and head tile b (the others
// hold zeros in a's columns 8 tr .. 8 tr + 7)
template <int kHD>
__device__ __forceinline__ void rank_update(const float* a, const float* b,
                                            int r0, int n, int tr, int tc,
                                            float (&acc)[8][kHD / 16]) {
  constexpr int kBLd = head_ld<kHD>();
#pragma unroll 4
  for (int r = r0; r < n; ++r) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + r * kPLd + 8 * tr);
    const float4 a1 =
        *reinterpret_cast<const float4*>(a + r * kPLd + 8 * tr + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int cb = 0; cb < kHD / 64; ++cb) {
      const float4 bv =
          *reinterpret_cast<const float4*>(b + r * kBLd + 64 * cb + 4 * tc);
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][4 * cb + j] = fmaf(av[i], bw[j], acc[i][4 * cb + j]);
    }
  }
}

// acc[i][4 cb + j] = fmaf(a[r_i][c], b[c][64 cb + 4 tc + j], ...) for c
// ascending over [0, n) (n a multiple of 4), rows r_i = tr + (64 / kR) i <
// rows of (q, k) tile a (the others are left as they are), head tile b
template <int kR, int kHD>
__device__ __forceinline__ void rows_times_tile(const float* a,
                                                const float* b, int n,
                                                int rows, int tr, int tc,
                                                float (&acc)[kR][kHD / 16]) {
  constexpr int kStride = kTile / kR, kCB = kHD / 64, kBLd = head_ld<kHD>();
#pragma unroll 2
  for (int c = 0; c < n; c += 4) {
    float4 bv[kCB][4];
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        bv[cb][kk] = *reinterpret_cast<const float4*>(
            b + (c + kk) * kBLd + 64 * cb + 4 * tc);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (tr + kStride * i >= rows) break;
      const float4 av = *reinterpret_cast<const float4*>(
          a + (tr + kStride * i) * kPLd + c);
      const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb) {
          float* o = acc[i] + 4 * cb;
          o[0] = fmaf(a4[kk], bv[cb][kk].x, o[0]);
          o[1] = fmaf(a4[kk], bv[cb][kk].y, o[1]);
          o[2] = fmaf(a4[kk], bv[cb][kk].z, o[2]);
          o[3] = fmaf(a4[kk], bv[cb][kk].w, o[3]);
        }
    }
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  p[0] = __float2bfloat16(a);
  p[1] = __float2bfloat16(b);
  p[2] = __float2bfloat16(c);
  p[3] = __float2bfloat16(d);
}

// rows 8 tr + i < n_valid of an 8 x (kHD / 16) accumulator into dst (row
// stride ld, columns 64 cb + 4 tc .. + 3 below hd)
template <int kHD, typename T>
__device__ __forceinline__ void store_rows(T* dst, size_t ld, int n_valid,
                                           int tr, int tc, int hd,
                                           const float (&acc)[8][kHD / 16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (8 * tr + i < n_valid)
#pragma unroll
      for (int cb = 0; cb < kHD / 64; ++cb)
        if (64 * cb + 4 * tc < hd)
          store4(dst + (size_t)(8 * tr + i) * ld + 64 * cb + 4 * tc,
                 acc[i][4 * cb], acc[i][4 * cb + 1], acc[i][4 * cb + 2],
                 acc[i][4 * cb + 3]);
}

// delta[(b H + h) Tq + q] = sum_d dout[b, q, h, d] out[b, q, h, d]: each
// lane's kHD / 32 products (features past hd read as 0), then the warp's
// xor tree.  Grid ceil(B H Tq / 8), 256 threads.
template <typename T, int kHD, bool kPad>
__global__ void __launch_bounds__(256)
    mha_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                         float* __restrict__ delta, Geometry g, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int qr = row % g.Tq, bh = row / g.Tq;
  const int h = bh % g.H, b = bh / g.H;
  const int hd = head_dim_of<kHD, kPad>(g);
  const size_t base = ((size_t)b * g.Tq + qr) * (g.H * hd) + h * hd;
  float x[kHD / 32], y[kHD / 32];
#pragma unroll
  for (int i = 0; i < kHD / 32; ++i) {
    const int c = lane + 32 * i;
    x[i] = c < hd ? to_f32(dout[base + c]) : 0.f;
    y[i] = c < hd ? to_f32(out[base + c]) : 0.f;
  }
  float s = x[0] * y[0] + x[1] * y[1];
  if constexpr (kHD == 128) s = s + x[2] * y[2] + x[3] * y[3];
  s = simulst::warp_sum(s);
  if (lane == 0) delta[row] = s;
}

template <int kHD>
__host__ __device__ constexpr int dkdv_min_blocks() { return kHD == 64 ? 2 : 1; }

template <typename T, int kHD, bool kPad>
__global__ void __launch_bounds__(2 * kGroup, dkdv_min_blocks<kHD>())
    mha_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kmask,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const T* __restrict__ dout, T* __restrict__ dk,
                        T* __restrict__ dv, float* __restrict__ ds_out,
                        int tk64, Geometry g, Dropout drop) {
  constexpr int kHT = head_tile<kHD>();
  extern __shared__ __align__(16) float bwd_smem[];
  float* ks = bwd_smem;
  float* vs = ks + kHT;
  float* qs = vs + kHT;
  float* dos = qs + kHT;
  float* ps = dos + kHT;         // dropped probabilities [q][k], rounded to T
  float* dss = ps + kProbTile;   // p, then the score gradients [q][k]
  __shared__ int kflags[kTile];
  __shared__ unsigned char keep[kTile][kTile];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int hd = head_dim_of<kHD, kPad>(g), D = g.H * hd;
  const int group = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int tr = t / 16, tc = t % 16;
  const size_t head = (size_t)(b * g.H + h) * g.Tq;   // row 0 of lse / delta

  stage_tile<2 * kGroup, kHD>(ks, k + ((size_t)b * g.Tk + k0) * D + h * hd,
                              D, g.Tk - k0, hd);
  stage_tile<2 * kGroup, kHD>(vs, v + ((size_t)b * g.Tk + k0) * D + h * hd,
                              D, g.Tk - k0, hd);
  load_key_flags(kflags, kmask, b, k0, g.Tk);
  // group 0: dV, group 1: dK; keys 8 tr + i, dims 64 cb + 4 tc + j
  float acc[8][kHD / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kHD / 16; ++j) acc[i][j] = 0.f;

  // causal: q tiles that end before k0 see none of these keys
  const int q_begin = g.causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_begin; q0 < g.Tq; q0 += kTile) {
    __syncthreads();   // the previous q tile's tiles are read
    stage_tile<2 * kGroup, kHD>(qs, q + ((size_t)b * g.Tq + q0) * D + h * hd,
                                D, g.Tq - q0, hd);
    stage_tile<2 * kGroup, kHD>(
        dos, dout + ((size_t)b * g.Tq + q0) * D + h * hd, D, g.Tq - q0,
        hd);
    simulst::async_commit();
    // the rows' lse (group 0) or delta (group 1), loaded while the tiles
    // arrive; 0 past Tq
    float row_term[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qr = q0 + tr + 8 * i;
      row_term[i] = qr < g.Tq ? (group ? delta : lse)[head + qr] : 0.f;
    }
    simulst::async_wait<0>();
    __syncthreads();
    // group 0: s and p; group 1: dpd = dO . v (q rows tr + 8 i, keys
    // tc + 16 j); rows past Tq hold zeros, and their sums are skipped
    const int q_rows = min(kTile, g.Tq - q0);
    float st[8][4];
    row_dots<8, kHD>(group ? dos : qs, group ? vs : ks, q_rows, tr, tc, st);
    // each pair's dropout multiplier is drawn once, group 0 drawing rows
    // tr + 8 i for i < 4 and group 1 for i >= 4, into keep[q][k]: 0
    // dropped, 1 kept (1 / keep), 2 a multiplier of 1 (an invisible pair,
    // or no dropout)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 8 * (i + 4 * group), qr = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float m = visible(g, kflags, qr, k0 + c, c)
                            ? drop.scale(prob_offset(g, b, h, qr, k0 + c), 0)
                            : 1.f;
        keep[r][c] = m == 1.f ? 2 : m != 0.f;
      }
    }
    if (group == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tr + 8 * i, qr = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tc + 16 * j;
          float p = 0.f;
          if (visible(g, kflags, qr, k0 + c, c))
            p = expf(st[i][j] * g.scale - row_term[i]);
          st[i][j] = p;
          dss[r * kPLd + c] = p;
        }
      }
    }
    __syncthreads();
    // pd = p mult (group 0) and dS = p (dpd mult - delta) scale (group 1),
    // rounded to T where the JAX kernel casts them
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tr + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const int code = keep[r][c];
        const float mult = code == 2 ? 1.f : code ? drop.inv_keep : 0.f;
        if (group == 0) {
          ps[r * kPLd + c] = round_to<T>(st[i][j] * mult);
        } else {
          const float p = dss[r * kPLd + c];
          dss[r * kPLd + c] =
              round_to<T>(p * (st[i][j] * mult - row_term[i]) * g.scale);
        }
      }
    }
    __syncthreads();
    // dS rows q0 .. into the scratch, for the dQ kernel
    for (int idx = threadIdx.x; idx < kTile * kTile / 4; idx += 2 * kGroup) {
      const int r = idx / (kTile / 4), c = idx % (kTile / 4) * 4;
      if (q0 + r < g.Tq)
        *reinterpret_cast<float4*>(ds_out + (head + q0 + r) * tk64 + k0 + c) =
            *reinterpret_cast<const float4*>(dss + r * kPLd + c);
    }
    // dV[k][d] += sum_q pd[q][k] dO[q][d];  dK[k][d] += sum_q dS[q][k] Q[q][d]
    // on a causal diagonal tile, rows before this thread's first key see
    // none of its keys: their P and dS columns are zero
    rank_update<kHD>(group ? dss : ps, group ? qs : dos,
                     g.causal && q0 == k0 ? 8 * tr : 0, q_rows, tr, tc, acc);
  }
  const size_t row0 = ((size_t)b * g.Tk + k0) * D + h * hd;
  store_rows<kHD>(group ? dk + row0 : dv + row0, D, g.Tk - k0, tr, tc, hd,
                  acc);
}

// dQ[q][d] = sum over k ascending of dS[q][k] K[k][d]: grid (ceil(Tq / 64),
// H, B), kGroup threads; q rows tr + 8 i, dims 64 cb + 4 tc + j
template <typename T, int kHD, bool kPad>
__global__ void __launch_bounds__(kGroup, 3)
    mha_bwd_dq_kernel(const T* __restrict__ k, const float* __restrict__ ds,
                      T* __restrict__ dq, int tk64, Geometry g) {
  constexpr int kHT = head_tile<kHD>(), kKLd = head_ld<kHD>(),
                kCB = kHD / 64;
  extern __shared__ __align__(16) float bwd_smem[];
  float* const ring = bwd_smem;   // 2 stages of [dS | K]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int hd = head_dim_of<kHD, kPad>(g), D = g.H * hd;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const float* ds_rows = ds + ((size_t)(b * g.H + h) * g.Tq + q0) * tk64;
  const int k_end = g.causal ? min(g.Tk, q0 + kTile) : g.Tk;
  const int steps = (k_end + kTile - 1) / kTile;
  auto load = [&](int step) {
    float* s = ring + step % 2 * (kProbTile + kHT);
    const int k0 = step * kTile;
    stage_tile<kGroup, kTile>(s, ds_rows + k0, tk64, g.Tq - q0);
    stage_tile<kGroup, kHD>(s + kProbTile,
                            k + ((size_t)b * g.Tk + k0) * D + h * hd, D,
                            g.Tk - k0, hd);
    simulst::async_commit();
  };
  float acc[8][kHD / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kHD / 16; ++j) acc[i][j] = 0.f;
  load(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      load(step + 1);   // its stage was read in step - 1
      simulst::async_wait<1>();
    } else {
      simulst::async_wait<0>();
    }
    __syncthreads();
    const float* dss = ring + step % 2 * (kProbTile + kHT);
    const float* ks = dss + kProbTile;
    // keys past Tk add zeros: stop at the first whole step of 4 past it
    const int n = min(kTile, (g.Tk - step * kTile + 3) / 4 * 4);
#pragma unroll 2
    for (int c = 0; c < n; c += 4) {
      float4 kv[kCB][4];
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          kv[cb][kk] = *reinterpret_cast<const float4*>(
              ks + (c + kk) * kKLd + 64 * cb + 4 * tc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 sv =
            *reinterpret_cast<const float4*>(dss + (tr + 8 * i) * kPLd + c);
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int cb = 0; cb < kCB; ++cb) {
            float* o = acc[i] + 4 * cb;
            o[0] = fmaf(s4[kk], kv[cb][kk].x, o[0]);
            o[1] = fmaf(s4[kk], kv[cb][kk].y, o[1]);
            o[2] = fmaf(s4[kk], kv[cb][kk].z, o[2]);
            o[3] = fmaf(s4[kk], kv[cb][kk].w, o[3]);
          }
      }
    }
    __syncthreads();   // this stage is free for step + 2's loads
  }
  // rows tr + 8 i
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qr = q0 + tr + 8 * i;
    if (qr < g.Tq)
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
        if (64 * cb + 4 * tc < hd)
          store4(dq + ((size_t)b * g.Tq + qr) * D + h * hd + 64 * cb +
                     4 * tc,
                 acc[i][4 * cb], acc[i][4 * cb + 1], acc[i][4 * cb + 2],
                 acc[i][4 * cb + 3]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
// Two kernels, which sum every output as the first design's one block of
// 256 threads per 64-row q tile summed it, so that the results are bit for
// bit the same.  Per 64-key tile, the tiles in ascending order:
//  - s = fmaf chain of q . k over d ascending from 0, times scale; -inf
//    where the pair is not visible;
//  - the running max m_new = max(m, the tile's max), alpha = expf(m -
//    m_new), once per tile;
//  - p = expf(s - m_new); psum as a tree: lane l of 16 sums the p of
//    columns l, l + 16, l + 32, l + 48 in that order from 0, then a
//    butterfly over xor 8, 4, 2, 1; l = l alpha + psum;
//  - acc = acc alpha, then acc = fmaf(round_T(p mult), v, acc) over the 64
//    columns ascending (mult the dropout multiplier, drawn once where p
//    != 0);
// then out = acc (1 / l) and lse = m + log l; a row that sees no key gives
// zeros and lse +inf.
//  - mha_fwd_kernel (training, Tq > ops/mha.py DECODE_MAX_TQ): grid (H,
//    B, ceil(Tq / 64)), the last q tiles first (under the causal rule they
//    walk the most keys), 256 threads; thread (tr, tc) = (t / 16, t % 16)
//    owns q rows tr + 16 i (i < 4): s of key columns tc + 16 j, so that
//    each half-warp holds its row's tree, then out dims 4 tc + j.  K and V
//    tiles arrive by 16-byte cp.async in a two-stage ring (bf16 through
//    registers), one barrier per tile before the products and one between
//    them; rows padded to 68 floats, read as float4: 8 shared reads per 64
//    FMAs in both products.  Rows past Tq are skipped in the products;
//    tiles past the causal diagonal are not read.  102 KB of shared
//    memory: two blocks per SM.  ptxas: 91 registers (bf16 87), no spills.
//  - mha_decode_kernel (decoding, Tq <= DECODE_MAX_TQ, the decoder step's
//    Tq = 1): grid (ceil(Tq / 2), H, B), 64 threads for up to 2 q rows of
//    one (b, h), which share the staged K and V tiles (a three-stage
//    ring); thread t owns key column t for s and out dim t for the
//    product, so that no dot product is computed for a row that does not
//    exist; the tile's p goes through shared memory, where each half-warp
//    forms the 16-lane tree.  104 KB: two blocks per SM.  ptxas: 128
//    registers (bf16 120), no spills.
constexpr int kFwdRows = 4;                         // q rows per thread
constexpr int kFwdThreads = 16 * (kTile / kFwdRows);  // 256
constexpr int kDecRows = 2;
constexpr int kDecStages = 3;
constexpr int kDecThreads = kTile;

// the K and V rows [k0, k0 + 64) of head h and their key flags into a ring
// stage [K | V] (kN threads); the caller commits
template <int kN, int kHD, typename T>
__device__ __forceinline__ void stage_kv(float* stage, int* flags,
                                         const T* k, const T* v,
                                         const int* kmask, const Geometry& g,
                                         int hd, int b, int h, int k0) {
  const int D = g.H * hd;
  const size_t row0 = ((size_t)b * g.Tk + k0) * D + h * hd;
  stage_tile<kN, kHD>(stage, k + row0, D, g.Tk - k0, hd);
  stage_tile<kN, kHD>(stage + head_tile<kHD>(), v + row0, D, g.Tk - k0, hd);
  load_key_flags(flags, kmask, b, k0, g.Tk);
}

template <int kHD>
__host__ __device__ constexpr int fwd_min_blocks() { return kHD == 64 ? 2 : 1; }

template <typename T, int kHD, bool kPad>
__global__ void __launch_bounds__(kFwdThreads, fwd_min_blocks<kHD>())
    mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ kmask,
                   T* __restrict__ out, float* __restrict__ lse, Geometry g,
                   Dropout drop) {
  constexpr int kR = kFwdRows, kN = kFwdThreads, kStride = kTile / kR;
  constexpr int kHT = head_tile<kHD>(), kCB = kHD / 64;
  extern __shared__ __align__(16) float fwd_smem[];
  float* qs = fwd_smem;
  float* ps = qs + kHT;          // the tile's round_T(p mult) [q][k]
  float* ring = ps + kProbTile;  // 2 stages of [K | V]
  __shared__ int kflags[2][kTile];
  // the last q tiles first: under the causal rule they walk the most keys
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int hd = head_dim_of<kHD, kPad>(g), D = g.H * hd;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int q_rows = min(kTile, g.Tq - q0);
  const int k_end = g.causal ? min(g.Tk, q0 + kTile) : g.Tk;
  const int steps = (k_end + kTile - 1) / kTile;
  auto load = [&](int step) {
    stage_kv<kN, kHD>(ring + step % 2 * 2 * kHT, kflags[step % 2], k, v,
                      kmask, g, hd, b, h, step * kTile);
  };
  stage_tile<kN, kHD>(qs, q + ((size_t)b * g.Tq + q0) * D + h * hd, D,
                      q_rows, hd);
  load(0);   // q arrives with tile 0
  simulst::async_commit();

  float m_run[kR], l_run[kR], acc[kR][kHD / 16];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kHD / 16; ++j) acc[i][j] = 0.f;
  }
  for (int step = 0; step < steps; ++step) {
    simulst::async_wait<0>();
    __syncthreads();   // tile step is in; step - 1's stage and ps are free
    if (step + 1 < steps) load(step + 1);
    simulst::async_commit();
    const int k0 = step * kTile;
    const float* ks = ring + step % 2 * 2 * kHT;
    const float* vs = ks + kHT;
    const int* flags = kflags[step % 2];
    float st[kR][4];
    row_dots<kR, kHD>(qs, ks, q_rows, tr, tc, st);
    // every row, past Tq too, so that the half-warp's shuffles see all
    // lanes (those rows' pairs are not visible: p = 0)
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = tr + kStride * i, qr = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        st[i][j] = visible(g, flags, qr, k0 + c, c) ? st[i][j] * g.scale
                                                    : -INFINITY;
        mx = fmaxf(mx, st[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      // rows with nothing visible yet keep m = -inf, p = 0 and acc = 0
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float p = st[i][j] == -INFINITY ? 0.f : expf(st[i][j] - m_new);
        psum += p;
        const float pd =
            p == 0.f ? 0.f : p * drop.scale(prob_offset(g, b, h, qr, k0 + c), 0);
        ps[r * kPLd + c] = round_to<T>(pd);
      }
      l_run[i] = l_run[i] * alpha + row_sum(psum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < kHD / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    rows_times_tile<kR, kHD>(ps, vs, kTile, q_rows, tr, tc, acc);
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qr = q0 + tr + kStride * i;
    if (qr >= g.Tq) break;
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
      if (64 * cb + 4 * tc < hd)
        store4(out + ((size_t)b * g.Tq + qr) * D + h * hd + 64 * cb +
                   4 * tc,
               acc[i][4 * cb] * inv, acc[i][4 * cb + 1] * inv,
               acc[i][4 * cb + 2] * inv, acc[i][4 * cb + 3] * inv);
    if (tc == 0)
      lse[((size_t)b * g.H + h) * g.Tq + qr] =
          l_run[i] > 0.f ? m_run[i] + logf(l_run[i]) : INFINITY;
  }
}

template <typename T, int kHD, bool kPad>
__global__ void __launch_bounds__(kDecThreads)
    mha_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kmask,
                      T* __restrict__ out, float* __restrict__ lse,
                      Geometry g, Dropout drop) {
  constexpr int kHT = head_tile<kHD>(), kKLd = head_ld<kHD>(),
                kCB = kHD / 64;
  extern __shared__ __align__(16) float dec_smem[];   // stages of [K | V]
  __shared__ __align__(16) float qs[kDecRows][kHD];
  __shared__ __align__(16) float pr[kDecRows][kTile];   // p
  __shared__ __align__(16) float ps[kDecRows][kTile];   // round_T(p mult)
  __shared__ float warp_mx[kDecRows][kTile / 32];
  __shared__ int kflags[kDecStages][kTile];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kDecRows;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int hd = head_dim_of<kHD, kPad>(g), D = g.H * hd;
  const int rows = min(kDecRows, g.Tq - q0);
  // the training kernel's 64-row q tile holding these rows sets k_end
  const int k_end = g.causal ? min(g.Tk, q0 / kTile * kTile + kTile) : g.Tk;
  const int steps = (k_end + kTile - 1) / kTile;
  auto load = [&](int step) {
    stage_kv<kDecThreads, kHD>(dec_smem + step % kDecStages * 2 * kHT,
                               kflags[step % kDecStages], k, v, kmask, g, hd,
                               b, h, step * kTile);
  };
  for (int idx = t; idx < kDecRows * kHD / 4; idx += kDecThreads) {
    const int r = idx / (kHD / 4), d = idx % (kHD / 4) * 4;
    const bool ok = r < rows && d < hd;
    simulst::stage4(
        &qs[r][d],
        q + (ok ? ((size_t)b * g.Tq + q0 + r) * D + h * hd + d : 0), ok);
  }
  // q arrives with tile 0
#pragma unroll
  for (int step = 0; step < kDecStages - 1; ++step) {
    if (step < steps) load(step);
    simulst::async_commit();
  }

  float m_run[kDecRows], l_run[kDecRows], acc[kDecRows][kCB],
      alpha[kDecRows];
  float s[kDecRows];
#pragma unroll
  for (int r = 0; r < kDecRows; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) acc[r][cb] = 0.f;
  }
  for (int step = 0; step < steps; ++step) {
    simulst::async_wait<kDecStages - 2>();
    __syncthreads();   // tile step is in; step - 1's stage, pr, ps are free
    if (step + kDecStages - 1 < steps) load(step + kDecStages - 1);
    simulst::async_commit();
    const int k0 = step * kTile;
    const float* ks = dec_smem + step % kDecStages * 2 * kHT;
    const float* vs = ks + kHT;
    const int* flags = kflags[step % kDecStages];
    // s of key column t for each row (rows is uniform over the block)
#pragma unroll
    for (int r = 0; r < kDecRows; ++r) s[r] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kHD; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + t * kKLd + d);
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) {
        if (r >= rows) break;
        const float4 qv = *reinterpret_cast<const float4*>(&qs[r][d]);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kDecRows; ++r) {
      if (r >= rows) break;
      s[r] = visible(g, flags, q0 + r, k0 + t, t) ? s[r] * g.scale : -INFINITY;
      const float mx = simulst::warp_max(s[r]);
      if (lane == 0) warp_mx[r][warp] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kDecRows; ++r) {
      if (r >= rows) break;
      const int qr = q0 + r;
      const float m_new = fmaxf(m_run[r], fmaxf(warp_mx[r][0], warp_mx[r][1]));
      alpha[r] = m_new == -INFINITY ? 1.f : expf(m_run[r] - m_new);
      const float p = s[r] == -INFINITY ? 0.f : expf(s[r] - m_new);
      const float pd =
          p == 0.f ? 0.f : p * drop.scale(prob_offset(g, b, h, qr, k0 + t), 0);
      pr[r][t] = p;
      ps[r][t] = round_to<T>(pd);
      m_run[r] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kDecRows; ++r) {
      if (r >= rows) break;
      // lane t % 16 of each half-warp: columns t % 16 + 16 j, then the
      // butterfly (every half-warp forms the same tree)
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) psum += pr[r][t % 16 + 16 * j];
      l_run[r] = l_run[r] * alpha[r] + row_sum(psum);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb) {
        const float* vc = vs + 64 * cb + t;   // out dim 64 cb + t
        float a = acc[r][cb] * alpha[r];
#pragma unroll 2
        for (int c = 0; c < kTile; c += 4) {
          const float4 pv = *reinterpret_cast<const float4*>(&ps[r][c]);
          a = fmaf(pv.x, vc[(c + 0) * kKLd], a);
          a = fmaf(pv.y, vc[(c + 1) * kKLd], a);
          a = fmaf(pv.z, vc[(c + 2) * kKLd], a);
          a = fmaf(pv.w, vc[(c + 3) * kKLd], a);
        }
        acc[r][cb] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kDecRows; ++r) {
    if (r >= rows) break;
    const int qr = q0 + r;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
      if (64 * cb + t < hd)
        out[((size_t)b * g.Tq + qr) * D + h * hd + 64 * cb + t] =
            from_f32<T>(acc[r][cb] * inv);
    if (t == 0)
      lse[((size_t)b * g.H + h) * g.Tq + qr] =
          l_run[r] > 0.f ? m_run[r] + logf(l_run[r]) : INFINITY;
  }
}

// dynamic shared memory of each kernel, in bytes
template <int kHD>
constexpr size_t fwd_smem() {
  return (5 * (size_t)head_tile<kHD>() + kProbTile) * sizeof(float);
}
template <int kHD>
constexpr size_t dec_smem() {
  return 2 * kDecStages * (size_t)head_tile<kHD>() * sizeof(float);
}
template <int kHD>
constexpr size_t dkdv_smem() {
  return (4 * (size_t)head_tile<kHD>() + 2 * kProbTile) * sizeof(float);
}
template <int kHD>
constexpr size_t dq_smem() {
  return 2 * ((size_t)head_tile<kHD>() + kProbTile) * sizeof(float);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// hd_real: the head dim of a call zero-padded to hd, whose 1 / sqrt scales
// the scores
Geometry make_geometry(int Tq, int Tk, int H, int hd, int hd_real,
                       int causal) {
  return Geometry{Tq, Tk, H, causal, hd, 1.0f / sqrtf((float)hd_real)};
}

Dropout make_dropout(int on, unsigned long long seed, unsigned threshold,
                     float inv_keep) {
  return Dropout{seed, threshold, inv_keep, on};
}

// the forward's kernels (ops/mha.py FWD_PATHS)
constexpr int kPathDecode = 0;
constexpr int kPathTiles = 1;

template <typename T, int kHD, bool kPad>
int launch_decode(const T* q, const T* k, const T* v, const int* kmask,
                  T* out, float* lse, int B, const Geometry& g, Dropout drop,
                  cudaStream_t s) {
  SIMULST_TRY(allow_smem(mha_decode_kernel<T, kHD, kPad>, dec_smem<kHD>()));
  mha_decode_kernel<T, kHD, kPad>
      <<<dim3(simulst::ceil_div(g.Tq, kDecRows), g.H, B), kDecThreads,
         dec_smem<kHD>(), s>>>(q, k, v, kmask, out, lse, g, drop);
  return (int)cudaGetLastError();
}

template <typename T, int kHD, bool kPad>
int launch_tiles(const T* q, const T* k, const T* v, const int* kmask,
                 T* out, float* lse, int B, const Geometry& g, Dropout drop,
                 cudaStream_t s) {
  SIMULST_TRY(allow_smem(mha_fwd_kernel<T, kHD, kPad>, fwd_smem<kHD>()));
  mha_fwd_kernel<T, kHD, kPad>
      <<<dim3(g.H, B, simulst::ceil_div(g.Tq, kTile)), kFwdThreads,
         fwd_smem<kHD>(), s>>>(q, k, v, kmask, out, lse, g, drop);
  return (int)cudaGetLastError();
}

template <typename T, int kHD, bool kPad>
int launch_fwd(const void* q_, const void* k_, const void* v_,
               const int* kmask, void* out_, float* lse, int B, int Tq, int Tk,
               int H, int hd, int hd_real, int causal, int path, Dropout drop,
               cudaStream_t s) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  T* out = static_cast<T*>(out_);
  const Geometry g = make_geometry(Tq, Tk, H, hd, hd_real, causal);
  switch (path) {
    case kPathDecode:
      return launch_decode<T, kHD, kPad>(q, k, v, kmask, out, lse, B, g, drop, s);
    case kPathTiles:
      return launch_tiles<T, kHD, kPad>(q, k, v, kmask, out, lse, B, g, drop, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int kHD, bool kPad>
int launch_bwd(const void* q, const void* k, const void* v, const int* kmask,
               const void* out, const float* lse, const void* dout, void* dq,
               void* dk, void* dv, float* delta, float* ds, int B, int Tq,
               int Tk, int H, int hd, int hd_real, int causal, Dropout drop,
               cudaStream_t s) {
  const Geometry g = make_geometry(Tq, Tk, H, hd, hd_real, causal);
  const int rows = B * H * Tq;
  const int tk64 = simulst::ceil_div(Tk, kTile) * kTile;
  mha_bwd_delta_kernel<T, kHD, kPad><<<simulst::ceil_div(rows, 8), 256, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, g, rows);
  SIMULST_TRY(cudaGetLastError());
  SIMULST_TRY(allow_smem(mha_bwd_dkdv_kernel<T, kHD, kPad>, dkdv_smem<kHD>()));
  SIMULST_TRY(allow_smem(mha_bwd_dq_kernel<T, kHD, kPad>, dq_smem<kHD>()));
  mha_bwd_dkdv_kernel<T, kHD, kPad>
      <<<dim3(simulst::ceil_div(Tk, kTile), H, B), 2 * kGroup,
         dkdv_smem<kHD>(), s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), kmask, lse, delta,
          static_cast<const T*>(dout), static_cast<T*>(dk),
          static_cast<T*>(dv), ds, tk64, g, drop);
  SIMULST_TRY(cudaGetLastError());
  mha_bwd_dq_kernel<T, kHD, kPad>
      <<<dim3(simulst::ceil_div(Tq, kTile), H, B), kGroup, dq_smem<kHD>(),
         s>>>(static_cast<const T*>(k), ds, static_cast<T*>(dq), tk64, g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// head dims above kMaxHD: the wide kernels
// ---------------------------------------------------------------------------
constexpr int kWideThreads = 128;

// the block's max / sum of v (every thread gets it); red: kWideThreads / 32
// floats of shared memory
__device__ __forceinline__ float block_max(float v, float* red) {
  v = simulst::warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWideThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = simulst::warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWideThreads / 32; ++w) m += red[w];
  return m;
}

// x . y over hd features, x fp32 in shared memory, y a row of T
template <typename T>
__device__ __forceinline__ float row_dot(const float* x, const T* y, int hd) {
  float s = 0.f;
  for (int d = 0; d < hd; ++d) s = fmaf(x[d], to_f32(y[d]), s);
  return s;
}

// q . k_key * scale for query row qr of head h, batch b, -inf where the
// pair is not visible (or key >= Tk)
template <typename T>
__device__ __forceinline__ float wide_score(const Geometry& g,
                                            const float* qs, const T* k,
                                            const int* kmask, int b, int h,
                                            int qr, int key) {
  if (key >= g.Tk || kmask[(size_t)b * g.Tk + key] == 0 ||
      (g.causal && key > qr))
    return -INFINITY;
  return row_dot(qs, k + ((size_t)b * g.Tk + key) * (g.H * g.hd) + h * g.hd,
                 g.hd) *
         g.scale;
}

// acc[d] += sum over the tile's n keys j ascending of w[j] rows[key0 + j][d]
// for the features d of this thread (t, t + kWideThreads, ...)
template <typename T>
__device__ __forceinline__ void wide_accumulate(float* acc, const float* w,
                                                int n, const T* rows,
                                                size_t row_stride, int hd) {
  for (int j = 0; j < n; ++j) {
    const float wj = w[j];
    if (wj == 0.f) continue;
    const T* r = rows + j * row_stride;
    for (int d = threadIdx.x; d < hd; d += kWideThreads)
      acc[d] = fmaf(wj, to_f32(r[d]), acc[d]);
  }
}

// grid (Tq, H, B): out = sum_k round_T(p_k mult) v_k with p the softmax
// of the scores (max, then sum, then the output: three passes over the
// keys), lse = max + log(sum); zeros and lse +inf for a row that sees no
// key.  Shared memory: q row, the output row, one tile of weights.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    mha_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kmask,
                        T* __restrict__ out, float* __restrict__ lse,
                        Geometry g, Dropout drop) {
  extern __shared__ __align__(16) float wide_smem[];
  __shared__ float red[kWideThreads / 32];
  float* qs = wide_smem;
  float* acc = qs + g.hd;
  float* ws = acc + g.hd;
  const int qr = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int hd = g.hd, D = g.H * hd;
  const size_t row = ((size_t)b * g.Tq + qr) * D + h * hd;
  for (int d = t; d < hd; d += kWideThreads) {
    qs[d] = to_f32(q[row + d]);
    acc[d] = 0.f;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int k0 = 0; k0 < g.Tk; k0 += kWideThreads)
    m = fmaxf(m, wide_score(g, qs, k, kmask, b, h, qr, k0 + t));
  m = block_max(m, red);
  float l = 0.f;
  if (m != -INFINITY)
    for (int k0 = 0; k0 < g.Tk; k0 += kWideThreads) {
      const float s = wide_score(g, qs, k, kmask, b, h, qr, k0 + t);
      if (s != -INFINITY) l += expf(s - m);
    }
  l = block_sum(l, red);
  if (m != -INFINITY)
    for (int k0 = 0; k0 < g.Tk; k0 += kWideThreads) {
      const int key = k0 + t;
      const float s = wide_score(g, qs, k, kmask, b, h, qr, key);
      float p = 0.f;
      if (s != -INFINITY)
        p = round_to<T>(expf(s - m) / l *
                        drop.scale(prob_offset(g, b, h, qr, key), 0));
      __syncthreads();   // the previous tile's weights are read
      ws[t] = p;
      __syncthreads();
      wide_accumulate(acc, ws, min(kWideThreads, g.Tk - k0),
                      v + ((size_t)b * g.Tk + k0) * D + h * hd, D, hd);
    }
  for (int d = t; d < hd; d += kWideThreads) out[row + d] = from_f32<T>(acc[d]);
  if (t == 0)
    lse[((size_t)b * g.H + h) * g.Tq + qr] =
        m == -INFINITY ? INFINITY : m + logf(l);
}

// delta[(b H + h) Tq + q] = sum_d dout . out, one warp a row
template <typename T>
__global__ void __launch_bounds__(256)
    mha_bwd_delta_wide_kernel(const T* __restrict__ out,
                              const T* __restrict__ dout,
                              float* __restrict__ delta, Geometry g,
                              int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int qr = row % g.Tq, bh = row / g.Tq;
  const int h = bh % g.H, b = bh / g.H;
  const size_t base = ((size_t)b * g.Tq + qr) * (g.H * g.hd) + h * g.hd;
  float s = 0.f;
  for (int c = lane; c < g.hd; c += 32)
    s += to_f32(dout[base + c]) * to_f32(out[base + c]);
  s = simulst::warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// grid (Tq, H, B): per key, p = exp(s - lse), pd = round_T(p mult) and
// dS = round_T(p (dO . v mult - delta) scale) into the scratch rows of
// this query row (row stride tk64), and dQ = sum_k dS_k k_k
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    mha_bwd_rows_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const int* __restrict__ kmask,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const T* __restrict__ dout, T* __restrict__ dq,
                             float* __restrict__ ds, float* __restrict__ pd,
                             int tk64, Geometry g, Dropout drop) {
  extern __shared__ __align__(16) float wide_smem[];
  float* qs = wide_smem;
  float* dos = qs + g.hd;
  float* acc = dos + g.hd;
  float* ws = acc + g.hd;
  const int qr = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int hd = g.hd, D = g.H * hd;
  const size_t row = ((size_t)b * g.Tq + qr) * D + h * hd;
  const size_t head_row = ((size_t)b * g.H + h) * g.Tq + qr;
  for (int d = t; d < hd; d += kWideThreads) {
    qs[d] = to_f32(q[row + d]);
    dos[d] = to_f32(dout[row + d]);
    acc[d] = 0.f;
  }
  __syncthreads();
  const float row_lse = lse[head_row], row_delta = delta[head_row];
  for (int k0 = 0; k0 < g.Tk; k0 += kWideThreads) {
    const int key = k0 + t;
    const float s = wide_score(g, qs, k, kmask, b, h, qr, key);
    float p_d = 0.f, d_s = 0.f;
    if (s != -INFINITY) {
      const float p = expf(s - row_lse);
      const float mult = drop.scale(prob_offset(g, b, h, qr, key), 0);
      const float dp =
          row_dot(dos, v + ((size_t)b * g.Tk + key) * D + h * hd, hd);
      p_d = round_to<T>(p * mult);
      d_s = round_to<T>(p * (dp * mult - row_delta) * g.scale);
    }
    if (key < g.Tk) {
      ds[head_row * tk64 + key] = d_s;
      pd[head_row * tk64 + key] = p_d;
    }
    __syncthreads();
    ws[t] = d_s;
    __syncthreads();
    wide_accumulate(acc, ws, min(kWideThreads, g.Tk - k0),
                    k + ((size_t)b * g.Tk + k0) * D + h * hd, D, hd);
  }
  for (int d = t; d < hd; d += kWideThreads) dq[row + d] = from_f32<T>(acc[d]);
}

// grid (Tk, H, B): dK_k = sum_q dS[q][k] q_q and dV_k = sum_q pd[q][k]
// dO_q over the query rows ascending (under the causal rule from row k)
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    mha_bwd_keys_wide_kernel(const T* __restrict__ q,
                             const T* __restrict__ dout,
                             const float* __restrict__ ds,
                             const float* __restrict__ pd,
                             T* __restrict__ dk, T* __restrict__ dv,
                             int tk64, Geometry g) {
  extern __shared__ __align__(16) float wide_smem[];
  float* dka = wide_smem;
  float* dva = dka + g.hd;
  float* w = dva + g.hd;   // [2][kWideThreads]: dS, then pd
  const int key = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int hd = g.hd, D = g.H * hd;
  for (int d = t; d < hd; d += kWideThreads) dka[d] = dva[d] = 0.f;
  const size_t head = ((size_t)b * g.H + h) * g.Tq;
  const int q_begin = g.causal ? key : 0;
  for (int q0 = q_begin; q0 < g.Tq; q0 += kWideThreads) {
    const int qr = q0 + t;
    __syncthreads();
    w[t] = qr < g.Tq ? ds[(head + qr) * tk64 + key] : 0.f;
    w[kWideThreads + t] = qr < g.Tq ? pd[(head + qr) * tk64 + key] : 0.f;
    __syncthreads();
    const int n = min(kWideThreads, g.Tq - q0);
    const size_t r0 = ((size_t)b * g.Tq + q0) * D + h * hd;
    wide_accumulate(dka, w, n, q + r0, D, hd);
    wide_accumulate(dva, w + kWideThreads, n, dout + r0, D, hd);
  }
  const size_t row = ((size_t)b * g.Tk + key) * D + h * hd;
  for (int d = t; d < hd; d += kWideThreads) {
    dk[row + d] = from_f32<T>(dka[d]);
    dv[row + d] = from_f32<T>(dva[d]);
  }
}

template <typename T>
int launch_fwd_wide(const void* q, const void* k, const void* v,
                    const int* kmask, void* out, float* lse, int B,
                    const Geometry& g, Dropout drop, cudaStream_t s) {
  const size_t smem = (2 * (size_t)g.hd + kWideThreads) * sizeof(float);
  SIMULST_TRY(allow_smem(mha_fwd_wide_kernel<T>, smem));
  mha_fwd_wide_kernel<T><<<dim3(g.Tq, g.H, B), kWideThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kmask, static_cast<T*>(out), lse, g, drop);
  return (int)cudaGetLastError();
}

// ds: the scratch of the tiled backward twice over, dS then pd
template <typename T>
int launch_bwd_wide(const void* q, const void* k, const void* v,
                    const int* kmask, const void* out, const float* lse,
                    const void* dout, void* dq, void* dk, void* dv,
                    float* delta, float* ds, int B, const Geometry& g,
                    Dropout drop, cudaStream_t s) {
  const int rows = B * g.H * g.Tq;
  const int tk64 = simulst::ceil_div(g.Tk, kTile) * kTile;
  float* pd = ds + (size_t)rows * tk64;
  mha_bwd_delta_wide_kernel<T><<<simulst::ceil_div(rows, 8), 256, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, g,
      rows);
  SIMULST_TRY(cudaGetLastError());
  const size_t rows_smem = (3 * (size_t)g.hd + kWideThreads) * sizeof(float);
  SIMULST_TRY(allow_smem(mha_bwd_rows_wide_kernel<T>, rows_smem));
  mha_bwd_rows_wide_kernel<T>
      <<<dim3(g.Tq, g.H, B), kWideThreads, rows_smem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), kmask, lse, delta,
          static_cast<const T*>(dout), static_cast<T*>(dq), ds, pd, tk64, g,
          drop);
  SIMULST_TRY(cudaGetLastError());
  const size_t keys_smem =
      (2 * (size_t)g.hd + 2 * kWideThreads) * sizeof(float);
  SIMULST_TRY(allow_smem(mha_bwd_keys_wide_kernel<T>, keys_smem));
  mha_bwd_keys_wide_kernel<T>
      <<<dim3(g.Tk, g.H, B), kWideThreads, keys_smem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(dout), ds, pd,
          static_cast<T*>(dk), static_cast<T*>(dv), tk64, g);
  return (int)cudaGetLastError();
}

// the head dim of D over `heads`, 0 unless a positive multiple of kHDStep
int head_dim(int D, int heads) {
  if (heads <= 0 || D % heads != 0) return 0;
  const int hd = D / heads;
  return hd % kHDStep == 0 ? hd : 0;
}

// runs the statement with kH bound to the staged head dim of hd and kP to
// whether it pads the head: (64, false) at hd 64, (64, true) below, (128,
// true) above
#define MHA_HD_DISPATCH(hd, ...)                                  \
  do {                                                            \
    if ((hd) == 64) {                                             \
      constexpr int kH = 64;                                      \
      constexpr bool kP = false;                                  \
      __VA_ARGS__;                                                \
    } else if ((hd) < 64) {                                       \
      constexpr int kH = 64;                                      \
      constexpr bool kP = true;                                   \
      __VA_ARGS__;                                                \
    } else {                                                      \
      constexpr int kH = 128;                                     \
      constexpr bool kP = true;                                   \
      __VA_ARGS__;                                                \
    }                                                             \
  } while (0)

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// the real head dim of a call padded to hd: at most hd, less than one step
// below it
bool hd_real_ok(int hd, int hd_real) {
  return hd_real <= hd && hd_real > hd - kHDStep && hd_real > 0;
}

}  // namespace

// q: (B, Tq, D); k, v: (B, Tk, D), all of `dtype`, D = heads * hd with hd
// a multiple of 8 (above 128 the wide kernel, whatever the path), each
// starting on a 16-byte boundary; hd_real
// the head dim of a call zero-padded to hd (hd itself when nothing is
// padded; less than 8 below it), whose 1 / sqrt scales the scores; kmask:
// (B, Tk) int32; out: (B, Tq, D);
// lse: (B, heads, Tq) fp32.  Dropout on the probabilities when dropout !=
// 0.  path: the decode kernel (0) or the training kernel (1), as
// ops/mha.py:fwd_plan picks; both give the same bits.  Returns a
// cudaError_t.
extern "C" int simulst_mha_fwd(int dtype, const void* q, const void* k,
                               const void* v, const void* kmask, void* out,
                               void* lse, int B, int Tq, int Tk, int D,
                               int heads, int hd_real, int causal, int path,
                               int dropout, unsigned long long seed,
                               unsigned threshold, float inv_keep,
                               void* stream) {
  const int hd = head_dim(D, heads);
  if (hd == 0 || !hd_real_ok(hd, hd_real) || B <= 0 || Tq <= 0 || Tk <= 0 ||
      !aligned16(q) ||
      !aligned16(k) || !aligned16(v))
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(dropout, seed, threshold, inv_keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd > kMaxHD) {
    const Geometry g = make_geometry(Tq, Tk, heads, hd, hd_real, causal);
    SIMULST_DISPATCH(dtype, return launch_fwd_wide<scalar_t>(
                                q, k, v, static_cast<const int*>(kmask), out,
                                static_cast<float*>(lse), B, g, drop, s));
  }
  MHA_HD_DISPATCH(hd, SIMULST_DISPATCH(dtype, return launch_fwd<scalar_t, kH, kP>(
                              q, k, v, static_cast<const int*>(kmask), out,
                              static_cast<float*>(lse), B, Tq, Tk, heads, hd,
                              hd_real, causal, path, drop, s)));
}

// The backward of simulst_mha_fwd: dq (B, Tq, D), dk and dv (B, Tk, D) from
// the forward's inputs, its out and lse, and dout (B, Tq, D).  Scratch,
// fp32: delta (B, heads, Tq) and ds (B, heads, Tq, Tk rounded up to 64),
// twice that above head dim 128 (the wide kernels' dS and probabilities).
// q, k, v, dout, dq, dk and dv start on a 16-byte boundary; hd_real as the
// forward's.  Returns a cudaError_t.
extern "C" int simulst_mha_bwd(int dtype, const void* q, const void* k,
                               const void* v, const void* kmask,
                               const void* out, const void* lse,
                               const void* dout, void* dq, void* dk, void* dv,
                               void* delta, void* ds, int B, int Tq, int Tk,
                               int D, int heads, int hd_real, int causal,
                               int dropout, unsigned long long seed,
                               unsigned threshold, float inv_keep,
                               void* stream) {
  const int hd = head_dim(D, heads);
  if (hd == 0 || !hd_real_ok(hd, hd_real) || B <= 0 || Tq <= 0 || Tk <= 0 ||
      !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv) || !aligned16(ds))
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(dropout, seed, threshold, inv_keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd > kMaxHD) {
    const Geometry g = make_geometry(Tq, Tk, heads, hd, hd_real, causal);
    SIMULST_DISPATCH(dtype, return launch_bwd_wide<scalar_t>(
                                q, k, v, static_cast<const int*>(kmask), out,
                                static_cast<const float*>(lse), dout, dq, dk,
                                dv, static_cast<float*>(delta),
                                static_cast<float*>(ds), B, g, drop, s));
  }
  MHA_HD_DISPATCH(hd, SIMULST_DISPATCH(dtype, return launch_bwd<scalar_t, kH, kP>(
                              q, k, v, static_cast<const int*>(kmask), out,
                              static_cast<const float*>(lse), dout, dq, dk,
                              dv, static_cast<float*>(delta),
                              static_cast<float*>(ds), B, Tq, Tk, heads, hd,
                              hd_real, causal, drop, s)));
}
