// Grouped-segment Emformer attention core (pre out_proj) for Hopper,
// forward and backward.
//
// Replaces the Pallas kernel simulst_tpu/ops/emformer_attn_pallas.py
// `emformer_grouped_attention` (_fwd_kernel and _bwd_kernel), with its
// attention dropout and its sequence-packing example-id gate.  Keys and
// values are the projected rows of [mems (n-1) | rc blocks (n*rc) |
// utterance (U)]; queries are (B, ng, nq, D) with rows [G rc blocks | G
// segments | G summaries] per group of G segments.  Row visibility follows
// nn/emformer.py _group_gather_indices and the length rule: a query of
// segment i sees at most max_mem memory slots (summary rows none), its own
// rc block, and lc + seg utterance frames below the example's length.
// With the gate (sequence-packed rows, the has_eid branches of the TPU
// kernels) it also sees a key only where the key row's example id equals
// its segment's: kid[b, key row] == seg_eid[b, segment].  The TPU kernel
// read a dense (B, ng, nq, ctx) int8 mask and added (eid - 1) * 1e9 to the
// scores (a Mosaic workaround); here the two small id vectors are read
// directly and the rule is one more boolean term of `unit_columns`, compiled
// out of the ungated instantiation, so the dense path runs the same code
// as without a gate.  A row that sees no key outputs exact zeros, as the
// JAX softmax does.
// Dropout on the probabilities draws Philox bits keyed by (seed, element
// offset ((((b ng + g) heads + h) nq + row) ctx + col)), stream 0, in the
// gathered-context layout, so the backward regenerates the forward's mask.
//
// What bounds it on the H100: a segment's query rows see few of the
// group's context slots.  At s2t_emformer_s's geometry (seg 16, lc 32,
// rc 8, max_mem 5, G 8) the group context has 236 slots but the 25 rows
// of a segment (8 rc, 16 frames, 1 summary) see at most 61 of them:
// max_mem memory slots, the segment's own rc block and lc + seg utterance
// frames, about a quarter of the (row, slot) pairs.  The work on those
// pairs is small (about 0.7 GFLOP forward at the train shape, 10 us at the
// fp32 CUDA-core peak), so the cost is what surrounds it: masked pairs,
// shared-memory loads per FMA and how many blocks an SM holds.
//
// So the work unit is one segment of one (batch, group, head): its rows
// are three runs of the group's query rows (rc rows [i rc, (i+1) rc),
// frame rows [G rc + i seg, +seg), summary row G (rc+seg) + i) and its
// columns three runs of the group context (memory [i, i+max_mem), rc
// [m_slots + i rc, +rc), utterance [m_slots + G rc + i seg, +lc+seg)).
// Only those K and V rows are staged into shared memory, by 16-byte
// cp.async copies in fp32 (zero-filled for slots outside the sequence).
// Products are register-blocked on the CUDA cores in fp32, as csrc/mha.cu:
// each thread holds a micro-tile of a 32-row x 64-column tile and reads
// operands as float4 from rows padded to 68 floats (16-byte aligned, and
// eight neighbouring rows fall in eight distinct bank quads), so every
// shared load feeds several FMAs.  Dropout keeps the global gathered-
// context offset above (the group-context slot, never the unit's column).
//
// Sums run in the order of a computation over the whole group context,
// whatever the tiling: the softmax's row sums and Delta lane-strided over
// the context slots (lane l adds slots l, l + 32, ... in order, then the
// shuffle tree; `for_lane_slots`), each product over a row's columns or a
// column's rows in ascending order, as a sequential fp32 product does.  So
// the results do not depend on how the context is cut into units, and the
// kernels give the same bits as one warp per query row over the gathered
// context would.
//
// Forward: one block of 128 threads per unit (B ng heads G blocks, 53 KB
// of shared memory at the geometry above, four blocks per SM): scores into
// shared memory, the row softmax by one warp per row (max and sum by
// shuffles), the probabilities dropped and rounded to the activation
// dtype, then P . V.
//
// Backward: one block of 256 threads per (batch, group, head).  A first
// walk over its G segments recomputes each segment's probabilities once
// over the segment's columns, forms dp = (dO . v) m, Delta = sum(dp p) and
// ds = p (dp - Delta) / sqrt(64) and writes the segment's dq rows (each
// query row belongs to one segment).  dK = ds^T Q and dV = round(p m)^T dO
// add each slot's rows in the group's row order (rc rows, frame rows, then
// summary rows, each by segment), which interleaves the segments, so the
// first walk keeps each unit's ds and round(p m) in an fp32 scratch (26 MB
// at the train shape) and three more walks add them, in that order, into
// fp32 accumulators of the group's whole context in shared memory (121 KB
// at the geometry above, 200 KB per block, one block per SM; neighbouring
// segments share memory slots and lc frames, and the block owns them, so
// nothing races).  At the end the block writes the group's (B, ng, ctx,
// dim) fp32 partials, and the ordered sum kernel adds the groups' partials
// into key rows (groups overlap by lc frames and share memory slots), in
// group order, without atomics.  This backward runs fp32, head dims above
// 128, and the bf16 shapes that ops/emformer_attn.py `bwd_plan` does not
// send to the tensor cores: the bf16 backward up to head dim 128 is
// csrc/emformer_attn_bwd.cu's (mma.sync, no probs scratch), which shares
// this file's unit maps through emformer_attn.cuh.
//
// What bounds them is latency, not bytes or operations: per block at the
// train shape (tools/attn_phase_profile.py), the forward spends about half
// of its cycles in the row softmax and a quarter staging; the backward,
// one block of 8 warps per SM, about a third in the row softmax and ds, a
// fifth in the three dK / dV walks, and the rest in the scores, staging
// and dq.  A warp takes kRowTile / warps rows at once so that their chains
// of shuffles, exp and Philox overlap.
//
// Head dims: any multiple of 8.  Up to 128 the kernels are templates on
// the staged head dim kHeadDim, 64 or 128 (the next at or above hd): rows
// are staged kHeadDim wide with the features past hd zero-filled, so every
// score adds exact zeros past hd, and only the hd real features of an
// output are stored; products along the features run in blocks of 64.
// The backward's dK / dV accumulators hold F features of every context
// slot, F the largest of 64 (the walks' thread map: 16 threads of 4
// features), 32 and 16 with which the block fits the card's shared memory;
// the three walks run once per block of F features.  Each output's sum is
// the same whatever F.  Any other head dim reaches the kernels zero-padded
// to the next multiple of 8 (ops/emformer_attn.py), with the real head dim
// beside it for the scale 1 / sqrt(hd_real): the padded features add exact
// zeros to every score, and their outputs (zero) are sliced away.  Above
// 128 (a 256-wide staged unit would not fit the backward's block at
// s2t_emformer_s's geometry) the "wide" kernels run, correct rather than
// fast: the same units, with only the unit's (row, column) matrices in
// shared memory and the rows read from device memory (each score one
// thread's dot product over hd); the backward writes dq per unit and the
// unit's ds and round(p m) to `probs` as the tiled backward does, then one
// block per (batch, group, head) sums dK and dV of every context slot into
// the same partials, and the ordered sum kernel adds them into key rows.
#include <math.h>

#include "emformer_attn.cuh"

namespace {

constexpr int kFwdThreads = 128;   // 8 x 16, a 4 x 4 micro-tile each
constexpr int kBwdThreads = 256;   // 16 x 16, 2 x 4 (scores) or 4 x 4

// Shared memory of a forward block: Q, K, V, the scores, and three ints
// per column.  ops/emformer_attn.py `unit_shape` computes the same bytes.
size_t fwd_smem_bytes(const Geom& g) {
  const size_t ld = staged_ld(g.shd);
  return sizeof(float) * ((size_t)g.Rp * ld + 2 * (size_t)g.Cp * ld +
                          (size_t)g.Rp * g.sld) +
         3 * sizeof(int) * (size_t)g.Cp;
}

// f(j) for the columns j of segment i's unit whose group-context slot is
// lane mod 32, in ascending slot order (the unit's columns are three runs
// of consecutive slots): a lane's share of a row sum taken in the order of
// a warp reducing the whole group context lane-strided, so that row sums
// do not depend on how the context is cut into units.
template <class F>
__device__ __forceinline__ void for_lane_slots(const Geom& g, int i, int lane,
                                               F f) {
  const int col0[3] = {0, g.max_mem, g.max_mem + g.rc};
  const int slot0[3] = {i, g.m_slots + i * g.rc,
                        g.m_slots + g.G * g.rc + i * g.seg};
  const int len[3] = {g.max_mem, g.rc, g.lc + g.seg};
#pragma unroll
  for (int k = 0; k < 3; ++k)
    for (int d = (lane - slot0[k]) & 31; d < len[k]; d += 32) f(col0[k] + d);
}

template <int K>
__device__ __forceinline__ void warp_max_k(float (&v)[K]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
}

template <int K>
__device__ __forceinline__ void warp_sum_k(float (&v)[K]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
}

// The softmax's max and sum of K rows of a unit at once, so that their
// latency chains overlap (a warp owns the rows; src[k] null: no row):
// mx[k] the row max (-inf: the row sees no key), dst[k][j] =
// exp(src[k][j] - mx[k]) for j < C (0 off the mask), and sum[k] their sum
// in the slot order of for_lane_slots.  Each row's arithmetic is that of
// one row alone.
template <int K>
__device__ __forceinline__ void exp_rows(const Geom& g, int i, int lane,
                                         float* const (&src)[K],
                                         float* const (&dst)[K],
                                         float (&mx)[K], float (&sum)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    mx[k] = -INFINITY;
    if (src[k])
      for (int j = lane; j < g.Cp; j += 32) mx[k] = fmaxf(mx[k], src[k][j]);
  }
  warp_max_k(mx);
  for (int j = lane; j < g.C; j += 32)
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (src[k] && mx[k] != -INFINITY) dst[k][j] = expf(src[k][j] - mx[k]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k) sum[k] = 0.f;
  for_lane_slots(g, i, lane, [&](int j) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (src[k] && mx[k] != -INFINITY) sum[k] += dst[k][j];
  });
  warp_sum_k(sum);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// Stage n rows of one head's kHeadDim features into dst (row stride
// staged_ld): row r from src + off(r), zeros where off(r) < 0 and in the
// features from hd on.  fp32 rows go by 16-byte cp.async (zero-filled
// through its source size), bf16 rows by 16-byte loads widened to fp32.
// stage_wait() completes them.
template <int kHeadDim, typename T, class Off>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const T* __restrict__ src, int n,
                                           int hd, Off off) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kHeadDim / kVec;
  constexpr int kLd = staged_ld(kHeadDim);
  for (int idx = threadIdx.x; idx < n * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const long long o = ch * kVec < hd ? off(r) : -1;
    float* d = dst + r * kLd + ch * kVec;
    if constexpr (sizeof(T) == sizeof(float)) {
      cp_async16(d, o >= 0 ? src + o + ch * kVec : src, o >= 0);
    } else {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (o >= 0)
        raw = __ldg(reinterpret_cast<const uint4*>(src + o + ch * kVec));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]),
                   f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
      reinterpret_cast<float4*>(d)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      reinterpret_cast<float4*>(d)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  }
}

// n floats (a multiple of 4) from src to dst, by 16-byte cp.async
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int n) {
  for (int q = 4 * threadIdx.x; q < n; q += 4 * blockDim.x)
    cp_async16(dst + q, src + q, true);
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;\n" ::
                   : "memory");
  __syncthreads();
}

__device__ __forceinline__ const float4& at4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void store4(float* dst, const float4& v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float4& v) {
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(v.z, v.w);
}

// acc[a][c] = x row (xr + kStep a) . y row (yr + 16 c) over the kHeadDim
// staged features, for staged tiles x and y (row stride staged_ld)
template <int kA, int kStep, int kHeadDim>
__device__ __forceinline__ void tile_dots(const float* x, int xr,
                                          const float* y, int yr,
                                          float acc[kA][4]) {
  constexpr int kLd = staged_ld(kHeadDim);
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kHeadDim; d += 4) {
    float4 xa[kA], yc[4];
#pragma unroll
    for (int a = 0; a < kA; ++a) xa[a] = at4(x + (xr + kStep * a) * kLd + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) yc[c] = at4(y + (yr + 16 * c) * kLd + d);
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = dot4(xa[a], yc[c], acc[a][c]);
  }
}

// acc[a] += sum over columns j < jn of p[row (r + kStep a)][j] * y[j][4 f..]:
// rows of the probabilities (or ds; row stride sld) times a staged tile
// (row stride staged_ld)
template <int kA, int kStep, int kHeadDim>
__device__ __forceinline__ void tile_pv(const float* p, int sld, int r,
                                        const float* y, int f, int jn,
                                        float4 acc[kA]) {
  constexpr int kLd = staged_ld(kHeadDim);
#pragma unroll 2
  for (int j = 0; j < jn; j += 4) {
    float4 pa[kA], yc[4];
#pragma unroll
    for (int a = 0; a < kA; ++a) pa[a] = at4(p + (r + kStep * a) * sld + j);
#pragma unroll
    for (int t = 0; t < 4; ++t) yc[t] = at4(y + (j + t) * kLd + 4 * f);
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      fma4(acc[a], pa[a].x, yc[0]);
      fma4(acc[a], pa[a].y, yc[1]);
      fma4(acc[a], pa[a].z, yc[2]);
      fma4(acc[a], pa[a].w, yc[3]);
    }
  }
}

// one forward block per unit: blockIdx.x = ((b ng + grp) heads + head) G + i
template <typename T, bool kGated, int kHeadDim, bool kExact>
__global__ void __launch_bounds__(kFwdThreads)
    grouped_attn_kernel(const T* __restrict__ q3, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, Gate gate,
                        T* __restrict__ out, Geom g, Dropout drop) {
  constexpr int kLd = staged_ld(kHeadDim);
  const int hd = kExact ? kHeadDim : g.hd;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [Rp][kLd]
  float* ks = qs + g.Rp * kLd;                  // [Cp][kLd]
  float* vs = ks + g.Cp * kLd;                  // [Cp][kLd]
  float* ps = vs + g.Cp * kLd;                  // [Rp][sld] scores, probs
  int* col_slot = reinterpret_cast<int*>(ps + g.Rp * g.sld);  // [Cp]
  int* col_row = col_slot + g.Cp;                             // [Cp]
  int* col_ok = col_row + g.Cp;                               // [Cp]

  const int i = blockIdx.x % g.G;
  const int head = (blockIdx.x / g.G) % g.heads;
  const int grp = (blockIdx.x / (g.G * g.heads)) % g.ng;
  const int b = blockIdx.x / (g.G * g.heads * g.ng);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t q_base =
      ((size_t)b * g.ng + grp) * g.nq * g.dim + head * hd;
  const size_t kv_base = (size_t)b * g.tk * g.dim + head * hd;
  const size_t row_base =
      (((size_t)b * g.ng + grp) * g.heads + head) * g.nq;

  unit_columns<kGated>(g, gate, b, grp, i, lengths[b], col_slot, col_row,
                       col_ok);
  __syncthreads();
  const auto q_off = [&](int r) -> long long {
    return r < g.R ? (long long)(q_base + (size_t)unit_row(g, i, r) * g.dim)
                   : -1;
  };
  const auto kv_off = [&](int j) -> long long {
    return col_row[j] >= 0 ? (long long)(kv_base + (size_t)col_row[j] * g.dim)
                           : -1;
  };
  stage_rows<kHeadDim>(qs, q3, g.Rp, hd, q_off);
  stage_rows<kHeadDim>(ks, k, g.Cp, hd, kv_off);
  stage_rows<kHeadDim>(vs, v, g.Cp, hd, kv_off);
  stage_wait();

  const float scale = 1.0f / sqrtf((float)(kExact ? kHeadDim : g.hd_real));
  for (int r0 = 0; r0 < g.Rp; r0 += kRowTile)
    for (int c0 = 0; c0 < g.Cp; c0 += kColTile) {
      float s[4][4];
      tile_dots<4, 8, kHeadDim>(qs, r0 + ty, ks, c0 + tx, s);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = r0 + ty + 8 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = c0 + tx + 16 * c;
          ps[r * g.sld + j] =
              r >= g.R ? 0.f
              : unit_visible(g, col_ok, r, j) ? s[a][c] * scale
                                              : -INFINITY;
        }
      }
    }
  __syncthreads();

  // the row softmax, a warp on kFwdRows rows at once; dropped and rounded
  // to the activation dtype (a row that sees no key: zeros)
  const float keep_mult = drop.on ? drop.inv_keep : 1.f;
  constexpr int kWarps = kFwdThreads / 32, kFwdRows = kRowTile / kWarps;
  for (int rb = warp; rb < g.R; rb += kRowTile) {
    float* pr[kFwdRows];
#pragma unroll
    for (int k = 0; k < kFwdRows; ++k)
      pr[k] = rb + k * kWarps < g.R ? ps + (rb + k * kWarps) * g.sld : nullptr;
    float mx[kFwdRows], sum[kFwdRows], inv[kFwdRows];
    unsigned long long off[kFwdRows];
    exp_rows(g, i, lane, pr, pr, mx, sum);
#pragma unroll
    for (int k = 0; k < kFwdRows; ++k) {
      inv[k] = mx[k] != -INFINITY ? 1.0f / sum[k] : 0.f;
      off[k] = (unsigned long long)(row_base +
                                    unit_row(g, i, rb + k * kWarps)) *
               g.ctx;
    }
    for (int j = lane; j < g.Cp; j += 32)
#pragma unroll
      for (int k = 0; k < kFwdRows; ++k) {
        if (!pr[k]) continue;
        const float e = mx[k] != -INFINITY ? pr[k][j] : 0.f;
        pr[k][j] = e > 0.f && drop.scale(off[k] + col_slot[j], 0) != 0.f
                       ? round_to<T>(e * inv[k] * keep_mult)
                       : 0.f;
      }
  }
  __syncthreads();

  const int jn = (g.C + 3) & ~3;  // columns past C hold zeros
  for (int r0 = 0; r0 < g.Rp; r0 += kRowTile)
    for (int fb = 0; fb < hd; fb += 64) {   // features fb + 4 tx ..
      float4 o[4] = {};
      tile_pv<4, 8, kHeadDim>(ps, g.sld, r0 + ty, vs + fb, tx, jn, o);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = r0 + ty + 8 * a;
        if (r < g.R && fb + 4 * tx < hd)
          store4(out + q_off(r) + fb + 4 * tx, o[a]);
      }
    }
}

// One backward block per (batch, group, head).  A first walk over the G
// segments recomputes each segment's probabilities once, forms ds for dq
// and writes the segment's dq rows, and keeps ds and round(p m) for dK / dV
// in the block's slice of `probs` (G units of R x Cp each, two matrices).
// Three more walks add dK = ds^T Q and dV = round(p m)^T dO into the
// group's accumulators over the rc rows, then the frame rows, then the
// summary rows of the segments in order: the group's row order, so each
// slot's sum runs over the rows in the order of a product over all nq rows,
// whatever the tiling.  The accumulators end in the (B, ng, ctx, dim) fp32
// partials (zeros for slots no row sees).
//
// dq takes p = e / sum, and Delta = sum(dp p) over the columns with
// p > 0, dp = (dO . v) m; dK and dV take p = exp(s - lse) with
// lse = max + log(sum).  The two agree to rounding.
template <typename T, bool kGated, int kHeadDim, bool kExact>
__global__ void __launch_bounds__(kBwdThreads, 1)
    grouped_attn_bwd_kernel(const T* __restrict__ q3, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const int* __restrict__ lengths, Gate gate,
                            T* __restrict__ dq, float* __restrict__ probs,
                            float* __restrict__ dk_part,
                            float* __restrict__ dv_part, Geom g,
                            Dropout drop) {
  constexpr int kLd = staged_ld(kHeadDim);
  const int hd = kExact ? kHeadDim : g.hd;
  const int F = kExact ? kHeadDim : g.F;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [Rp][kLd]
  float* dos = qs + g.Rp * kLd;                 // [Rp][kLd]
  float* ks = dos + g.Rp * kLd;                 // [Cp][kLd]
  float* vs = ks + g.Cp * kLd;                  // [Cp][kLd]
  float* as = vs + g.Cp * kLd;                  // [Rp][sld] scores, ds (dq)
  float* ts = as + g.Rp * g.sld;                // [Rp][sld] dO . v, round(p m)
  float* xs = ts + g.Rp * g.sld;                // [Rp][sld] e, ds (dK)
  float* dk_acc = xs + g.Rp * g.sld;            // [ctx][F]
  float* dv_acc = dk_acc + g.ctx * F;         // [ctx][F]
  int* col_slot = reinterpret_cast<int*>(dv_acc + g.ctx * F);  // [Cp]
  int* col_row = col_slot + g.Cp;                                     // [Cp]
  int* col_ok = col_row + g.Cp;                                       // [Cp]

  const int head = blockIdx.x % g.heads;
  const int grp = (blockIdx.x / g.heads) % g.ng;
  const int b = blockIdx.x / (g.heads * g.ng);
  const int length = lengths[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t q_base =
      ((size_t)b * g.ng + grp) * g.nq * g.dim + head * hd;
  const size_t kv_base = (size_t)b * g.tk * g.dim + head * hd;
  const size_t row_base =
      (((size_t)b * g.ng + grp) * g.heads + head) * g.nq;
  const float scale = 1.0f / sqrtf((float)(kExact ? kHeadDim : g.hd_real));
  const float keep_mult = drop.on ? drop.inv_keep : 1.f;
  const int jn = (g.C + 3) & ~3;
  const size_t unit_probs = 2 * (size_t)g.R * g.Cp;  // round(p m), then ds
  probs += (size_t)blockIdx.x * g.G * unit_probs;

  for (int i = 0; i < g.G; ++i) {
    unit_columns<kGated>(g, gate, b, grp, i, length, col_slot, col_row,
                         col_ok);
    __syncthreads();
    const auto q_off = [&](int r) -> long long {
      return r < g.R
                 ? (long long)(q_base + (size_t)unit_row(g, i, r) * g.dim)
                 : -1;
    };
    const auto kv_off = [&](int j) -> long long {
      return col_row[j] >= 0
                 ? (long long)(kv_base + (size_t)col_row[j] * g.dim)
                 : -1;
    };
    stage_rows<kHeadDim>(qs, q3, g.Rp, hd, q_off);
    stage_rows<kHeadDim>(dos, dout, g.Rp, hd, q_off);
    stage_rows<kHeadDim>(ks, k, g.Cp, hd, kv_off);
    stage_rows<kHeadDim>(vs, v, g.Cp, hd, kv_off);
    stage_wait();

    // scores and dO . v
    for (int r0 = 0; r0 < g.Rp; r0 += kRowTile)
      for (int c0 = 0; c0 < g.Cp; c0 += kColTile) {
        float s[2][4], t[2][4];
        tile_dots<2, 16, kHeadDim>(qs, r0 + ty, ks, c0 + tx, s);
        tile_dots<2, 16, kHeadDim>(dos, r0 + ty, vs, c0 + tx, t);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int r = r0 + ty + 16 * a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = c0 + tx + 16 * c;
            as[r * g.sld + j] =
                r >= g.R ? 0.f
                : unit_visible(g, col_ok, r, j) ? s[a][c] * scale
                                                : -INFINITY;
            ts[r * g.sld + j] = r >= g.R ? 0.f : t[a][c];
          }
        }
      }
    __syncthreads();

    // per row, a warp on kBwdRows rows at once: the softmax, the dropout
    // mask, Delta, then ds for dq (in `as`), round(p m) (in `ts`) and ds
    // for dK (in `xs`); a row that sees no key: zeros
    constexpr int kWarps = kBwdThreads / 32, kBwdRows = kRowTile / kWarps;
    for (int rb = warp; rb < g.R; rb += kRowTile) {
      int r[kBwdRows];
      float *ar[kBwdRows], *tr[kBwdRows], *xr[kBwdRows];
#pragma unroll
      for (int k = 0; k < kBwdRows; ++k) {
        r[k] = rb + k * kWarps;
        const bool row = r[k] < g.R;
        ar[k] = row ? as + r[k] * g.sld : nullptr;
        tr[k] = row ? ts + r[k] * g.sld : nullptr;
        xr[k] = row ? xs + r[k] * g.sld : nullptr;
      }
      float mx[kBwdRows], sum[kBwdRows], inv[kBwdRows], lse[kBwdRows],
          dsum[kBwdRows];
      bool live[kBwdRows];
      unsigned long long off[kBwdRows];
      exp_rows(g, i, lane, ar, xr, mx, sum);
#pragma unroll
      for (int k = 0; k < kBwdRows; ++k) {
        live[k] = ar[k] && mx[k] != -INFINITY;
        inv[k] = live[k] ? 1.0f / sum[k] : 0.f;
        lse[k] = live[k] ? mx[k] + logf(sum[k]) : 0.f;
        off[k] = (unsigned long long)(row_base + unit_row(g, i, r[k])) * g.ctx;
        dsum[k] = 0.f;
      }
      for (int j = lane; j < g.C; j += 32)  // the sign keeps the mask (-0 too)
#pragma unroll
        for (int k = 0; k < kBwdRows; ++k)
          if (live[k] && unit_visible(g, col_ok, r[k], j) &&
              drop.scale(off[k] + col_slot[j], 0) == 0.f)
            xr[k][j] = -xr[k][j];
      __syncwarp();
      for_lane_slots(g, i, lane, [&](int j) {  // Delta in exp_rows' order
#pragma unroll
        for (int k = 0; k < kBwdRows; ++k) {
          if (!live[k]) continue;
          const float xe = xr[k][j], p = fabsf(xe) * inv[k];
          const float dp =
              p > 0.f ? __fmul_rn(tr[k][j], signbit(xe) ? 0.f : keep_mult)
                      : 0.f;
          dsum[k] += dp * p;
        }
      });
      warp_sum_k(dsum);  // Delta
      __syncwarp();
      for (int j = lane; j < g.Cp; j += 32)
#pragma unroll
        for (int k = 0; k < kBwdRows; ++k) {
          if (!ar[k]) continue;
          float ds_q = 0.f, pd = 0.f, ds_k = 0.f;
          if (live[k] && unit_visible(g, col_ok, r[k], j)) {
            const float xe = xr[k][j], t = tr[k][j], delta = dsum[k];
            const float m = signbit(xe) ? 0.f : keep_mult;
            const float p = fabsf(xe) * inv[k];
            const float dp = p > 0.f ? __fmul_rn(t, m) : 0.f;
            ds_q = round_to<T>(p * (dp - delta) * scale);
            const float pl = expf(ar[k][j] - lse[k]);
            pd = m != 0.f ? round_to<T>(pl * keep_mult) : 0.f;
            ds_k = round_to<T>(pl * (t * m - delta) * scale);
          }
          ar[k][j] = ds_q;
          tr[k][j] = pd;
          xr[k][j] = ds_k;
        }
    }
    __syncthreads();

    // dq = ds K, straight into the segment's rows; round(p m) and ds to
    // the unit's probs
    for (int r0 = 0; r0 < g.Rp; r0 += kRowTile)
      for (int fb = 0; fb < hd; fb += 64) {   // features fb + 4 tx ..
        float4 acc[2] = {};
        tile_pv<2, 16, kHeadDim>(as, g.sld, r0 + ty, ks + fb, tx, jn, acc);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int r = r0 + ty + 16 * a;
          if (r < g.R && fb + 4 * tx < hd)
            store4(dq + q_off(r) + fb + 4 * tx, acc[a]);
        }
      }
    float* up = probs + i * unit_probs;
    for (int idx = threadIdx.x; idx < g.R * g.Cp / 4; idx += kBwdThreads) {
      const int r = idx / (g.Cp / 4), q = 4 * (idx % (g.Cp / 4));
      store4(up + r * g.Cp + q, at4(ts + r * g.sld + q));
      store4(up + (g.R + r) * g.Cp + q, at4(xs + r * g.sld + q));
    }
    __syncthreads();  // the next segment restages the tiles and columns
  }

  // dK and dV over the rc rows, the frame rows, then the summary rows,
  // once per block of F features (f0 ..).
  // The tiles' space (Q through xs) holds the rows of as many segments as
  // fit: Q and dO rows (stride kLd), round(p m) and ds rows (stride Cp).
  // Columns no row sees carry exact zeros, so every column of a unit adds.
  float* const space = qs;
  const int space_floats =
      2 * g.Rp * kLd + 2 * g.Cp * kLd + 3 * g.Rp * g.sld;
  const int run_rows[4] = {0, g.rc, g.rc + g.seg, g.R};
  const size_t part_base =
      ((size_t)b * g.ng + grp) * g.ctx * g.dim + head * hd;
  // thread (ty, tx) adds features f0 + 4 tx .. +3 where 4 tx < F
  const bool feat_ok = 4 * tx < F;
  for (int f0 = 0; f0 < hd; f0 += F) {
    for (int idx = threadIdx.x; idx < 2 * g.ctx * F; idx += kBwdThreads)
      dk_acc[idx] = 0.f;  // and dv_acc, which follows it
    for (int run = 0; run < 3; ++run) {
      const int r0 = run_rows[run], n = run_rows[run + 1] - r0;
      const int per_seg = n * (2 * kLd + 2 * g.Cp);
      const int batch = max(1, min(g.G, space_floats / per_seg));
      float* qb = space;                   // [batch n][kLd]
      float* db = qb + batch * n * kLd;    // [batch n][kLd]
      float* pb = db + batch * n * kLd;    // [batch n][Cp] round(p m)
      float* sb = pb + batch * n * g.Cp;   // [batch n][Cp] ds
      for (int i0 = 0; i0 < g.G; i0 += batch) {
        const int nseg = min(batch, g.G - i0);
        const auto q_off = [&](int r) -> long long {
          return (long long)(q_base + (size_t)unit_row(g, i0 + r / n,
                                                       r0 + r % n) *
                                          g.dim);
        };
        stage_rows<kHeadDim>(qb, q3, nseg * n, hd, q_off);
        stage_rows<kHeadDim>(db, dout, nseg * n, hd, q_off);
        for (int u = 0; u < nseg; ++u) {
          const float* up = probs + (i0 + u) * unit_probs + r0 * g.Cp;
          stage_f32(pb + u * n * g.Cp, up, n * g.Cp);
          stage_f32(sb + u * n * g.Cp, up + g.R * g.Cp, n * g.Cp);
        }
        stage_wait();
        for (int u = 0; u < nseg; ++u) {
          const int i = i0 + u;
          // thread (ty, tx): columns c0 + 4 ty .. +3, features f0 + 4 tx ..
          for (int c0 = 0; c0 < g.Cp && feat_ok; c0 += kColTile) {
            const int j0 = c0 + 4 * ty;
            int o[4];
            float4 ak[4], av[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              o[c] = j0 + c < g.C ? unit_slot(g, i, j0 + c) * F + 4 * tx
                                  : -1;
              ak[c] = o[c] >= 0 ? at4(dk_acc + o[c]) : make_float4(0, 0, 0, 0);
              av[c] = o[c] >= 0 ? at4(dv_acc + o[c]) : make_float4(0, 0, 0, 0);
            }
            for (int r = u * n; r < (u + 1) * n; ++r) {
              const float4 dsr = at4(sb + r * g.Cp + j0);
              const float4 pdr = at4(pb + r * g.Cp + j0);
              const float4 qv = at4(qb + r * kLd + f0 + 4 * tx);
              const float4 ov = at4(db + r * kLd + f0 + 4 * tx);
              fma4(ak[0], dsr.x, qv);
              fma4(ak[1], dsr.y, qv);
              fma4(ak[2], dsr.z, qv);
              fma4(ak[3], dsr.w, qv);
              fma4(av[0], pdr.x, ov);
              fma4(av[1], pdr.y, ov);
              fma4(av[2], pdr.z, ov);
              fma4(av[3], pdr.w, ov);
            }
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (o[c] >= 0) {
                store4(dk_acc + o[c], ak[c]);
                store4(dv_acc + o[c], av[c]);
              }
          }
          __syncthreads();  // the next segment's columns overlap this one's
        }
      }
    }
    // this block's features of the group's (ctx, dim) fp32 partials
    for (int idx = threadIdx.x; idx < g.ctx * F / 4; idx += kBwdThreads) {
      const int f = f0 + 4 * (idx % (F / 4));
      if (f >= hd) continue;
      const size_t o = part_base + (size_t)(idx / (F / 4)) * g.dim + f;
      store4(dk_part + o, at4(dk_acc + 4 * idx));
      store4(dv_part + o, at4(dv_acc + 4 * idx));
    }
    __syncthreads();  // the accumulators are read before the next block
  }
}


template <typename T, bool kGated, int kHeadDim, bool kExact>
int launch_attn(const void* q3, const void* k, const void* v,
                const void* lengths, Gate gate, void* out, int batch,
                const Geom& g, size_t smem, Dropout drop,
                cudaStream_t stream) {
  SIMULST_TRY(cudaFuncSetAttribute(
      grouped_attn_kernel<T, kGated, kHeadDim, kExact>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  grouped_attn_kernel<T, kGated, kHeadDim, kExact>
      <<<batch * g.ng * g.heads * g.G, kFwdThreads, smem, stream>>>(
          static_cast<const T*>(q3), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(lengths), gate,
          static_cast<T*>(out), g, drop);
  return (int)cudaGetLastError();
}

template <typename T, bool kGated, int kHeadDim, bool kExact>
int launch_attn_bwd(const void* q3, const void* k, const void* v,
                    const void* dout, const void* lengths, Gate gate,
                    void* dq, void* dk, void* dv, float* probs,
                    float* dk_part, float* dv_part, int batch, const Geom& g,
                    size_t smem, Dropout drop, cudaStream_t s) {
  SIMULST_TRY(cudaFuncSetAttribute(
      grouped_attn_bwd_kernel<T, kGated, kHeadDim, kExact>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  grouped_attn_bwd_kernel<T, kGated, kHeadDim, kExact>
      <<<batch * g.ng * g.heads, kBwdThreads, smem, s>>>(
          static_cast<const T*>(q3), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const int*>(lengths), gate, static_cast<T*>(dq),
          probs, dk_part, dv_part, g, drop);
  SIMULST_TRY(cudaGetLastError());
  grouped_attn_dkv_sum_kernel<T><<<batch * g.tk, kSumThreads, 0, s>>>(
      dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), g,
      false);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// head dims above kMaxHeadDim: the wide kernels
// ---------------------------------------------------------------------------
constexpr int kWideThreads = 128;

// shared memory of a wide forward block (the scores, three ints per
// column) and of a wide backward unit block (three matrices)
size_t wide_fwd_smem_bytes(const Geom& g) {
  return sizeof(float) * (size_t)g.Rp * g.sld + 3 * sizeof(int) * (size_t)g.Cp;
}
size_t wide_bwd_smem_bytes(const Geom& g) {
  return sizeof(float) * 3 * (size_t)g.Rp * g.sld +
         3 * sizeof(int) * (size_t)g.Cp;
}

// x . y over hd features, both rows of T in device memory
template <typename T>
__device__ __forceinline__ float dot_rows(const T* x, const T* y, int hd) {
  float s = 0.f;
  for (int d = 0; d < hd; ++d) s = fmaf(to_f32(x[d]), to_f32(y[d]), s);
  return s;
}

// the column of segment i's unit holding group-context slot c, -1 if none
__device__ __forceinline__ int slot_column(const Geom& g, int i, int c) {
  if (c < g.m_slots) return c - i >= 0 && c - i < g.max_mem ? c - i : -1;
  const int rc0 = g.m_slots + i * g.rc;
  if (c < g.m_slots + g.G * g.rc)
    return c >= rc0 && c < rc0 + g.rc ? g.max_mem + (c - rc0) : -1;
  const int u0 = g.m_slots + g.G * g.rc + i * g.seg;
  return c >= u0 && c < u0 + g.lc + g.seg ? g.max_mem + g.rc + (c - u0) : -1;
}

// out = softmax(q k^T scale) dropped, rounded to T, times v, one block per
// unit (grouped_attn_kernel's), its scores in shared memory
template <typename T, bool kGated>
__global__ void __launch_bounds__(kWideThreads)
    grouped_attn_wide_kernel(const T* __restrict__ q3,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const int* __restrict__ lengths, Gate gate,
                             T* __restrict__ out, Geom g, Dropout drop) {
  extern __shared__ float4 smem4[];
  float* ps = reinterpret_cast<float*>(smem4);                // [Rp][sld]
  int* col_slot = reinterpret_cast<int*>(ps + g.Rp * g.sld);  // [Cp]
  int* col_row = col_slot + g.Cp;                             // [Cp]
  int* col_ok = col_row + g.Cp;                               // [Cp]
  const int i = blockIdx.x % g.G;
  const int head = (blockIdx.x / g.G) % g.heads;
  const int grp = (blockIdx.x / (g.G * g.heads)) % g.ng;
  const int b = blockIdx.x / (g.G * g.heads * g.ng);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hd = g.hd;
  const size_t q_base = ((size_t)b * g.ng + grp) * g.nq * g.dim + head * hd;
  const size_t kv_base = (size_t)b * g.tk * g.dim + head * hd;
  const size_t row_base =
      (((size_t)b * g.ng + grp) * g.heads + head) * g.nq;
  const float scale = 1.0f / sqrtf((float)g.hd_real);
  unit_columns<kGated>(g, gate, b, grp, i, lengths[b], col_slot, col_row,
                       col_ok);
  __syncthreads();
  for (int idx = threadIdx.x; idx < g.R * g.Cp; idx += kWideThreads) {
    const int r = idx / g.Cp, j = idx % g.Cp;
    float s = -INFINITY;
    if (j < g.C && unit_visible(g, col_ok, r, j))
      s = dot_rows(q3 + q_base + (size_t)unit_row(g, i, r) * g.dim,
                   k + kv_base + (size_t)col_row[j] * g.dim, hd) *
          scale;
    ps[r * g.sld + j] = s;
  }
  __syncthreads();
  const float keep_mult = drop.on ? drop.inv_keep : 1.f;
  for (int r = warp; r < g.R; r += kWideThreads / 32) {
    float* pr = ps + r * g.sld;
    float mx = -INFINITY;
    for (int j = lane; j < g.Cp; j += 32) mx = fmaxf(mx, pr[j]);
    mx = simulst::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < g.C; j += 32)
      if (mx != -INFINITY && pr[j] != -INFINITY) sum += expf(pr[j] - mx);
    sum = simulst::warp_sum(sum);
    const unsigned long long off =
        (unsigned long long)(row_base + unit_row(g, i, r)) * g.ctx;
    for (int j = lane; j < g.Cp; j += 32) {
      const float e = mx != -INFINITY && pr[j] != -INFINITY
                          ? expf(pr[j] - mx) : 0.f;
      pr[j] = e > 0.f && drop.scale(off + col_slot[j], 0) != 0.f
                  ? round_to<T>(e * (1.0f / sum) * keep_mult)
                  : 0.f;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g.R * hd; idx += kWideThreads) {
    const int r = idx / hd, d = idx % hd;
    const float* pr = ps + r * g.sld;
    float acc = 0.f;
    for (int j = 0; j < g.C; ++j)
      if (pr[j] != 0.f)
        acc = fmaf(pr[j], to_f32(v[kv_base + (size_t)col_row[j] * g.dim + d]),
                   acc);
    out[q_base + (size_t)unit_row(g, i, r) * g.dim + d] = from_f32<T>(acc);
  }
}

// the backward's first pass, one block per unit: the probabilities
// recomputed, dq written, round(p m) and ds (for dK) into the unit's
// `probs` (grouped_attn_bwd_kernel's layout and formulas)
template <typename T, bool kGated>
__global__ void __launch_bounds__(kWideThreads)
    grouped_attn_wide_bwd_kernel(const T* __restrict__ q3,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const T* __restrict__ dout,
                                 const int* __restrict__ lengths, Gate gate,
                                 T* __restrict__ dq,
                                 float* __restrict__ probs, Geom g,
                                 Dropout drop) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);   // scores, then ds (dq)
  float* ts = as + g.Rp * g.sld;                 // dO . v, then round(p m)
  float* xs = ts + g.Rp * g.sld;                 // ds (dK)
  int* col_slot = reinterpret_cast<int*>(xs + g.Rp * g.sld);
  int* col_row = col_slot + g.Cp;
  int* col_ok = col_row + g.Cp;
  const int i = blockIdx.x % g.G;
  const int head = (blockIdx.x / g.G) % g.heads;
  const int grp = (blockIdx.x / (g.G * g.heads)) % g.ng;
  const int b = blockIdx.x / (g.G * g.heads * g.ng);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hd = g.hd;
  const size_t q_base = ((size_t)b * g.ng + grp) * g.nq * g.dim + head * hd;
  const size_t kv_base = (size_t)b * g.tk * g.dim + head * hd;
  const size_t row_base =
      (((size_t)b * g.ng + grp) * g.heads + head) * g.nq;
  const float scale = 1.0f / sqrtf((float)g.hd_real);
  const float keep_mult = drop.on ? drop.inv_keep : 1.f;
  unit_columns<kGated>(g, gate, b, grp, i, lengths[b], col_slot, col_row,
                       col_ok);
  __syncthreads();
  for (int idx = threadIdx.x; idx < g.R * g.Cp; idx += kWideThreads) {
    const int r = idx / g.Cp, j = idx % g.Cp;
    float s = -INFINITY, t = 0.f;
    if (j < g.C && unit_visible(g, col_ok, r, j)) {
      const size_t qo = q_base + (size_t)unit_row(g, i, r) * g.dim;
      const size_t ko = kv_base + (size_t)col_row[j] * g.dim;
      s = dot_rows(q3 + qo, k + ko, hd) * scale;
      t = dot_rows(dout + qo, v + ko, hd);
    }
    as[r * g.sld + j] = s;
    ts[r * g.sld + j] = t;
  }
  __syncthreads();
  for (int r = warp; r < g.R; r += kWideThreads / 32) {
    float *ar = as + r * g.sld, *tr = ts + r * g.sld, *xr = xs + r * g.sld;
    float mx = -INFINITY;
    for (int j = lane; j < g.Cp; j += 32) mx = fmaxf(mx, ar[j]);
    mx = simulst::warp_max(mx);
    const bool live = mx != -INFINITY;
    float sum = 0.f;
    for (int j = lane; j < g.C; j += 32)
      if (live && ar[j] != -INFINITY) sum += expf(ar[j] - mx);
    sum = simulst::warp_sum(sum);
    const float inv = live ? 1.0f / sum : 0.f;
    const float lse = live ? mx + logf(sum) : 0.f;
    const unsigned long long off =
        (unsigned long long)(row_base + unit_row(g, i, r)) * g.ctx;
    // Delta = sum over the visible columns of (dO . v) m p
    float delta = 0.f;
    for (int j = lane; j < g.C; j += 32)
      if (live && ar[j] != -INFINITY) {
        const float m =
            drop.scale(off + col_slot[j], 0) != 0.f ? keep_mult : 0.f;
        delta += __fmul_rn(tr[j], m) * (expf(ar[j] - mx) * inv);
      }
    delta = simulst::warp_sum(delta);
    for (int j = lane; j < g.Cp; j += 32) {
      float ds_q = 0.f, pd = 0.f, ds_k = 0.f;
      if (live && j < g.C && ar[j] != -INFINITY) {
        const float m =
            drop.scale(off + col_slot[j], 0) != 0.f ? keep_mult : 0.f;
        const float p = expf(ar[j] - mx) * inv, t = tr[j];
        ds_q = round_to<T>(p * (__fmul_rn(t, m) - delta) * scale);
        const float pl = expf(ar[j] - lse);
        pd = m != 0.f ? round_to<T>(pl * keep_mult) : 0.f;
        ds_k = round_to<T>(pl * (t * m - delta) * scale);
      }
      ar[j] = ds_q;
      tr[j] = pd;
      xr[j] = ds_k;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g.R * hd; idx += kWideThreads) {
    const int r = idx / hd, d = idx % hd;
    const float* ar = as + r * g.sld;
    float acc = 0.f;
    for (int j = 0; j < g.C; ++j)
      if (ar[j] != 0.f)
        acc = fmaf(ar[j], to_f32(k[kv_base + (size_t)col_row[j] * g.dim + d]),
                   acc);
    dq[q_base + (size_t)unit_row(g, i, r) * g.dim + d] = from_f32<T>(acc);
  }
  float* up = probs + (size_t)blockIdx.x * 2 * g.R * g.Cp;
  for (int idx = threadIdx.x; idx < g.R * g.Cp; idx += kWideThreads) {
    const int r = idx / g.Cp, j = idx % g.Cp;
    up[idx] = ts[r * g.sld + j];
    up[g.R * g.Cp + idx] = xs[r * g.sld + j];
  }
}

// the backward's second pass, one block per (batch, group, head): dK and
// dV of every context slot of the group over the units' rows (segments,
// then rows, ascending) into the (batch, ng, ctx, dim) partials
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    grouped_attn_wide_dkv_kernel(const T* __restrict__ q3,
                                 const T* __restrict__ dout,
                                 const float* __restrict__ probs,
                                 float* __restrict__ dk_part,
                                 float* __restrict__ dv_part, Geom g) {
  const int head = blockIdx.x % g.heads;
  const int grp = (blockIdx.x / g.heads) % g.ng;
  const int b = blockIdx.x / (g.heads * g.ng);
  const int hd = g.hd;
  const size_t q_base = ((size_t)b * g.ng + grp) * g.nq * g.dim + head * hd;
  const size_t part_base =
      ((size_t)b * g.ng + grp) * g.ctx * g.dim + head * hd;
  const size_t unit_probs = 2 * (size_t)g.R * g.Cp;
  const float* bp = probs + (size_t)blockIdx.x * g.G * unit_probs;
  for (int idx = threadIdx.x; idx < g.ctx * hd; idx += kWideThreads) {
    const int c = idx / hd, d = idx % hd;
    float sk = 0.f, sv = 0.f;
    for (int i = 0; i < g.G; ++i) {
      const int j = slot_column(g, i, c);
      if (j < 0) continue;
      const float* up = bp + i * unit_probs;
      for (int r = 0; r < g.R; ++r) {
        const float pd = up[r * g.Cp + j], ds = up[(g.R + r) * g.Cp + j];
        if (pd == 0.f && ds == 0.f) continue;
        const size_t qo = q_base + (size_t)unit_row(g, i, r) * g.dim + d;
        sk = fmaf(ds, to_f32(q3[qo]), sk);
        sv = fmaf(pd, to_f32(dout[qo]), sv);
      }
    }
    dk_part[part_base + (size_t)c * g.dim + d] = sk;
    dv_part[part_base + (size_t)c * g.dim + d] = sv;
  }
}

template <typename T, bool kGated>
int launch_attn_wide(const void* q3, const void* k, const void* v,
                     const void* lengths, Gate gate, void* out, int batch,
                     const Geom& g, size_t smem, Dropout drop,
                     cudaStream_t stream) {
  SIMULST_TRY(cudaFuncSetAttribute(
      grouped_attn_wide_kernel<T, kGated>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  grouped_attn_wide_kernel<T, kGated>
      <<<batch * g.ng * g.heads * g.G, kWideThreads, smem, stream>>>(
          static_cast<const T*>(q3), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(lengths), gate,
          static_cast<T*>(out), g, drop);
  return (int)cudaGetLastError();
}

template <typename T, bool kGated>
int launch_attn_wide_bwd(const void* q3, const void* k, const void* v,
                         const void* dout, const void* lengths, Gate gate,
                         void* dq, void* dk, void* dv, float* probs,
                         float* dk_part, float* dv_part, int batch,
                         const Geom& g, size_t smem, Dropout drop,
                         cudaStream_t s) {
  SIMULST_TRY(cudaFuncSetAttribute(
      grouped_attn_wide_bwd_kernel<T, kGated>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  grouped_attn_wide_bwd_kernel<T, kGated>
      <<<batch * g.ng * g.heads * g.G, kWideThreads, smem, s>>>(
          static_cast<const T*>(q3), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const int*>(lengths), gate, static_cast<T*>(dq),
          probs, g, drop);
  SIMULST_TRY(cudaGetLastError());
  grouped_attn_wide_dkv_kernel<T><<<batch * g.ng * g.heads, kWideThreads, 0,
                                    s>>>(static_cast<const T*>(q3),
                                         static_cast<const T*>(dout), probs,
                                         dk_part, dv_part, g);
  SIMULST_TRY(cudaGetLastError());
  grouped_attn_dkv_sum_kernel<T><<<batch * g.tk, kSumThreads, 0, s>>>(
      dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), g,
      false);
  return (int)cudaGetLastError();
}


// runs the statement with kH bound to the staged head dim g.shd and kE to
// whether the head is 64 wide, unpadded, with 64 accumulator features (its
// offsets, scale and walks then fold to constants)
#define ATTN_HD_DISPATCH(g, ...)                            \
  do {                                                      \
    if ((g).hd == 64 && (g).hd_real == 64 && (g).F == 64) { \
      constexpr int kH = 64;                                \
      constexpr bool kE = true;                             \
      __VA_ARGS__;                                          \
    } else if ((g).shd == 64) {                             \
      constexpr int kH = 64;                                \
      constexpr bool kE = false;                            \
      __VA_ARGS__;                                          \
    } else {                                                \
      constexpr int kH = 128;                               \
      constexpr bool kE = false;                            \
      __VA_ARGS__;                                          \
    }                                                       \
  } while (0)

}  // namespace

// q3, out: (batch, ng, nq, dim); k, v: (batch, tk, dim), all of `dtype`;
// lengths: (batch,) int32 valid utterance frames.  dim = heads * hd with hd
// a multiple of 8 (above 128 the wide kernels, whose blocks hold only the
// unit's matrices: wide_*_smem_bytes); hd_real the head dim of a call
// zero-padded to hd (hd itself when nothing is padded; less than 8 below
// it), whose 1 / sqrt scales the scores;
// nq = G * (rc + seg + 1), tk = (n - 1) + n * rc + n * seg with n = ng * G.
// kid (batch, tk) and seg_eid (batch, n), int32: the sequence-packing
// gate, both null for none.  unit_cols = max_mem + rc + lc + seg and
// smem_bytes, the shared memory of one block, come from
// ops/emformer_attn.py `unit_shape`; a mismatch or more than 227 KB is
// refused.  Dropout on the probabilities when drop_on.  Returns a
// cudaError_t.
extern "C" int simulst_emformer_attn(int dtype, const void* q3, const void* k,
                                     const void* v, const void* lengths,
                                     const void* kid, const void* seg_eid,
                                     void* out, int batch, int ng, int nq,
                                     int dim, int heads, int hd_real, int seg,
                                     int lc, int rc, int max_mem, int G, int tk,
                                     int unit_cols, int smem_bytes,
                                     int drop_on, unsigned long long seed,
                                     unsigned threshold, float inv_keep,
                                     void* stream) {
  Geom g;
  const bool wide = heads > 0 && dim / heads > kMaxHeadDim;
  if (!make_geom(&g, batch, ng, nq, dim, heads, hd_real, seg, lc, rc,
                 max_mem, G, tk, unit_cols) ||
      (wide ? wide_fwd_smem_bytes(g) : fwd_smem_bytes(g)) !=
          (size_t)smem_bytes ||
      smem_bytes > kSmemLimit || (kid == nullptr) != (seg_eid == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, inv_keep, drop_on};
  const Gate gate{static_cast<const int*>(kid),
                  static_cast<const int*>(seg_eid)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    SIMULST_DISPATCH(dtype,
                     return gate.kid ? launch_attn_wide<scalar_t, true>(
                                           q3, k, v, lengths, gate, out,
                                           batch, g, smem_bytes, drop, s)
                                     : launch_attn_wide<scalar_t, false>(
                                           q3, k, v, lengths, gate, out,
                                           batch, g, smem_bytes, drop, s));
  ATTN_HD_DISPATCH(g, SIMULST_DISPATCH(dtype,
                   return gate.kid ? launch_attn<scalar_t, true, kH, kE>(
                                         q3, k, v, lengths, gate, out, batch,
                                         g, smem_bytes, drop, s)
                                   : launch_attn<scalar_t, false, kH, kE>(
                                         q3, k, v, lengths, gate, out, batch,
                                         g, smem_bytes, drop, s)));
}

// The backward: dq (batch, ng, nq, dim), dk and dv (batch, tk, dim) of
// `dtype` for upstream gradient dout (batch, ng, nq, dim), with the gate
// (kid, seg_eid), unit_cols and smem_bytes (the backward block's) as in
// the forward.  Scratch, fp32: probs (batch, ng, heads, G, 2, R, Cp) with
// R = rc + seg + 1 and Cp = unit_cols rounded up to 64, dk_part and
// dv_part (batch, ng, ctx, dim).  Two launches: the segment-walking block
// kernel and the ordered sum (above head dim 128 three: the wide units,
// the wide dK / dV sums and the ordered sum).  Returns a cudaError_t.
extern "C" int simulst_emformer_attn_bwd(
    int dtype, const void* q3, const void* k, const void* v,
    const void* lengths, const void* kid, const void* seg_eid,
    const void* dout, void* dq, void* dk, void* dv, void* probs,
    void* dk_part, void* dv_part, int batch, int ng, int nq, int dim,
    int heads, int hd_real, int seg, int lc, int rc, int max_mem, int G,
    int tk, int unit_cols, int smem_bytes, int drop_on, unsigned long long seed,
    unsigned threshold, float inv_keep, void* stream) {
  Geom g;
  const bool wide = heads > 0 && dim / heads > kMaxHeadDim;
  if (!make_geom(&g, batch, ng, nq, dim, heads, hd_real, seg, lc, rc,
                 max_mem, G, tk, unit_cols) ||
      (wide ? wide_bwd_smem_bytes(g) : bwd_smem_bytes(g, g.F)) !=
          (size_t)smem_bytes ||
      smem_bytes > kSmemLimit ||
      (kid == nullptr) != (seg_eid == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, inv_keep, drop_on};
  const Gate gate{static_cast<const int*>(kid),
                  static_cast<const int*>(seg_eid)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *pp = static_cast<float*>(probs), *kp = static_cast<float*>(dk_part),
        *vp = static_cast<float*>(dv_part);
  if (wide)
    SIMULST_DISPATCH(dtype,
                     return gate.kid
                                ? launch_attn_wide_bwd<scalar_t, true>(
                                      q3, k, v, dout, lengths, gate, dq, dk,
                                      dv, pp, kp, vp, batch, g, smem_bytes,
                                      drop, s)
                                : launch_attn_wide_bwd<scalar_t, false>(
                                      q3, k, v, dout, lengths, gate, dq, dk,
                                      dv, pp, kp, vp, batch, g, smem_bytes,
                                      drop, s));
  ATTN_HD_DISPATCH(g, SIMULST_DISPATCH(dtype,
                   return gate.kid ? launch_attn_bwd<scalar_t, true, kH, kE>(
                                         q3, k, v, dout, lengths, gate, dq,
                                         dk, dv, pp, kp, vp, batch, g,
                                         smem_bytes, drop, s)
                                   : launch_attn_bwd<scalar_t, false, kH, kE>(
                                         q3, k, v, dout, lengths, gate, dq,
                                         dk, dv, pp, kp, vp, batch, g,
                                         smem_bytes, drop, s)));
}
