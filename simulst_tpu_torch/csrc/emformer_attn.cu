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
// directly and the rule is one more boolean term of `visible`, compiled
// out of the ungated instantiation, so the dense path runs the same code
// as without a gate.  A row that sees no key outputs exact zeros, as the
// JAX softmax does.
// Dropout on the probabilities draws Philox bits keyed by (seed, element
// offset ((((b ng + g) heads + h) nq + row) ctx + col)), stream 0, in the
// gathered-context layout, so the backward regenerates the forward's mask.
//
// What bounds it on the H100: per (batch, group, head) the context is only
// m_slots + G*rc + lc + G*seg rows (236 at the s2t_emformer_s geometry),
// so the work is small (about 2 x 200 x 236 x 64 FMA per block) and the
// cost is latency and shared-memory traffic, not device memory.  The
// forward gives each block one (batch, group, head) and a slice of the
// query rows (grid.y), gathers that head's K and V context rows straight
// from the projected K/V once into dynamic shared memory (about 121 KB in
// fp32, above the 48 KB static limit, hence cudaFuncSetAttribute) and
// lets each warp own one query row at a time: lanes score 1/32 of the
// context, the row max and sum are warp reductions, and each lane then
// accumulates two of the 64 output features.  Unlike the TPU kernel there
// are no 16-row aligned windows or padded Tk (a Mosaic slicing rule), and
// the softmax uses the row max instead of a clamp at 80.
//
// The backward cannot carry dK/dV across the groups in one accumulator as
// the TPU kernel does (its grid runs in order; neighbouring groups' windows
// overlap by lc frames and share memory slots), so it runs as three
// kernels and sums nothing across blocks with atomics:
//   dq:   the forward's layout, one warp per query row: recompute p, then
//         dp = (dO . v) m, Delta = sum(dp p), ds = p (dp - Delta) / sqrt(64),
//         dq = ds K; it also writes each row's log-sum-exp and Delta;
//   dkv:  one block per (batch, group, head) holding that block's Q and dO
//         rows in shared memory, one warp per context column: p from the
//         row's log-sum-exp, dv_c = sum_r round(p m) dO_r,
//         dk_c = sum_r ds_r q_r, written as an fp32 partial per (b, g);
//   sum:  one thread per key-row element adds, in group order, the partial
//         of each group whose context holds that row (a static map: at most
//         one column per group), and casts to the activation dtype.
#include <climits>
#include <math.h>

#include "common.cuh"

namespace {

using simulst::Dropout;
using simulst::from_f32;
using simulst::round_to;
using simulst::to_f32;

constexpr int kHeadDim = 64;
constexpr int kKPad = kHeadDim + 1;  // padded rows: conflict-free scoring
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Geom {
  int ng, nq, dim, heads, seg, lc, rc, max_mem, G, n, U, tk, m_slots, ctx,
      rows_per_block;
};

// The sequence-packing gate: kid (batch, tk) the example id of each key
// row, seg_eid (batch, n) that of each segment; null in the dense path.
struct Gate {
  const int* kid;
  const int* seg_eid;

  // the query id of row segment i of group grp, batch b
  __device__ __forceinline__ int query_id(const Geom& g, int b, int grp,
                                          int i) const {
    return seg_eid[(size_t)b * g.n + grp * g.G + i];
  }
  // whether key row `row` (-1: outside the sequence, never seen) belongs
  // to example qid
  __device__ __forceinline__ bool same(const Geom& g, int b, int row,
                                       int qid) const {
    return row >= 0 && __ldg(kid + (size_t)b * g.tk + row) == qid;
  }
};

size_t smem_bytes(const Geom& g) {
  return (size_t)g.ctx * (kKPad + kHeadDim) * sizeof(float)  // K, V
         + (size_t)kWarps * (kHeadDim + g.ctx) * sizeof(float)  // q, p
         + (size_t)g.ctx * sizeof(int);                          // slot rows
}

// backward dq kernel: K, V padded; per warp q, dO, p, dp
size_t smem_bytes_dq(const Geom& g) {
  return (size_t)g.ctx * 2 * kKPad * sizeof(float) +
         (size_t)kWarps * (2 * kHeadDim + 2 * g.ctx) * sizeof(float) +
         (size_t)g.ctx * sizeof(int);
}

// backward dkv kernel: Q, dO rows padded, row lse and Delta; per warp k, v
// and the per-row scalars
size_t smem_bytes_dkv(const Geom& g) {
  return (size_t)g.nq * (2 * kKPad + 2) * sizeof(float) +
         (size_t)kWarps * (2 * kHeadDim + 2 * g.nq) * sizeof(float);
}

// context slot c of group grp -> key row, -1 where the slot lies outside
// the sequence
__device__ __forceinline__ int slot_to_row(const Geom& g, int grp, int c) {
  const int utt0 = g.m_slots + g.G * g.rc;
  if (c < g.m_slots) {
    const int js = grp * g.G - g.max_mem + c;  // summary of segment js
    return (js >= 0 && js <= g.n - 2) ? js : -1;
  }
  if (c < utt0) return (g.n - 1) + grp * g.G * g.rc + (c - g.m_slots);
  const int f = grp * g.G * g.seg - g.lc + (c - utt0);
  return (f >= 0 && f < g.U) ? (g.n - 1) + g.n * g.rc + f : -1;
}

// query row r of a group -> (segment within the group, is a summary row)
__device__ __forceinline__ int row_segment(const Geom& g, int r, bool* is_sum) {
  const int grc = g.G * g.rc;
  *is_sum = false;
  if (r < grc) return r / g.rc;
  if (r < g.G * (g.rc + g.seg)) return (r - grc) / g.seg;
  *is_sum = true;
  return r - g.G * (g.rc + g.seg);
}

// whether query row (segment i, is_sum) sees context slot c holding key
// row `row` (-1: outside the sequence); frame0 = frame of utterance slot 0;
// same_example: the gate's term (true without a gate)
__device__ __forceinline__ bool visible(const Geom& g, int i, bool is_sum,
                                        int c, int row, int frame0,
                                        int length, bool same_example) {
  if (!same_example) return false;
  const int utt0 = g.m_slots + g.G * g.rc;
  if (c < g.m_slots)
    return !is_sum && c >= i && c < i + g.max_mem && row >= 0;
  if (c < utt0) return (c - g.m_slots) / g.rc == i;
  const int j = c - utt0;
  return j >= i * g.seg && j < i * g.seg + g.lc + g.seg && row >= 0 &&
         frame0 + j < length;
}

// Gather one head's K and V context rows of group grp into shared memory
// (row stride kKPad for K, vld for V), zeros for slots outside the
// sequence; slot_row[c] receives the key row of each slot.
template <typename T>
__device__ void load_context(const T* __restrict__ k, const T* __restrict__ v,
                             const Geom& g, int b, int grp, int head,
                             float* ks, float* vs, int vld, int* slot_row) {
  for (int c = threadIdx.x; c < g.ctx; c += blockDim.x)
    slot_row[c] = slot_to_row(g, grp, c);
  __syncthreads();
  const size_t kv_base = (size_t)b * g.tk * g.dim + head * kHeadDim;
  for (int idx = threadIdx.x; idx < g.ctx * kHeadDim; idx += blockDim.x) {
    const int c = idx / kHeadDim, d = idx % kHeadDim;
    const int row = slot_row[c];
    float kk = 0.f, vv = 0.f;
    if (row >= 0) {
      const size_t off = kv_base + (size_t)row * g.dim + d;
      kk = to_f32(k[off]);
      vv = to_f32(v[off]);
    }
    ks[c * kKPad + d] = kk;
    vs[c * vld + d] = vv;
  }
  __syncthreads();
}

template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads)
    grouped_attn_kernel(const T* __restrict__ q3, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, Gate gate,
                        T* __restrict__ out, Geom g, Dropout drop) {
  extern __shared__ float smem[];
  float* ks = smem;                          // [ctx][kKPad]
  float* vs = ks + g.ctx * kKPad;            // [ctx][kHeadDim]
  float* qs = vs + g.ctx * kHeadDim;         // [kWarps][kHeadDim]
  float* ps = qs + kWarps * kHeadDim;        // [kWarps][ctx]
  int* slot_row = reinterpret_cast<int*>(ps + kWarps * g.ctx);  // [ctx]

  const int head = blockIdx.x % g.heads;
  const int grp = (blockIdx.x / g.heads) % g.ng;
  const int b = blockIdx.x / (g.heads * g.ng);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int frame0 = grp * g.G * g.seg - g.lc;  // frame of utterance slot 0
  const int length = lengths[b];
  load_context(k, v, g, b, grp, head, ks, vs, kHeadDim, slot_row);

  const float scale = 1.0f / sqrtf((float)kHeadDim);
  const float keep_mult = drop.on ? drop.inv_keep : 1.f;
  float* qw = qs + warp * kHeadDim;
  float* pw = ps + warp * g.ctx;
  const int r_end = min((int)(blockIdx.y + 1) * g.rows_per_block, g.nq);
  for (int r = blockIdx.y * g.rows_per_block + warp; r < r_end; r += kWarps) {
    const size_t q_off =
        (((size_t)b * g.ng + grp) * g.nq + r) * g.dim + head * kHeadDim;
    const unsigned long long drop_off =
        ((((unsigned long long)b * g.ng + grp) * g.heads + head) * g.nq + r) *
        g.ctx;
    qw[lane] = to_f32(q3[q_off + lane]);
    qw[lane + 32] = to_f32(q3[q_off + lane + 32]);
    __syncwarp();
    bool is_sum;
    const int i = row_segment(g, r, &is_sum);
    const int qid = kGated ? gate.query_id(g, b, grp, i) : 0;

    float mx = -INFINITY;
    for (int c = lane; c < g.ctx; c += 32) {
      float s = -INFINITY;
      const int row = slot_row[c];
      if (visible(g, i, is_sum, c, row, frame0, length,
                  !kGated || gate.same(g, b, row, qid))) {
        const float* kr = ks + c * kKPad;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < kHeadDim; ++d) acc = fmaf(qw[d], kr[d], acc);
        s = acc * scale;
      }
      pw[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = simulst::warp_max(mx);

    float o0 = 0.f, o1 = 0.f;
    if (mx != -INFINITY) {  // warp-uniform; no visible key -> zeros
      float sum = 0.f;
      for (int c = lane; c < g.ctx; c += 32) {
        const float e = expf(pw[c] - mx);  // exp(-inf) == 0 off the mask
        sum += e;
        // a dropped entry is stored negated (e >= 0, so the sign says it)
        pw[c] = drop.scale(drop_off + c, 0) != 0.f ? e : -e;
      }
      const float inv = 1.0f / simulst::warp_sum(sum);
      __syncwarp();
      for (int c = 0; c < g.ctx; ++c) {
        const float e = pw[c];
        // probs (dropped) in the act dtype
        const float p = e > 0.f ? round_to<T>(e * inv * keep_mult) : 0.f;
        o0 = fmaf(p, vs[c * kHeadDim + lane], o0);
        o1 = fmaf(p, vs[c * kHeadDim + lane + 32], o1);
      }
    }
    out[q_off + lane] = from_f32<T>(o0);
    out[q_off + lane + 32] = from_f32<T>(o1);
    __syncwarp();  // qw and pw are rewritten for the next row
  }
}

// dq = ds K per query row; stats[row] = (log-sum-exp, Delta), the
// log-sum-exp -inf for a row that sees no key
template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads)
    grouped_attn_dq_kernel(const T* __restrict__ q3, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const int* __restrict__ lengths, Gate gate,
                           T* __restrict__ dq, float* __restrict__ stats,
                           Geom g, Dropout drop) {
  extern __shared__ float smem[];
  float* ks = smem;                          // [ctx][kKPad]
  float* vs = ks + g.ctx * kKPad;            // [ctx][kKPad]
  float* qs = vs + g.ctx * kKPad;            // [kWarps][kHeadDim]
  float* dos = qs + kWarps * kHeadDim;       // [kWarps][kHeadDim]
  float* ps = dos + kWarps * kHeadDim;       // [kWarps][ctx]
  float* dps = ps + kWarps * g.ctx;          // [kWarps][ctx]
  int* slot_row = reinterpret_cast<int*>(dps + kWarps * g.ctx);  // [ctx]

  const int head = blockIdx.x % g.heads;
  const int grp = (blockIdx.x / g.heads) % g.ng;
  const int b = blockIdx.x / (g.heads * g.ng);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int frame0 = grp * g.G * g.seg - g.lc;
  const int length = lengths[b];
  load_context(k, v, g, b, grp, head, ks, vs, kKPad, slot_row);

  const float scale = 1.0f / sqrtf((float)kHeadDim);
  float* qw = qs + warp * kHeadDim;
  float* dow = dos + warp * kHeadDim;
  float* pw = ps + warp * g.ctx;
  float* dpw = dps + warp * g.ctx;
  const int r_end = min((int)(blockIdx.y + 1) * g.rows_per_block, g.nq);
  for (int r = blockIdx.y * g.rows_per_block + warp; r < r_end; r += kWarps) {
    const size_t q_off =
        (((size_t)b * g.ng + grp) * g.nq + r) * g.dim + head * kHeadDim;
    const size_t row_id =
        (((size_t)b * g.ng + grp) * g.heads + head) * g.nq + r;
    const unsigned long long drop_off = (unsigned long long)row_id * g.ctx;
    qw[lane] = to_f32(q3[q_off + lane]);
    qw[lane + 32] = to_f32(q3[q_off + lane + 32]);
    dow[lane] = to_f32(dout[q_off + lane]);
    dow[lane + 32] = to_f32(dout[q_off + lane + 32]);
    __syncwarp();
    bool is_sum;
    const int i = row_segment(g, r, &is_sum);
    const int qid = kGated ? gate.query_id(g, b, grp, i) : 0;

    float mx = -INFINITY;
    for (int c = lane; c < g.ctx; c += 32) {
      float s = -INFINITY;
      const int row = slot_row[c];
      if (visible(g, i, is_sum, c, row, frame0, length,
                  !kGated || gate.same(g, b, row, qid))) {
        const float* kr = ks + c * kKPad;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < kHeadDim; ++d) acc = fmaf(qw[d], kr[d], acc);
        s = acc * scale;
      }
      pw[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = simulst::warp_max(mx);

    float g0 = 0.f, g1 = 0.f, lse = -INFINITY, delta = 0.f;
    if (mx != -INFINITY) {  // warp-uniform; no visible key -> zeros
      float sum = 0.f;
      for (int c = lane; c < g.ctx; c += 32) {
        const float e = expf(pw[c] - mx);
        pw[c] = e;
        sum += e;
      }
      sum = simulst::warp_sum(sum);
      const float inv = 1.0f / sum;
      lse = mx + logf(sum);
      float dsum = 0.f;
      for (int c = lane; c < g.ctx; c += 32) {
        const float p = pw[c] * inv;
        float dp = 0.f;
        if (p > 0.f) {
          const float* vr = vs + c * kKPad;
          float acc = 0.f;
#pragma unroll 16
          for (int d = 0; d < kHeadDim; ++d) acc = fmaf(dow[d], vr[d], acc);
          dp = acc * drop.scale(drop_off + c, 0);
        }
        pw[c] = p;
        dpw[c] = dp;
        dsum += dp * p;
      }
      delta = simulst::warp_sum(dsum);
      for (int c = lane; c < g.ctx; c += 32)
        dpw[c] = round_to<T>(pw[c] * (dpw[c] - delta) * scale);
      __syncwarp();
      for (int c = 0; c < g.ctx; ++c) {
        const float ds = dpw[c];
        g0 = fmaf(ds, ks[c * kKPad + lane], g0);
        g1 = fmaf(ds, ks[c * kKPad + lane + 32], g1);
      }
    }
    dq[q_off + lane] = from_f32<T>(g0);
    dq[q_off + lane + 32] = from_f32<T>(g1);
    if (lane == 0) {
      stats[2 * row_id] = lse;
      stats[2 * row_id + 1] = delta;
    }
    __syncwarp();
  }
}

// dk / dv of each context slot of one (batch, group, head) into the fp32
// partials (B, ng, ctx, dim); a slot outside the sequence gets zeros
template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads)
    grouped_attn_dkv_kernel(const T* __restrict__ q3, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const int* __restrict__ lengths, Gate gate,
                            const float* __restrict__ stats,
                            float* __restrict__ dk_part,
                            float* __restrict__ dv_part, Geom g,
                            Dropout drop) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [nq][kKPad]
  float* dos = qs + g.nq * kKPad;            // [nq][kKPad]
  float* lse_s = dos + g.nq * kKPad;         // [nq]
  float* delta_s = lse_s + g.nq;             // [nq]
  float* kvs = delta_s + g.nq;               // [kWarps][2 * kHeadDim]
  float* rs = kvs + kWarps * 2 * kHeadDim;   // [kWarps][2 * nq]

  const int head = blockIdx.x % g.heads;
  const int grp = (blockIdx.x / g.heads) % g.ng;
  const int b = blockIdx.x / (g.heads * g.ng);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int frame0 = grp * g.G * g.seg - g.lc;
  const int length = lengths[b];
  const size_t q_base = ((size_t)b * g.ng + grp) * g.nq * g.dim +
                        head * kHeadDim;
  const size_t row_base = (((size_t)b * g.ng + grp) * g.heads + head) * g.nq;
  for (int idx = threadIdx.x; idx < g.nq * kHeadDim; idx += blockDim.x) {
    const int r = idx / kHeadDim, d = idx % kHeadDim;
    qs[r * kKPad + d] = to_f32(q3[q_base + (size_t)r * g.dim + d]);
    dos[r * kKPad + d] = to_f32(dout[q_base + (size_t)r * g.dim + d]);
  }
  for (int r = threadIdx.x; r < g.nq; r += blockDim.x) {
    lse_s[r] = stats[2 * (row_base + r)];
    delta_s[r] = stats[2 * (row_base + r) + 1];
  }
  __syncthreads();

  const float scale = 1.0f / sqrtf((float)kHeadDim);
  const float keep_mult = drop.on ? drop.inv_keep : 1.f;
  float* kw = kvs + warp * 2 * kHeadDim;
  float* vw = kw + kHeadDim;
  float* pdw = rs + warp * 2 * g.nq;
  float* dsw = pdw + g.nq;
  const size_t kv_base = (size_t)b * g.tk * g.dim + head * kHeadDim;
  const size_t part_base = ((size_t)b * g.ng + grp) * g.ctx * g.dim +
                           head * kHeadDim;
  const int c_end = min((int)(blockIdx.y + 1) * g.rows_per_block, g.ctx);
  for (int c = blockIdx.y * g.rows_per_block + warp; c < c_end; c += kWarps) {
    const int row = slot_to_row(g, grp, c);
    // the gate: this column's example id, never equal where out of range
    const int key_id = kGated && row >= 0
                           ? __ldg(gate.kid + (size_t)b * g.tk + row)
                           : INT_MIN;
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    if (row >= 0) {
      const size_t off = kv_base + (size_t)row * g.dim;
      kw[lane] = to_f32(k[off + lane]);
      kw[lane + 32] = to_f32(k[off + lane + 32]);
      vw[lane] = to_f32(v[off + lane]);
      vw[lane + 32] = to_f32(v[off + lane + 32]);
      __syncwarp();
      for (int r = lane; r < g.nq; r += 32) {
        bool is_sum;
        const int i = row_segment(g, r, &is_sum);
        float pd = 0.f, ds = 0.f;
        if (lse_s[r] != -INFINITY &&
            visible(g, i, is_sum, c, row, frame0, length,
                    !kGated || key_id == gate.query_id(g, b, grp, i))) {
          const float* qr = qs + r * kKPad;
          const float* dr = dos + r * kKPad;
          float s = 0.f, dpd = 0.f;
#pragma unroll 16
          for (int d = 0; d < kHeadDim; ++d) {
            s = fmaf(qr[d], kw[d], s);
            dpd = fmaf(dr[d], vw[d], dpd);
          }
          const float p = expf(s * scale - lse_s[r]);
          const float m =
              drop.scale((unsigned long long)(row_base + r) * g.ctx + c, 0);
          pd = m != 0.f ? round_to<T>(p * keep_mult) : 0.f;
          ds = round_to<T>(p * (dpd * m - delta_s[r]) * scale);
        }
        pdw[r] = pd;
        dsw[r] = ds;
      }
      __syncwarp();
      for (int r = 0; r < g.nq; ++r) {
        const float pd = pdw[r], ds = dsw[r];
        v0 = fmaf(pd, dos[r * kKPad + lane], v0);
        v1 = fmaf(pd, dos[r * kKPad + lane + 32], v1);
        k0 = fmaf(ds, qs[r * kKPad + lane], k0);
        k1 = fmaf(ds, qs[r * kKPad + lane + 32], k1);
      }
    }
    const size_t po = part_base + (size_t)c * g.dim;
    dk_part[po + lane] = k0;
    dk_part[po + lane + 32] = k1;
    dv_part[po + lane] = v0;
    dv_part[po + lane + 32] = v1;
    __syncwarp();  // kw, vw and the row scalars are rewritten
  }
}

// dk[b, j, :], dv[b, j, :] = sum over groups (in order) of the partial of
// the one context slot of that group holding key row j, if any
template <typename T>
__global__ void grouped_attn_dkv_sum_kernel(const float* __restrict__ dk_part,
                                            const float* __restrict__ dv_part,
                                            T* __restrict__ dk,
                                            T* __restrict__ dv, int batch,
                                            Geom g) {
  const size_t total = (size_t)batch * g.tk * g.dim;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = (int)(idx % g.dim);
  const int j = (int)((idx / g.dim) % g.tk);
  const int b = (int)(idx / ((size_t)g.dim * g.tk));
  const int mem_len = g.n - 1, rc_len = g.n * g.rc;
  const int utt0 = g.m_slots + g.G * g.rc;
  float sk = 0.f, sv = 0.f;
  for (int grp = 0; grp < g.ng; ++grp) {
    int c = -1;
    if (j < mem_len) {
      const int t = j - (grp * g.G - g.max_mem);
      if (t >= 0 && t < g.m_slots) c = t;
    } else if (j < mem_len + rc_len) {
      const int p = j - mem_len;
      if (p / (g.G * g.rc) == grp) c = g.m_slots + p - grp * g.G * g.rc;
    } else {
      const int off = (j - mem_len - rc_len) - (grp * g.G * g.seg - g.lc);
      if (off >= 0 && off < g.lc + g.G * g.seg) c = utt0 + off;
    }
    if (c >= 0) {
      const size_t po = (((size_t)b * g.ng + grp) * g.ctx + c) * g.dim + d;
      sk += dk_part[po];
      sv += dv_part[po];
    }
  }
  dk[idx] = from_f32<T>(sk);
  dv[idx] = from_f32<T>(sv);
}

template <typename T, bool kGated>
int launch_attn(const void* q3, const void* k, const void* v,
                const void* lengths, Gate gate, void* out, int batch,
                const Geom& g, Dropout drop, cudaStream_t stream) {
  const size_t smem = smem_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_attn_kernel<T, kGated>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * g.ng * g.heads,
                  simulst::ceil_div(g.nq, g.rows_per_block));
  grouped_attn_kernel<T, kGated><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q3), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths), gate,
      static_cast<T*>(out), g, drop);
  return (int)cudaGetLastError();
}

template <typename T, bool kGated>
int launch_attn_bwd(const void* q3_, const void* k_, const void* v_,
                    const void* dout_, const void* lengths_, Gate gate,
                    void* dq, void* dk, void* dv, float* stats,
                    float* dk_part, float* dv_part, int batch, const Geom& g,
                    int col_chunk, Dropout drop, cudaStream_t s) {
  const T* q3 = static_cast<const T*>(q3_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* dout = static_cast<const T*>(dout_);
  const int* lengths = static_cast<const int*>(lengths_);
  const size_t smem_dq = smem_bytes_dq(g), smem_dkv = smem_bytes_dkv(g);
  SIMULST_TRY(cudaFuncSetAttribute(grouped_attn_dq_kernel<T, kGated>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_dq));
  SIMULST_TRY(cudaFuncSetAttribute(grouped_attn_dkv_kernel<T, kGated>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_dkv));
  const int blocks = batch * g.ng * g.heads;
  grouped_attn_dq_kernel<T, kGated>
      <<<dim3(blocks, simulst::ceil_div(g.nq, g.rows_per_block)), kThreads,
         smem_dq, s>>>(q3, k, v, dout, lengths, gate, static_cast<T*>(dq),
                       stats, g, drop);
  SIMULST_TRY(cudaGetLastError());
  Geom gc = g;
  gc.rows_per_block = col_chunk;  // context columns per block in dkv
  grouped_attn_dkv_kernel<T, kGated>
      <<<dim3(blocks, simulst::ceil_div(g.ctx, col_chunk)), kThreads,
         smem_dkv, s>>>(q3, k, v, dout, lengths, gate, stats, dk_part,
                        dv_part, gc, drop);
  SIMULST_TRY(cudaGetLastError());
  const size_t total = (size_t)batch * g.tk * g.dim;
  grouped_attn_dkv_sum_kernel<T>
      <<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
          dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), batch,
          g);
  return (int)cudaGetLastError();
}

bool make_geom(Geom* g, int batch, int ng, int nq, int dim, int heads,
               int seg, int lc, int rc, int max_mem, int G, int tk,
               int rows_per_block) {
  g->ng = ng;
  g->nq = nq;
  g->dim = dim;
  g->heads = heads;
  g->seg = seg;
  g->lc = lc;
  g->rc = rc;
  g->max_mem = max_mem;
  g->G = G;
  g->n = ng * G;
  g->U = g->n * seg;
  g->tk = tk;
  g->m_slots = max_mem + G - 1;
  g->ctx = g->m_slots + G * rc + lc + G * seg;
  g->rows_per_block = rows_per_block;
  return batch > 0 && dim == heads * kHeadDim && rc > 0 && seg > 0 &&
         nq == G * (rc + seg + 1) && tk == (g->n - 1) + g->n * rc + g->U &&
         rows_per_block > 0;
}

}  // namespace

// q3, out: (batch, ng, nq, dim); k, v: (batch, tk, dim), all of `dtype`;
// lengths: (batch,) int32 valid utterance frames.  dim = heads * 64,
// nq = G * (rc + seg + 1), tk = (n - 1) + n * rc + n * seg with n = ng * G.
// kid (batch, tk) and seg_eid (batch, n), int32: the sequence-packing
// gate, both null for none.  Dropout on the probabilities when drop_on.
// Returns a cudaError_t.
extern "C" int simulst_emformer_attn(int dtype, const void* q3, const void* k,
                                     const void* v, const void* lengths,
                                     const void* kid, const void* seg_eid,
                                     void* out, int batch, int ng, int nq,
                                     int dim, int heads, int seg, int lc,
                                     int rc, int max_mem, int G, int tk,
                                     int rows_per_block, int drop_on,
                                     unsigned long long seed,
                                     unsigned threshold, float inv_keep,
                                     void* stream) {
  Geom g;
  if (!make_geom(&g, batch, ng, nq, dim, heads, seg, lc, rc, max_mem, G, tk,
                 rows_per_block) ||
      smem_bytes(g) > 227 * 1024 || (kid == nullptr) != (seg_eid == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, inv_keep, drop_on};
  const Gate gate{static_cast<const int*>(kid),
                  static_cast<const int*>(seg_eid)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SIMULST_DISPATCH(dtype,
                   return gate.kid ? launch_attn<scalar_t, true>(
                                         q3, k, v, lengths, gate, out, batch,
                                         g, drop, s)
                                   : launch_attn<scalar_t, false>(
                                         q3, k, v, lengths, gate, out, batch,
                                         g, drop, s));
}

// The backward: dq (batch, ng, nq, dim), dk and dv (batch, tk, dim) of
// `dtype` for upstream gradient dout (batch, ng, nq, dim), with the gate
// (kid, seg_eid) as in the forward.  Scratch, fp32:
// stats (batch, ng, heads, nq, 2), dk_part and dv_part (batch, ng, ctx,
// dim).  rows_per_block slices the query rows of the dq kernel, col_chunk
// the context columns of the dkv kernel.  Returns a cudaError_t.
extern "C" int simulst_emformer_attn_bwd(
    int dtype, const void* q3, const void* k, const void* v,
    const void* lengths, const void* kid, const void* seg_eid,
    const void* dout, void* dq, void* dk, void* dv,
    void* stats, void* dk_part, void* dv_part, int batch, int ng, int nq,
    int dim, int heads, int seg, int lc, int rc, int max_mem, int G, int tk,
    int rows_per_block, int col_chunk, int drop_on, unsigned long long seed,
    unsigned threshold, float inv_keep, void* stream) {
  Geom g;
  if (!make_geom(&g, batch, ng, nq, dim, heads, seg, lc, rc, max_mem, G, tk,
                 rows_per_block) ||
      col_chunk <= 0 || smem_bytes_dq(g) > 227 * 1024 ||
      smem_bytes_dkv(g) > 227 * 1024 ||
      (kid == nullptr) != (seg_eid == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, inv_keep, drop_on};
  const Gate gate{static_cast<const int*>(kid),
                  static_cast<const int*>(seg_eid)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *st = static_cast<float*>(stats), *kp = static_cast<float*>(dk_part),
        *vp = static_cast<float*>(dv_part);
  SIMULST_DISPATCH(dtype,
                   return gate.kid ? launch_attn_bwd<scalar_t, true>(
                                         q3, k, v, dout, lengths, gate, dq,
                                         dk, dv, st, kp, vp, batch, g,
                                         col_chunk, drop, s)
                                   : launch_attn_bwd<scalar_t, false>(
                                         q3, k, v, dout, lengths, gate, dq,
                                         dk, dv, st, kp, vp, batch, g,
                                         col_chunk, drop, s));
}
