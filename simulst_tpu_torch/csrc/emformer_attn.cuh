// What csrc/emformer_attn.cu (the grouped attention's forward and its
// backward on the CUDA cores) and csrc/emformer_attn_bwd.cu (the bf16
// backward on the tensor cores) share: the geometry of the group context
// and of a segment's work unit, the example-id gate, the units' row and
// column maps and visibility, and the ordered sum of the groups' dK / dV
// partials into key rows.  Each source builds as its own translation unit.
#pragma once

#include "common.cuh"

namespace {

using simulst::Dropout;
using simulst::from_f32;
using simulst::round_to;
using simulst::to_f32;

constexpr int kMaxHeadDim = 128;   // staged head dims; the wide kernels above
constexpr int kHeadDimStep = 8;
constexpr int kMaxAccFeatures = 64;  // the dK / dV walks' features a pass
constexpr int kMinAccFeatures = 16;  // ... at the least
constexpr int kRowTile = 32;       // unit rows per product tile
constexpr int kColTile = 64;       // unit columns per product tile
constexpr int kSmemLimit = 227 * 1024;

struct Geom {
  int ng, nq, dim, heads, seg, lc, rc, max_mem, G, n, U, tk, m_slots, ctx;
  // a unit: R = rc + seg + 1 rows and C = max_mem + rc + lc + seg columns,
  // padded to whole tiles (Rp, Cp); sld the row stride of its scores
  int R, C, Rp, Cp, sld;
  // the head dim, the staged head dim (64 or 128) and the features of the
  // backward's dK / dV accumulators; the real head dim of a call padded to
  // hd, whose 1 / sqrt scales the scores
  int hd, shd, F, hd_real;
};

// staged row stride (floats) of a kHD-wide row
__host__ __device__ constexpr int staged_ld(int khd) { return khd + 4; }

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

// ... of a backward block: Q, dO, K, V, three (row, column) matrices, the
// group's dK and dV accumulators (F features a slot), and three ints per
// column
size_t bwd_smem_bytes(const Geom& g, int F) {
  const size_t ld = staged_ld(g.shd);
  return sizeof(float) * (2 * (size_t)g.Rp * ld + 2 * (size_t)g.Cp * ld +
                          3 * (size_t)g.Rp * g.sld + 2 * (size_t)g.ctx * F) +
         3 * sizeof(int) * (size_t)g.Cp;
}

// the backward's accumulator features: the largest of kMaxAccFeatures,
// its half, ..., kMinAccFeatures with which a block fits, else
// kMinAccFeatures
int acc_features(const Geom& g) {
  int F = kMaxAccFeatures;
  while (F > kMinAccFeatures && bwd_smem_bytes(g, F) > (size_t)kSmemLimit)
    F /= 2;
  return F;
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

// group-context slot of column j (< C) of segment i's unit
__device__ __forceinline__ int unit_slot(const Geom& g, int i, int j) {
  if (j < g.max_mem) return i + j;
  j -= g.max_mem;
  if (j < g.rc) return g.m_slots + i * g.rc + j;
  return g.m_slots + g.G * g.rc + i * g.seg + (j - g.rc);
}

// group query row of row r (< R) of segment i's unit
__device__ __forceinline__ int unit_row(const Geom& g, int i, int r) {
  if (r < g.rc) return i * g.rc + r;
  if (r < g.rc + g.seg) return g.G * g.rc + i * g.seg + (r - g.rc);
  return g.G * (g.rc + g.seg) + i;
}

// Per column j < Cp of segment i's unit: its group-context slot (-1:
// padding), its key row (-1: none, staged as zeros) and whether the
// segment's rows see it: memory slots that exist, the own rc block,
// utterance frames that exist below the length, and with the gate only
// keys of the segment's example.
// whether the rows of segment i's unit see its column j (< C), of slot
// `slot` and key row `row`: memory slots that exist, the own rc block,
// utterance frames that exist below the length, and with the gate only
// keys of the segment's example (qid, `Gate::query_id`)
template <bool kGated>
__device__ __forceinline__ bool column_seen(const Geom& g, const Gate& gate,
                                            int b, int grp, int j, int slot,
                                            int row, int length, int qid) {
  const int utt0 = g.m_slots + g.G * g.rc;
  const int frame0 = grp * g.G * g.seg - g.lc;  // frame of utterance slot 0
  const bool own_rc = j >= g.max_mem && j < g.max_mem + g.rc;
  bool ok = own_rc || (row >= 0 && (j < g.max_mem ||
                                    frame0 + (slot - utt0) < length));
  if (kGated) ok = ok && gate.same(g, b, row, qid);
  return ok;
}

// Per column j < Cp of segment i's unit: its group-context slot (-1:
// padding), its key row (-1: none, staged as zeros) and whether the
// segment's rows see it (column_seen).
template <bool kGated>
__device__ void unit_columns(const Geom& g, const Gate& gate, int b, int grp,
                             int i, int length, int* col_slot, int* col_row,
                             int* col_ok) {
  const int qid = kGated ? gate.query_id(g, b, grp, i) : 0;
  for (int j = threadIdx.x; j < g.Cp; j += blockDim.x) {
    int slot = -1, row = -1;
    bool ok = false;
    if (j < g.C) {
      slot = unit_slot(g, i, j);
      row = slot_to_row(g, grp, slot);
      ok = column_seen<kGated>(g, gate, b, grp, j, slot, row, length, qid);
    }
    col_slot[j] = slot;
    col_row[j] = row;
    col_ok[j] = ok;
  }
}

// whether unit row r (< R) sees unit column j: the summary row (the last)
// sees no memory slot
__device__ __forceinline__ bool unit_visible(const Geom& g, const int* col_ok,
                                             int r, int j) {
  return col_ok[j] && !(r == g.R - 1 && j < g.max_mem);
}

// the context slot of group grp holding key row j, -1 if none
__device__ __forceinline__ int row_slot(const Geom& g, int grp, int j) {
  const int mem_len = g.n - 1, rc_len = g.n * g.rc;
  if (j < mem_len) {
    const int t = j - (grp * g.G - g.max_mem);
    return t >= 0 && t < g.m_slots ? t : -1;
  }
  if (j < mem_len + rc_len) {
    const int p = j - mem_len;
    return p / (g.G * g.rc) == grp ? g.m_slots + p - grp * g.G * g.rc : -1;
  }
  const int off = (j - mem_len - rc_len) - (grp * g.G * g.seg - g.lc);
  return off >= 0 && off < g.lc + g.G * g.seg
             ? g.m_slots + g.G * g.rc + off
             : -1;
}

// whether slot c of group grp holds a key row that no other group's
// context holds (false where it holds none): the rc slots; the memory
// slots that the neighbouring groups' max_mem + G - 1 slots miss; the
// utterance slots past the lc frames the previous group shares and
// before the lc the next group shares (the first and last groups share
// on one side only)
__device__ __forceinline__ bool slot_exclusive(const Geom& g, int grp,
                                               int c) {
  const int utt0 = g.m_slots + g.G * g.rc;
  if (c < g.m_slots) {
    const int js = grp * g.G - g.max_mem + c;
    return js >= 0 && js <= g.n - 2 &&
           (grp == 0 || js >= grp * g.G - 1) &&
           (grp == g.ng - 1 || js < (grp + 1) * g.G - g.max_mem);
  }
  if (c < utt0) return true;
  const int u = c - utt0, f = grp * g.G * g.seg - g.lc + u;
  return f >= 0 && f < g.U && (grp == 0 || u >= g.lc) &&
         (grp == g.ng - 1 || u < g.G * g.seg);
}

// dk[b, j, :], dv[b, j, :] = sum over groups (in order) of the partial of
// the one context slot of that group holding key row j, if any; with
// shared_only, only the rows that several groups' contexts hold, or none
// (the caller's block kernel wrote the others, `slot_exclusive`).  One
// block of kSumThreads per key row (blockIdx.x = b tk + j), 4 features a
// thread: no 64-bit index arithmetic, and a row the block kernel wrote
// leaves its whole block at once.  dim is a multiple of 4.
constexpr int kSumThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    grouped_attn_dkv_sum_kernel(const float* __restrict__ dk_part,
                                const float* __restrict__ dv_part,
                                T* __restrict__ dk, T* __restrict__ dv,
                                Geom g, bool shared_only) {
  const int j = blockIdx.x % g.tk, b = blockIdx.x / g.tk;
  if (shared_only) {
    int groups = 0;
    for (int grp = 0; grp < g.ng; ++grp) groups += row_slot(g, grp, j) >= 0;
    if (groups == 1) return;
  }
  const size_t out = (size_t)blockIdx.x * g.dim;
  for (int d = 4 * threadIdx.x; d < g.dim; d += 4 * kSumThreads) {
    float sk[4] = {0.f, 0.f, 0.f, 0.f}, sv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int grp = 0; grp < g.ng; ++grp) {
      const int c = row_slot(g, grp, j);
      if (c < 0) continue;
      const size_t po = (((size_t)b * g.ng + grp) * g.ctx + c) * g.dim + d;
      const float4 pk = *reinterpret_cast<const float4*>(dk_part + po);
      const float4 pv = *reinterpret_cast<const float4*>(dv_part + po);
      sk[0] += pk.x;
      sk[1] += pk.y;
      sk[2] += pk.z;
      sk[3] += pk.w;
      sv[0] += pv.x;
      sv[1] += pv.y;
      sv[2] += pv.z;
      sv[3] += pv.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[out + d + e] = from_f32<T>(sk[e]);
      dv[out + d + e] = from_f32<T>(sv[e]);
    }
  }
}

// unit_cols: the columns of a segment's unit, max_mem + rc + lc + seg
bool make_geom(Geom* g, int batch, int ng, int nq, int dim, int heads,
               int hd_real, int seg, int lc, int rc, int max_mem, int G,
               int tk, int unit_cols) {
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
  g->R = rc + seg + 1;
  g->C = unit_cols;
  g->Rp = simulst::ceil_div(g->R, kRowTile) * kRowTile;
  g->Cp = simulst::ceil_div(g->C, kColTile) * kColTile;
  g->sld = g->Cp + 4;
  g->hd = heads > 0 && dim % heads == 0 ? dim / heads : 0;
  g->shd = g->hd <= 64 ? 64 : 128;
  g->F = acc_features(*g);
  g->hd_real = hd_real;
  return batch > 0 && g->hd > 0 && g->hd % kHeadDimStep == 0 &&
         hd_real <= g->hd && hd_real > g->hd - kHeadDimStep && hd_real > 0 &&
         rc > 0 && seg > 0 && max_mem >= 0 &&
         lc >= 0 && nq == G * (rc + seg + 1) &&
         tk == (g->n - 1) + g->n * rc + g->U &&
         unit_cols == max_mem + rc + lc + seg;
}

}  // namespace
