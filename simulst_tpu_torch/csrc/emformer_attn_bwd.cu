// The grouped Emformer attention's backward in bf16 on Hopper's tensor
// cores: (dq, dk, dv) of csrc/emformer_attn.cu's forward, bf16 operands
// through mma.sync m16n8k16 with fp32 sums.
//
// Replaces, for bf16 activations, the Pallas kernel
// simulst_tpu/ops/emformer_attn_pallas.py `_bwd_kernel` (called from
// `_bwd_call`), with its attention dropout and its has_eid gate.  fp32
// and head dims above 128 keep emformer_attn.cu's backward, which sums in
// the order of a whole-context computation so that fp32 keeps its bits;
// bf16 is held to its plain version at bf16 tolerance, and this kernel
// drops that ordering machinery (the fp32 `probs` scratch of each unit's
// ds and round(p m), 26 MB at the train shape, and the three walks that
// add them in the group's row order).
//
// What bounds it on the H100: bytes.  At asr-train's shape (q3 (32, 2,
// 200, 256), 4 heads of 64) the five products over the visible pairs are
// about 0.7 GFLOP, under a microsecond at the dense bf16 rate, and reading
// q3, dout, k, v once and writing dq, dk, dv takes about 0.014 ms at 3.35
// TB/s.  The CUDA-core backward took 0.39 ms: its block (200 KB of shared
// memory, one per SM) widened every staged row to fp32 and multiplied on
// the CUDA cores, and a third of its time went to the row softmax.
//
// The design:
//  - the work unit stays one segment of one (batch, group, head): its
//    R = rc + seg + 1 query rows (25 at s2t_emformer_s's geometry, one
//    32-row tile) and the C = max_mem + rc + lc + seg context slots they
//    may see (61, one 64-column tile), with emformer_attn.cuh's maps,
//    visibility and gate.  mma.sync rather than wgmma: wgmma takes 64-row
//    tiles, and a group-wide form (200 rows x 236 slots) would multiply
//    about four times the visible pairs, its rows of one segment spread
//    over three runs of the group's row order;
//  - one block of 8 warps per (batch, group, head) walks its G units in
//    order.  A unit's Q, dO, K and V rows are staged as bf16, no
//    widening, by 16-byte cp.async into two stages: the next unit's
//    copies are in flight while this one computes.  Rows and columns
//    outside the unit or the sequence, and features past the head dim,
//    are staged as zeros;
//  - S = Q K^T and dP = dO V^T: warp w takes 16 rows (w % 2) and a
//    quarter of the columns (w / 2), operands by ldmatrix.  The row
//    statistics come in one barrier: each warp's max, sum of exp and sum
//    of exp * dp m over its quarter, combined across the four quarters,
//    rescaled by their maxima, give the row's max, sum and Delta = sum(p
//    dp m) at once (the forward saves no statistics);
//  - ds = round(p (dp m - Delta) / sqrt(hd)) and round(p m) go to shared
//    memory as bf16 (the plain version's rounding points), then dQ = dS K
//    (K by ldmatrix.trans), dK = dS^T Q and dV = (P m)^T dO (both
//    operands by ldmatrix.trans);
//  - dK and dV add up in fp32 in shared memory for the slots still open:
//    the memory slots for the whole group, the utterance slots in a ring
//    of lc + seg (a unit covers lc + seg consecutive ones, so a slot is
//    complete after the last unit that covers it, whose thread writes it
//    to the group's partials and clears the ring entry), and the unit's
//    own rc slots at once.  Within a unit one thread owns each (slot,
//    feature) and the units run one after another: no atomics, the same
//    bits every run.  A complete slot whose key row no other group's
//    context holds (the rc slots, most utterance slots) goes straight
//    into dk / dv; the others (the lc frames and the memory slots that
//    neighbouring groups share) to the group's (B, ng, ctx, dim) fp32
//    partials, and the ordered sum kernel adds those rows only, in group
//    order (`slot_exclusive`, `grouped_attn_dkv_sum_kernel`'s
//    shared_only);
//  - shared memory at asr-train's geometry: 100 KB, two blocks (16
//    warps) an SM, so the 256 blocks of the train shape take one wave.
// Rows are padded to 32 and columns to 64 or 128; ops/emformer_attn.py
// `bwd_plan` sends here the bf16 shapes whose columns fit 128 and whose
// block fits the card's shared memory (`tc_smem_bytes`), the others to
// emformer_attn.cu's backward.
#include <math.h>

#include "emformer_attn.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;   // 8 warps
constexpr int kTcMaxCols = 128;   // the unit's padded columns, at most
constexpr int kTcRows = 32;       // unit rows per pass of the scores

// row stride (elements) of a staged row or a dS / P m row n wide: 16
// bytes of padding, so that the 8 rows an ldmatrix reads fall in 8
// distinct bank quads
__host__ __device__ constexpr int tc_ld(int n) { return n + 8; }

// Shared memory of a block: two stages of Q and dO (Rp rows) and K and V
// (Cp rows), bf16; dS and round(P m) (Rp x Cp, bf16); the row statistics
// of a pass (4 column quarters x kTcRows rows x 3 floats); the dK and dV
// accumulators of the open slots (m_slots + lc + seg rows, fp32); two
// stages of four ints per column (the column tables).  ops/emformer_attn.py
// `tc_smem_bytes` computes the same bytes.
size_t tc_smem_bytes(const Geom& g) {
  const size_t ldh = tc_ld(g.shd), ldc = tc_ld(g.Cp);
  const size_t open = (size_t)g.m_slots + g.lc + g.seg;
  return sizeof(bf16) * (2 * (2 * (size_t)g.Rp + 2 * (size_t)g.Cp) * ldh +
                         2 * (size_t)g.Rp * ldc) +
         sizeof(float) * (4 * kTcRows * 3 + 2 * open * ldh) +
         sizeof(int) * 2 * 4 * (size_t)g.Cp;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices, row i of matrix j from the address of lane
// 8 j + i; .trans hands each thread the transposed fragments
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b for one m16n8k16 tile: a the 16 x 16 bf16 A fragment, (b0, b1)
// the 16 x 8 B fragment, fp32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// n rows of kHD bf16 features into dst (row stride tc_ld(kHD)): row r from
// src + off(r), zeros where off(r) < 0 and in the features from hd on (a
// multiple of 8)
template <int kHD, class Off>
__device__ __forceinline__ void stage_rows_bf16(bf16* dst,
                                                const bf16* __restrict__ src,
                                                int n, int hd, Off off) {
  constexpr int kChunks = kHD / 8, kLd = tc_ld(kHD);
  for (int idx = threadIdx.x; idx < n * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const long long o = ch * 8 < hd ? off(r) : -1;
    cp16(dst + r * kLd + ch * 8, o >= 0 ? src + o + ch * 8 : src, o >= 0);
  }
}

// One block per (batch, group, head): blockIdx.x = (b ng + grp) heads +
// head.  kHD the staged head dim (64 or 128), kCp the unit's padded
// columns (64 or 128).
template <bool kGated, int kHD, int kCp>
__global__ void __launch_bounds__(kTcThreads, 2)
    grouped_attn_bwd_tc_kernel(const bf16* __restrict__ q3,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const int* __restrict__ lengths, Gate gate,
                               bf16* __restrict__ dq,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               float* __restrict__ dk_part,
                               float* __restrict__ dv_part, Geom g,
                               Dropout drop) {
  constexpr int kLdH = tc_ld(kHD), kLdC = tc_ld(kCp);
  constexpr int kQuarter = kCp / 4;   // a warp's columns of the scores
  constexpr int kNT = kQuarter / 8;   // ... in n8 tiles
  extern __shared__ float4 smem4[];
  bf16* const stages = reinterpret_cast<bf16*>(smem4);
  const int stage_elems = (2 * g.Rp + 2 * kCp) * kLdH;
  bf16* const dss = stages + 2 * stage_elems;   // [Rp][kLdC] ds
  bf16* const pms = dss + g.Rp * kLdC;        // [Rp][kLdC] round(p m)
  float* const red =
      reinterpret_cast<float*>(pms + g.Rp * kLdC);  // [4][kTcRows][3]
  const int open = g.m_slots + g.lc + g.seg;
  float* const dk_acc = red + 4 * kTcRows * 3;      // [open][kLdH]
  float* const dv_acc = dk_acc + open * kLdH;       // [open][kLdH]
  int* const cols = reinterpret_cast<int*>(dv_acc + open * kLdH);
  // cols, per stage and column of the unit: its slot, whether its rows
  // see it, its accumulator row and its output (the column tables below)

  const int head = blockIdx.x % g.heads;
  const int grp = (blockIdx.x / g.heads) % g.ng;
  const int b = blockIdx.x / (g.heads * g.ng);
  const int length = lengths[b];
  const int hd = g.hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // fragment row, column pair
  const size_t q_base = ((size_t)b * g.ng + grp) * g.nq * g.dim + head * hd;
  const size_t kv_base = (size_t)b * g.tk * g.dim + head * hd;
  const size_t row_base =
      (((size_t)b * g.ng + grp) * g.heads + head) * g.nq;
  const size_t part_base =
      ((size_t)b * g.ng + grp) * g.ctx * g.dim + head * hd;
  const float scale = 1.0f / sqrtf((float)g.hd_real);
  const int utt0 = g.m_slots + g.G * g.rc;
  const int ring_slots = g.lc + g.seg;

  for (int idx = threadIdx.x; idx < 2 * open * kLdH; idx += kTcThreads)
    dk_acc[idx] = 0.f;   // and dv_acc, which follows it
  // where a complete slot goes: its key row (>= 0) of dk and dv where no
  // other group's context holds the row, else -2 - slot, the group's
  // partials for the ordered sum
  const auto out_of = [&](int slot) {
    return slot_exclusive(g, grp, slot) ? slot_to_row(g, grp, slot)
                                        : -2 - slot;
  };
  // features f, f + 1 of a complete slot to `out` (out_of)
  const auto put = [&](int out, int f, float k0, float k1, float v0,
                       float v1) {
    if (out >= 0) {
      const size_t o = kv_base + (size_t)out * g.dim + f;
      simulst::store_pair(dk + o, k0, k1);
      simulst::store_pair(dv + o, v0, v1);
    } else {
      const size_t po = part_base + (size_t)(-2 - out) * g.dim + f;
      simulst::store_pair(dk_part + po, k0, k1);
      simulst::store_pair(dv_part + po, v0, v1);
    }
  };

  // the unit's column tables, kCp threads on each half: the slot and
  // whether the unit's rows see it (column_seen), and each column's
  // accumulator row (a memory slot's own; an utterance slot's ring row;
  // -1 for the unit's rc slots and the padding) and its output where this
  // unit completes its slot (out_of; -1 where the slot stays open, and
  // for the padding), so that the dK / dV epilogue does no index
  // arithmetic
  const auto columns = [&](int i, int s) {
    int* c = cols + s * 4 * kCp;
    const int j = threadIdx.x % kCp;
    const int slot = j < g.C ? unit_slot(g, i, j) : -1;
    if (threadIdx.x < kCp) {
      const int qid = kGated ? gate.query_id(g, b, grp, i) : 0;
      c[j] = slot;
      c[kCp + j] = slot >= 0 && column_seen<kGated>(
                                    g, gate, b, grp, j, slot,
                                    slot_to_row(g, grp, slot), length, qid);
    } else if (threadIdx.x < 2 * kCp) {
      int acc = -1, out = -1;
      if (j < g.max_mem) {
        acc = slot;
      } else if (j < g.max_mem + g.rc) {
        out = out_of(slot);
      } else if (j < g.C) {
        const int u = slot - utt0;
        acc = g.m_slots + u % ring_slots;
        if (i == min(u / g.seg, g.G - 1)) out = out_of(slot);   // its last
      }
      c[2 * kCp + j] = acc;
      c[3 * kCp + j] = out;
    }
  };
  // the unit's rows into stage s, by cp.async (K and V rows from the
  // slot maps themselves, so that no barrier waits for the tables)
  const auto stage = [&](int i, int s) {
    bf16* qs = stages + s * stage_elems;
    const auto q_off = [&](int r) -> long long {
      return r < g.R
                 ? (long long)(q_base + (size_t)unit_row(g, i, r) * g.dim)
                 : -1;
    };
    const auto kv_off = [&](int j) -> long long {
      const int row = j < g.C ? slot_to_row(g, grp, unit_slot(g, i, j)) : -1;
      return row >= 0 ? (long long)(kv_base + (size_t)row * g.dim) : -1;
    };
    stage_rows_bf16<kHD>(qs, q3, g.Rp, hd, q_off);
    stage_rows_bf16<kHD>(qs + g.Rp * kLdH, dout, g.Rp, hd, q_off);
    stage_rows_bf16<kHD>(qs + 2 * g.Rp * kLdH, k, kCp, hd, kv_off);
    stage_rows_bf16<kHD>(qs + (2 * g.Rp + kCp) * kLdH, v, kCp, hd, kv_off);
    simulst::async_commit();
  };

  columns(0, 0);
  stage(0, 0);
  for (int i = 0; i < g.G; ++i) {
    const int s = i & 1;
    // unit i's rows and tables are in, and unit i - 1 is done with stage
    // s ^ 1, its tables, dS and the ring
    simulst::async_wait<0>();
    __syncthreads();
    if (i + 1 < g.G) {   // the next unit's rows fly while this one runs
      columns(i + 1, s ^ 1);
      stage(i + 1, s ^ 1);
    }
    const bf16* qs = stages + s * stage_elems;
    const bf16* dos = qs + g.Rp * kLdH;
    const bf16* ks = dos + g.Rp * kLdH;
    const bf16* vs = ks + kCp * kLdH;
    const int* col_slot = cols + s * 4 * kCp;
    const int* col_ok = col_slot + kCp;
    const int* col_acc = col_slot + 2 * kCp;
    const int* col_out = col_slot + 3 * kCp;

    // S and dP of 32 rows a pass: warp w's rows r0 + 16 (w % 2) .. + 15,
    // columns c0 = kQuarter (w / 2) ..; a thread's fragment holds rows
    // r0 + gq + 8 h (h = 0, 1), columns c0 + 8 nt + 2 tq + (e & 1)
    const int c0 = (warp >> 1) * kQuarter;
    for (int rp = 0; rp < g.Rp; rp += kTcRows) {
      const int r0 = rp + 16 * (warp & 1);
      float sc[kNT][4], dp[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHD; kk += 16) {
        unsigned aq[4], ao[4];
        const int arow = (r0 + (lane & 15)) * kLdH + kk + (lane >> 4) * 8;
        ldsm4(aq, qs + arow);
        ldsm4(ao, dos + arow);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          const int brow = (c0 + 16 * np + (lane & 7) + ((lane >> 4) << 3)) *
                               kLdH +
                           kk + ((lane >> 3) & 1) * 8;
          unsigned bk[4], bv[4];
          ldsm4(bk, ks + brow);
          ldsm4(bv, vs + brow);
          mma16816(sc[2 * np], aq, bk[0], bk[1]);
          mma16816(sc[2 * np + 1], aq, bk[2], bk[3]);
          mma16816(dp[2 * np], ao, bv[0], bv[1]);
          mma16816(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
      }

      // the quarter's row max, sum of e = exp(s - max) and sum of e dp m;
      // the dropout multipliers m kept as bits (keep: 1)
      int row[2];
      unsigned long long off[2];
      float mx[2], sum[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row[h] = r0 + gq + 8 * h;
        off[h] = row[h] < g.R
                     ? (row_base + unit_row(g, i, row[h])) * (size_t)g.ctx
                     : 0;
        mx[h] = -INFINITY;
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, j = c0 + 8 * nt + 2 * tq + (e & 1);
          const bool vis = row[h] < g.R && unit_visible(g, col_ok, row[h], j);
          sc[nt][e] = vis ? sc[nt][e] * scale : -INFINITY;
          mx[h] = fmaxf(mx[h], sc[nt][e]);
        }
      unsigned keep = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, j = c0 + 8 * nt + 2 * tq + (e & 1);
          float ex = 0.f, d = 0.f;
          if (sc[nt][e] != -INFINITY) {
            ex = expf(sc[nt][e] - mx[h]);
            const float m = drop.scale(off[h] + col_slot[j], 0);
            if (m != 0.f) keep |= 1u << (4 * nt + e);
            d = dp[nt][e] * m;
          }
          sc[nt][e] = ex;
          dp[nt][e] = d;
          sum[h] += ex;
          t[h] += ex * d;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], o);
          t[h] += __shfl_xor_sync(0xffffffffu, t[h], o);
        }
      float* my_red = red + ((warp >> 1) * kTcRows + 16 * (warp & 1)) * 3;
      if (tq == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* r = my_red + (gq + 8 * h) * 3;
          r[0] = mx[h];
          r[1] = sum[h];
          r[2] = t[h];
        }
      __syncthreads();

      // the row's max M, sum S and Delta over the four quarters; then
      // p = e exp(max - M) / S, ds and round(p m)
      float corr[2], delta[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 16 * (warp & 1) + gq + 8 * h;
        float big = -INFINITY;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          big = fmaxf(big, red[(q * kTcRows + rl) * 3]);
        float ssum = 0.f, tsum = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* r = red + (q * kTcRows + rl) * 3;
          if (r[0] == -INFINITY) continue;
          const float w = expf(r[0] - big);
          ssum += r[1] * w;
          tsum += r[2] * w;
        }
        const bool live = big != -INFINITY;
        const float inv = live ? 1.0f / ssum : 0.f;
        delta[h] = tsum * inv;
        corr[h] = live && mx[h] != -INFINITY ? expf(mx[h] - big) * inv : 0.f;
      }
      const float keep_mult = drop.on ? drop.inv_keep : 1.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ds[2], pd[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * h + c;
            const float p = sc[nt][e] * corr[h];
            ds[c] = p * (dp[nt][e] - delta[h]) * scale;
            pd[c] = (keep >> (4 * nt + e)) & 1u ? p * keep_mult : 0.f;
          }
          const int o = row[h] * kLdC + c0 + 8 * nt + 2 * tq;
          simulst::store_pair(dss + o, ds[0], ds[1]);
          simulst::store_pair(pms + o, pd[0], pd[1]);
        }
      __syncthreads();
    }

    // dQ = dS K: 16 rows x 16 features an item, straight into the
    // segment's dq rows
    const int mtiles = g.Rp / 16;
    for (int item = warp; item < mtiles * (kHD / 16); item += 8) {
      const int m0 = 16 * (item % mtiles), f0 = 16 * (item / mtiles);
      if (f0 >= hd) continue;
      float acc[2][4] = {};
#pragma unroll 4
      for (int kc = 0; kc < kCp; kc += 16) {
        unsigned a[4], bb[4];
        ldsm4(a, dss + (m0 + (lane & 15)) * kLdC + kc + (lane >> 4) * 8);
        ldsm4_t(bb, ks + (kc + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdH +
                        f0 + (lane >> 4) * 8);
        mma16816(acc[0], a, bb[0], bb[1]);
        mma16816(acc[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + gq + 8 * h, f = f0 + 8 * nt + 2 * tq;
          if (r < g.R && f < hd)
            simulst::store_pair(
                dq + q_base + (size_t)unit_row(g, i, r) * g.dim + f,
                acc[nt][2 * h], acc[nt][2 * h + 1]);
        }
    }

    // dK = dS^T Q and dV = (P m)^T dO: 16 columns x 32 features an item,
    // added into the open slots (or written out where complete)
    for (int item = warp; item < (kCp / 16) * (kHD / 32); item += 8) {
      const int n0 = 16 * (item % (kCp / 16)), f0 = 32 * (item / (kCp / 16));
      if (f0 >= hd) continue;
      float ak[4][4] = {}, av[4][4] = {};
      for (int kr = 0; kr < g.Rp; kr += 16) {
        unsigned a_ds[4], a_pm[4];
        const int mi = lane >> 3;
        const int ao = (kr + (lane & 7) + (mi >> 1) * 8) * kLdC + n0 +
                       (mi & 1) * 8;
        ldsm4_t(a_ds, dss + ao);
        ldsm4_t(a_pm, pms + ao);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int bo = (kr + (lane & 7) + (mi & 1) * 8) * kLdH + f0 +
                         16 * np + (mi >> 1) * 8;
          unsigned bq[4], bd[4];
          ldsm4_t(bq, qs + bo);
          ldsm4_t(bd, dos + bo);
          mma16816(ak[2 * np], a_ds, bq[0], bq[1]);
          mma16816(ak[2 * np + 1], a_ds, bq[2], bq[3]);
          mma16816(av[2 * np], a_pm, bd[0], bd[1]);
          mma16816(av[2 * np + 1], a_pm, bd[2], bd[3]);
        }
      }
      // the thread's two columns (h): the accumulated rows added, then
      // an open slot's sums back to its row, a complete one's out (its
      // ring row cleared for the slot that takes it next)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = n0 + gq + 8 * h;
        const int acc = col_acc[j], out = col_out[j];
        float* pk = dk_acc + max(acc, 0) * kLdH + f0 + 2 * tq;
        float* pv = dv_acc + (pk - dk_acc);
        float k2[4][2], v2[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          k2[nt][0] = ak[nt][2 * h];
          k2[nt][1] = ak[nt][2 * h + 1];
          v2[nt][0] = av[nt][2 * h];
          v2[nt][1] = av[nt][2 * h + 1];
          if (acc >= 0 && f0 + 8 * nt < hd) {
            const float2 ok2 = *reinterpret_cast<const float2*>(pk + 8 * nt);
            const float2 ov2 = *reinterpret_cast<const float2*>(pv + 8 * nt);
            k2[nt][0] += ok2.x;
            k2[nt][1] += ok2.y;
            v2[nt][0] += ov2.x;
            v2[nt][1] += ov2.y;
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (f0 + 8 * nt >= hd) continue;
          const int f = f0 + 8 * nt + 2 * tq;
          if (out != -1)
            put(out, f, k2[nt][0], k2[nt][1], v2[nt][0], v2[nt][1]);
          if (acc < 0) continue;
          simulst::store_pair(pk + 8 * nt, out == -1 ? k2[nt][0] : 0.f,
                              out == -1 ? k2[nt][1] : 0.f);
          simulst::store_pair(pv + 8 * nt, out == -1 ? v2[nt][0] : 0.f,
                              out == -1 ? v2[nt][1] : 0.f);
        }
      }
    }
  }
  __syncthreads();   // the last unit's dK / dV are in the memory slots

  // the memory slots, complete (zeros where no unit sees them)
  for (int idx = threadIdx.x; idx < g.m_slots * hd / 2; idx += kTcThreads) {
    const int c = idx / (hd / 2), f = 2 * (idx % (hd / 2));
    const float* pk = dk_acc + c * kLdH + f;
    const float* pv = dv_acc + c * kLdH + f;
    put(out_of(c), f, pk[0], pk[1], pv[0], pv[1]);
  }
}

template <bool kGated, int kHD, int kCp>
int launch_attn_bwd_tc(const void* q3, const void* k, const void* v,
                       const void* dout, const void* lengths, Gate gate,
                       void* dq, void* dk, void* dv, float* dk_part,
                       float* dv_part, int batch, const Geom& g, size_t smem,
                       Dropout drop, cudaStream_t s) {
  const auto kernel = grouped_attn_bwd_tc_kernel<kGated, kHD, kCp>;
  SIMULST_TRY(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  // room for two blocks an SM where they fit
  SIMULST_TRY(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100));
  kernel<<<batch * g.ng * g.heads, kTcThreads, smem, s>>>(
      static_cast<const bf16*>(q3), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const int*>(lengths), gate, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), dk_part, dv_part, g,
      drop);
  SIMULST_TRY(cudaGetLastError());
  grouped_attn_dkv_sum_kernel<bf16><<<batch * g.tk, kSumThreads, 0, s>>>(
      dk_part, dv_part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), g,
      true);
  return (int)cudaGetLastError();
}

// runs the statement with kH bound to the staged head dim and kC to the
// unit's padded columns, both 64 or 128
#define ATTN_TC_DISPATCH(g, ...)                                      \
  do {                                                                \
    if ((g).shd == 64 && (g).Cp == 64) {                              \
      constexpr int kH = 64, kC = 64;                                 \
      __VA_ARGS__;                                                    \
    } else if ((g).shd == 64) {                                       \
      constexpr int kH = 64, kC = 128;                                \
      __VA_ARGS__;                                                    \
    } else if ((g).Cp == 64) {                                        \
      constexpr int kH = 128, kC = 64;                                \
      __VA_ARGS__;                                                    \
    } else {                                                          \
      constexpr int kH = 128, kC = 128;                               \
      __VA_ARGS__;                                                    \
    }                                                                 \
  } while (0)

}  // namespace

// The bf16 backward on the tensor cores: simulst_emformer_attn_bwd's
// arguments, all of bf16, without its dtype and its probs scratch
// (dk_part, dv_part: (batch, ng, ctx, dim) fp32); head dims up to 128,
// unit_cols up to 128 once padded to 64, and smem_bytes =
// ops/emformer_attn.py `tc_smem_bytes` at most 227 KB, else
// cudaErrorInvalidValue.  Two launches: the unit-walking block kernel and
// the ordered sum.  Returns a cudaError_t.
extern "C" int simulst_emformer_attn_bwd_tc(
    const void* q3, const void* k, const void* v, const void* lengths,
    const void* kid, const void* seg_eid, const void* dout, void* dq,
    void* dk, void* dv, void* dk_part, void* dv_part, int batch, int ng,
    int nq, int dim, int heads, int hd_real, int seg, int lc, int rc,
    int max_mem, int G, int tk, int unit_cols, int smem_bytes, int drop_on,
    unsigned long long seed, unsigned threshold, float inv_keep,
    void* stream) {
  Geom g;
  if (!make_geom(&g, batch, ng, nq, dim, heads, hd_real, seg, lc, rc,
                 max_mem, G, tk, unit_cols) ||
      g.hd > kMaxHeadDim || g.Cp > kTcMaxCols ||
      tc_smem_bytes(g) != (size_t)smem_bytes || smem_bytes > kSmemLimit ||
      (kid == nullptr) != (seg_eid == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, inv_keep, drop_on};
  const Gate gate{static_cast<const int*>(kid),
                  static_cast<const int*>(seg_eid)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *kp = static_cast<float*>(dk_part), *vp = static_cast<float*>(dv_part);
  ATTN_TC_DISPATCH(g, return gate.kid
                              ? launch_attn_bwd_tc<true, kH, kC>(
                                    q3, k, v, dout, lengths, gate, dq, dk, dv,
                                    kp, vp, batch, g, smem_bytes, drop, s)
                              : launch_attn_bwd_tc<false, kH, kC>(
                                    q3, k, v, dout, lengths, gate, dq, dk, dv,
                                    kp, vp, batch, g, smem_bytes, drop, s));
}
