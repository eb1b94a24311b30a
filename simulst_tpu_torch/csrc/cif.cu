// CIF integrate-and-fire for Hopper.
//
// Replaces the Pallas kernel simulst_tpu/ops/cif_pallas.py
// `_forward_pallas` (_kernel), the forward of `cif_integrate`.  Given the
// fp32 cumulative sums csum_s of the integration weights alpha_s (computed
// by the caller with torch.cumsum, as the JAX package computes them outside
// its kernel) and cprev_s = csum_s - alpha_s (one rounding, __fsub_rn, the
// same as torch's subtraction), each output bucket t of width beta
// integrates the source frames that overlap it:
//
//   portion[s, t] = max(min(csum_s, (t + 1) beta) - max(cprev_s, t beta), 0)
//   out[b, t, c]  = sum_s portion[s, t] x[b, s, c]
//   delays[b, t]  = sum_s portion[s, t] (s + 1) / beta
//
// The bucket edges are written with __fmul_rn / __fadd_rn (t beta, then
// + beta), as the plain version and JAX compute them, so that nvcc
// contracts neither into a fused multiply-add; the portion is the same
// min / max / subtract.  Each sum is one fmaf chain over ascending s.
//
// Design: the TPU kernel built each 128-bucket portion tile in VMEM and
// fed it to the MXU as a dense (S x 128)^T (S x C) product.  That product
// is almost all zeros: a source frame overlaps one or two buckets.  Here a
// block owns kBuckets consecutive buckets of one example and up to 256
// channels, 4 per thread.  It first finds, in one parallel pass, the
// frames whose span [cprev_s, csum_s] overlaps its buckets: each thread
// loads kScan frames' csum and alpha at once and tests them; a frame whose
// span ends at or before the block's first bucket, or starts at or after
// its last, has a zero portion in every bucket of the block, and so has a
// frame of zero weight (cprev_s = csum_s), such as padding.  The test
// compares each frame with the block's edges and does not assume that csum
// is monotone (an fp32 cumsum on the card need not be, to the last ulp).
// __ballot_sync and a prefix over the warps compact the hits into a list
// in shared memory, in ascending s.  The block then walks only that list:
// it stages the listed frames' x rows in shared memory with cp.async (16
// bytes per thread where C is a multiple of 4 and x is 16-byte aligned,
// 4 bytes otherwise), kStage rows in flight together, and each thread
// accumulates portion x for its 4 channels and every bucket in fp32
// registers.  A skipped frame adds an exact 0 for finite x.  The skip is
// as fine as the block's 4 buckets and each frame's weight: a frame that
// overlaps only a neighbouring bucket, or has zero weight, which a block
// of 8 buckets testing spans only would add as fmaf(0, x, acc) = acc, is
// skipped here.  That is the same sum for finite x; where that x is inf or
// NaN the coarser skip gives NaN and this one not.  Zero-weight padding
// at the end of a row would otherwise pile into the block that holds the
// row's total, and that one block would set the kernel's time.
//
// What bounds it on the H100: the bytes.  At the training shape (B 32,
// S 256, C 256, T 72) x is 8.4 MB and out 2.4 MB, about 3 us at 3.35
// TB/s; the non-zero portions need some 5 MFLOP.  The grid is (B, T / 4,
// C / 256): 576 blocks of 64 threads there, all resident at once, each
// with two dependent global round trips (the scan, then its x rows), and
// every x row read by the one or two blocks whose buckets it overlaps.
#include "common.cuh"

namespace {

constexpr int kBuckets = 4;       // output buckets per block
constexpr int kVec = 4;           // channels per thread
constexpr int kMaxThreads = 64;   // so at most 256 channels per block
constexpr int kScan = 8;          // frames per thread per scan pass
constexpr int kList = kScan * kMaxThreads;
constexpr int kStage = 32;        // x rows staged at once
constexpr int kMaxWarps = kMaxThreads / 32;

__global__ void __launch_bounds__(kMaxThreads)
cif_integrate_kernel(const float* __restrict__ x,
                     const float* __restrict__ csum,
                     const float* __restrict__ alpha,
                     float* __restrict__ out, float* __restrict__ delays,
                     int s_len, int t_len, int c_len, float beta, int vec) {
  __shared__ int l_s[kList];
  __shared__ float l_cs[kList];
  __shared__ float l_cp[kList];
  __shared__ int warp_hits[kScan][kMaxWarps];
  __shared__ __align__(16) float xs[kStage * kMaxThreads * kVec];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * kBuckets;
  const int nb = min(kBuckets, t_len - t0);
  const int c0 = (blockIdx.z * blockDim.x + tid) * kVec;

  float lo[kBuckets], hi[kBuckets];
#pragma unroll
  for (int j = 0; j < kBuckets; ++j) {
    lo[j] = __fmul_rn(static_cast<float>(t0 + j), beta);
    hi[j] = __fadd_rn(lo[j], beta);
  }
  const float block_lo = lo[0];
  // hi[nb - 1], computed apart so that hi stays in registers
  const float block_hi =
      __fadd_rn(__fmul_rn(static_cast<float>(t0 + nb - 1), beta), beta);

  const size_t row0 = static_cast<size_t>(b) * s_len;
  const float* csb = csum + row0;
  const float* ab = alpha + row0;
  float* my_xs = xs + tid * kVec;
  const int xs_row = blockDim.x * kVec;

  float acc[kBuckets][kVec], dsum[kBuckets];
#pragma unroll
  for (int j = 0; j < kBuckets; ++j) {
    dsum[j] = 0.f;
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[j][v] = 0.f;
  }

  const unsigned lanes_below = (1u << lane) - 1u;
  for (int s0 = 0; s0 < s_len; s0 += kScan * blockDim.x) {
    // the scan: kScan frames per thread, all loads in flight together
    float cs[kScan], cp[kScan];   // cp holds alpha until the test
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      const int s = s0 + q * blockDim.x + tid;
      cs[q] = s < s_len ? csb[s] : 0.f;
      cp[q] = s < s_len ? ab[s] : 0.f;
    }
    unsigned hits = 0u;
    int rank[kScan];
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      const int s = s0 + q * blockDim.x + tid;
      cp[q] = __fsub_rn(cs[q], cp[q]);
      // min(cs, hi_j) <= cs <= lo_j <= max(cp, lo_j) in every bucket j,
      // or max(cp, lo_j) >= cp >= hi_j >= min(cs, hi_j), or (a frame of
      // zero weight) min(cs, hi_j) <= cs <= cp <= max(cp, lo_j): zero
      // portions
      const bool hit = s < s_len && cs[q] > cp[q] &&
                       !(cs[q] <= block_lo || cp[q] >= block_hi);
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_hits[q][warp] = __popc(ballot);
      rank[q] = __popc(ballot & lanes_below);
      hits |= static_cast<unsigned>(hit) << q;
    }
    __syncthreads();
    // list position: frames in (q, warp, lane) order, i.e. ascending s
    int n_list = 0;
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      int base = n_list;
      for (int w = 0; w < n_warps; ++w) {
        if (w == warp) base = n_list;
        n_list += warp_hits[q][w];
      }
      if (hits >> q & 1u) {
        const int e = base + rank[q];
        l_s[e] = s0 + q * blockDim.x + tid;
        l_cs[e] = cs[q];
        l_cp[e] = cp[q];
      }
    }
    __syncthreads();

    // the walk over the listed frames, kStage x rows staged at a time; each
    // thread stages and reads back only its own channels
    for (int e0 = 0; e0 < n_list; e0 += kStage) {
      const int ne = min(kStage, n_list - e0);
#pragma unroll 4
      for (int e = 0; e < ne; ++e) {
        const float* src = x + (row0 + l_s[e0 + e]) * c_len + c0;
        float* dst = my_xs + e * xs_row;
        if (vec) {
          simulst::async_copy16(dst, c0 < c_len ? src : x, c0 < c_len);
        } else {
#pragma unroll
          for (int v = 0; v < kVec; ++v)
            simulst::async_copy4(dst + v, c0 + v < c_len ? src + v : x,
                                 c0 + v < c_len);
        }
      }
      simulst::async_commit();
      simulst::async_wait<0>();
#pragma unroll 4
      for (int e = 0; e < ne; ++e) {
        const float4 xv = *reinterpret_cast<const float4*>(my_xs + e * xs_row);
        const float xa[kVec] = {xv.x, xv.y, xv.z, xv.w};
        const float c_s = l_cs[e0 + e];
        const float c_p = l_cp[e0 + e];
        const float pos = static_cast<float>(l_s[e0 + e] + 1);
#pragma unroll
        for (int j = 0; j < kBuckets; ++j) {
          const float p = fmaxf(
              __fsub_rn(fminf(c_s, hi[j]), fmaxf(c_p, lo[j])), 0.f);
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[j][v] = fmaf(p, xa[v], acc[j][v]);
          dsum[j] = fmaf(p, pos, dsum[j]);
        }
      }
      __syncthreads();   // the staged rows are read before the next copies
    }
  }

  // loops over kBuckets (unrolled), not nb, keep acc and dsum in registers
#pragma unroll
  for (int j = 0; j < kBuckets; ++j) {
    if (j >= nb) continue;
    float* o = out + (static_cast<size_t>(b) * t_len + t0 + j) * c_len + c0;
    if (vec) {
      if (c0 < c_len)
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (c0 + v < c_len) o[v] = acc[j][v];
    }
  }
  if (blockIdx.z == 0 && tid == 0) {
#pragma unroll
    for (int j = 0; j < kBuckets; ++j)
      if (j < nb)
        delays[static_cast<size_t>(b) * t_len + t0 + j] = dsum[j] / beta;
  }
}

}  // namespace

// x: (b, s, c) fp32; csum = cumsum(alpha), alpha: (b, s) fp32; out:
// (b, t, c) fp32; delays: (b, t) fp32; all contiguous.  Returns a
// cudaError_t.
extern "C" int simulst_cif_integrate(const void* x, const void* csum,
                                     const void* alpha, void* out,
                                     void* delays, int b, int s, int t, int c,
                                     float beta, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0 || c <= 0 || !(beta > 0.f) ||
      t > 65535 * kBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_thread = simulst::ceil_div(c, kVec);
  const int threads =
      simulst::ceil_div(per_thread < kMaxThreads ? per_thread : kMaxThreads,
                        32) * 32;
  // 16-byte copies need 16-byte rows: C a multiple of 4 and x and out
  // 16-byte aligned
  const int vec = c % kVec == 0 &&
                  reinterpret_cast<size_t>(x) % 16 == 0 &&
                  reinterpret_cast<size_t>(out) % 16 == 0;
  const dim3 grid(b, simulst::ceil_div(t, kBuckets),
                  simulst::ceil_div(c, threads * kVec));
  cif_integrate_kernel<<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(csum),
      static_cast<const float*>(alpha), static_cast<float*>(out),
      static_cast<float*>(delays), s, t, c, beta, vec);
  return static_cast<int>(cudaGetLastError());
}
