// CIF integrate-and-fire for Hopper.
//
// Replaces the Pallas kernel simulst_tpu/ops/cif_pallas.py
// `_forward_pallas` (_kernel), the forward of `cif_integrate`.  Given the
// fp32 cumulative sums of the integration weights, csum_s and cprev_s =
// csum_s - alpha_s (computed by the caller, outside the kernel, as the JAX
// package does), each output bucket t of width beta integrates the source
// frames that overlap it:
//
//   portion[s, t] = max(min(csum_s, (t + 1) beta) - max(cprev_s, t beta), 0)
//   out[b, t, c]  = sum_s portion[s, t] x[b, s, c]
//   delays[b, t]  = sum_s portion[s, t] (s + 1) / beta
//
// The bucket edges are written with __fmul_rn / __fadd_rn (t beta, then
// + beta), as the plain version and JAX compute them, so that nvcc
// contracts neither into a fused multiply-add; the portion is the same
// min / max / subtract.  Only the order of the sums over s differs.
//
// Design: the TPU kernel built each 128-bucket portion tile in VMEM and
// fed it to the MXU as a dense (S x 128)^T (S x C) product.  That product
// is almost all zeros: a source frame overlaps one or two buckets.  Here a
// block owns kBuckets consecutive buckets of one example and one thread a
// channel (blocks of C threads, up to 256; wider C loops over groups).  The
// block stages its row's csum and cprev in shared memory, kSTile frames at
// a time (any S), and walks s in order.  The portion depends only on (s, t),
// so every test is uniform across the block: a frame whose span ends at or
// before the block's first bucket, or starts at or after its last, has a
// zero portion in every bucket of the block and is skipped without touching
// x; for the others each thread reads x[s, c] once (neighbouring threads on
// neighbouring addresses) and accumulates portion x in fp32 registers.
// The skip test compares each frame with the block's edges and does not
// assume that csum is monotone: an fp32 cumsum on the card need not be, to
// the last ulp.
//
// What bounds it on the H100: the bytes.  At the training shape (B 32,
// S 256, C 256, T 65) x is 8.4 MB and out 2.1 MB, about 3 us at 3.35 TB/s;
// the non-zero portions need some 5 MFLOP.  The kernel reads x once per
// bucket block for the frames that overlap it (a frame on a block edge is
// read by both), and csum / cprev once per block; its cost is the walk over
// all S frames per block, S / kSTile barriers and a few compares per frame.
// A binary search over a monotone csum for each block's first frame, and
// tensor cores, are later work.
#include "common.cuh"

namespace {

constexpr int kBuckets = 8;       // output buckets per block
constexpr int kSTile = 1024;      // frames of csum / cprev staged per pass
constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
cif_integrate_kernel(const float* __restrict__ x,
                     const float* __restrict__ csum,
                     const float* __restrict__ cprev,
                     float* __restrict__ out, float* __restrict__ delays,
                     int s_len, int t_len, int c_len, float beta) {
  __shared__ float s_cs[kSTile];
  __shared__ float s_cp[kSTile];
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * kBuckets;
  const int nb = min(kBuckets, t_len - t0);

  float lo[kBuckets], hi[kBuckets];
#pragma unroll
  for (int j = 0; j < kBuckets; ++j) {
    lo[j] = __fmul_rn(static_cast<float>(t0 + j), beta);
    hi[j] = __fadd_rn(lo[j], beta);
  }
  const float block_lo = lo[0];
  const float block_hi = hi[nb - 1];

  const float* xb = x + static_cast<size_t>(b) * s_len * c_len;
  const float* csb = csum + static_cast<size_t>(b) * s_len;
  const float* cpb = cprev + static_cast<size_t>(b) * s_len;

  for (int c0 = 0; c0 < c_len; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    float acc[kBuckets], dsum[kBuckets];
#pragma unroll
    for (int j = 0; j < kBuckets; ++j) acc[j] = dsum[j] = 0.f;

    for (int s0 = 0; s0 < s_len; s0 += kSTile) {
      const int n = min(kSTile, s_len - s0);
      __syncthreads();   // the previous tile has been read by every thread
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        s_cs[i] = csb[s0 + i];
        s_cp[i] = cpb[s0 + i];
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        const float cs = s_cs[i];
        const float cp = s_cp[i];
        // min(cs, hi_j) <= cs <= lo_j <= max(cp, lo_j) in every bucket j,
        // or max(cp, lo_j) >= cp >= hi_j >= min(cs, hi_j): zero portions
        if (cs <= block_lo || cp >= block_hi) continue;
        const int s = s0 + i;
        const float xv = c < c_len ? xb[static_cast<size_t>(s) * c_len + c]
                                   : 0.f;
        const float pos = static_cast<float>(s + 1);
#pragma unroll
        for (int j = 0; j < kBuckets; ++j) {
          const float p = fmaxf(
              __fsub_rn(fminf(cs, hi[j]), fmaxf(cp, lo[j])), 0.f);
          acc[j] = fmaf(p, xv, acc[j]);
          dsum[j] = fmaf(p, pos, dsum[j]);
        }
      }
    }
    if (c < c_len) {
      for (int j = 0; j < nb; ++j)
        out[(static_cast<size_t>(b) * t_len + t0 + j) * c_len + c] = acc[j];
    }
    if (c0 == 0 && threadIdx.x == 0) {
      for (int j = 0; j < nb; ++j)
        delays[static_cast<size_t>(b) * t_len + t0 + j] = dsum[j] / beta;
    }
  }
}

}  // namespace

// x: (b, s, c) fp32; csum, cprev: (b, s) fp32; out: (b, t, c) fp32;
// delays: (b, t) fp32; all contiguous.  Returns a cudaError_t.
extern "C" int simulst_cif_integrate(const void* x, const void* csum,
                                     const void* cprev, void* out,
                                     void* delays, int b, int s, int t, int c,
                                     float beta, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0 || c <= 0 || !(beta > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = simulst::ceil_div(c < kMaxThreads ? c : kMaxThreads,
                                        32) * 32;
  const dim3 grid(b, (t + kBuckets - 1) / kBuckets);
  cif_integrate_kernel<<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(csum),
      static_cast<const float*>(cprev), static_cast<float*>(out),
      static_cast<float*>(delays), s, t, c, beta);
  return static_cast<int>(cudaGetLastError());
}
