// wgmma_product: bf16 matrix products on Hopper's tensor cores, beside
// common.cuh's fp32 tile_product and with its interface.
//
// C(m, n) = sum_k A(m, k) B(k, n) over the z-th K slice, handed to
// store(m, n, z, value) once per output, A and B bf16 RowMajor /
// Transposed views, the sums in fp32.  The bf16 FFN and linear-res paths
// run their products here (csrc/ffn.cu's tiled forward, csrc/ffn_bwd.cu,
// csrc/ln_ffn_bwd.cu, csrc/linear_res.cu's backward; `product` below
// picks it for two bf16 operands), as the JAX kernels feed bf16 operands
// to the TPU's matrix unit with fp32 accumulation
// (simulst_tpu/ops/ffn_pallas.py, linear_res_pallas.py `jnp.dot(...,
// preferred_element_type=jnp.float32)`), so every epilogue of the store
// functors (bias, activation, both dropout sites, the split-K partials)
// stays as it is.
//
// What bounds it: at the LN-FFN's training shapes (12,288 rows x 256 x
// 2048) 26-65 GFLOP a call, about 0.026-0.065 ms at the H100's 989 TFLOP/s
// of dense bf16, against 0.82 / 2.28 ms for the fp32 CUDA-core products
// over widened bf16 operands.  The design is the one of the card's fast
// products, kept simple:
//  - one 128 x 128 output tile per block (grid tiles_m x tiles_n x K
//    slices), 288 threads: warpgroups 0 and 1 the consumers, 64 output
//    rows each, warp 8 the producer (one thread issues the copies); two
//    blocks per SM (97 KB of shared memory and at most 112 registers a
//    thread each), so that one block's epilogue overlaps the other's
//    products (the FFN's hidden products have K = D = 256: 4 k steps,
//    and an epilogue of erf, Philox and stores over 128 x 128 outputs);
//  - K in steps of 64 (128 bytes of bf16) through a ring of kWgStages
//    stages of A (128 x 64) and B (64 x 128), 32 KB a stage, filled by
//    TMA (cp.async.bulk.tensor, tensor maps built on the host and passed
//    as __grid_constant__ parameters) with 128-byte swizzled tiles, each
//    stage's arrival and release tracked by a pair of mbarriers;
//  - per stage each consumer issues four wgmma.mma_async m64n128k16 (bf16
//    in, fp32 accumulators in registers, 64 a thread), both operands read
//    from shared memory through matrix descriptors.  wgmma reads a 16-bit
//    operand in either major order (the descriptor's transpose bits), so
//    a Transposed view (w2^T, w1^T, xn^T, h^T) is loaded as it lies in
//    device memory: no transpose pass.  A RowMajor A and a Transposed B
//    are K-major (one box of 64 k x 128 rows), a Transposed A and a
//    RowMajor B MN-major (two boxes of 64 rows x 64 k);
//  - the tile's edges (rows past M, columns past N, k past K) arrive as
//    zeros from TMA's out-of-bounds fill, and only outputs inside (M, N)
//    are stored;
//  - the epilogue: a thread holds its outputs in pairs of neighbouring
//    columns (n, n + 1); a store functor with a `pair(m, n, z, v0, v1)`
//    hook stores both columns at once (bf16x2, float2).  Work that reads
//    other tensors per output (the backwards' hidden gradient) is not
//    put here: at wgmma_product's 16 consumer warps an SM it costs more
//    than the product (PERF.md), so it runs as a pass of its own
//    (ffn.cuh `launch_hidden_grad`) over an fp32 product.
// A K slice is a multiple of kWgBK long (the tiles never straddle two
// slices); a split-K caller's slices may therefore be fewer than it asked
// for, and the partials of the missing ones must be zero (the wrappers'
// partial buffers are).  The tensor cores sum a product's terms in their
// own order, so the bits differ from tile_product's fmaf chains (the
// products agree within bf16 tolerance, not bit for bit), but not between
// runs: there are no atomics, and each split's partial is summed by its
// caller in a fixed order.  Every operand must start on a 16-byte boundary
// with a leading dimension a multiple of 8; wgmma_product returns
// cudaErrorInvalidValue otherwise.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <utility>

#include "common.cuh"

namespace simulst {

constexpr int kWgBM = 128;     // output rows per block: two warpgroups of 64
constexpr int kWgBN = 128;     // output columns per block: m64n128k16
constexpr int kWgBK = 64;      // k per stage: one 128-byte swizzle row
constexpr int kWgStages = 3;
constexpr int kWgConsumers = 256;           // two consumer warpgroups
constexpr int kWgThreads = kWgConsumers + 32;   // + the producer warp
constexpr int kWgBlocksPerSm = 2;
constexpr int kWgBox = 64 * 64 * 2;         // one 64 x 64 bf16 box: 8 KB
constexpr int kWgOperand = 2 * kWgBox;      // an operand's stage: 16 KB
constexpr int kWgStage = 2 * kWgOperand;    // A and B: 32 KB
constexpr int kWgSmem = kWgStages * kWgStage + 1024;   // + the alignment

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the producer's arrival, expecting `bytes` from the copies it issues
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of `map` at coordinates (c0 innermost, c1) into dst, its bytes
// reported to bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A wgmma matrix descriptor of a 128-byte swizzled tile at shared address
// `addr` (1024-byte aligned at its tile's start): lbo the byte stride
// between 64-element atoms along M / N (MN-major; 16, unused, K-major), sbo
// the byte stride between groups of 8 rows (K-major) or 8 k (MN-major)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A B for one m64n128k16 step: kTA / kTB 1 where A / B is MN-major
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// ---------------------------------------------------------------------------
// the product
// ---------------------------------------------------------------------------
template <class Store>
struct WgProblem {
  int M, N, K, k_chunk, tiles_m, tiles_n;
  Store store;
};

// the store functor's optional epilogue hook (see above)
template <class S, class = void>
struct WgPairs : std::false_type {};
template <class S>
struct WgPairs<S, decltype(void(std::declval<const S&>().pair(
                      0, 0, 0, 0.f, 0.f)))> : std::true_type {};

// kAK: A is K-major (a RowMajor view), else MN-major (Transposed); kBK: B
// is K-major (a Transposed view), else MN-major (RowMajor)
template <bool kAK, bool kBK, class Store>
__global__ void __launch_bounds__(kWgThreads, kWgBlocksPerSm)
    wgmma_product_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         WgProblem<Store> p) {
  extern __shared__ uint8_t wg_raw[];
  __shared__ __align__(8) uint64_t full[kWgStages], empty[kWgStages];
  // the swizzle is a function of the shared address: tiles start on
  // 1024-byte boundaries of it
  uint8_t* const ring = wg_raw + ((1024 - (smem_addr(wg_raw) & 1023)) & 1023);
  const int tn = blockIdx.x % p.tiles_n;
  const int tm = blockIdx.x / p.tiles_n % p.tiles_m;
  const int z = blockIdx.x / (p.tiles_n * p.tiles_m);
  const int m0 = tm * kWgBM, n0 = tn * kWgBN;
  const int k_begin = z * p.k_chunk;
  const int k_end = min(p.K, k_begin + p.k_chunk);
  const int steps = (k_end - k_begin + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWgConsumers) {
    // the producer: one thread keeps the ring full
    if (threadIdx.x == kWgConsumers) {
      for (int t = 0; t < steps; ++t) {
        const int s = t % kWgStages;
        if (t >= kWgStages) mbar_wait(&empty[s], (t / kWgStages - 1) & 1);
        mbar_expect_tx(&full[s], kWgStage);
        uint8_t* a = ring + s * kWgStage;
        uint8_t* b = a + kWgOperand;
        const int k0 = k_begin + t * kWgBK;
        if (kAK) {
          tma_load(a, &map_a, k0, m0, &full[s]);
        } else {
          tma_load(a, &map_a, m0, k0, &full[s]);
          tma_load(a + kWgBox, &map_a, m0 + 64, k0, &full[s]);
        }
        if (kBK) {
          tma_load(b, &map_b, k0, n0, &full[s]);
        } else {
          tma_load(b, &map_b, n0, k0, &full[s]);
          tma_load(b + kWgBox, &map_b, n0 + 64, k0, &full[s]);
        }
      }
    }
    return;
  }

  // a consumer: warpgroup c owns output rows m0 + 64 c .. + 63
  const int c = threadIdx.x / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = 0; t < steps; ++t) {
    const int s = t % kWgStages;
    mbar_wait(&full[s], (t / kWgStages) & 1);
    const uint32_t a = smem_addr(ring + s * kWgStage) + c * kWgBox;
    const uint32_t b = smem_addr(ring + s * kWgStage + kWgOperand);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      // 16 k: 32 bytes along a K-major row, 16 rows of 128 bytes MN-major
      const uint64_t da = wg_desc(a + (kAK ? 32 * kk : 2048 * kk),
                                  kAK ? 16 : kWgBox, 1024);
      const uint64_t db = wg_desc(b + (kBK ? 32 * kk : 2048 * kk),
                                  kBK ? 16 : kWgBox, 1024);
      wgmma_m64n128k16<kAK ? 0 : 1, kBK ? 0 : 1>(acc, da, db);
    }
    wg_commit();
    wg_wait_all();
    mbar_arrive(&empty[s]);
  }

  // accumulators 2 q and 2 q + 1 of lane l in warp w: row 16 w + l / 4 + 8
  // (q % 2), columns 8 (q / 2) + 2 (l % 4) and the next
  const int w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int row0 = m0 + 64 * c + 16 * w + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int m = row0 + 8 * (q % 2), n = col0 + 8 * (q / 2);
    const float v0 = acc[2 * q], v1 = acc[2 * q + 1];
    if (m >= p.M || n >= p.N) continue;
    if constexpr (WgPairs<Store>::value) {
      if (n + 1 < p.N) {
        p.store.pair(m, n, z, v0, v1);
        continue;
      }
    }
    p.store(m, n, z, v0);
    if (n + 1 < p.N) p.store(m, n + 1, z, v1);
  }
}

using TensorMapEncode = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no link
// against libcuda); null if the driver lacks it
inline TensorMapEncode tensor_map_encode() {
  static const TensorMapEncode fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncode>(f)
               : nullptr;
  }();
  return fn;
}

// a 2-D bf16 tensor map of `outer` rows of `inner` elements at p (row
// stride ld elements), boxes of 64 x box_outer, 128-byte swizzle, zeros
// out of bounds
inline bool wg_tensor_map(CUtensorMap* map, const __nv_bfloat16* p, int ld,
                          int inner, int outer, int box_outer) {
  const TensorMapEncode encode = tensor_map_encode();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(p) % 16 != 0 ||
      ld % 8 != 0 || ld < inner)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64u, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<__nv_bfloat16*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C = A B over `splits` K slices (each a multiple of kWgBK long) in one
// launch, A and B bf16 RowMajor / Transposed views; returns
// cudaGetLastError(), or cudaErrorInvalidValue for an operand TMA cannot
// read
template <class A, class B, class Store>
cudaError_t wgmma_product(int M, int N, int K, int splits, A a, B b,
                          Store store, cudaStream_t stream) {
  static_assert(std::is_same<typename TileOperand<A>::type,
                             __nv_bfloat16>::value &&
                    std::is_same<typename TileOperand<B>::type,
                                 __nv_bfloat16>::value,
                "wgmma_product takes bf16 operands");
  constexpr bool kAK = TileOperand<A>::kRowMajor;
  constexpr bool kBK = !TileOperand<B>::kRowMajor;
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  const bool ok =
      (kAK ? wg_tensor_map(&map_a, a.p, a.ld, K, M, kWgBM)
           : wg_tensor_map(&map_a, a.p, a.ld, M, K, 64)) &&
      (kBK ? wg_tensor_map(&map_b, b.p, b.ld, K, N, kWgBN)
           : wg_tensor_map(&map_b, b.p, b.ld, N, K, 64));
  if (!ok) return cudaErrorInvalidValue;
  const int k_chunk = ceil_div(ceil_div(K, splits), kWgBK) * kWgBK;
  const WgProblem<Store> p{M, N, K, k_chunk, ceil_div(M, kWgBM),
                           ceil_div(N, kWgBN), store};
  auto kernel = wgmma_product_kernel<kAK, kBK, Store>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (e == cudaSuccess)   // room for kWgBlocksPerSm blocks an SM
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return e;
  kernel<<<p.tiles_m * p.tiles_n * ceil_div(K, k_chunk), kWgThreads, kWgSmem,
           stream>>>(map_a, map_b, p);
  return cudaGetLastError();
}

// C = A B as the port's products take it: two bf16 operands on the tensor
// cores (wgmma_product), any other pair on tile_product (kBN and kStaged
// as its), so that one launch code serves fp32 and bf16 (the FFN forward
// and both FFN backwards, the linear-res backward)
template <int kBN, bool kStaged = false, class A, class B, class Store>
cudaError_t product(int M, int N, int K, int splits, A a, B b, Store store,
                    cudaStream_t s) {
  using TA = typename TileOperand<A>::type;
  using TB = typename TileOperand<B>::type;
  if constexpr (std::is_same<TA, __nv_bfloat16>::value &&
                std::is_same<TB, __nv_bfloat16>::value)
    return wgmma_product(M, N, K, splits, a, b, store, s);
  else
    return tile_product<kBN, kStaged>(M, N, K, splits, a, b, store, s);
}

}  // namespace simulst
