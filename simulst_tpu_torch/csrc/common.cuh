// Shared helpers for the simulst_tpu_torch kernels (sm_90a, plain C ABI).
//
// Every kernel reads fp32 or bf16 activations, converts to fp32 on load and
// accumulates in fp32.  `round_to<T>` rounds an fp32 value through T where
// the JAX package casts an intermediate to the activation dtype, so the
// bf16 kernels and their plain PyTorch versions round at the same places.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace simulst {

// dtype codes passed from Python (ops/_build.py DTYPE_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// two neighbouring values of T at p (8-byte aligned for fp32, 4 for bf16)
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// exact GELU, torch.nn.GELU's default: 0.5 u (1 + erf(u / sqrt 2))
__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.7071067811865476f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// cp.async from global to shared memory: 16 or 4 bytes, zero-filled when
// `valid` is false (src is then not read, but must be a mapped address).
__device__ __forceinline__ void async_copy16(float* dst, const void* src,
                                             bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void async_copy4(float* dst, const void* src,
                                            bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// ---------------------------------------------------------------------------
// dropout masks: Philox4x32-10 keyed by (seed, element offset)
// ---------------------------------------------------------------------------
// Counter (offset lo, offset hi, stream, 0), key (seed lo, seed hi); the
// first output word is the draw.  ops/philox.py computes the same bits in
// torch, so a kernel and its plain version drop the same elements and a
// backward regenerates its forward's mask.  `stream` separates two masks of
// one call (the FFN's hidden and output dropout).
__device__ __forceinline__ unsigned philox_bits(unsigned long long seed,
                                                unsigned long long offset,
                                                unsigned stream) {
  unsigned c0 = (unsigned)offset, c1 = (unsigned)(offset >> 32), c2 = stream,
           c3 = 0u;
  unsigned k0 = (unsigned)seed, k1 = (unsigned)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

// One dropout site of a call: the multiplier is 1/keep where the draw is
// below `threshold` (= round(keep * 2^32)), 0 where it is dropped, and 1
// everywhere when the site is off.
struct Dropout {
  unsigned long long seed;
  unsigned threshold;
  float inv_keep;
  int on;

  __device__ __forceinline__ float scale(unsigned long long offset,
                                         unsigned stream) const {
    if (!on) return 1.f;
    return philox_bits(seed, offset, stream) < threshold ? inv_keep : 0.f;
  }
};

// The dropout offset of element i of a row-major array `cols` wide whose
// first `real` columns hold a (rows, real) tensor zero-padded to `cols`
// (the wrappers pad widths the kernels do not take): row * real + column,
// the unpadded tensor's offset, so that a padded call drops what the
// unpadded plain version drops; i itself when nothing is padded.  A padded
// column's offset is another element's, which does not matter: its value
// is zero.  For the elementwise kernels; the products' store functors,
// which know the row and column, compute row * real + column themselves
// (a 64-bit division there costs the surrounding tile its registers).
__device__ __forceinline__ unsigned long long unpadded_offset(size_t i,
                                                              int cols,
                                                              int real) {
  return real == cols ? i : (i / cols) * real + i % cols;
}

// ---------------------------------------------------------------------------
// operands and partial stores of the tiled products
// ---------------------------------------------------------------------------
// A weight gradient's K (rows) axis is cut into slices whose length is a
// multiple of this step; each slice's partial is summed apart, then the
// slices in order, so the slices fix the gradient's bits
// (ops/ffn.py:k_splits picks their count).
constexpr int kSliceStep = 32;

// element (r, c) of a row-major matrix with leading dimension ld
template <typename T>
struct RowMajor {
  const T* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return to_f32(p[(size_t)r * ld + c]);
  }
};

// element (r, c) of the transpose of a row-major matrix: p[c][r]
template <typename T>
struct Transposed {
  const T* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return to_f32(p[(size_t)c * ld + r]);
  }
};

// fp32 partial of split z at p[z * split_stride + offset + m * ld + n];
// Caller, a tag type, names the product's caller in the kernel's name, so
// that a profile tells the callers of one template apart
template <class Caller>
struct PartialStore {
  float* p;
  size_t split_stride;
  size_t offset;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, int z,
                                             float v) const {
    p[(size_t)z * split_stride + offset + (size_t)m * ld + n] = v;
  }
};

// ---------------------------------------------------------------------------
// tile_product: fp32 tiled matrix products for Hopper's CUDA cores
// ---------------------------------------------------------------------------
// C(m, n) = sum_k A(m, k) B(k, n) over the z-th K slice, handed to
// store(m, n, z, value) once per output, so that transposes, dropout
// multipliers and epilogues cost no extra pass.  Each output is acc = 0,
// then acc = fmaf(A(m, k), B(k, n), acc) for k ascending through its slice
// (k_chunk a multiple of kSliceStep), with zeros past its end: the bits
// depend on the slices and on nothing else, whatever the tiles.  The feed:
//  - a 128 x kBN output tile per block (kBN 128: 256 threads; 64: 128
//    threads), 8 x 8 outputs per thread in four 4 x 4 quadrants, so that a
//    k step reads 2 float4 of A and 2 of B from shared memory for 64 FMAs;
//  - K in steps of kTileBK through a ring of kTileStages shared tiles, both
//    operands k-major ([k][row], rows padded by 4 floats, which keeps the
//    float4 reads aligned and the transposed stores at two-way bank
//    conflicts): the loads of step t + kTileStages - 1 are in flight while
//    step t computes;
//  - 16-byte global loads: an fp32 operand whose row index is contiguous
//    goes by cp.async straight into its tile; one whose k index is
//    contiguous, and any bf16 operand (8-byte loads of 4 values, widened to
//    fp32 exactly), goes through registers: loaded before the step's
//    products and stored (transposed where k is contiguous) after them;
//  - with kStaged, the tile reaches the store functor through shared
//    memory, so that its per-output reads and writes of device memory
//    coalesce (worth its barriers only for a heavy functor);
//  - registers capped for two blocks of 256 threads per SM, or three of
//    128 (tile_min_blocks).
// A and B are RowMajor / Transposed views, whose layout picks the path.
// Every pointer must be 16-byte aligned and every leading dimension a
// multiple of 4, an operand loaded by rows (Transposed A, RowMajor B) must
// have a multiple of 4 rows, and K must be a multiple of 4 where an operand
// is loaded along k; tile_product returns cudaErrorInvalidValue otherwise.
constexpr int kTileBM = 128;
constexpr int kTileBK = 16;
constexpr int kTileStages = 2;
constexpr int kTilePad = 4;

__host__ __device__ constexpr int tile_threads(int bn) {
  return (kTileBM / 8) * (bn / 8);
}

template <int kBN>
constexpr int tile_smem_bytes() {
  return kTileStages * (kTileBM + kBN + 2 * kTilePad) * kTileBK *
         (int)sizeof(float);
}

template <class F>
struct TileOperand;
template <typename T>
struct TileOperand<RowMajor<T>> {
  using type = T;
  static constexpr bool kRowMajor = true;
};
template <typename T>
struct TileOperand<Transposed<T>> {
  using type = T;
  static constexpr bool kRowMajor = false;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// four values of T at src into fp32 dst (16-byte aligned): fp32 by a
// 16-byte cp.async (the caller commits and waits), bf16 through registers,
// widened exactly; zeros when !ok (src is then not read, but must be a
// mapped address)
template <typename T>
__device__ __forceinline__ void stage4(float* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) == sizeof(float)) {
    async_copy16(dst, src, ok);
  } else {
    *reinterpret_cast<float4*>(dst) =
        ok ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One operand's part of a kRows x kTileBK tile, in chunks of 4 values per
// thread: element (i, k) (i its output row or column) lies at p[i ld + k]
// when kKFast, else at p[k ld + i], and goes to s[k (kRows + kTilePad) + i];
// zeros where i >= rows or k >= k_end.
template <int kRows, int kThreads, bool kKFast, typename T>
struct TileFeed {
  static constexpr int kLd = kRows + kTilePad;
  static constexpr int kChunks = kRows * kTileBK / 4 / kThreads;
  static constexpr bool kAsync = !kKFast && sizeof(T) == sizeof(float);
  static_assert(kChunks * kThreads * 4 == kRows * kTileBK, "whole chunks");
  float4 r[kChunks];

  static __device__ __forceinline__ void coords(int q, int& i, int& k) {
    const int idx = (int)threadIdx.x + q * kThreads;
    if (kKFast) {
      i = idx / (kTileBK / 4);
      k = idx % (kTileBK / 4) * 4;
    } else {
      k = idx / (kRows / 4);
      i = idx % (kRows / 4) * 4;
    }
  }

  __device__ __forceinline__ void load(const T* p, int ld, int rows, int i0,
                                       int k0, int k_end, float* s) {
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      int i, k;
      coords(q, i, k);
      const bool ok = i0 + i < rows && k0 + k < k_end;
      const T* src = kKFast ? p + (size_t)(i0 + i) * ld + k0 + k
                            : p + (size_t)(k0 + k) * ld + i0 + i;
      if constexpr (kAsync)
        async_copy16(s + k * kLd + i, ok ? src : p, ok);
      else
        r[q] = ok ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // the register path's second half: write what load() read into tile s
  __device__ __forceinline__ void store(float* s) const {
    if constexpr (!kAsync) {
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        int i, k;
        coords(q, i, k);
        if (kKFast) {
          s[(k + 0) * kLd + i] = r[q].x;
          s[(k + 1) * kLd + i] = r[q].y;
          s[(k + 2) * kLd + i] = r[q].z;
          s[(k + 3) * kLd + i] = r[q].w;
        } else {
          *reinterpret_cast<float4*>(s + k * kLd + i) = r[q];
        }
      }
    }
  }
};

template <class A, class B, class Store>
struct TileProblem {
  using OpA = TileOperand<A>;
  using OpB = TileOperand<B>;
  int M, N, K, k_chunk, tiles_m, tiles_n, blocks;
  bool ok;
  A a;
  B b;
  Store store;
};

// the second problem of a one-problem launch
struct TileNone {
  int blocks = 0;
  bool ok = true;
};

template <class F>
bool tile_operand_ok(const F& f, bool by_rows, int rows, int K) {
  return reinterpret_cast<size_t>(f.p) % 16 == 0 && f.ld % 4 == 0 &&
         (by_rows ? rows % 4 == 0 : K % 4 == 0);
}

// C = A B over `splits` K slices of k_chunk, a multiple of kSliceStep
template <int kBN, class A, class B, class Store>
TileProblem<A, B, Store> tile_problem(int M, int N, int K, int splits, A a,
                                      B b, Store store) {
  const int k_chunk = ceil_div(ceil_div(K, splits), kSliceStep) * kSliceStep;
  const int tm = ceil_div(M, kTileBM), tn = ceil_div(N, kBN);
  const bool ok = M > 0 && N > 0 && K > 0 && splits > 0 &&
                  tile_operand_ok(a, !TileOperand<A>::kRowMajor, M, K) &&
                  tile_operand_ok(b, TileOperand<B>::kRowMajor, N, K);
  return {M, N, K, k_chunk, tm, tn, ok ? tm * tn * ceil_div(K, k_chunk) : 0,
          ok, a, b, store};
}

template <int kBN, bool kStaged, class P>
__device__ __forceinline__ void tile_block(const P& p, int bid,
                                           float* smem) {
  constexpr int kThreads = tile_threads(kBN);
  using OpA = typename P::OpA;
  using OpB = typename P::OpB;
  TileFeed<kTileBM, kThreads, OpA::kRowMajor, typename OpA::type> fa;
  TileFeed<kBN, kThreads, !OpB::kRowMajor, typename OpB::type> fb;
  constexpr int kALd = kTileBM + kTilePad, kBLd = kBN + kTilePad;
  constexpr int kStage = (kALd + kBLd) * kTileBK;

  const int tn = bid % p.tiles_n;
  const int tm = bid / p.tiles_n % p.tiles_m;
  const int z = bid / (p.tiles_n * p.tiles_m);
  const int m0 = tm * kTileBM, n0 = tn * kBN;
  const int k_begin = z * p.k_chunk;
  const int k_end = min(p.K, k_begin + p.k_chunk);
  const int steps = (k_end - k_begin + kTileBK - 1) / kTileBK;

  // warps of 4 x 8 threads; thread (ty, tx) owns rows 4 ty + {0..3} and
  // 64 + 4 ty + {0..3}, columns 4 tx + {0..3} and kBN / 2 + 4 tx + {0..3}
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = warp / (kBN / 64) * 4 + lane / 8;
  const int tx = warp % (kBN / 64) * 8 + lane % 8;

  auto load = [&](int step) {
    float* s = smem + step % kTileStages * kStage;
    const int k0 = k_begin + step * kTileBK;
    fa.load(p.a.p, p.a.ld, p.M, m0, k0, k_end, s);
    fb.load(p.b.p, p.b.ld, p.N, n0, k0, k_end, s + kALd * kTileBK);
  };
  auto store = [&](int step) {
    float* s = smem + step % kTileStages * kStage;
    fa.store(s);
    fb.store(s + kALd * kTileBK);
  };

  float acc[8][8] = {};
#pragma unroll
  for (int step = 0; step < kTileStages - 1; ++step) {
    if (step < steps) {
      load(step);
      store(step);
    }
    async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    async_wait<kTileStages - 2>();
    __syncthreads();   // step's tile is in; step - 1's is free
    const int next = step + kTileStages - 1;
    if (next < steps) load(next);
    async_commit();
    const float* as = smem + step % kTileStages * kStage;
    const float* bs = as + kALd * kTileBK;
#pragma unroll
    for (int k = 0; k < kTileBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kALd + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(
          as + k * kALd + kTileBM / 2 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kBLd + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(
          bs + k * kBLd + kBN / 2 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (next < steps) store(next);
  }
  if constexpr (!kStaged) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? 4 * ty + i : kTileBM / 2 + 4 * ty + i - 4);
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + (j < 4 ? 4 * tx + j : kBN / 2 + 4 * tx + j - 4);
        if (n < p.N) p.store(m, n, z, acc[i][j]);
      }
    }
    return;
  }
  // kStaged: the tile passes through the ring's memory in two halves of 64
  // rows, so that neighbouring threads store neighbouring columns
  constexpr int kHalf = kTileBM / 2, kELd = kBN + kTilePad;
  static_assert(kHalf * kELd <= kTileStages * kStage, "a half tile fits");
  async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __syncthreads();   // the ring, or the previous half, has been read
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * h + i;
      float* row = smem + (4 * ty + i) * kELd;
      *reinterpret_cast<float4*>(row + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(row + kBN / 2 + 4 * tx) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    __syncthreads();
    const int mh = m0 + h * kHalf;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kHalf * kBN; idx += kThreads) {
      const int m = mh + idx / kBN, n = n0 + idx % kBN;
      if (m < p.M && n < p.N)
        p.store(m, n, z, smem[idx / kBN * kELd + idx % kBN]);
    }
  }
}

// blocks per SM that the register budget must allow: two of 256 threads
// (128 x 128 tiles) or three of 128 (128 x 64), at most 128 or 170
// registers a thread
__host__ __device__ constexpr int tile_min_blocks(int bn) {
  return bn == 128 ? 2 : 3;
}

// blocks [0, p0.blocks) compute p0's tiles, the rest p1's
template <int kBN, bool kStaged, class P0, class P1>
__global__ void __launch_bounds__(tile_threads(kBN), tile_min_blocks(kBN))
    tile_product_kernel(P0 p0, P1 p1) {
  extern __shared__ __align__(16) float tile_smem[];
  const int bid = blockIdx.x;
  if (bid < p0.blocks) {
    tile_block<kBN, kStaged>(p0, bid, tile_smem);
  } else {
    if constexpr (!std::is_same<P1, TileNone>::value)
      tile_block<kBN, kStaged>(p1, bid - p0.blocks, tile_smem);
  }
}

template <int kBN, bool kStaged, class P0, class P1>
cudaError_t tile_launch(const P0& p0, const P1& p1, cudaStream_t stream) {
  static_assert(tile_smem_bytes<kBN>() <= 48 * 1024,
                "the ring needs no opt-in to more shared memory");
  if (!p0.ok || !p1.ok) return cudaErrorInvalidValue;
  tile_product_kernel<kBN, kStaged>
      <<<p0.blocks + p1.blocks, tile_threads(kBN), tile_smem_bytes<kBN>(),
         stream>>>(p0, p1);
  return cudaGetLastError();
}

// C = A B over `splits` K slices in one launch; returns cudaGetLastError().
// kStaged for a store functor that reads and writes device memory per
// output (HiddenGradStore): the tile reaches it through shared memory.
template <int kBN, bool kStaged = false, class A, class B, class Store>
cudaError_t tile_product(int M, int N, int K, int splits, A a, B b,
                         Store store, cudaStream_t stream) {
  return tile_launch<kBN, kStaged>(
      tile_problem<kBN>(M, N, K, splits, a, b, store), TileNone{}, stream);
}

// two products (from tile_problem) in one launch, so that two small grids
// fill the card together
template <int kBN, class P0, class P1>
cudaError_t tile_product_pair(const P0& p0, const P1& p1,
                              cudaStream_t stream) {
  return tile_launch<kBN, false>(p0, p1, stream);
}

// Column sums of a row-major (rows, cols) matrix of S (fp32 or bf16,
// summed in fp32), one partial per row split: out[z * split_stride +
// offset + c] = sum of rows in split z.  Block (32, kLanes): lane y of a
// column adds rows y, y + kLanes, ... of the split, then the kLanes sums
// in order.  Grid (ceil(cols / 32), splits).  kLanes 8 is the fp32
// paths' (it fixes their bits); the bf16 LN-FFN backward takes 32, four
// times the rows in flight.
template <int kLanes, typename S>
__global__ void __launch_bounds__(32 * kLanes)
    colsum_partial_kernel(const S* __restrict__ src, int rows, int cols,
                          int rows_per_split, float* __restrict__ out,
                          size_t split_stride, size_t offset) {
  __shared__ float part[kLanes][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  float s = 0.f;
  if (c < cols)
    for (int r = r_begin + threadIdx.y; r < r_end; r += kLanes)
      s += to_f32(src[(size_t)r * cols + c]);
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kLanes; ++i) t += part[i][threadIdx.x];
    out[(size_t)blockIdx.y * split_stride + offset + c] = t;
  }
}

template <int kLanes = 8, typename S>
cudaError_t colsum_partial(const S* src, int rows, int cols, int splits,
                           float* out, size_t split_stride, size_t offset,
                           cudaStream_t stream) {
  const int per = ceil_div(rows, splits);
  colsum_partial_kernel<kLanes, S>
      <<<dim3(ceil_div(cols, 32), splits), dim3(32, kLanes), 0, stream>>>(
          src, rows, cols, per, out, split_stride, offset);
  return cudaGetLastError();
}

// out[i] = sum over z of partial[z * len + i], i < len
static __global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  int splits, size_t len,
                                  float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * len + i];
  out[i] = s;
}

static inline cudaError_t sum_splits(const float* partial, int splits, size_t len,
                              float* out, cudaStream_t stream) {
  sum_splits_kernel<<<(unsigned)((len + 255) / 256), 256, 0, stream>>>(
      partial, splits, len, out);
  return cudaGetLastError();
}

// g[i] = round_T(dy[i] * mult) with mult the dropout multiplier of element
// i (offset unpadded_offset(i, cols, real_cols), `stream`) on gated rows
// (row % period < res_rows, or every row when period == 0) and 1
// elsewhere, stored as G (fp32, or T itself where the products read T).
// The upstream gradient of a dropout site, materialised once for the
// products that read it.
template <typename T, typename G>
__global__ void drop_grad_kernel(const T* __restrict__ dy,
                                 G* __restrict__ g, int rows, int cols,
                                 int real_cols, Dropout drop, unsigned stream,
                                 int period, int res_rows) {
  const size_t total = (size_t)rows * cols;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int row = (int)(i / cols);
  const bool gated = period == 0 || row % period < res_rows;
  const float m =
      gated ? drop.scale(unpadded_offset(i, cols, real_cols), stream) : 1.f;
  g[i] = from_f32<G>(round_to<T>(to_f32(dy[i]) * m));
}

template <typename T, typename G = float>
cudaError_t drop_grad(const void* dy, G* g, int rows, int cols,
                      int real_cols, Dropout drop, unsigned stream,
                      int period, int res_rows, cudaStream_t s) {
  const size_t total = (size_t)rows * cols;
  drop_grad_kernel<T, G><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(dy), g, rows, cols, real_cols, drop, stream,
      period, res_rows);
  return cudaGetLastError();
}

}  // namespace simulst

// Return from the enclosing function if a CUDA call reported an error.
#define SIMULST_TRY(expr)                                 \
  do {                                                    \
    const cudaError_t simulst_err_ = (expr);              \
    if (simulst_err_ != cudaSuccess) return (int)simulst_err_; \
  } while (0)

// Dispatch a templated launch statement on the Python dtype code (variadic:
// the statement may hold commas); unknown codes report
// cudaErrorInvalidValue to the caller.
#define SIMULST_DISPATCH(dtype, ...)                     \
  do {                                                   \
    if ((dtype) == simulst::kF32) {                      \
      using scalar_t = float;                            \
      __VA_ARGS__;                                       \
    } else if ((dtype) == simulst::kBF16) {              \
      using scalar_t = __nv_bfloat16;                    \
      __VA_ARGS__;                                       \
    } else {                                             \
      return static_cast<int>(cudaErrorInvalidValue);    \
    }                                                    \
  } while (0)
