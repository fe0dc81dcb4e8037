// Tiled GeMM, C = A @ B, for int32 and float32 inputs.
//
// Replaces the TPU kernel src/repro/kernels/gemm/gemm.py:_gemm_kernel
// (launched by gemm_pallas), which walks a (M/bm, N/bn, K/bk) grid with the
// K axis innermost and sequential, carrying each output tile's sum across
// grid steps in a VMEM accumulator.  Blocks on Hopper run in parallel and in
// no order, so here the K loop runs inside the block: each block owns one
// (BM, BN) output tile, keeps its partial sums in registers, and streams
// (BM, BK) tiles of A and (BK, BN) tiles of B through a ring of STAGES
// shared-memory buffers.
//
// What bounds it on the H100: at large sizes the float path by the FFMA
// rate (no TF32: the float path must match a full-precision product) and
// the int32 path by the INT32 multiply-add rate, half the FFMA rate (Hopper's
// tensor cores have no int32 x int32 product, and int32 values do not fit
// in int8).  The design keeps those units fed:
//
// * register tiles read as vectors.  Each thread owns TM x TN outputs
//   (8 x 8 at the 64 x 128 tiling, 4 x 4 and 2 x 4 at the smaller ones),
//   rows ty*4 + i and columns tx*4 + j in runs of four (split in two
//   halves of the tile where TM or TN is 8).  A sits in shared memory
//   row-major with rows BK + 4 words apart and is read along k, as a
//   float2/int2 (two k-steps of a row) at 8 x 8, where registers are
//   scarce, and as a float4/int4 otherwise; B is row-major and read as a
//   float4/int4 along n: 8 vector loads for 128 multiply-adds at 8 x 8,
//   not the 32 scalar loads of a scalar read.  The padding puts the rows a
//   warp reads at once in distinct banks, and the columns of B are
//   contiguous, so the reads are conflict-free.  At 64 x 128 an SM holds 4
//   blocks for float32 (2048^2 outputs, 512 blocks, run as one wave on
//   132 SMs, at the price of a few spilled registers) and 3 for int32.
//   Shared reads, the 4-byte copies and the number of blocks were what held
//   the first version back; it is still short of the FFMA rate at 2048^3
//   (PERF.md records by how much).
// * 16-byte copies.  The ring is filled with cp.async.cg 16-byte copies
//   (zero-filled past the ragged edges, so nothing is padded in device
//   memory).  A matrix whose rows are not 16-byte aligned (K or N not a
//   multiple of 4, or an unaligned base) takes a 4-byte cp.async a word.
// * split-K for int32.  When the tiling leaves the card idle (256^3 with
//   the 64 x 128 tiling is 8 blocks on 132 SMs), plan_split_k in
//   repro_torch/kernels/gemm/gemm.py cuts K into whole k-tiles across a
//   third grid axis; C is zeroed here with cudaMemsetAsync and every split
//   adds its partial with a 32-bit atomic add.  uint32 addition is exact
//   modulo 2^32, so the bits do not depend on the order.  float32 never
//   splits K: that would break its in-order chain.
//
// Arithmetic: int32 products and sums in uint32_t, so wraparound is defined
// and equals XLA's int32 dot modulo 2^32; cast to int32 at the store.
// float32: one accumulator per output, k = 0 .. K-1 added in order with a
// fused multiply-add (__fmaf_rn), and the last, partial K tile stops at K
// instead of adding zeros, so every tiling, pipeline depth, graph or eager
// launch gives the same bits.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kBK = 16;            // K-tile depth of every tiling
constexpr int kLdA = kBK + 4;      // words between A rows in shared memory

template <typename T>
using Vec4 = typename std::conditional<std::is_same<T, float>::value, float4,
                                       int4>::type;
template <typename T>
using Vec2 = typename std::conditional<std::is_same<T, float>::value, float2,
                                       int2>::type;

template <typename T, int N>
struct VecOf;
template <typename T>
struct VecOf<T, 2> { using type = Vec2<T>; };
template <typename T>
struct VecOf<T, 4> { using type = Vec4<T>; };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool in_bounds) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = in_bounds ? 16 : 0;  // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool in_bounds) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = in_bounds ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mac(float& acc, float a, float b) {
  acc = __fmaf_rn(a, b, acc);
}

__device__ __forceinline__ void mac(uint32_t& acc, int32_t a, int32_t b) {
  acc += static_cast<uint32_t>(a) * static_cast<uint32_t>(b);
}

__device__ __forceinline__ float lane(const float2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ int lane(const int2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ int lane(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void store_out(float* c, float acc) { *c = acc; }
__device__ __forceinline__ void store_out(int32_t* c, uint32_t acc) {
  *c = static_cast<int32_t>(acc);
}

template <int BM, int BN, int TM, int TN>
struct Layout {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kColThreads = BN / TN;
  static constexpr int kRM = TM < 4 ? TM : 4;   // rows in one run
  // k-steps of one A read: 2 (a float2) at 8 x 8, where the fragment of 8
  // rows x 4 k would take 32 registers; 4 (a float4) otherwise
  static constexpr int kKV = TM * TN >= 64 ? 2 : 4;
  // blocks an SM must hold at the 64 x 128 tiling: 4 for float32, so that
  // 2048^2 outputs (512 blocks) run as one wave on 132 SMs (a few
  // registers spill); 3 for int32, which measured faster without spills
  template <typename T>
  static constexpr int min_blocks() {
    return TM * TN < 64 ? 1 : std::is_same<T, float>::value ? 4 : 3;
  }
  // output row of the thread's i-th row, column of its j-th column
  __device__ static int row(int ty, int i) {
    return (i / kRM) * (BM / (TM / kRM)) + ty * kRM + i % kRM;
  }
  __device__ static int col(int tx, int j) {
    return (j / 4) * (BN / (TN / 4)) + tx * 4 + j % 4;
  }
};

// Copy the A tile (rows m0.., cols k0..) to as[BM][kLdA] and the B tile
// (rows k0.., cols n0..) to bs[kBK][BN].
template <typename T, int BM, int BN, int NT>
__device__ __forceinline__ void load_tiles(const T* __restrict__ a,
                                           const T* __restrict__ b, T* as,
                                           T* bs, int m, int n, int k, int m0,
                                           int n0, int k0, bool a_vec,
                                           bool b_vec) {
  if (a_vec) {  // K % 4 == 0: a 4-word run is wholly inside or outside
    for (int idx = threadIdx.x; idx < BM * kBK / 4; idx += NT) {
      const int r = idx / (kBK / 4), c = (idx % (kBK / 4)) * 4;
      const bool ok = m0 + r < m && k0 + c < k;
      const T* src = ok ? a + static_cast<long long>(m0 + r) * k + k0 + c : a;
      cp_async16(as + r * kLdA + c, src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < BM * kBK; idx += NT) {
      const int r = idx / kBK, c = idx % kBK;
      const bool ok = m0 + r < m && k0 + c < k;
      const T* src = ok ? a + static_cast<long long>(m0 + r) * k + k0 + c : a;
      cp_async4(as + r * kLdA + c, src, ok);
    }
  }
  if (b_vec) {  // N % 4 == 0
    for (int idx = threadIdx.x; idx < kBK * BN / 4; idx += NT) {
      const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      const bool ok = k0 + r < k && n0 + c < n;
      const T* src = ok ? b + static_cast<long long>(k0 + r) * n + n0 + c : b;
      cp_async16(bs + r * BN + c, src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBK * BN; idx += NT) {
      const int r = idx / BN, c = idx % BN;
      const bool ok = k0 + r < k && n0 + c < n;
      const T* src = ok ? b + static_cast<long long>(k0 + r) * n + n0 + c : b;
      cp_async4(bs + r * BN + c, src, ok);
    }
  }
}

template <typename T, typename Acc, int BM, int BN, int TM, int TN, int STAGES>
__global__ void __launch_bounds__(
    Layout<BM, BN, TM, TN>::kThreads,
    Layout<BM, BN, TM, TN>::template min_blocks<T>())
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ c, int m, int n, int k, int tiles_per_split,
            bool a_vec, bool b_vec, bool c_vec) {
  using L = Layout<BM, BN, TM, TN>;
  using V = Vec4<T>;
  constexpr int NT = L::kThreads;
  constexpr int kStageWords = BM * kLdA + kBK * BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tx = threadIdx.x % L::kColThreads;
  const int ty = threadIdx.x / L::kColThreads;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (k + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(k_tiles, kt0 + tiles_per_split);
  const int tiles = max(0, kt1 - kt0);

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  // Prologue: the first STAGES - 1 tiles in flight.  Every iteration
  // commits one group, empty or not, so wait_group counts stay aligned.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) {
      T* as = smem + s * kStageWords;
      load_tiles<T, BM, BN, NT>(a, b, as, as + BM * kLdA, m, n, k, m0, n0,
                                (kt0 + s) * kBK, a_vec, b_vec);
    }
    cp_async_commit();
  }

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed
    __syncthreads();              // ... for every thread, and stage t - 1 is free
    const int next = t + STAGES - 1;
    if (next < tiles) {
      T* as = smem + (next % STAGES) * kStageWords;
      load_tiles<T, BM, BN, NT>(a, b, as, as + BM * kLdA, m, n, k, m0, n0,
                                (kt0 + next) * kBK, a_vec, b_vec);
    }
    cp_async_commit();

    const T* as = smem + (t % STAGES) * kStageWords;
    const T* bs = as + BM * kLdA;
    const int depth = min(kBK, k - (kt0 + t) * kBK);
    if (depth == kBK) {
#pragma unroll
      for (int k4 = 0; k4 < kBK; k4 += L::kKV) {
        using VA = typename VecOf<T, L::kKV>::type;
        VA av[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          av[i] = *reinterpret_cast<const VA*>(as + L::row(ty, i) * kLdA + k4);
#pragma unroll
        for (int kk = 0; kk < L::kKV; ++kk) {
          T bv[TN];
#pragma unroll
          for (int j4 = 0; j4 < TN; j4 += 4) {
            const V v = *reinterpret_cast<const V*>(
                bs + (k4 + kk) * BN + L::col(tx, j4));
            bv[j4] = v.x;
            bv[j4 + 1] = v.y;
            bv[j4 + 2] = v.z;
            bv[j4 + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const T ai = lane(av[i], kk);
#pragma unroll
            for (int j = 0; j < TN; ++j) mac(acc[i][j], ai, bv[j]);
          }
        }
      }
    } else {  // the ragged last tile: stop at K
      for (int kk = 0; kk < depth; ++kk) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const T ai = as[L::row(ty, i) * kLdA + kk];
#pragma unroll
          for (int j = 0; j < TN; ++j)
            mac(acc[i][j], ai, bs[kk * BN + L::col(tx, j)]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + L::row(ty, i);
    if (row >= m) continue;
    T* crow = c + static_cast<long long>(row) * n;
#pragma unroll
    for (int j4 = 0; j4 < TN; j4 += 4) {
      const int col = n0 + L::col(tx, j4);
      if (split) {  // int32 only: exact modulo 2^32 in any order
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n)
            atomicAdd(reinterpret_cast<unsigned int*>(crow + col + j),
                      static_cast<unsigned int>(acc[i][j4 + j]));
      } else if (c_vec && col < n) {  // N % 4 == 0: the run fits
        V v;
        store_out(&v.x, acc[i][j4]);
        store_out(&v.y, acc[i][j4 + 1]);
        store_out(&v.z, acc[i][j4 + 2]);
        store_out(&v.w, acc[i][j4 + 3]);
        *reinterpret_cast<V*>(crow + col) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) store_out(crow + col + j, acc[i][j4 + j]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, typename Acc, int BM, int BN, int TM, int TN, int STAGES>
int launch_tiled(const T* a, const T* b, T* c, int m, int n, int k,
                 int tiles_per_split, cudaStream_t stream) {
  constexpr int kThreads = Layout<BM, BN, TM, TN>::kThreads;
  constexpr size_t smem = sizeof(T) * STAGES * (BM * kLdA + kBK * BN);
  auto kernel = gemm_kernel<T, Acc, BM, BN, TM, TN, STAGES>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int k_tiles = (k + kBK - 1) / kBK;
  const int splits =
      k_tiles > tiles_per_split ? (k_tiles + tiles_per_split - 1) / tiles_per_split : 1;
  if (splits > 1) {
    if (std::is_same<T, float>::value) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e =
        cudaMemsetAsync(c, 0, sizeof(T) * static_cast<size_t>(m) * n, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool a_vec = k % 4 == 0 && aligned16(a);
  const bool b_vec = n % 4 == 0 && aligned16(b);
  const bool c_vec = n % 4 == 0 && aligned16(c);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  kernel<<<grid, kThreads, smem, stream>>>(a, b, c, m, n, k, tiles_per_split,
                                           a_vec, b_vec, c_vec);
  return REPRO_LAUNCH_STATUS();
}

// The tilings this file is compiled for: (bm, bn) in {(16, 32), (32, 64),
// (64, 128)} with (TM, TN) = (2, 4), (4, 4), (8, 8) outputs a thread (64,
// 128 and 128 threads), bk = 16, 2 or 4 stages
// (repro_torch/kernels/gemm/gemm.py, COMPILED_TILES and COMPILED_STAGES,
// lists the same set).
template <typename T, typename Acc>
int launch_gemm(const T* a, const T* b, T* c, int m, int n, int k, int bm,
                int bn, int stages, int tiles_per_split, int device,
                void* stream_ptr) {
  REPRO_SET_DEVICE(device);
  if (m <= 0 || n <= 0) return 0;
  if (tiles_per_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define REPRO_GEMM_TILE(BM_, BN_, TM_, TN_)                                   \
  if (bm == BM_ && bn == BN_) {                                               \
    if (stages == 2)                                                          \
      return launch_tiled<T, Acc, BM_, BN_, TM_, TN_, 2>(a, b, c, m, n, k,    \
                                                         tiles_per_split, s); \
    if (stages == 4)                                                          \
      return launch_tiled<T, Acc, BM_, BN_, TM_, TN_, 4>(a, b, c, m, n, k,    \
                                                         tiles_per_split, s); \
  }
  REPRO_GEMM_TILE(16, 32, 2, 4)
  REPRO_GEMM_TILE(32, 64, 4, 4)
  REPRO_GEMM_TILE(64, 128, 8, 8)
#undef REPRO_GEMM_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // not a compiled tiling
}

}  // namespace

// tiles_per_split: k-tiles of bk = 16 each split of K takes (K split across
// blocks when it is under the K's k-tiles; C is then zeroed and summed
// into with atomics).
REPRO_API int repro_gemm_i32(const void* a, const void* b, void* c, int m,
                             int n, int k, int bm, int bn, int stages,
                             int tiles_per_split, int device, void* stream) {
  return launch_gemm<int32_t, uint32_t>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(c), m, n, k, bm, bn, stages, tiles_per_split,
      device, stream);
}

// float32 never splits K: one in-order chain per output.
REPRO_API int repro_gemm_f32(const void* a, const void* b, void* c, int m,
                             int n, int k, int bm, int bn, int stages,
                             int device, void* stream) {
  return launch_gemm<float, float>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, n, k, bm, bn, stages, 1 << 30, device,
      stream);
}
