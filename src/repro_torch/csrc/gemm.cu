// Tiled GeMM, C = A @ B, for int32 and float32 inputs.
//
// Replaces the TPU kernel src/repro/kernels/gemm/gemm.py:_gemm_kernel
// (launched by gemm_pallas), which walks a (M/bm, N/bn, K/bk) grid with the
// K axis innermost and sequential, carrying each output tile's sum across
// grid steps in a VMEM accumulator.  Blocks on Hopper run in parallel and in
// no order, so here the K loop runs inside the block: each block owns one
// (BM, BN) output tile, keeps its partial sums in registers, and streams
// (BM, BK) tiles of A and (BK, BN) tiles of B through a ring of STAGES
// shared-memory buffers filled with cp.async (zero-filled past the ragged
// edges, so nothing is padded in device memory).  128 threads per block,
// each owning a (BM/8) x (BN/16) strip of outputs, rows ty + 8 i and
// columns tx + 16 j, so the shared-memory reads of B are one word per bank
// and those of A are broadcasts.
//
// What bounds it on the H100: at the paper's 256^3 int32 size the work is
// 16.8 M multiply-adds and 0.75 MB, about 1 us at the card's INT32
// multiply-add issue rate, under the few microseconds a launch takes, so
// launch latency bounds it.  At large sizes the int32 path is bound by
// INT32 multiply-add issue (Hopper's tensor cores have no int32 x int32
// product, and int32 values do not fit in int8) and the float path by FFMA
// issue (no TF32: the float path must match a full-precision product); the
// register strip of up to 8 x 8 outputs does 64 multiply-adds for every 16
// words it reads from shared memory.  wgmma and TMA are not used.
//
// Arithmetic: int32 products and sums in uint32_t, so wraparound is defined
// and equals XLA's int32 dot modulo 2^32; cast to int32 at the store.
// float32: one accumulator per output, k = 0 .. K-1 added in order with a
// fused multiply-add (__fmaf_rn), and the last, partial K tile stops at K
// instead of adding zeros, so every tiling, pipeline depth, graph or eager
// launch gives the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kThreadCols = 16;  // threads across a tile's columns
constexpr int kThreadRows = kThreads / kThreadCols;
constexpr int kBK = 16;          // K-tile depth of every tiling

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool in_bounds) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = in_bounds ? 4 : 0;  // 0: fill the word with zeros
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

// Copy the A tile (rows m0.., cols k0..) and the B tile (rows k0.., cols
// n0..) into one stage: As[BM][kBK] and Bs[kBK][BN], both row-major.
template <typename T, int BM, int BN>
__device__ __forceinline__ void load_tiles(const T* __restrict__ a,
                                           const T* __restrict__ b, T* as,
                                           T* bs, int m, int n, int k,
                                           int m0, int n0, int k0) {
  for (int idx = threadIdx.x; idx < BM * kBK; idx += kThreads) {
    const int r = idx / kBK, c = idx % kBK;
    const bool ok = m0 + r < m && k0 + c < k;
    const T* src = ok ? a + static_cast<long long>(m0 + r) * k + k0 + c : a;
    cp_async4(as + idx, src, ok);
  }
  for (int idx = threadIdx.x; idx < kBK * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const bool ok = k0 + r < k && n0 + c < n;
    const T* src = ok ? b + static_cast<long long>(k0 + r) * n + n0 + c : b;
    cp_async4(bs + idx, src, ok);
  }
}

template <typename T, typename Acc, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ c, int m, int n, int k) {
  constexpr int TM = BM / kThreadRows;
  constexpr int TN = BN / kThreadCols;
  constexpr int kStageWords = BM * kBK + kBK * BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tx = threadIdx.x % kThreadCols;
  const int ty = threadIdx.x / kThreadCols;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (k + kBK - 1) / kBK;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  // Prologue: the first STAGES - 1 tiles in flight.  Every iteration
  // commits one group, empty or not, so wait_group counts stay aligned.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) {
      T* as = smem + s * kStageWords;
      load_tiles<T, BM, BN>(a, b, as, as + BM * kBK, m, n, k, m0, n0, s * kBK);
    }
    cp_async_commit();
  }

  for (int t = 0; t < k_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed
    __syncthreads();              // ... for every thread, and stage t - 1 is free
    const int next = t + STAGES - 1;
    if (next < k_tiles) {
      T* as = smem + (next % STAGES) * kStageWords;
      load_tiles<T, BM, BN>(a, b, as, as + BM * kBK, m, n, k, m0, n0,
                            next * kBK);
    }
    cp_async_commit();

    const T* as = smem + (t % STAGES) * kStageWords;
    const T* bs = as + BM * kBK;
    const int depth = min(kBK, k - t * kBK);
    if (depth == kBK) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        T av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = as[(ty + kThreadRows * i) * kBK + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = bs[kk * BN + tx + kThreadCols * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) mac(acc[i][j], av[i], bv[j]);
      }
    } else {  // the ragged last tile: stop at K
      for (int kk = 0; kk < depth; ++kk) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const T av = as[(ty + kThreadRows * i) * kBK + kk];
#pragma unroll
          for (int j = 0; j < TN; ++j)
            mac(acc[i][j], av, bs[kk * BN + tx + kThreadCols * j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + kThreadRows * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + kThreadCols * j;
      if (col < n) c[static_cast<long long>(row) * n + col] = static_cast<T>(acc[i][j]);
    }
  }
}

template <typename T, typename Acc, int BM, int BN, int STAGES>
int launch_tiled(const T* a, const T* b, T* c, int m, int n, int k,
                 cudaStream_t stream) {
  constexpr size_t smem = sizeof(T) * STAGES * (BM * kBK + kBK * BN);
  auto kernel = gemm_kernel<T, Acc, BM, BN, STAGES>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(a, b, c, m, n, k);
  return REPRO_LAUNCH_STATUS();
}

// The tilings this file is compiled for: (bm, bn) in {(16, 32), (32, 64),
// (64, 128)}, bk = 16, 2 or 4 stages (repro_torch/kernels/gemm/gemm.py,
// COMPILED_TILES and COMPILED_STAGES, lists the same set).
template <typename T, typename Acc>
int launch_gemm(const T* a, const T* b, T* c, int m, int n, int k, int bm,
                int bn, int stages, int device, void* stream_ptr) {
  REPRO_SET_DEVICE(device);
  if (m <= 0 || n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define REPRO_GEMM_TILE(BM_, BN_)                                              \
  if (bm == BM_ && bn == BN_) {                                                \
    if (stages == 2) return launch_tiled<T, Acc, BM_, BN_, 2>(a, b, c, m, n, k, s); \
    if (stages == 4) return launch_tiled<T, Acc, BM_, BN_, 4>(a, b, c, m, n, k, s); \
  }
  REPRO_GEMM_TILE(16, 32)
  REPRO_GEMM_TILE(32, 64)
  REPRO_GEMM_TILE(64, 128)
#undef REPRO_GEMM_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // not a compiled tiling
}

}  // namespace

REPRO_API int repro_gemm_i32(const void* a, const void* b, void* c, int m,
                             int n, int k, int bm, int bn, int stages,
                             int device, void* stream) {
  return launch_gemm<int32_t, uint32_t>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(c), m, n, k, bm, bn, stages, device, stream);
}

REPRO_API int repro_gemm_f32(const void* a, const void* b, void* c, int m,
                             int n, int k, int bm, int bn, int stages,
                             int device, void* stream) {
  return launch_gemm<float, float>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, n, k, bm, bn, stages, device, stream);
}
