// FlashAttention-2 backward (GQA, causal with a q_offset >= 0 or non-causal), for
// float32 and bfloat16 q/k/v at the (Dk, Dv) pairs (32, 32), (64, 64),
// (80, 80), (96, 96), (128, 128), MLA's (192, 128) and paligemma's (256,
// 256); the gradients take the inputs' dtype, every sum is f32.
//
// The gradient of the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:_flash_kernel
// (pallas_call at :92).  The JAX package defines no backward for it: off a
// TPU, jax.grad differentiates the XLA blocked path
// (src/repro/kernels/flash_attention/ops.py:_xla_causal, _xla_full), and
// that gradient is what this file computes.  With P = exp(scale QK^T + mask
// - lse) (lse the forward's natural-log row log-sum-exp, written by
// csrc/flash_attention.cu) and dP = dO V^T:
//
//   D_i  = sum_j P_ij dP_ij          (= sum_d dO_id O_id in exact arithmetic)
//   dS   = P o (dP - D)
//   dQ   = scale dS K,   dK = scale dS^T Q,   dV = P^T dO
//
// Causal masking keeps q_offset + i >= j, as the forward's (q_offset the
// absolute position of q's first row: a context-parallel shard's rows,
// models/attention.py): the dQ kernels stop at the last key a tile's rows
// see, and the dK/dV kernels start at the first q tile that sees the kv
// tile, so a kv tile past every row (T > q_offset + S) writes zeros.  With
// q_offset >= 0 every row sees key 0; the wrapper refuses a negative one.
//
// Q, K, dQ and dK are Dk wide; V, dO and dV are Dv wide.  D is summed from
// P and dP here, not from the saved output: in bfloat16 the output is
// rounded to 8 bits, and D taken from it would carry that rounding (2^-9 of
// |O|) into every dS, far past one bf16 ulp of a small gradient; the plain
// version's autograd uses the f32 output.
//
// Two routes, chosen by the caller (repro_torch/kernels/flash_attention/
// flash_attention.py:bwd_route) by dtype, each FlashAttention-2's
// deterministic two-kernel schedule without atomics:
//
// * bfloat16: flash_dq_wgmma_kernel and flash_dkdv_wgmma_kernel, every
//   product on the tensor cores (wgmma, TMA, mbarrier rings; see the note
//   above them);
// * float32 (which must match a full-precision product, so no TF32):
//   flash_dq_kernel and flash_dkdv_kernel, f32 FMAs on the CUDA cores:
//   - flash_dq_kernel, one block per (q tile of 64 rows, head, batch): Q and
//     dO stay in shared memory while K and V tiles of 32 rows stream past
//     twice, first to sum D (each row's 32 columns a tile over the 16 lanes
//     of a half warp, then a butterfly: every lane ends with the same bits),
//     which it writes for the second kernel, then to accumulate dQ in
//     registers; each q row's dQ is written once;
//   - flash_dkdv_kernel, one block per (kv tile of 32 rows, kv head,
//     batch): K and V stay in shared memory; it loops over the q heads of
//     its GQA group and over the q tiles of 32 rows that can see the tile
//     (causal: those at or below it), recomputing P and dS, and accumulates
//     dV += P^T dO and dK += dS^T Q in registers; dK and dV are written
//     once, so the group's sum runs in one fixed order.
//   Products are f32 FMAs, 128 threads a block in 8 half warps: a half
//   warp owns rows ty + 8 i of a score tile, its lanes columns tx + 16 jj
//   and output columns tx * VEC + 16 VEC u + e (the forward kernel's
//   layout).
//
// Every sum runs in a fixed order that no batch size, head count or launch
// changes: two calls give the same bits, and a row of a B = 4 call the bits
// of the same row called alone.
//
// What bounds it on the H100: at stablelm-1.6b's training shape (B = 8, 32
// heads of 64, S = T = 128, causal, bf16) a backward needs five products
// over the causal half (QK^T again, dO V^T, P^T dO, dS K, dS^T Q), 0.68 G
// multiply-adds, against 29.4 MB of q, k, v, dO, dQ, dK and dV: 8.8 us of
// bytes against 1.4 us at the bf16 tensor-core peak, so bytes bound it.
// The CUDA-core route does seven products (QK^T and dO V^T twice, for D):
// 28 us at the f32 peak of 67 TFLOP/s; it took 0.212 ms there.  The
// tensor-core route does those seven on wgmma, P and dS each as two bf16
// parts (six products a tile in each kernel): 2.8 us at the bf16 peak,
// under the byte bound's time.  At deepseek-v2's MLA training shape (B = 8,
// 128 heads, S = T = 128, (192, 128)) the bytes are 302 MB (90 us) against
// 14 GFLOP of the five products (14 us at the peak): bytes again.
#include "common.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kTX = 16;                  // lanes across columns
constexpr int kTY = kThreads / kTX;      // 8 half warps
// flash_dq_kernel: q rows a block, kv rows a tile
constexpr int kDqRows = 64;
constexpr int kDqCols = 32;
// flash_dkdv_kernel: kv rows a block, q rows a tile
constexpr int kKvRows = 32;
constexpr int kKvCols = 32;
constexpr int kLdW = 32 + 4;             // row stride of a 32-column score tile

struct BwdArgs {
  const void* q;      // (B, H, S, Dk), contiguous
  const void* k;      // (B, KVH, T, Dk)
  const void* v;      // (B, KVH, T, Dv)
  const void* dout;   // (B, H, S, Dv)
  const float* lse;   // (B, H, S), natural log
  float* delta;       // (B, H, S): D_i, written by the dQ kernel
  void* dq;
  void* dk;
  void* dv;
  int b, h, kvh, s, t;
  float scale;
  int causal;
  int q_offset;       // absolute position of q row 0 (causal masking)
  float* part;        // null, or the tensor-core route's f32 dK/dV partials of
                      // each head of a GQA group: [group][B][KVH][T][Dk], then
                      // [group][B][KVH][T][Dv]
};

// Each thread owns output columns tx * kVec + kTX * kVec * u + e.
template <int D>
struct Cols {
  static constexpr int kPer = D / kTX;
  static constexpr int kVec = kPer % 4 == 0 ? 4 : (kPer % 2 == 0 ? 2 : 1);
  static constexpr int kGroups = kPer / kVec;
  static constexpr int kLd = D + 4;      // row stride of a (rows, D) tile
};

// rows [r0, r0 + rows) of a row-major (n, D) matrix into shared memory,
// rows past n zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int rows,
                                          int n) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * Cols<D>::kLd + d] = r0 + r < n ? src[static_cast<long long>(r0 + r) * D + d] : 0.f;
  }
}

// out[i][jj] = a[ty + kTY i] . b[tx + kTX jj] over D, FMAs in d order.
template <int D, int R, int C>
__device__ __forceinline__ void dots(float (&out)[R][C], const float* a, const float* b,
                                     int ty, int tx) {
  constexpr int ld = Cols<D>::kLd;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < C; ++jj) out[i][jj] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + kTY * i) * ld + d);
#pragma unroll
    for (int jj = 0; jj < C; ++jj)
      bv[jj] = *reinterpret_cast<const float4*>(b + (tx + kTX * jj) * ld + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        float x = out[i][jj];
        x = fmaf(av[i].x, bv[jj].x, x);
        x = fmaf(av[i].y, bv[jj].y, x);
        x = fmaf(av[i].z, bv[jj].z, x);
        x = fmaf(av[i].w, bv[jj].w, x);
        out[i][jj] = x;
      }
  }
}

// acc[i][c] += sum over the tile's 32 columns w[ty + kTY i][c'] m[c'][col(c)],
// w a (rows, 32) tile of stride kLdW, m a (32, D) tile of stride D + 4.
template <int D, int R>
__device__ __forceinline__ void accumulate(float (&acc)[R][Cols<D>::kPer], const float* w,
                                           const float* m, int ty, int tx) {
  using C = Cols<D>;
  for (int c0 = 0; c0 < 32; c0 += 4) {
    float4 wv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      wv[i] = *reinterpret_cast<const float4*>(w + (ty + kTY * i) * kLdW + c0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* row = m + (c0 + e) * C::kLd + tx * C::kVec;
      float mv[C::kPer];
#pragma unroll
      for (int u = 0; u < C::kGroups; ++u) {
        const float* src = row + kTX * C::kVec * u;
        if constexpr (C::kVec == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(src);
          mv[4 * u] = t4.x, mv[4 * u + 1] = t4.y, mv[4 * u + 2] = t4.z, mv[4 * u + 3] = t4.w;
        } else if constexpr (C::kVec == 2) {
          const float2 t2 = *reinterpret_cast<const float2*>(src);
          mv[2 * u] = t2.x, mv[2 * u + 1] = t2.y;
        } else {
          mv[u] = src[0];
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float x = e == 0 ? wv[i].x : e == 1 ? wv[i].y : e == 2 ? wv[i].z : wv[i].w;
#pragma unroll
        for (int c = 0; c < C::kPer; ++c) acc[i][c] = fmaf(x, mv[c], acc[i][c]);
      }
    }
  }
}

// Store a thread's rows of a (rows, D) result, times ``mul``, rows past n
// skipped.
template <int D, int R>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[R][Cols<D>::kPer],
                                           int r0, int n, float mul, int ty, int tx) {
  using C = Cols<D>;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = r0 + ty + kTY * i;
    if (row >= n) continue;
#pragma unroll
    for (int u = 0; u < C::kGroups; ++u)
#pragma unroll
      for (int w = 0; w < C::kVec; ++w) {
        const int col = tx * C::kVec + kTX * C::kVec * u + w;
        out[static_cast<long long>(row) * D + col] = acc[i][u * C::kVec + w] * mul;
      }
  }
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int qi, int kj) {
  return qi < a.s && kj < a.t && (!a.causal || a.q_offset + qi >= kj);
}

// Q and dO resident, K and V streamed, and the dS tile.
template <int DK, int DV>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((kDqRows + kDqCols) * static_cast<size_t>(Cols<DK>::kLd + Cols<DV>::kLd) +
                          kDqRows * kLdW);
}

// K and V resident, Q and dO streamed, and the P and dS tiles.
template <int DK, int DV>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * ((kKvRows + kKvCols) * static_cast<size_t>(Cols<DK>::kLd + Cols<DV>::kLd) +
                          2 * kKvRows * kLdW);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(BwdArgs a) {
  using CK = Cols<DK>;
  using CV = Cols<DV>;
  constexpr int R = kDqRows / kTY, J = kDqCols / kTX;   // 8 rows, 2 columns a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kDqRows * CK::kLd;
  float* ks = dos + kDqRows * CV::kLd;
  float* vs = ks + kDqCols * CK::kLd;
  float* dss = vs + kDqCols * CV::kLd;

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int q_tile = gridDim.x - 1 - blockIdx.x;          // heaviest causal tiles first
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kv_head = hh / (a.h / a.kvh);
  const int q0 = q_tile * kDqRows;
  const long long qrow = (static_cast<long long>(b) * a.h + hh) * a.s;   // (b, hh)'s row 0
  const long long krow = (static_cast<long long>(b) * a.kvh + kv_head) * a.t;
  const float* k = static_cast<const float*>(a.k) + krow * DK;
  const float* v = static_cast<const float*>(a.v) + krow * DV;
  load_tile<DK>(qs, static_cast<const float*>(a.q) + qrow * DK, q0, kDqRows, a.s);
  load_tile<DV>(dos, static_cast<const float*>(a.dout) + qrow * DV, q0, kDqRows, a.s);

  float lse[R], dsum[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + kTY * i;
    lse[i] = row < a.s ? a.lse[qrow + row] : 0.f;
    dsum[i] = 0.f;
  }
  const int kv_end = a.causal ? min(a.t, a.q_offset + min(q0 + kDqRows, a.s)) : a.t;
  const int n_tiles = (kv_end + kDqCols - 1) / kDqCols;

  // P and dP of the tile at k0 for this thread's (row, column) pairs
  auto scores = [&](int k0, float (&p)[R][J], float (&dp)[R][J]) {
    __syncthreads();  // every thread is done with the previous K/V tile
    load_tile<DK>(ks, k, k0, kDqCols, a.t);
    load_tile<DV>(vs, v, k0, kDqCols, a.t);
    __syncthreads();
    dots<DK, R, J>(p, qs, ks, ty, tx);
    dots<DV, R, J>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        p[i][jj] = visible(a, q0 + ty + kTY * i, k0 + tx + kTX * jj)
                       ? expf(p[i][jj] * a.scale - lse[i])
                       : 0.f;
  };

  // pass 1: D_i = sum_j P_ij dP_ij
  for (int j = 0; j < n_tiles; ++j) {
    float p[R][J], dp[R][J];
    scores(j * kDqCols, p, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int jj = 0; jj < J; ++jj) dsum[i] = fmaf(p[i][jj], dp[i][jj], dsum[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    dsum[i] = half_warp_sum(dsum[i]);
    const int row = q0 + ty + kTY * i;
    if (tx == 0 && row < a.s) a.delta[qrow + row] = dsum[i];
  }

  // pass 2: dQ = scale dS K
  float acc[R][CK::kPer];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CK::kPer; ++c) acc[i][c] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    float p[R][J], dp[R][J];
    scores(j * kDqCols, p, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        dss[(ty + kTY * i) * kLdW + tx + kTX * jj] = p[i][jj] * (dp[i][jj] - dsum[i]);
    __syncwarp();  // a row's dS is written and read by the same half warp
    accumulate<DK, R>(acc, dss, ks, ty, tx);
  }
  store_rows<DK, R>(static_cast<float*>(a.dq) + qrow * DK, acc, q0, a.s, a.scale, ty, tx);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads) flash_dkdv_kernel(BwdArgs a) {
  using CK = Cols<DK>;
  using CV = Cols<DV>;
  constexpr int R = kKvRows / kTY, J = kKvCols / kTX;   // 4 rows, 2 columns a thread
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kKvRows * CK::kLd;
  float* qs = vs + kKvRows * CV::kLd;
  float* dos = qs + kKvCols * CK::kLd;
  float* ps = dos + kKvCols * CV::kLd;
  float* dss = ps + kKvRows * kLdW;

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int kv_tile = blockIdx.x;                         // tile 0 sees the most rows
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.h / a.kvh;
  const int k0 = kv_tile * kKvRows;
  const long long krow = (static_cast<long long>(b) * a.kvh + kvh) * a.t;
  load_tile<DK>(ks, static_cast<const float*>(a.k) + krow * DK, k0, kKvRows, a.t);
  load_tile<DV>(vs, static_cast<const float*>(a.v) + krow * DV, k0, kKvRows, a.t);

  float dk[R][CK::kPer], dv[R][CV::kPer];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < CK::kPer; ++c) dk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < CV::kPer; ++c) dv[i][c] = 0.f;
  }
  // causal: q rows i with q_offset + i < k0 see none of the tile
  const int q_start = a.causal ? (max(0, k0 - a.q_offset) / kKvCols) * kKvCols : 0;

  for (int g = 0; g < group; ++g) {
    const int hh = kvh * group + g;
    const long long qrow = (static_cast<long long>(b) * a.h + hh) * a.s;
    const float* q = static_cast<const float*>(a.q) + qrow * DK;
    const float* dout = static_cast<const float*>(a.dout) + qrow * DV;
    for (int q0 = q_start; q0 < a.s; q0 += kKvCols) {
      __syncthreads();  // every thread is done with the previous Q/dO tile
      load_tile<DK>(qs, q, q0, kKvCols, a.s);
      load_tile<DV>(dos, dout, q0, kKvCols, a.s);
      __syncthreads();
      float p[R][J], dp[R][J];
      dots<DK, R, J>(p, ks, qs, ty, tx);    // (kv row, q row): S^T
      dots<DV, R, J>(dp, vs, dos, ty, tx);  // dP^T
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const int qi = q0 + tx + kTX * jj;
        const float lse = qi < a.s ? a.lse[qrow + qi] : 0.f;
        const float dsum = qi < a.s ? a.delta[qrow + qi] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = ty + kTY * i;
          const float pv = visible(a, qi, k0 + r) ? expf(p[i][jj] * a.scale - lse) : 0.f;
          ps[r * kLdW + tx + kTX * jj] = pv;
          dss[r * kLdW + tx + kTX * jj] = pv * (dp[i][jj] - dsum);
        }
      }
      __syncwarp();  // a kv row's P and dS are written and read by one half warp
      accumulate<DV, R>(dv, ps, dos, ty, tx);
      accumulate<DK, R>(dk, dss, qs, ty, tx);
    }
  }
  store_rows<DK, R>(static_cast<float*>(a.dk) + krow * DK, dk, k0, a.t, a.scale, ty, tx);
  store_rows<DV, R>(static_cast<float*>(a.dv) + krow * DV, dv, k0, a.t, 1.f, ty, tx);
}

template <int DK, int DV>
int launch_d(const BwdArgs& a, cudaStream_t st) {
  constexpr size_t s1 = dq_smem_bytes<DK, DV>(), s2 = dkdv_smem_bytes<DK, DV>();
  cudaError_t e = cudaFuncSetAttribute(flash_dq_kernel<DK, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(s1));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_dkdv_kernel<DK, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s2));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_dq_kernel<DK, DV><<<dim3((a.s + kDqRows - 1) / kDqRows, a.h, a.b), kThreads, s1,
                            st>>>(a);
  const int err = REPRO_LAUNCH_STATUS();
  if (err != 0) return err;
  flash_dkdv_kernel<DK, DV><<<dim3((a.t + kKvRows - 1) / kKvRows, a.kvh, a.b), kThreads, s2,
                              st>>>(a);
  return REPRO_LAUNCH_STATUS();
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: flash_dq_wgmma_kernel, flash_dkdv_wgmma_kernel.
//
// Each block is one consumer warpgroup (warps 0-3), which owns 64 rows of
// the result (q rows of dQ; kv rows of dK and dV), and a producer warp
// (warp 4) whose lane 0 issues every TMA copy: the block's own 64-row tiles
// once, then the tiles it streams through a 2-stage ring, each stage with a
// full and an empty mbarrier.  Every tile is one to three 128-byte-swizzled
// boxes of 64 bf16 columns and 64 rows (flash_wgmma_kernel's boxes and
// descriptors, csrc/hopper.cuh): Dk's boxes first, then Dv's; TMA
// zero-fills columns past the head dim and rows past S and T (hubert's 80
// is two boxes, 16 columns of the second real).  Products, in
// wgmma's accumulator layout (thread (warp w, lane l) holds rows 16w + l/4
// and + 8, columns 8j + 2(l%4) + {0, 1}):
//
// * flash_dq_wgmma_kernel, one block per (q tile, head, batch), Q and dO
//   resident, K and V tiles streamed twice.  S = Q K^T (Dk / 16 k-steps)
//   and dP = dO V^T (Dv / 16) on wgmma.m64n64k16 with both operands K-major
//   from shared memory; P = exp(scale S - lse), masked to 0.  The first
//   pass sums D_i = sum_j P_ij dP_ij per thread in tile and register order,
//   then over the 4 lanes of a row (every lane the same bits), and writes D
//   for the second kernel; the second pass forms dS = P (dP - D) and
//   accumulates dQ += dS K (wgmma.m64nNk16, N = mma_n<Dk>: Dk, or 96 at Dk
//   80, K's columns 80-95 TMA's zeros, so the extra accumulators stay 0
//   and are not stored) with A = dS from registers (two
//   n8 accumulator tiles are one k16 A fragment) and B = the K tile with the
//   transpose bit (MN-major): K is never staged transposed;
// * flash_dkdv_wgmma_kernel, one block per (kv tile, kv head, batch), K and V
//   resident; the q heads of the GQA group and, for each, the q tiles that
//   see the kv tile (causal: from its own diagonal on) stream past as (Q,
//   dO) tiles.  It computes S^T = K Q^T and dP^T = V dO^T directly, so P^T
//   and dS^T come out in the accumulator layout that is the A-from-registers
//   operand of dV += P^T dO and dK += dS^T Q (dO and Q MN-major): no
//   transposition through shared memory.  Each q column's lse and D are
//   read from device memory (L2) before the products are issued; dV and dK
//   are mma_n<Dv> and mma_n<Dk> wide, as dQ.  With a
//   GQA group (H > KVH) one block takes one head of the group instead, and
//   writes its f32 dK and dV partials; flash_dkdv_sum_kernel adds the
//   group's in head order.  One block a kv head walking the whole group
//   left most SMs idle (qwen's 16 over 2 heads: 32 blocks of 32 tiles).
//
//   Where dK and dV do not fit one thread's registers together (Dk + Dv >
//   256: MLA's (192, 128) would hold 96 + 64 accumulators a thread beside
//   S^T, dP^T and the lse and D of its 16 columns), the kernel makes two
//   passes over the (Q, dO) tiles instead of one (dkdv_passes): the first
//   recomputes S^T and P^T and accumulates dV alone, stores it and frees
//   its registers; the second recomputes S^T, forms dP^T and dS^T and
//   accumulates dK.  Each pass streams the tiles again (from L2 mostly) and
//   S^T is computed twice, which costs one more K Q^T a tile than the
//   fused pass; splitting dK and dV over two consumer warpgroups instead
//   would cost the same products and a bigger block.  At Dk 256 dK's 128
//   accumulators do not fit beside S^T, dP^T and the lse and D of the
//   thread's 16 q columns either, so dK takes two passes of 128 columns
//   each (dk_parts): three passes, S^T three times and dP^T twice a tile,
//   224 registers and no spills (230 for the dQ kernel, whose 128 dQ
//   accumulators fit beside S, dP and the two rows' lse and D).
//
// P and dS are f32; each is fed to its product as p_hi + p_lo, two bf16
// parts multiplied in turn (the forward's P): about 16 bits of each, where
// one bf16 rounding keeps 8, so the gradients hold to the f32 plain version
// within the check's bf16 tolerance.  Q K^T and dO V^T take bf16 inputs,
// whose products are exact in f32.  No atomics: dQ, dK and dV are each
// written once by the block that owns their rows.
constexpr int kMmaRows = 64;                 // result rows a block owns; rows a tile
constexpr int kMmaStages = 2;
constexpr int kMmaThreads = 128 + 32;        // a consumer warpgroup and a producer warp
constexpr int kMmaBoxBytes = kMmaRows * 128; // one swizzled box: 64 rows x 64 bf16

struct MmaPerm {                             // tensor-map dims of q, k, v and dout
  int q[3], k[3], v[3], o[3];
};

template <int D>
__host__ __device__ constexpr int mma_boxes() { return (D + kBox - 1) / kBox; }

// The boxes of one tile pair: Dk's (Q or K), then Dv's (dO or V).
template <int DK, int DV>
__host__ __device__ constexpr int mma_pair_bytes() {
  return (mma_boxes<DK>() + mma_boxes<DV>()) * kMmaBoxBytes;
}

// The resident pair and the ring's pairs of tiles, the barriers, and slack
// to align the boxes to 1024 bytes.
template <int DK, int DV>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (1 + kMmaStages) * mma_pair_bytes<DK, DV>() + (1 + 2 * kMmaStages) * 8 + 1024;
}

// Column parts of dK in flash_dkdv_wgmma_kernel's dK passes: 1, or 2 at
// Dk 256, whose 128 accumulators a thread would not fit beside S^T, dP^T
// and the lse and D of its 16 q columns.
template <int DK, int DV>
__host__ __device__ constexpr int dk_parts() { return DK > 192 ? 2 : 1; }

// Passes of flash_dkdv_wgmma_kernel over its (Q, dO) tiles: 1 (dK and dV
// together), or, where their accumulators do not fit beside the scores, one
// for dV and then one for each part of dK's columns.
template <int DK, int DV>
__host__ __device__ constexpr int dkdv_passes() {
  return DK + DV > 256 ? 1 + dk_parts<DK, DV>() : 1;
}

// acc (64 x 64) = A B^T over d: A and B 64-row tiles, both K-major.
template <int D>
__device__ __forceinline__ void mma_scores(float (&acc)[32], const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;           // bytes: 16 columns a step
    wgmma_ss_n64(acc, sw128_desc(a + (kk / 4) * kMmaBoxBytes + off, 16, 1024),
                 sw128_desc(b + (kk / 4) * kMmaBoxBytes + off, 16, 1024), kk > 0);
  }
}

// The A fragments of a 64 x 64 accumulator tile x, as x_hi + x_lo.
__device__ __forceinline__ void split_frags(const float (&x)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // r: (row g, k lo), (row g + 8, k lo), (row g, k hi), (row g + 8, k hi)
      const float* sv = x + 4 * (2 * kk + r / 2) + 2 * (r % 2);
      hi[kk][r] = pack_bf16(sv[0], sv[1]);
      const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][r]);
      lo[kk][r] = pack_bf16(sv[0] - __low2float(h2), sv[1] - __high2float(h2));
    }
}

// acc (64 x mma_n<D>) += (hi + lo) (64 x 64) @ M, M a 64-row tile of D
// columns read MN-major (zeros past D), in steps of 16 of its rows.
template <int D>
__device__ __forceinline__ void mma_accumulate(float (&acc)[mma_n<D>() / 2],
                                               const uint32_t (&hi)[4][4],
                                               const uint32_t (&lo)[4][4],
                                               const unsigned char* m) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = sw128_desc(m + kk * 16 * 128, kMmaBoxBytes, 1024);
    wgmma_rs<mma_n<D>()>(acc, hi[kk], desc);
    wgmma_rs<mma_n<D>()>(acc, lo[kk], desc);
  }
}

// Rows row0 and row0 + 8 of a 64 x mma_n<D> accumulator, times mul, to its
// first D columns of a bf16 matrix of n rows LD apart; rows >= n skipped.
template <int D, int LD = D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float (&acc)[mma_n<D>() / 2],
                                          int row0, int n, float mul, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * LD + nt * 8 +
                                         2 * t4) =
          __floats2bfloat162_rn(acc[4 * nt + 2 * r] * mul, acc[4 * nt + 2 * r + 1] * mul);
  }
}

// The same rows in f32, unscaled.
template <int D, int LD = D>
__device__ __forceinline__ void store_acc_f32(float* out, const float (&acc)[mma_n<D>() / 2],
                                              int row0, int n, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(out + static_cast<long long>(row) * LD + nt * 8 + 2 * t4) =
          make_float2(acc[4 * nt + 2 * r], acc[4 * nt + 2 * r + 1]);
  }
}

// Barriers after the tiles: the resident pair's, then full and empty per stage.
__device__ __forceinline__ void mma_init_barriers(uint64_t* res_full, uint64_t* full,
                                                  uint64_t* empty) {
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < kMmaStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);                 // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

template <int DK, int DV>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, BwdArgs a, MmaPerm perm) {
  constexpr int NK = mma_boxes<DK>(), NV = mma_boxes<DV>(), PAIR = mma_pair_bytes<DK, DV>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* res = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = res + PAIR;            // stage s: K boxes, then V boxes
  uint64_t* res_full = reinterpret_cast<uint64_t*>(ring + kMmaStages * PAIR);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + kMmaStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_tile = gridDim.x - 1 - blockIdx.x;           // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_head = h / (a.h / a.kvh);
  const int q0 = q_tile * kMmaRows;
  const int kv_end = a.causal ? min(a.t, a.q_offset + min(q0 + kMmaRows, a.s)) : a.t;
  const int n_tiles = (kv_end + kMmaRows - 1) / kMmaRows;
  mma_init_barriers(res_full, full, empty);

  if (warp == 4) {
    // producer: Q and dO once, then every K and V tile, twice
    if (lane == 0) {
      mbar_arrive_tx(res_full, PAIR);
#pragma unroll
      for (int x = 0; x < NK; ++x)
        tma_load(res + x * kMmaBoxBytes, &tq, perm.q, x * kBox, q0, h, b, res_full);
#pragma unroll
      for (int x = 0; x < NV; ++x)
        tma_load(res + (NK + x) * kMmaBoxBytes, &to, perm.o, x * kBox, q0, h, b, res_full);
      for (int g = 0; g < 2 * n_tiles; ++g) {
        const int s = g % kMmaStages, k0 = (g % n_tiles) * kMmaRows;
        mbar_wait(&empty[s], ((g / kMmaStages) & 1) ^ 1);
        mbar_arrive_tx(&full[s], PAIR);
        unsigned char* st = ring + s * PAIR;
#pragma unroll
        for (int x = 0; x < NK; ++x)
          tma_load(st + x * kMmaBoxBytes, &tk, perm.k, x * kBox, k0, kv_head, b, &full[s]);
#pragma unroll
        for (int x = 0; x < NV; ++x)
          tma_load(st + (NK + x) * kMmaBoxBytes, &tv, perm.v, x * kBox, k0, kv_head, b,
                   &full[s]);
      }
    }
    return;
  }

  const int g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;          // this thread's two q rows
  const long long qrow = (static_cast<long long>(b) * a.h + h) * a.s;
  const float lse[2] = {r0 < a.s ? a.lse[qrow + r0] : 0.f, r1 < a.s ? a.lse[qrow + r1] : 0.f};
  float dsum[2] = {0.f, 0.f};
  float dq[mma_n<DK>() / 2];
#pragma unroll
  for (int i = 0; i < mma_n<DK>() / 2; ++i) dq[i] = 0.f;
  mbar_wait(res_full, 0);

  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int pass = it / n_tiles, s = it % kMmaStages;
    const int k0 = (it % n_tiles) * kMmaRows;
    mbar_wait(&full[s], (it / kMmaStages) & 1);
    const unsigned char* st = ring + s * PAIR;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f, dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    mma_scores<DK>(sc, res, st);                                             // S = Q K^T
    mma_scores<DV>(dp, res + NK * kMmaBoxBytes, st + NK * kMmaBoxBytes);     // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + nt * 8 + 2 * t4 + (e & 1);
        const int qi = e < 2 ? r0 : r1;
        const bool vis = qi < a.s && kj < a.t && (!a.causal || a.q_offset + qi >= kj);
        float& p = sc[4 * nt + e];
        p = vis ? expf(p * a.scale - lse[e / 2]) : 0.f;
      }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dsum[(i % 4) / 2] = fmaf(sc[i], dp[i], dsum[(i % 4) / 2]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = sc[i] * (dp[i] - dsum[(i % 4) / 2]);   // dS
      uint32_t hi[4][4], lo[4][4];
      split_frags(sc, hi, lo);
      fence_regs(dq);
      wgmma_fence();
      mma_accumulate<DK>(dq, hi, lo, st);                    // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);                 // this warp is done with stage s
    if (it == n_tiles - 1) {                                // D, for pass 2 and flash_dkdv_wgmma_kernel
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dsum[r] = quad_sum(dsum[r]);
        const int row = r == 0 ? r0 : r1;
        if (t4 == 0 && row < a.s) a.delta[qrow + row] = dsum[r];
      }
    }
  }
  store_acc<DK>(static_cast<__nv_bfloat16*>(a.dq) + qrow * DK, dq, r0, a.s, a.scale, t4);
}

// One (Q, dO) tile of flash_dkdv_wgmma_kernel, once stage ``st`` is full
// (``full`` at ``parity``): S^T = K Q^T and P^T; with WANT_DK also
// dP^T = V dO^T and dS^T; then dV += P^T dO (WANT_DV) and dK's columns
// [DK0, DK0 + DKC) += dS^T Q (WANT_DK), in one commit group.  An
// accumulator the pass does not want is never touched.
template <int DK, int DV, bool WANT_DV, bool WANT_DK, int DKC = DK, int DK0 = 0>
__device__ __forceinline__ void dkdv_tile(float (&dv)[mma_n<DV>() / 2],
                                          float (&dk)[mma_n<DKC>() / 2],
                                          const unsigned char* res, const unsigned char* st,
                                          uint64_t* full, unsigned parity, const BwdArgs& a,
                                          long long qrow, int q0, int j0, int j1, int t4) {
  constexpr int V_OFF = mma_boxes<DK>() * kMmaBoxBytes;    // V after K, dO after Q
  // lse and D of this thread's 16 q columns
  float lq[16], dl[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int qi = q0 + (c / 2) * 8 + 2 * t4 + (c % 2);
    lq[c] = qi < a.s ? a.lse[qrow + qi] : 0.f;
    if constexpr (WANT_DK) dl[c] = qi < a.s ? a.delta[qrow + qi] : 0.f;
  }
  mbar_wait(full, parity);
  float sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = 0.f;
    if constexpr (WANT_DK) dp[i] = 0.f;
  }
  fence_regs(sc);
  if constexpr (WANT_DK) fence_regs(dp);
  wgmma_fence();
  mma_scores<DK>(sc, res, st);                                             // S^T = K Q^T
  if constexpr (WANT_DK) mma_scores<DV>(dp, res + V_OFF, st + V_OFF);      // dP^T = V dO^T
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  if constexpr (WANT_DK) fence_regs(dp);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 2 * nt + (e & 1);
      const int qi = q0 + nt * 8 + 2 * t4 + (e & 1);
      const int kj = e < 2 ? j0 : j1;
      const bool vis = qi < a.s && kj < a.t && (!a.causal || a.q_offset + qi >= kj);
      const float p = vis ? expf(sc[4 * nt + e] * a.scale - lq[c]) : 0.f;
      sc[4 * nt + e] = p;                                                  // P^T
      if constexpr (WANT_DK) dp[4 * nt + e] = p * (dp[4 * nt + e] - dl[c]);  // dS^T
    }
  uint32_t phi[4][4], plo[4][4], shi[4][4], slo[4][4];
  if constexpr (WANT_DV) {
    split_frags(sc, phi, plo);
    fence_regs(dv);
  }
  if constexpr (WANT_DK) {
    split_frags(dp, shi, slo);
    fence_regs(dk);
  }
  wgmma_fence();
  if constexpr (WANT_DV) mma_accumulate<DV>(dv, phi, plo, st + V_OFF);     // dV += P^T dO
  if constexpr (WANT_DK)                                                   // dK += dS^T Q
    mma_accumulate<DKC>(dk, shi, slo, st + DK0 / kBox * kMmaBoxBytes);
  wgmma_commit();
  wgmma_wait<0>();
  if constexpr (WANT_DV) fence_regs(dv);
  if constexpr (WANT_DK) fence_regs(dk);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap to, BwdArgs a, MmaPerm perm) {
  constexpr int NK = mma_boxes<DK>(), NV = mma_boxes<DV>(), PAIR = mma_pair_bytes<DK, DV>();
  constexpr int PASSES = dkdv_passes<DK, DV>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* res = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = res + PAIR;            // stage s: Q boxes, then dO boxes
  uint64_t* res_full = reinterpret_cast<uint64_t*>(ring + kMmaStages * PAIR);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + kMmaStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_tile = blockIdx.x;                           // tile 0 sees the most rows
  const int group = a.h / a.kvh;
  // with partials, one block a head of the group (grid y = KVH * group),
  // else one a kv head, looping over its group's heads
  const bool split = a.part != nullptr;
  const int kvh = split ? blockIdx.y / group : blockIdx.y, b = blockIdx.z;
  const int head0 = kvh * group + (split ? blockIdx.y % group : 0);
  const int k0 = kv_tile * kMmaRows;
  // q tiles that see the kv tile: causal, those from the row at position
  // k0 on (none when k0 - q_offset >= S: the tile's dK and dV are zeros)
  const int first_q = a.causal ? max(0, k0 - a.q_offset) / kMmaRows : 0;
  const int q_tiles = max(0, (a.s + kMmaRows - 1) / kMmaRows - first_q);
  const int n_tiles = (split ? 1 : group) * q_tiles;       // (Q, dO) tiles a pass
  mma_init_barriers(res_full, full, empty);

  if (warp == 4) {
    // producer: K and V once, then (Q, dO) tiles head by head, once a pass
    if (lane == 0) {
      mbar_arrive_tx(res_full, PAIR);
#pragma unroll
      for (int x = 0; x < NK; ++x)
        tma_load(res + x * kMmaBoxBytes, &tk, perm.k, x * kBox, k0, kvh, b, res_full);
#pragma unroll
      for (int x = 0; x < NV; ++x)
        tma_load(res + (NK + x) * kMmaBoxBytes, &tv, perm.v, x * kBox, k0, kvh, b, res_full);
      for (int it = 0; it < PASSES * n_tiles; ++it) {
        const int s = it % kMmaStages, j = it % n_tiles;
        const int hh = head0 + j / q_tiles, q0 = (first_q + j % q_tiles) * kMmaRows;
        mbar_wait(&empty[s], ((it / kMmaStages) & 1) ^ 1);
        mbar_arrive_tx(&full[s], PAIR);
        unsigned char* st = ring + s * PAIR;
#pragma unroll
        for (int x = 0; x < NK; ++x)
          tma_load(st + x * kMmaBoxBytes, &tq, perm.q, x * kBox, q0, hh, b, &full[s]);
#pragma unroll
        for (int x = 0; x < NV; ++x)
          tma_load(st + (NK + x) * kMmaBoxBytes, &to, perm.o, x * kBox, q0, hh, b, &full[s]);
      }
    }
    return;
  }

  const int g = lane / 4, t4 = lane % 4;
  const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;          // this thread's two kv rows
  const long long krow = (static_cast<long long>(b) * a.kvh + kvh) * a.t;
  // this head's f32 partials (flash_dkdv_sum_kernel adds the group's), or
  // the kv head's bf16 rows
  const long long nk = static_cast<long long>(a.b) * a.kvh * a.t * DK;
  const long long nv = static_cast<long long>(a.b) * a.kvh * a.t * DV;
  const int gi = head0 - kvh * group;
  // dK's columns [c0, c0 + DKC)
  constexpr int DKC = DK / dk_parts<DK, DV>();
  auto store_dk = [&](const float (&dk)[mma_n<DKC>() / 2], int c0) {
    if (split)
      store_acc_f32<DKC, DK>(a.part + gi * nk + krow * DK + c0, dk, j0, a.t, t4);
    else
      store_acc<DKC, DK>(static_cast<__nv_bfloat16*>(a.dk) + krow * DK + c0, dk, j0, a.t,
                         a.scale, t4);
  };
  auto store_dv = [&](const float (&dv)[mma_n<DV>() / 2]) {
    if (split)
      store_acc_f32<DV>(a.part + group * nk + gi * nv + krow * DV, dv, j0, a.t, t4);
    else
      store_acc<DV>(static_cast<__nv_bfloat16*>(a.dv) + krow * DV, dv, j0, a.t, 1.f, t4);
  };
  mbar_wait(res_full, 0);

  // ring iteration it: tile it % n_tiles of pass it / n_tiles
  auto tile_args = [&](int it, int& s, int& q0, long long& qrow) {
    const int j = it % n_tiles;
    s = it % kMmaStages;
    q0 = (first_q + j % q_tiles) * kMmaRows;
    qrow = (static_cast<long long>(b) * a.h + head0 + j / q_tiles) * a.s;
  };
  if constexpr (PASSES == 1) {
    float dk[mma_n<DK>() / 2], dv[mma_n<DV>() / 2];
#pragma unroll
    for (int i = 0; i < mma_n<DK>() / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < mma_n<DV>() / 2; ++i) dv[i] = 0.f;
    for (int it = 0; it < n_tiles; ++it) {
      int s, q0;
      long long qrow;
      tile_args(it, s, q0, qrow);
      dkdv_tile<DK, DV, true, true>(dv, dk, res, ring + s * PAIR, &full[s],
                                    (it / kMmaStages) & 1, a, qrow, q0, j0, j1, t4);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    store_dk(dk, 0);
    store_dv(dv);
  } else {
    {  // pass 1: dV
      float dv[mma_n<DV>() / 2], unused[mma_n<DK>() / 2];
#pragma unroll
      for (int i = 0; i < mma_n<DV>() / 2; ++i) dv[i] = 0.f;
      for (int it = 0; it < n_tiles; ++it) {
        int s, q0;
        long long qrow;
        tile_args(it, s, q0, qrow);
        dkdv_tile<DK, DV, true, false>(dv, unused, res, ring + s * PAIR, &full[s],
                                       (it / kMmaStages) & 1, a, qrow, q0, j0, j1, t4);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      store_dv(dv);
    }
    // passes 2 ..: dK, DKC of its columns a pass
    auto dk_pass = [&](auto part) {
      constexpr int DK0 = decltype(part)::value * DKC;
      float dk[mma_n<DKC>() / 2], unused[mma_n<DV>() / 2];
#pragma unroll
      for (int i = 0; i < mma_n<DKC>() / 2; ++i) dk[i] = 0.f;
      const int it0 = (1 + decltype(part)::value) * n_tiles;
      for (int it = it0; it < it0 + n_tiles; ++it) {
        int s, q0;
        long long qrow;
        tile_args(it, s, q0, qrow);
        dkdv_tile<DK, DV, false, true, DKC, DK0>(unused, dk, res, ring + s * PAIR, &full[s],
                                                 (it / kMmaStages) & 1, a, qrow, q0, j0, j1,
                                                 t4);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      store_dk(dk, DK0);
    };
    dk_pass(std::integral_constant<int, 0>());
    if constexpr (dk_parts<DK, DV>() > 1) dk_pass(std::integral_constant<int, 1>());
  }
}

// A GQA group's dK and dV from its heads' f32 partials, added in head order
// (dK then times the scale), as bf16.
template <int DK, int DV>
__global__ void __launch_bounds__(256) flash_dkdv_sum_kernel(BwdArgs a) {
  const long long rows = static_cast<long long>(a.b) * a.kvh * a.t;
  const long long nk = rows * DK, nv = rows * DV;
  const int group = a.h / a.kvh;
  const long long stride = static_cast<long long>(gridDim.x) * 256;
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < nk;
       i += stride) {
    float sk = 0.f;
    for (int g = 0; g < group; ++g) sk += a.part[g * nk + i];
    static_cast<__nv_bfloat16*>(a.dk)[i] = __float2bfloat16_rn(sk * a.scale);
  }
  const float* pv = a.part + group * nk;
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < nv;
       i += stride) {
    float sv = 0.f;
    for (int g = 0; g < group; ++g) sv += pv[g * nv + i];
    static_cast<__nv_bfloat16*>(a.dv)[i] = __float2bfloat16_rn(sv);
  }
}

template <int DK, int DV>
int launch_wgmma_bwd(const BwdArgs& a, cudaStream_t st) {
  CUtensorMap tq, tk, tv, to;
  MmaPerm perm;
  const long long dk = DK, dv = DV;
  const long long qs[3] = {dk, a.s * dk, static_cast<long long>(a.h) * a.s * dk};
  const long long os[3] = {dv, a.s * dv, static_cast<long long>(a.h) * a.s * dv};
  const long long ks[3] = {dk, a.t * dk, static_cast<long long>(a.kvh) * a.t * dk};
  const long long vs[3] = {dv, a.t * dv, static_cast<long long>(a.kvh) * a.t * dv};
  const bool ok = encode_map(&tq, a.q, DK, {a.s, a.h, a.b}, qs, kMmaRows, perm.q) &&
                  encode_map(&to, a.dout, DV, {a.s, a.h, a.b}, os, kMmaRows, perm.o) &&
                  encode_map(&tk, a.k, DK, {a.t, a.kvh, a.b}, ks, kMmaRows, perm.k) &&
                  encode_map(&tv, a.v, DV, {a.t, a.kvh, a.b}, vs, kMmaRows, perm.v);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = mma_smem_bytes<DK, DV>();
  cudaError_t e = cudaFuncSetAttribute(flash_dq_wgmma_kernel<DK, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_dkdv_wgmma_kernel<DK, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_dq_wgmma_kernel<DK, DV><<<dim3((a.s + kMmaRows - 1) / kMmaRows, a.h, a.b), kMmaThreads,
                                  smem, st>>>(tq, tk, tv, to, a, perm);
  const int err = REPRO_LAUNCH_STATUS();
  if (err != 0) return err;
  const int group = a.h / a.kvh;
  flash_dkdv_wgmma_kernel<DK, DV><<<dim3((a.t + kMmaRows - 1) / kMmaRows,
                                         a.part != nullptr ? a.kvh * group : a.kvh, a.b),
                                    kMmaThreads, smem, st>>>(tq, tk, tv, to, a, perm);
  if (a.part == nullptr) return REPRO_LAUNCH_STATUS();
  const int err2 = REPRO_LAUNCH_STATUS();
  if (err2 != 0) return err2;
  const long long n = static_cast<long long>(a.b) * a.kvh * a.t * (DK > DV ? DK : DV);
  const long long blocks = (n + 255) / 256;
  flash_dkdv_sum_kernel<DK, DV><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
                                  st>>>(a);
  return REPRO_LAUNCH_STATUS();
}

// The (Dk, Dv) pairs this file takes, each dtype on its own route: float32
// on the CUDA cores and bfloat16 on the tensor cores (``wgmma``), both at
// (32, 32), (64, 64), (80, 80), (96, 96), (128, 128), (192, 128) and (256,
// 256) (repro_torch/kernels/flash_attention/flash_attention.py:BWD_PAIRS
// and BWD_MMA_PAIRS list the same).
template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int b,
               int h, int kvh, int s, int t, int d_k, int d_v, float scale, int causal,
               int q_offset, int wgmma, float* part, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 || s <= 0 || t <= 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (part != nullptr && (!wgmma || h == kvh)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh, s, t,
                  scale, causal, q_offset, part};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto is = [&](int x, int y) { return d_k == x && d_v == y; };
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (!wgmma) return static_cast<int>(cudaErrorInvalidValue);
    if (is(32, 32)) return launch_wgmma_bwd<32, 32>(a, st);
    if (is(64, 64)) return launch_wgmma_bwd<64, 64>(a, st);
    if (is(80, 80)) return launch_wgmma_bwd<80, 80>(a, st);      // hubert
    if (is(96, 96)) return launch_wgmma_bwd<96, 96>(a, st);
    if (is(128, 128)) return launch_wgmma_bwd<128, 128>(a, st);
    if (is(192, 128)) return launch_wgmma_bwd<192, 128>(a, st);
    if (is(256, 256)) return launch_wgmma_bwd<256, 256>(a, st);
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (wgmma) return static_cast<int>(cudaErrorInvalidValue);
    if (is(32, 32)) return launch_d<32, 32>(a, st);
    if (is(64, 64)) return launch_d<64, 64>(a, st);
    if (is(80, 80)) return launch_d<80, 80>(a, st);
    if (is(96, 96)) return launch_d<96, 96>(a, st);
    if (is(128, 128)) return launch_d<128, 128>(a, st);
    if (is(192, 128)) return launch_d<192, 128>(a, st);
    if (is(256, 256)) return launch_d<256, 256>(a, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout, dq (B, H, S, Dk / Dv / Dk); k, v, dk, dv (B, KVH, T, Dk / Dv /
// Dk / Dv), all contiguous; lse and delta (B, H, S) f32, delta scratch that
// the first kernel writes; wgmma: 1 for the tensor-core route (bfloat16 at
// the pairs above); q_offset >= 0: the absolute position of q's row 0 for
// causal masking (0 for a whole sequence); part: null, or on that route with a GQA group (H > KVH)
// f32 scratch of H * B * T * (Dk + Dv) floats for each head's dK and dV
// partials.
REPRO_API int repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            float* delta, void* dq, void* dk, void* dv,
                                            int b, int h, int kvh, int s, int t, int d_k,
                                            int d_v, float scale, int causal, int q_offset,
                                            int wgmma, float* part, int device, void* stream) {
  return launch_bwd<float>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh, s, t, d_k, d_v,
                           scale, causal, q_offset, wgmma, part, device, stream);
}

REPRO_API int repro_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             float* delta, void* dq, void* dk, void* dv,
                                             int b, int h, int kvh, int s, int t, int d_k,
                                             int d_v, float scale, int causal, int q_offset,
                                             int wgmma, float* part, int device, void* stream) {
  return launch_bwd<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh, s, t,
                                   d_k, d_v, scale, causal, q_offset, wgmma, part, device,
                                   stream);
}
