// FlashAttention-2 backward (GQA, causal with q_offset 0 or non-causal,
// Dk = Dv in {32, 64, 80, 96, 128}), for float32 and bfloat16 q/k/v; the
// gradients take the inputs' dtype, every sum is f32.
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
// D is summed from P and dP here, not from the saved output: in bfloat16
// the output is rounded to 8 bits, and D taken from it would carry that
// rounding (2^-9 of |O|) into every dS, far past one bf16 ulp of a small
// gradient; the plain version's autograd uses the f32 output.
//
// Two kernels, FlashAttention-2's deterministic schedule without atomics:
//
// * flash_dq_kernel, one block per (q tile of 64 rows, head, batch): Q and dO
//   stay in shared memory while K and V tiles of 32 rows stream past twice,
//   first to sum D (each row's 32 columns a tile over the 16 lanes of a
//   half warp, then a butterfly: every lane ends with the same bits),
//   which it writes for the second kernel, then to accumulate dQ in
//   registers; each q row's dQ is written once;
// * flash_dkdv_kernel, one block per (kv tile of 32 rows, kv head, batch): K and
//   V stay in shared memory; it loops over the q heads of its GQA group and
//   over the q tiles of 32 rows that can see the tile (causal: those at or
//   below it), recomputing P and dS, and accumulates dV += P^T dO and dK +=
//   dS^T Q in registers; dK and dV are written once, so the group's sum
//   runs in one fixed order.
//
// Every sum runs in a fixed order that no batch size, head count or launch
// changes: two calls give the same bits, and a row of a B = 4 call the bits
// of the same row called alone.  Products are f32 FMAs on the CUDA cores
// (bf16 inputs widened on load), 128 threads a block in 8 half warps: a
// half warp owns rows ty + 8 i of a score tile, its lanes columns tx + 16 jj
// and output columns tx * VEC + 16 VEC u + e (the forward kernel's layout).
//
// What bounds it on the H100: at stablelm-1.6b's training shape (B = 8, 32
// heads of 64, S = T = 128, causal, bf16) a backward needs five products
// over the causal half (QK^T again, dO V^T, P^T dO, dS K, dS^T Q), 0.68 G
// multiply-adds, against 29.4 MB of q, k, v, dO, dQ, dK and dV: 8.8 us of
// bytes against 1.4 us at the bf16 tensor-core peak, so bytes bound it.
// This kernel does seven products (QK^T and dO V^T twice, for D) on the
// CUDA cores: 28 us at their f32 peak of 67 TFLOP/s.  Running on the CUDA
// cores is the simple design of a first kernel; tensor cores (wgmma, TMA)
// are later work (ROADMAP.md queue 2 item 6).
#include "common.cuh"

#include <cuda_bf16.h>

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct BwdArgs {
  const void* q;      // (B, H, S, D), contiguous
  const void* k;      // (B, KVH, T, D)
  const void* v;      // (B, KVH, T, D)
  const void* dout;   // (B, H, S, D)
  const float* lse;   // (B, H, S), natural log
  float* delta;       // (B, H, S): D_i, written by flash_dq_kernel
  void* dq;
  void* dk;
  void* dv;
  int b, h, kvh, s, t;
  float scale;
  int causal;
};

// Each thread owns output columns tx * kVec + kTX * kVec * u + e.
template <int D>
struct Cols {
  static constexpr int kPer = D / kTX;
  static constexpr int kVec = kPer % 4 == 0 ? 4 : (kPer % 2 == 0 ? 2 : 1);
  static constexpr int kGroups = kPer / kVec;
  static constexpr int kLd = D + 4;      // row stride of a (rows, D) tile
};

// rows [r0, r0 + rows) of a row-major (n, D) matrix into shared memory as
// f32, rows past n zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int rows,
                                          int n) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * Cols<D>::kLd + d] =
        r0 + r < n ? to_f32(src[static_cast<long long>(r0 + r) * D + d]) : 0.f;
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
template <typename T, int D, int R>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[R][Cols<D>::kPer],
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
        store_as(out + static_cast<long long>(row) * D + col, acc[i][u * C::kVec + w] * mul);
      }
  }
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int qi, int kj) {
  return qi < a.s && kj < a.t && (!a.causal || qi >= kj);
}

template <int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((2 * kDqRows + 2 * kDqCols) * static_cast<size_t>(Cols<D>::kLd) +
                          kDqRows * kLdW);
}

template <int D>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * ((2 * kKvRows + 2 * kKvCols) * static_cast<size_t>(Cols<D>::kLd) +
                          2 * kKvRows * kLdW);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(BwdArgs a) {
  using C = Cols<D>;
  constexpr int R = kDqRows / kTY, J = kDqCols / kTX;   // 8 rows, 2 columns a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kDqRows * C::kLd;
  float* ks = dos + kDqRows * C::kLd;
  float* vs = ks + kDqCols * C::kLd;
  float* dss = vs + kDqCols * C::kLd;

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int q_tile = gridDim.x - 1 - blockIdx.x;          // heaviest causal tiles first
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kv_head = hh / (a.h / a.kvh);
  const int q0 = q_tile * kDqRows;
  const long long qrow = (static_cast<long long>(b) * a.h + hh) * a.s;   // (b, hh)'s row 0
  const long long krow = (static_cast<long long>(b) * a.kvh + kv_head) * a.t;
  const T* k = static_cast<const T*>(a.k) + krow * D;
  const T* v = static_cast<const T*>(a.v) + krow * D;
  load_tile<T, D>(qs, static_cast<const T*>(a.q) + qrow * D, q0, kDqRows, a.s);
  load_tile<T, D>(dos, static_cast<const T*>(a.dout) + qrow * D, q0, kDqRows, a.s);

  float lse[R], dsum[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + kTY * i;
    lse[i] = row < a.s ? a.lse[qrow + row] : 0.f;
    dsum[i] = 0.f;
  }
  const int kv_end = a.causal ? min(a.t, min(q0 + kDqRows, a.s)) : a.t;
  const int n_tiles = (kv_end + kDqCols - 1) / kDqCols;

  // P and dP of the tile at k0 for this thread's (row, column) pairs
  auto scores = [&](int k0, float (&p)[R][J], float (&dp)[R][J]) {
    __syncthreads();  // every thread is done with the previous K/V tile
    load_tile<T, D>(ks, k, k0, kDqCols, a.t);
    load_tile<T, D>(vs, v, k0, kDqCols, a.t);
    __syncthreads();
    dots<D, R, J>(p, qs, ks, ty, tx);
    dots<D, R, J>(dp, dos, vs, ty, tx);
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
  float acc[R][C::kPer];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C::kPer; ++c) acc[i][c] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    float p[R][J], dp[R][J];
    scores(j * kDqCols, p, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        dss[(ty + kTY * i) * kLdW + tx + kTX * jj] = p[i][jj] * (dp[i][jj] - dsum[i]);
    __syncwarp();  // a row's dS is written and read by the same half warp
    accumulate<D, R>(acc, dss, ks, ty, tx);
  }
  store_rows<T, D, R>(static_cast<T*>(a.dq) + qrow * D, acc, q0, a.s, a.scale, ty, tx);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkdv_kernel(BwdArgs a) {
  using C = Cols<D>;
  constexpr int R = kKvRows / kTY, J = kKvCols / kTX;   // 4 rows, 2 columns a thread
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kKvRows * C::kLd;
  float* qs = vs + kKvRows * C::kLd;
  float* dos = qs + kKvCols * C::kLd;
  float* ps = dos + kKvCols * C::kLd;
  float* dss = ps + kKvRows * kLdW;

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int kv_tile = blockIdx.x;                         // tile 0 sees the most rows
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.h / a.kvh;
  const int k0 = kv_tile * kKvRows;
  const long long krow = (static_cast<long long>(b) * a.kvh + kvh) * a.t;
  load_tile<T, D>(ks, static_cast<const T*>(a.k) + krow * D, k0, kKvRows, a.t);
  load_tile<T, D>(vs, static_cast<const T*>(a.v) + krow * D, k0, kKvRows, a.t);

  float dk[R][C::kPer], dv[R][C::kPer];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C::kPer; ++c) dk[i][c] = 0.f, dv[i][c] = 0.f;
  // causal: q rows below k0 see none of the tile
  const int q_start = a.causal ? (k0 / kKvCols) * kKvCols : 0;

  for (int g = 0; g < group; ++g) {
    const int hh = kvh * group + g;
    const long long qrow = (static_cast<long long>(b) * a.h + hh) * a.s;
    const T* q = static_cast<const T*>(a.q) + qrow * D;
    const T* dout = static_cast<const T*>(a.dout) + qrow * D;
    for (int q0 = q_start; q0 < a.s; q0 += kKvCols) {
      __syncthreads();  // every thread is done with the previous Q/dO tile
      load_tile<T, D>(qs, q, q0, kKvCols, a.s);
      load_tile<T, D>(dos, dout, q0, kKvCols, a.s);
      __syncthreads();
      float p[R][J], dp[R][J];
      dots<D, R, J>(p, ks, qs, ty, tx);    // (kv row, q row): S^T
      dots<D, R, J>(dp, vs, dos, ty, tx);  // dP^T
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
      accumulate<D, R>(dv, ps, dos, ty, tx);
      accumulate<D, R>(dk, dss, qs, ty, tx);
    }
  }
  store_rows<T, D, R>(static_cast<T*>(a.dk) + krow * D, dk, k0, a.t, a.scale, ty, tx);
  store_rows<T, D, R>(static_cast<T*>(a.dv) + krow * D, dv, k0, a.t, 1.f, ty, tx);
}

template <typename T, int D>
int launch_d(const BwdArgs& a, cudaStream_t st) {
  constexpr size_t s1 = dq_smem_bytes<D>(), s2 = dkdv_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_dq_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(s1));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s2));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_dq_kernel<T, D><<<dim3((a.s + kDqRows - 1) / kDqRows, a.h, a.b), kThreads, s1, st>>>(a);
  const int err = REPRO_LAUNCH_STATUS();
  if (err != 0) return err;
  flash_dkdv_kernel<T, D><<<dim3((a.t + kKvRows - 1) / kKvRows, a.kvh, a.b), kThreads, s2, st>>>(a);
  return REPRO_LAUNCH_STATUS();
}

// Head dims this file takes, Dk = Dv = d in {32, 64, 80, 96, 128}
// (repro_torch/kernels/flash_attention/flash_attention.py:BWD_HEAD_DIMS
// lists the same).
template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int b,
               int h, int kvh, int s, int t, int d, float scale, int causal, int device,
               void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 || s <= 0 || t <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh, s, t, scale, causal};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_d<T, 32>(a, st);
    case 64: return launch_d<T, 64>(a, st);
    case 80: return launch_d<T, 80>(a, st);
    case 96: return launch_d<T, 96>(a, st);
    case 128: return launch_d<T, 128>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout, dq (B, H, S, d); k, v, dk, dv (B, KVH, T, d), all contiguous;
// lse and delta (B, H, S) f32, delta scratch that the first kernel writes.
REPRO_API int repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            float* delta, void* dq, void* dk, void* dv,
                                            int b, int h, int kvh, int s, int t, int d,
                                            float scale, int causal, int device,
                                            void* stream) {
  return launch_bwd<float>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh, s, t, d,
                           scale, causal, device, stream);
}

REPRO_API int repro_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             float* delta, void* dq, void* dk, void* dv,
                                             int b, int h, int kvh, int s, int t, int d,
                                             float scale, int causal, int device,
                                             void* stream) {
  return launch_bwd<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh, s,
                                   t, d, scale, causal, device, stream);
}
