// The gradient of the Mamba (S6) selective scan (csrc/mamba_scan.cu, the
// scan without the D * x skip, which stays in PyTorch) with no state in and
// no gradient into the final state, the training path's case: x/delta
// (B, T, Dm), a (Dm, N), b/c (B, T, N) and the output's gradient dy
// (B, T, Dm) -> dx (B, T, Dm) in x's dtype, ddelta (B, T, Dm) in delta's,
// da (Dm, N), db and dc (B, T, N) f32.
//
// Replaces no TPU kernel: the JAX package trains jamba through jax.grad of
// its XLA path (src/repro/kernels/mamba_scan/ops.py:_chunked_assoc), and
// the TPU kernel _mamba_kernel has no VJP.
//
// The math, per (b, channel d, state n), with da_t = exp(delta_t a),
// h_t = da_t h_{t-1} + delta_t x_t b_t (h_{-1} = 0), y_t = sum_n h_t c_t and
// dh_t = dL/dh_t = dy_t c_t + da_{t+1} dh_{t+1}:
//
//     dx_t[d]     = delta_t[d] sum_n dh_t[d, n] b_t[n]
//     ddelta_t[d] = sum_n dh_t[d, n] (a[d, n] da_t h_{t-1}[d, n] + x_t[d] b_t[n])
//     da[d, n]    = sum_{b, t} dh_t delta_t da_t h_{t-1}
//     db_t[n]     = sum_d dh_t[d, n] delta_t[d] x_t[d]
//     dc_t[n]     = sum_d h_t[d, n] dy_t[d]
//
// Each h is recomputed with the forward's own arithmetic (da = 2^(delta *
// a log2 e) on the special-function unit's ex2.approx.ftz.f32, then one
// FMA), so the backward sees the forward kernel's h bit for bit.
//
// What bounds it on the H100: at jamba's training shape (B = 8, T = 128,
// Dm = 16384, N = 16) it reads x, dy (bf16), delta (f32) and writes dx
// (bf16) and ddelta (f32), about 235 MB with b, c and their gradients
// (70 us at 3.35 TB/s), against about 18 f32 flops a step, channel and
// state (72 us at 67 TFLOP/s) and one exponential each (64 us at the
// special-function unit's 16 a clock per SM).  This design takes each
// exponential three times (the checkpoint sweep, the recomputed chunk and
// the reverse walk): 805 M, 192 us, its own floor.  This first kernel is
// written to be right and simple; PERF.md has its time beside its bound.
//
// The design:
// * One thread a channel, its N states in registers (the forward's plan
//   with one lane), 128 channels of one batch row a block.
// * h_{t-1} at every step of the reverse walk, by recomputation: a first
//   forward sweep writes each channel's state at the start of every chunk
//   of kC = 8 steps to a scratch buffer (B T / 8 Dm N f32, 67 MB at the
//   training shape, each thread reading back only what it wrote); then,
//   chunk by chunk from the last, the chunk's steps run forward again from
//   that state, keeping each h_{t-1} in shared memory (each thread its own
//   entries, conflict-free), and the reverse walk carries dh backwards.
//   The forward kernel is left as it is.
// * The sums over channels (db and dc) without atomics: a reduce-scatter
//   of shuffles in each warp, then the block's four warps in order give a
//   per-block partial for each (b, t, n); mamba_bwd_sum_kernel adds the
//   blocks' partials in order, and da's per-row partials over b in order.
//   Two calls give the same bits.
//
// Any T and Dm work; channels past Dm run as zeros and write nothing.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kWarps = kThreads / 32;
constexpr int kC = 8;          // steps a chunk (its states kept in shared memory)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 2^z on the special-function unit (MUFU.EX2), as the forward kernel takes it.
__device__ __forceinline__ float ex2_sfu(float z) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
}

struct Args {
  const void* x;         // (B, T, Dm)
  const void* delta;     // (B, T, Dm)
  const float* a;        // (Dm, N)
  const float* bm;       // (B, T, N)
  const float* cm;       // (B, T, N)
  const void* dy;        // (B, T, Dm), x's dtype
  float* ckpt;           // (B, chunks, Dm, N): the state before each chunk
  void* dx;              // (B, T, Dm), x's dtype
  void* ddelta;          // (B, T, Dm), delta's dtype
  float* da_part;        // (B, Dm, N)
  float* db_part;        // (B, blocks, T, N)
  float* dc_part;        // (B, blocks, T, N)
  float* da;             // (Dm, N)
  float* db;             // (B, T, N)
  float* dc;             // (B, T, N)
  int b, t, dm;
};

template <int N>
struct Smem {
  static constexpr int kIn = 0;                       // [3][kC][kThreads]: x, delta, dy
  static constexpr int kBC = kIn + 3 * kC * kThreads;  // [2][kC][N]: b, c
  static constexpr int kRed = kBC + 2 * kC * N;       // [2][kC][kWarps][N]
  static constexpr int kHist = kRed + 2 * kC * kWarps * N;  // [kC][N][kThreads]
  static constexpr int kFloats = kHist + kC * N * kThreads;
  static constexpr int kBytes = kFloats * 4;
};

// Steps [t0, t0 + n) of the block's channels (x, delta, dy as f32) and of
// b and c; steps past n and channels past Dm are zeros.
template <typename TX, typename TD, int N>
__device__ __forceinline__ void stage(float* sm, const Args& a, long long row0,
                                      int ch0, int t0, int n) {
  using L = Smem<N>;
  const TX* x = static_cast<const TX*>(a.x);
  const TD* dl = static_cast<const TD*>(a.delta);
  const TX* dy = static_cast<const TX*>(a.dy);
  float* const in = sm + L::kIn;
  for (int idx = threadIdx.x; idx < kC * kThreads; idx += kThreads) {
    const int tt = idx / kThreads, c = idx % kThreads;
    const bool ok = tt < n && ch0 + c < a.dm;
    const long long g = (row0 + t0 + tt) * a.dm + ch0 + c;
    in[idx] = ok ? to_f32(x[g]) : 0.f;
    in[kC * kThreads + idx] = ok ? to_f32(dl[g]) : 0.f;
    in[2 * kC * kThreads + idx] = ok ? to_f32(dy[g]) : 0.f;
  }
  float* const bc = sm + L::kBC;
  for (int idx = threadIdx.x; idx < kC * N; idx += kThreads) {
    const bool ok = idx < n * N;
    const long long g = (row0 + t0) * N + idx;
    bc[idx] = ok ? a.bm[g] : 0.f;
    bc[kC * N + idx] = ok ? a.cm[g] : 0.f;
  }
}

template <typename TX, typename TD, int N>
__global__ void __launch_bounds__(kThreads) mamba_bwd_kernel(Args a) {
  using L = Smem<N>;
  extern __shared__ __align__(16) float sm[];
  const float* const xs = sm + L::kIn;
  const float* const ds = xs + kC * kThreads;
  const float* const dys = ds + kC * kThreads;
  const float* const bs = sm + L::kBC;
  const float* const cs = bs + kC * N;
  float* const red_b = sm + L::kRed;
  float* const red_c = red_b + kC * kWarps * N;
  float* const hist = sm + L::kHist;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch0 = blockIdx.x * kThreads;
  const int chn = ch0 + tid;
  const bool live = chn < a.dm;
  const int bi = blockIdx.y;
  const long long row0 = static_cast<long long>(bi) * a.t;
  const int chunks = (a.t + kC - 1) / kC;
  // the channel's state before chunk q at ckpt + q * Dm * N
  float* const ckpt = a.ckpt + static_cast<long long>(bi) * chunks * a.dm * N +
                      static_cast<long long>(chn) * N;
  constexpr int kLo = 32 / N > 1 ? 32 / N : 1;   // lanes that end with one n
  const bool writer = (lane & (kLo - 1)) == 0;

  float av[N], ap[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a.a[static_cast<long long>(chn) * N + n] : 0.f;
    ap[n] = av[n] * kLog2e;
  }

  // 1. Forward: each channel's state before every chunk, to the scratch.
  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;
  for (int q = 0; q < chunks; ++q) {
    const int t0 = q * kC, steps = min(kC, a.t - t0);
    if (live) {
      float* const out = ckpt + static_cast<long long>(q) * a.dm * N;
#pragma unroll
      for (int n = 0; n < N; ++n) out[n] = h[n];
    }
    if (q + 1 == chunks) break;               // the last chunk's end is not needed
    __syncthreads();                          // the last chunk's reads are done
    stage<TX, TD, N>(sm, a, row0, ch0, t0, steps);
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      const float dt = ds[tt * kThreads + tid];
      const float dx = dt * xs[tt * kThreads + tid];
#pragma unroll
      for (int n = 0; n < N; ++n)
        h[n] = fmaf(ex2_sfu(dt * ap[n]), h[n], dx * bs[tt * N + n]);
    }
  }

  // 2. Backward, chunk by chunk from the last.
  float carry[N], dav[N];   // da_{t+1} dh_{t+1}; the channel's sum for da
#pragma unroll
  for (int n = 0; n < N; ++n) carry[n] = dav[n] = 0.f;
  TX* const dxo = static_cast<TX*>(a.dx);
  TD* const ddo = static_cast<TD*>(a.ddelta);
  const int blocks = gridDim.x;
  for (int q = chunks - 1; q >= 0; --q) {
    const int t0 = q * kC, steps = min(kC, a.t - t0);
    __syncthreads();                          // the last chunk's reads are done
    stage<TX, TD, N>(sm, a, row0, ch0, t0, steps);
    __syncthreads();
    if (live) {
      const float* const in_h = ckpt + static_cast<long long>(q) * a.dm * N;
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = in_h[n];
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = 0.f;
    }
    // the chunk's steps forward again: h_{t-1} kept, and the block's share
    // of dc_t = sum_d h_t dy_t
    for (int tt = 0; tt < steps; ++tt) {
      const float dt = ds[tt * kThreads + tid];
      const float dx = dt * xs[tt * kThreads + tid];
      const float dyv = dys[tt * kThreads + tid];
      float pc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        hist[(tt * N + n) * kThreads + tid] = h[n];
        h[n] = fmaf(ex2_sfu(dt * ap[n]), h[n], dx * bs[tt * N + n]);
        pc[n] = h[n] * dyv;
      }
      int idx = 0;
      warp_reduce_scatter<N, 16, 1>(pc, lane, idx);
      if (writer) red_c[(tt * kWarps + warp) * N + idx] = pc[0];
    }
    // the reverse walk with dh
    for (int tt = steps - 1; tt >= 0; --tt) {
      const float dt = ds[tt * kThreads + tid];
      const float xv = xs[tt * kThreads + tid];
      const float dx = dt * xv;
      const float dyv = dys[tt * kThreads + tid];
      float gb = 0.f, gd = 0.f, pb[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float da = ex2_sfu(dt * ap[n]);
        const float bn = bs[tt * N + n];
        const float g = fmaf(dyv, cs[tt * N + n], carry[n]);           // dh_t
        const float dh_prev = da * hist[(tt * N + n) * kThreads + tid]; // da h_{t-1}
        gb = fmaf(g, bn, gb);
        gd = fmaf(g, fmaf(av[n], dh_prev, xv * bn), gd);
        dav[n] = fmaf(g, dt * dh_prev, dav[n]);
        pb[n] = g * dx;
        carry[n] = da * g;
      }
      if (live) {
        const long long o = (row0 + t0 + tt) * a.dm + chn;
        store_as(dxo + o, dt * gb);
        store_as(ddo + o, gd);
      }
      int idx = 0;
      warp_reduce_scatter<N, 16, 1>(pb, lane, idx);
      if (writer) red_b[(tt * kWarps + warp) * N + idx] = pb[0];
    }
    __syncthreads();                          // red_b and red_c are complete
    // the block's partials of db and dc: its warps' sums in order
    for (int idx = tid; idx < steps * N; idx += kThreads) {
      const int tt = idx / N, n = idx % N;
      float sb = red_b[(tt * kWarps) * N + n], sc = red_c[(tt * kWarps) * N + n];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        sb += red_b[(tt * kWarps + w) * N + n];
        sc += red_c[(tt * kWarps + w) * N + n];
      }
      const long long o =
          ((static_cast<long long>(bi) * blocks + blockIdx.x) * a.t + t0 + tt) * N + n;
      a.db_part[o] = sb;
      a.dc_part[o] = sc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      a.da_part[(static_cast<long long>(bi) * a.dm + chn) * N + n] = dav[n];
  }
}

// db, dc: the blocks' partials summed in block order; da: the batch rows'
// partials summed in row order.
__global__ void __launch_bounds__(256) mamba_bwd_sum_kernel(Args a, int n,
                                                            int blocks) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long btn = static_cast<long long>(a.b) * a.t * n;
  if (idx < btn) {
    const long long tn = static_cast<long long>(a.t) * n;
    const long long bi = idx / tn, rest = idx % tn;
    const long long base = bi * blocks * tn + rest;
    float sb = a.db_part[base], sc = a.dc_part[base];
    for (int q = 1; q < blocks; ++q) {
      sb += a.db_part[base + q * tn];
      sc += a.dc_part[base + q * tn];
    }
    a.db[idx] = sb;
    a.dc[idx] = sc;
    return;
  }
  const long long j = idx - btn;
  const long long dn = static_cast<long long>(a.dm) * n;
  if (j >= dn) return;
  float s = a.da_part[j];
  for (int q = 1; q < a.b; ++q) s += a.da_part[q * dn + j];
  a.da[j] = s;
}

template <typename TX, typename TD, int N>
int launch_n(const Args& a, cudaStream_t stream) {
  using L = Smem<N>;
  auto kernel = mamba_bwd_kernel<TX, TD, N>;
  if (L::kBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (a.dm + kThreads - 1) / kThreads;
  kernel<<<dim3(blocks, a.b), kThreads, L::kBytes, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(a.b) * a.t * N +
                          static_cast<long long>(a.dm) * N;
  mamba_bwd_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                         stream>>>(a, N, blocks);
  return REPRO_LAUNCH_STATUS();
}

template <typename TX, typename TD>
int mamba_bwd_entry(const Args& a, int n, cudaStream_t stream) {
  switch (n) {
    case 2: return launch_n<TX, TD, 2>(a, stream);
    case 4: return launch_n<TX, TD, 4>(a, stream);
    case 8: return launch_n<TX, TD, 8>(a, stream);
    case 16: return launch_n<TX, TD, 16>(a, stream);
    case 32: return launch_n<TX, TD, 32>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// N in {2, 4, 8, 16, 32}; every tensor contiguous; a, b, c float32; ckpt
// holds B ceil(T / 8) Dm N floats, da_part B Dm N, db_part and dc_part
// B ceil(Dm / 128) T N.  _f32: x, dy, delta float32; _bf16: x, dy bfloat16,
// delta float32 (what the jamba block passes under bfloat16); _bf16d: delta
// bfloat16 too.  dx in x's dtype, ddelta in delta's; da, db, dc float32.
#define REPRO_MAMBA_BWD(NAME, TX, TD)                                          \
  REPRO_API int NAME(const void* x, const void* delta, const float* a_mat,    \
                     const float* bm, const float* cm, const void* dy,        \
                     float* ckpt, void* dx, void* ddelta, float* da_part,     \
                     float* db_part, float* dc_part, float* da, float* db,    \
                     float* dc, int b, int t, int dm, int n, int device,      \
                     void* stream) {                                          \
    REPRO_SET_DEVICE(device);                                                 \
    if (b <= 0 || t <= 0 || dm <= 0 || b > 65535)                             \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    const Args args{x, delta, a_mat, bm, cm, dy, ckpt, dx, ddelta, da_part,   \
                    db_part, dc_part, da, db, dc, b, t, dm};                  \
    return mamba_bwd_entry<TX, TD>(args, n, static_cast<cudaStream_t>(stream)); \
  }

REPRO_MAMBA_BWD(repro_mamba_scan_bwd_f32, float, float)
REPRO_MAMBA_BWD(repro_mamba_scan_bwd_bf16, __nv_bfloat16, float)
REPRO_MAMBA_BWD(repro_mamba_scan_bwd_bf16d, __nv_bfloat16, __nv_bfloat16)
