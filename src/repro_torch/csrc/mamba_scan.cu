// Mamba (S6) selective scan: x/delta (B, T, Dm), a (Dm, N), b/c (B, T, N),
// optional state0 (B, Dm, N) -> y (B, T, Dm) in x's dtype, WITHOUT the
// D * x skip term (the wrapper adds it), and the final state (B, Dm, N) f32:
//
//     h_t = exp(delta_t * a) * h_{t-1} + delta_t * x_t * b_t      (Dm, N)
//     y_t = h_t . c_t                                              (Dm,)
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py:
// _mamba_kernel (launched by mamba_scan_pallas), which walks a
// (B, Dm / 128, T / 64) grid with time innermost and sequential, keeping
// the (128, N) state plane in VMEM and running each chunk's steps as a
// fori_loop of FMAs.  Here one thread owns one (b, channel) and keeps its
// N-long state (and its row of a) in registers for the whole time loop;
// a block is 128 channels of one batch row.  The b_t and c_t rows of
// kRun steps are staged in shared memory once per block, x and delta are
// read coalesced across the block's channels, and y is written the same
// way.  Any T and Dm work unpadded (the channel tail is masked), and the
// state may start from state0 or from zeros (the TPU kernel's only start).
//
// Arithmetic per step, as the oracle orders it (f32): da = exp(delta * a_n),
// h_n = da * h_n + (delta * x) * b_n, y = sum_n h_n * c_n in order n = 0..N-1.
//
// What bounds it on the H100: at jamba's width (Dm = 16384, N = 16, B = 4,
// T = 256) the 6 N flops per step and channel are 1.61 GFLOP, 24 us at
// 67 TFLOP/s, against 134 MB of x (bf16), delta (f32) and y (bf16) as the
// jamba block passes them under bf16 (40 us at 3.35 TB/s): bytes.  Each
// step's exponentials (N per channel, computed with expf) dominate the
// instruction count.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kRun = 64;       // time steps whose b and c are staged at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* x;         // (B, T, Dm)
  const void* delta;     // (B, T, Dm)
  const float* a;        // (Dm, N)
  const float* bm;       // (B, T, N)
  const float* cm;       // (B, T, N)
  const float* h0;       // (B, Dm, N) or null for zeros
  void* y;               // (B, T, Dm), x's dtype
  float* h_out;          // (B, Dm, N)
  int t, dm;
};

template <typename TX, typename TD, int N>
__global__ void __launch_bounds__(kThreads) mamba_kernel(Args a) {
  __shared__ float bs[kRun][N], cs[kRun][N];
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const bool live = ch < a.dm;
  const long long row0 = static_cast<long long>(b) * a.t;   // (b, t = 0)
  const TX* x = static_cast<const TX*>(a.x) + row0 * a.dm + ch;
  const TD* dl = static_cast<const TD*>(a.delta) + row0 * a.dm + ch;
  TX* y = static_cast<TX*>(a.y) + row0 * a.dm + ch;
  const float* bm = a.bm + row0 * N;
  const float* cm = a.cm + row0 * N;
  const long long hrow = (static_cast<long long>(b) * a.dm + ch) * N;

  float h[N], av[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a.a[static_cast<long long>(ch) * N + n] : 0.f;
    h[n] = live && a.h0 ? a.h0[hrow + n] : 0.f;
  }
  for (int t0 = 0; t0 < a.t; t0 += kRun) {
    const int steps = min(kRun, a.t - t0);
    __syncthreads();   // every thread is done with the previous run's rows
    for (int idx = threadIdx.x; idx < steps * N; idx += kThreads) {
      bs[idx / N][idx % N] = bm[static_cast<long long>(t0) * N + idx];
      cs[idx / N][idx % N] = cm[static_cast<long long>(t0) * N + idx];
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < steps; ++tt) {
      const long long off = static_cast<long long>(t0 + tt) * a.dm;
      const float dt = to_f32(dl[off]);
      const float dx = dt * to_f32(x[off]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float da = expf(dt * av[n]);
        h[n] = da * h[n] + dx * bs[tt][n];
        acc += h[n] * cs[tt][n];
      }
      store_as(y + off, acc);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) a.h_out[hrow + n] = h[n];
  }
}

template <typename TX, typename TD>
int launch_mamba(const Args& a, int b, int n, cudaStream_t stream) {
  const dim3 grid((a.dm + kThreads - 1) / kThreads, b);
  switch (n) {
    case 2: mamba_kernel<TX, TD, 2><<<grid, kThreads, 0, stream>>>(a); break;
    case 4: mamba_kernel<TX, TD, 4><<<grid, kThreads, 0, stream>>>(a); break;
    case 8: mamba_kernel<TX, TD, 8><<<grid, kThreads, 0, stream>>>(a); break;
    case 16: mamba_kernel<TX, TD, 16><<<grid, kThreads, 0, stream>>>(a); break;
    case 32: mamba_kernel<TX, TD, 32><<<grid, kThreads, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return REPRO_LAUNCH_STATUS();
}

template <typename TX, typename TD>
int mamba_entry(const void* x, const void* delta, const float* a_mat,
                const float* bm, const float* cm, const float* h0, void* y,
                float* h_out, int b, int t, int dm, int n, int device,
                void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || dm <= 0) return 0;
  if (t < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, delta, a_mat, bm, cm, h0, y, h_out, t, dm};
  return launch_mamba<TX, TD>(a, b, n, static_cast<cudaStream_t>(stream));
}

}  // namespace

// N in {2, 4, 8, 16, 32} (the state lives in registers); every tensor is
// contiguous; a, b, c (and state0, which may be null) are float32.
// _f32: x and delta float32; _bf16: x bfloat16, delta float32 (what the
// jamba block passes under bfloat16); _bf16d: x and delta bfloat16.
REPRO_API int repro_mamba_scan_f32(const void* x, const void* delta,
                                   const float* a, const float* bm,
                                   const float* cm, const float* h0, void* y,
                                   float* h_out, int b, int t, int dm, int n,
                                   int device, void* stream) {
  return mamba_entry<float, float>(x, delta, a, bm, cm, h0, y, h_out, b, t,
                                   dm, n, device, stream);
}

REPRO_API int repro_mamba_scan_bf16(const void* x, const void* delta,
                                    const float* a, const float* bm,
                                    const float* cm, const float* h0, void* y,
                                    float* h_out, int b, int t, int dm, int n,
                                    int device, void* stream) {
  return mamba_entry<__nv_bfloat16, float>(x, delta, a, bm, cm, h0, y, h_out,
                                           b, t, dm, n, device, stream);
}

REPRO_API int repro_mamba_scan_bf16d(const void* x, const void* delta,
                                     const float* a, const float* bm,
                                     const float* cm, const float* h0, void* y,
                                     float* h_out, int b, int t, int dm, int n,
                                     int device, void* stream) {
  return mamba_entry<__nv_bfloat16, __nv_bfloat16>(
      x, delta, a, bm, cm, h0, y, h_out, b, t, dm, n, device, stream);
}
