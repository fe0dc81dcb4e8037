// RWKV-6 (Finch) WKV scan: r/k/v/w (B, H, T, D), u (H, D), optional state0
// (B, H, D, D) -> y (B, H, T, D) in r's dtype and the final state
// (B, H, D, D) in f32:
//
//     y_t[j]   = sum_i r_t[i] * (S_{t-1}[i, j] + u[i] * k_t[i] * v_t[j])
//     S_t[i,j] = w_t[i] * S_{t-1}[i, j] + k_t[i] * v_t[j]
//
// Replaces the TPU kernel
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py:_rwkv6_kernel (launched by
// rwkv6_scan_pallas), which walks a (B, H, T / 32) grid with time innermost
// and sequential, carrying the D x D state across grid steps in VMEM and
// turning each chunk of 32 steps into matmuls in the log-decay form.  It
// also replaces the XLA chunked path of ops.rwkv6_scan, which is what the
// JAX package runs whenever a state is passed (its prefill and decode do):
// this kernel takes state0 or starts from zeros, the same function as the
// TPU kernel's state0 = None.
//
// Design: one block per (b, h) walks the recurrence step by step (the
// oracle's form, ref.py), with the state in registers for the whole time
// loop.  Column j of S evolves on its own (S[:, j] needs only v_t[j]), so
// thread (j, p) of D * 4 threads holds rows i = p, p + 4, ... of column j
// (D / 4 floats); y_t[j] is the sum of the four threads' partial dot
// products, taken with two lane shuffles in a fixed order.  The u bonus
// enters as v_t[j] * sum_i r_t[i] u[i] k_t[i], a sum that each thread
// forms over its own rows.  The block stages r, k, v and w of kRun steps
// in shared memory (one coalesced pass), runs those steps without a
// barrier, and writes their y through shared memory as one coalesced pass.
// Any T works and nothing is padded: the last run is shorter (the TPU
// kernel's w = 1, k = 0 padding is exactly a step that does nothing).
// r, k, v and w may be strided views (any strides over b, h and t, the
// last axis contiguous); y and the state are contiguous.
//
// Arithmetic: f32 throughout; the step form sums the same terms as the
// chunked form of the plain version in another order (and without its
// exp/log round trip), so the two agree to f32 rounding, not bit for bit.
//
// What bounds it on the H100: for rwkv6-3b's prefill (B = 4, H = 40,
// T = 256, D = 64) 5 D^2 flops per step and head are 0.84 GFLOP, 12.5 us
// at 67 TFLOP/s, against about 34 MB of inputs and outputs (10 us at
// 3.35 TB/s): operations.  A decode step (T = 1) moves 5.2 MB of state in
// and out: 1.6 us.  The step-by-step walk is latency-bound (each step is a
// chain of D / 4 dependent FMAs per thread, and 160 blocks of 256 threads
// leave the SMs thinly occupied); the chunked tensor-core form is for a
// later version.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kParts = 4;    // threads per state column
constexpr int kRun = 32;     // time steps staged per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;        // (H, D)
  const float* s0;       // (B, H, D, D) or null for zeros
  void* y;               // (B, H, T, D), r's dtype
  float* s_out;          // (B, H, D, D)
  int b, h, t;
  long long st[12];      // (b, h, t) strides of r, k, v, w
};

template <typename TI, typename TW, int D>
__global__ void __launch_bounds__(D * kParts) rwkv6_kernel(Args a) {
  constexpr int kThreads = D * kParts;
  constexpr int kRows = D / kParts;   // state rows per thread
  __shared__ float rs[kRun][D], ks[kRun][D], vs[kRun][D], ws[kRun][D];
  __shared__ float ys[kRun][D];
  __shared__ float us[D];

  const int tid = threadIdx.x;
  const int j = tid / kParts, part = tid % kParts;
  const int bh = blockIdx.x, b = bh / a.h, h = bh % a.h;

  const TI* r = static_cast<const TI*>(a.r) + b * a.st[0] + h * a.st[1];
  const TI* k = static_cast<const TI*>(a.k) + b * a.st[3] + h * a.st[4];
  const TI* v = static_cast<const TI*>(a.v) + b * a.st[6] + h * a.st[7];
  const TW* w = static_cast<const TW*>(a.w) + b * a.st[9] + h * a.st[10];
  const long long r_t = a.st[2], k_t = a.st[5], v_t = a.st[8], w_t = a.st[11];

  float s[kRows];
  const long long sbase = static_cast<long long>(bh) * D * D;
#pragma unroll
  for (int m = 0; m < kRows; ++m)
    s[m] = a.s0 ? a.s0[sbase + (part + kParts * m) * D + j] : 0.f;
  if (tid < D) us[tid] = a.u[h * D + tid];

  TI* y = static_cast<TI*>(a.y) + static_cast<long long>(bh) * a.t * D;
  for (int t0 = 0; t0 < a.t; t0 += kRun) {
    const int n = min(kRun, a.t - t0);
    __syncthreads();   // the previous run's ys are stored, the tiles free
    for (int idx = tid; idx < n * D; idx += kThreads) {
      const int tt = idx / D, d = idx % D;
      const int t = t0 + tt;
      rs[tt][d] = to_f32(r[t * r_t + d]);
      ks[tt][d] = to_f32(k[t * k_t + d]);
      vs[tt][d] = to_f32(v[t * v_t + d]);
      ws[tt][d] = to_f32(w[t * w_t + d]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int i = part + kParts * m;
        const float ri = rs[tt][i], ki = ks[tt][i];
        acc = fmaf(ri, s[m], acc);
        bonus = fmaf(ri * us[i], ki, bonus);
        s[m] = fmaf(ws[tt][i], s[m], ki * vj);
      }
      acc = fmaf(bonus, vj, acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) ys[tt][j] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < n * D; idx += kThreads)
      store_as(y + static_cast<long long>(t0) * D + idx, ys[idx / D][idx % D]);
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m)
    a.s_out[sbase + (part + kParts * m) * D + j] = s[m];
}

template <typename TI, typename TW>
int launch_rwkv6(const Args& a, int d, cudaStream_t stream) {
  const dim3 grid(a.b * a.h);
  switch (d) {
    case 32:
      rwkv6_kernel<TI, TW, 32><<<grid, 32 * kParts, 0, stream>>>(a);
      break;
    case 64:
      rwkv6_kernel<TI, TW, 64><<<grid, 64 * kParts, 0, stream>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return REPRO_LAUNCH_STATUS();
}

template <typename TI, typename TW>
int rwkv6_entry(const void* r, const void* k, const void* v, const void* w,
                const float* u, const float* s0, void* y, float* s_out, int b,
                int h, int t, int d, const long long* strides, int device,
                void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0) return 0;
  if (t < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, w, u, s0, y, s_out, b, h, t, {}};
  for (int i = 0; i < 12; ++i) a.st[i] = strides[i];
  return launch_rwkv6<TI, TW>(a, d, static_cast<cudaStream_t>(stream));
}

}  // namespace

// D in {32, 64} (each thread's D / 4 state rows live in registers);
// strides: 12 element strides, (batch, head, time) of r, then k, v and w;
// s0 may be null (a zero state).  _f32: r, k, v, w float32; _bf16: r, k, v
// bfloat16 and w float32 (as the model passes them); _bf16w: all bfloat16.
REPRO_API int repro_rwkv6_scan_f32(const void* r, const void* k, const void* v,
                                   const void* w, const float* u,
                                   const float* s0, void* y, float* s_out,
                                   int b, int h, int t, int d,
                                   const long long* strides, int device,
                                   void* stream) {
  return rwkv6_entry<float, float>(r, k, v, w, u, s0, y, s_out, b, h, t, d,
                                   strides, device, stream);
}

REPRO_API int repro_rwkv6_scan_bf16(const void* r, const void* k, const void* v,
                                    const void* w, const float* u,
                                    const float* s0, void* y, float* s_out,
                                    int b, int h, int t, int d,
                                    const long long* strides, int device,
                                    void* stream) {
  return rwkv6_entry<__nv_bfloat16, float>(r, k, v, w, u, s0, y, s_out, b, h,
                                           t, d, strides, device, stream);
}

REPRO_API int repro_rwkv6_scan_bf16w(const void* r, const void* k,
                                     const void* v, const void* w,
                                     const float* u, const float* s0, void* y,
                                     float* s_out, int b, int h, int t, int d,
                                     const long long* strides, int device,
                                     void* stream) {
  return rwkv6_entry<__nv_bfloat16, __nv_bfloat16>(
      r, k, v, w, u, s0, y, s_out, b, h, t, d, strides, device, stream);
}
