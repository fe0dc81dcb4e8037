// Row norms of the models: RMS norm and LayerNorm (population variance),
// over each row of x (rows, d) or over each group of ``group`` columns of a
// row, in f32, scaled (and shifted) per column by f32 vectors, cast back to
// x's dtype (float32 or bfloat16):
//
//   RMS:        y = (x * rsqrt(mean(x^2) + eps)) * scale
//   LayerNorm:  y = ((x - mu) * rsqrt(mean((x - mu)^2) + eps)) * scale + bias
//
// Replaces no TPU kernel: the JAX package leaves its norms to XLA
// (src/repro/models/layers.py apply_norm, rms_norm_1d; rwkv's per-head group
// norm; the audio frontend's LayerNorm).  It was added for two reasons.
// PyTorch's own f32 mean over a row picks its reduction by the number of
// rows, so a decode step's row got other bits at B = 1 or 2 than in a batch
// of six; here every group's sums run in one fixed order that no row count
// changes.  And a norm written in PyTorch ops is about eight launches (cast,
// square, mean, add, rsqrt, two products, cast); this is one.
//
// Order of the sums: a group is reduced either by one warp (group <= 1024
// columns: lane l sums columns l, l + 32, ... in turn, then a butterfly over
// the warp), or by one block of 256 threads (thread i sums columns i,
// i + 256, ..., a butterfly over each warp, then the 8 warps' sums added in
// warp order).  Which warp or block takes a group never changes its bits.
// LayerNorm takes two passes (the mean, then the squared deviations, as
// the plain version does); RMS one.  Optionally each group's mean (LayerNorm)
// and rstd are written out in f32, for the backward.
//
// What bounds it on the H100: bytes.  Each element is read from device
// memory once (the later passes hit L1) and written once, with a few flops
// per element: a 4 x 2048 bf16 decode row set is 32 KB, far under the
// launch time; a 1024 x 2048 training batch 8.4 MB, 2.5 us at 3.35 TB/s.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the widest group a single warp reduces
constexpr int kWarpGroupMax = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct NormArgs {
  const void* x;      // (rows, d), contiguous
  void* y;            // (rows, d), x's dtype
  const float* scale; // (d,)
  const float* bias;  // (d,) or null
  float* mean_out;    // (rows, d / group) or null (LayerNorm)
  float* rstd_out;    // (rows, d / group) or null
  long long rows;
  int d, group;
  float eps;
  int layer;          // 1: LayerNorm, 0: RMS
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The group's sum of every thread's ``v``: over the warp, or over the block
// (each warp's sum through shared memory, added in warp order).
template <bool kBlock>
__device__ __forceinline__ float group_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (!kBlock) {
    return v;
  } else {
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w];
    __syncthreads();   // red is written again by the next sum
    return s;
  }
}

// kBlock: one block per (row, group); else one warp per (row, group).
template <typename T, bool kBlock>
__global__ void __launch_bounds__(kThreads) norm_kernel(NormArgs a) {
  __shared__ float red[kWarps];
  const int gpr = a.d / a.group;
  const long long units = a.rows * gpr;
  const long long u = kBlock ? static_cast<long long>(blockIdx.x)
                             : static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (u >= units) return;          // a whole warp (warp mode) or block leaves
  const int first = kBlock ? threadIdx.x : threadIdx.x % 32;
  constexpr int kStep = kBlock ? kThreads : 32;
  const long long row = u / gpr;
  const int c0 = static_cast<int>(u % gpr) * a.group;
  const T* x = static_cast<const T*>(a.x) + row * a.d + c0;
  T* y = static_cast<T*>(a.y) + row * a.d + c0;
  const float n = static_cast<float>(a.group);

  float mu = 0.f;
  if (a.layer) {
    float s = 0.f;
    for (int i = first; i < a.group; i += kStep) s += to_f32(x[i]);
    mu = group_sum<kBlock>(s, red) / n;
  }
  float q = 0.f;
  for (int i = first; i < a.group; i += kStep) {
    const float c = to_f32(x[i]) - mu;
    q = fmaf(c, c, q);
  }
  const float rstd = rsqrtf(group_sum<kBlock>(q, red) / n + a.eps);
  if (first == 0) {
    if (a.mean_out != nullptr) a.mean_out[u] = mu;
    if (a.rstd_out != nullptr) a.rstd_out[u] = rstd;
  }
  for (int i = first; i < a.group; i += kStep) {
    float v = __fmul_rn(__fmul_rn(to_f32(x[i]) - mu, rstd), a.scale[c0 + i]);
    if (a.bias != nullptr) v = __fadd_rn(v, a.bias[c0 + i]);
    store_as(y + i, v);
  }
}

template <typename T>
int launch_norm(const void* x, void* y, const float* scale, const float* bias,
                float* mean_out, float* rstd_out, long long rows, int d, int group,
                float eps, int layer, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (rows <= 0) return 0;
  if (d <= 0 || group <= 0 || d % group != 0 || scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const NormArgs a{x, y, scale, bias, mean_out, rstd_out, rows, d, group, eps, layer};
  const long long units = rows * (d / group);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group > kWarpGroupMax) {
    if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    norm_kernel<T, true><<<static_cast<unsigned>(units), kThreads, 0, st>>>(a);
  } else {
    const long long blocks = (units + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    norm_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
  }
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

// x, y (rows, d) contiguous; scale, bias (d,) f32 (bias may be null);
// mean_out, rstd_out (rows, d / group) f32 or null; group divides d;
// layer 1 for LayerNorm, 0 for RMS.
REPRO_API int repro_norm_f32(const void* x, void* y, const float* scale, const float* bias,
                             float* mean_out, float* rstd_out, long long rows, int d,
                             int group, float eps, int layer, int device, void* stream) {
  return launch_norm<float>(x, y, scale, bias, mean_out, rstd_out, rows, d, group, eps,
                            layer, device, stream);
}

REPRO_API int repro_norm_bf16(const void* x, void* y, const float* scale, const float* bias,
                              float* mean_out, float* rstd_out, long long rows, int d,
                              int group, float eps, int layer, int device, void* stream) {
  return launch_norm<__nv_bfloat16>(x, y, scale, bias, mean_out, rstd_out, rows, d, group,
                                    eps, layer, device, stream);
}
