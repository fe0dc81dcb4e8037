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
// of six; here every group's sums run in one order fixed by the group's
// width and the dtype alone, which no row count changes.  And a norm
// written in PyTorch ops is about eight launches (cast, square, mean, add,
// rsqrt, two products, cast); this is one.
//
// What bounds it on the H100: bytes, and at decode widths the launch.  Each
// element is read from device memory once and written once, with a few
// flops: a 4 x 2048 bf16 decode row set is 32 KB, far under the launch
// time; a 1024 x 2048 training batch 8.4 MB, 2.5 us at 3.35 TB/s.  So the
// design reads each row once with 16-byte loads, all issued before the
// first sum, and keeps the row in registers:
//
// * The plan (kernels/norm/norm.py:plan_norm, from the group's width and the
//   dtype alone): a group is cut into 16-byte vectors (8 bf16 or 4 f32
//   values); a group takes up to kMaxGroupThreads threads, each holding
//   ``loads`` vectors (a power of two up to kMaxLoads) in registers: thread
//   l of the group holds vectors l, l + threads, ...  Up to 32 threads a
//   group is a power of two, so small groups share a warp (rwkv's groups of
//   64 bf16 are 8 lanes each); wider groups take whole warps (2048 bf16:
//   256 threads, one load each).  A block holds whole groups.
// * The sums: each thread adds its values in order (vector by vector), a
//   butterfly over the group's lanes of the warp, then the group's warps'
//   sums added in warp order.  The same bits for a row whatever the row
//   count or the block that takes it.  LayerNorm's deviations come from
//   the registers (two sums, as the plain version's two passes).
// * Scale and bias are read as 16-byte vectors (before the sums, for up to
//   two loads a thread), y written once with 16-byte stores.
// * x may be a strided view: rows a fixed stride apart, the last axis
//   contiguous (deepseek's latent kv_a[..., :512] needs no copy).  Rows,
//   scale, bias or y that are not 16-byte aligned, or a group that is not a
//   whole number of vectors, take the same plan with element loads and
//   stores: the same sums in the same order.
//
// Optionally each group's mean (LayerNorm) and rstd are written out in f32,
// for the backward.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

// bytes a vector load or store moves
constexpr int kVecBytes = 16;
// the most threads a group takes, and the most vectors a thread holds
constexpr int kMaxGroupThreads = 512;
constexpr int kMaxLoads = 8;
constexpr int kMaxWarps = kMaxGroupThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct NormArgs {
  const void* x;      // rows ``row_stride`` elements apart, last axis contiguous
  void* y;            // (rows, d), x's dtype, contiguous
  const float* scale; // (d,)
  const float* bias;  // (d,) or null
  float* mean_out;    // (rows, d / group) or null (LayerNorm)
  float* rstd_out;    // (rows, d / group) or null
  long long rows, row_stride, units;
  int d, group;
  int threads;        // threads a group (the plan)
  int groups;         // groups a block
  float eps;
  int layer;          // 1: LayerNorm, 0: RMS
};

// V values from 16 bytes (vector) or element by element, as f32.
template <typename T, int V, bool kVec>
__device__ __forceinline__ void load_values(float (&out)[V], const T* p, int valid) {
  if constexpr (kVec) {
    if (valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = to_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = i < valid ? to_f32(p[i]) : 0.f;
  }
}

template <int V, bool kVec>
__device__ __forceinline__ void load_f32(float (&out)[V], const float* p, int valid) {
  if constexpr (kVec) {
    if (valid) {
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + i);
        out[i] = q.x;
        out[i + 1] = q.y;
        out[i + 2] = q.z;
        out[i + 3] = q.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = i < valid ? p[i] : 0.f;
  }
}

// The group's sum of every thread's ``v``: a butterfly over the group's
// lanes, then (a group of whole warps) the warps' sums in warp order.
__device__ __forceinline__ float group_sum(float v, int threads, float* red) {
  for (int o = min(threads, 32) / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threads <= 32) return v;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  const int w0 = (threadIdx.x / threads) * (threads / 32);
  float s = red[w0];
  for (int q = 1; q < threads / 32; ++q) s += red[w0 + q];
  return s;
}

// One block of ``groups`` groups of ``threads`` threads; each thread holds
// L vectors of its group.
template <typename T, int L, bool kVec>
__global__ void __launch_bounds__(kMaxGroupThreads) norm_kernel(NormArgs a) {
  constexpr int V = kVecBytes / sizeof(T);
  __shared__ float red[2][kMaxWarps];
  const int gi = threadIdx.x / a.threads, li = threadIdx.x % a.threads;
  const long long u = static_cast<long long>(blockIdx.x) * a.groups + gi;
  const bool live = u < a.units;          // a block's last groups may be absent
  const int gpr = a.d / a.group;
  const long long row = live ? u / gpr : 0;
  const int c0 = live ? static_cast<int>(u % gpr) * a.group : 0;
  const T* x = static_cast<const T*>(a.x) + row * a.row_stride + c0;
  T* y = static_cast<T*>(a.y) + row * a.d + c0;
  const float* scale = a.scale + c0;
  const float* bias = a.bias != nullptr ? a.bias + c0 : nullptr;

  // every load of the row first; valid[l]: values of vector l in the group
  float xv[L][V], sv[L][V], bv[L][V];
  int valid[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int e0 = (l * a.threads + li) * V;
    valid[l] = live ? max(0, min(V, a.group - e0)) : 0;
    load_values<T, V, kVec>(xv[l], x + e0, valid[l]);
  }
  constexpr bool kEarly = L <= 2;         // scale and bias beside x
  if constexpr (kEarly) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int e0 = (l * a.threads + li) * V;
      load_f32<V, kVec>(sv[l], scale + e0, valid[l]);
      if (bias != nullptr) load_f32<V, kVec>(bv[l], bias + e0, valid[l]);
    }
  }
  const float n = static_cast<float>(a.group);
  float mu = 0.f;
  if (a.layer) {
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (i < valid[l]) s += xv[l][i];
    mu = group_sum(s, a.threads, red[0]) / n;
  }
  float q = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < valid[l]) {
        const float c = xv[l][i] - mu;
        q = fmaf(c, c, q);
      }
  const float rstd = rsqrtf(group_sum(q, a.threads, red[1]) / n + a.eps);
  if (li == 0 && live) {
    if (a.mean_out != nullptr) a.mean_out[u] = mu;
    if (a.rstd_out != nullptr) a.rstd_out[u] = rstd;
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (!valid[l]) continue;
    const int e0 = (l * a.threads + li) * V;
    if constexpr (!kEarly) {
      load_f32<V, kVec>(sv[l], scale + e0, valid[l]);
      if (bias != nullptr) load_f32<V, kVec>(bv[l], bias + e0, valid[l]);
    }
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      o[i] = __fmul_rn(__fmul_rn(xv[l][i] - mu, rstd), sv[l][i]);
      if (bias != nullptr) o[i] = __fadd_rn(o[i], bv[l][i]);
    }
    if constexpr (kVec) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) store_as(e + i, o[i]);
      *reinterpret_cast<uint4*>(y + e0) = raw;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (i < valid[l]) store_as(y + e0 + i, o[i]);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int L>
void launch_loads(const NormArgs& a, bool vec, unsigned blocks, cudaStream_t st) {
  const int threads = a.threads * a.groups;
  if (vec)
    norm_kernel<T, L, true><<<blocks, threads, 0, st>>>(a);
  else
    norm_kernel<T, L, false><<<blocks, threads, 0, st>>>(a);
}

template <typename T>
int launch_norm(const void* x, void* y, const float* scale, const float* bias,
                float* mean_out, float* rstd_out, long long rows, int d, int group,
                long long row_stride, int threads, int loads, int groups, float eps,
                int layer, int device, void* stream) {
  constexpr int V = kVecBytes / sizeof(T);
  REPRO_SET_DEVICE(device);
  if (rows <= 0) return 0;
  const bool pow2 = threads > 0 && (threads & (threads - 1)) == 0;
  if (d <= 0 || group <= 0 || d % group != 0 || scale == nullptr || groups <= 0 ||
      threads <= 0 || threads > kMaxGroupThreads || (threads > 32 && threads % 32) ||
      (threads <= 32 && !pow2) || threads * groups > kMaxGroupThreads ||
      static_cast<long long>(loads) * threads * V < group)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = rows * (d / group);
  const long long blocks = (units + groups - 1) / groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const NormArgs a{x, y, scale, bias, mean_out, rstd_out, rows, row_stride, units,
                   d, group, threads, groups, eps, layer};
  const bool vec = group % V == 0 && aligned16(x) && aligned16(y) && aligned16(scale) &&
                   (bias == nullptr || aligned16(bias)) &&
                   (row_stride * static_cast<long long>(sizeof(T))) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  switch (loads) {
    case 1: launch_loads<T, 1>(a, vec, nb, st); break;
    case 2: launch_loads<T, 2>(a, vec, nb, st); break;
    case 4: launch_loads<T, 4>(a, vec, nb, st); break;
    case 8: launch_loads<T, 8>(a, vec, nb, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

// x rows ``row_stride`` elements apart, last axis contiguous; y (rows, d)
// contiguous; scale, bias (d,) f32 (bias may be null); mean_out, rstd_out
// (rows, d / group) f32 or null; group divides d; layer 1 for LayerNorm, 0
// for RMS; threads, loads and groups: plan_norm(group, dtype)'s threads a
// group, vectors a thread and groups a block.
REPRO_API int repro_norm_f32(const void* x, void* y, const float* scale, const float* bias,
                             float* mean_out, float* rstd_out, long long rows, int d,
                             int group, long long row_stride, int threads, int loads,
                             int groups, float eps, int layer, int device, void* stream) {
  return launch_norm<float>(x, y, scale, bias, mean_out, rstd_out, rows, d, group,
                            row_stride, threads, loads, groups, eps, layer, device, stream);
}

REPRO_API int repro_norm_bf16(const void* x, void* y, const float* scale, const float* bias,
                              float* mean_out, float* rstd_out, long long rows, int d,
                              int group, long long row_stride, int threads, int loads,
                              int groups, float eps, int layer, int device, void* stream) {
  return launch_norm<__nv_bfloat16>(x, y, scale, bias, mean_out, rstd_out, rows, d, group,
                                    row_stride, threads, loads, groups, eps, layer, device,
                                    stream);
}
