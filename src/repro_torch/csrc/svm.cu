// SVM decision values: out[q] = sum_i alpha[i] * K(x[q], sv[i]) + b, with
// the RBF kernel K = exp(-gamma * max(|x|^2 + |sv|^2 - 2 x.sv, 0)) or the
// linear kernel K = x.sv.
//
// Replaces the TPU kernel src/repro/kernels/svm/svm.py:_svm_kernel (launched
// by svm_pallas), whose sequential grid walks blocks of support vectors and
// accumulates K_tile @ alpha_tile in a VMEM scratch, so the q x m kernel
// matrix never exists in HBM.
//
// What bounds it on the H100: one launch, and the support vectors that
// every block reads.  TinyBio's q = 128 queries, m = 256 support vectors
// and d = 36 features need about 2.6 M flops (0.04 us at 67 TFLOP/s) and
// 57 KB (0.02 us at 3.35 TB/s), far below the launch floor of about 1 us.
// But each block sums over all m support vectors itself, so each of the
// 128 blocks pulls the whole 36 KB of them from L2: 4.7 MB crossing from L2
// to the SMs at once.  Staging them in shared memory first (cp.async, 16
// bytes a copy) left every SM waiting on its own stream of copies, 4 us
// over the floor on an H100; reading each thread's rows straight into
// registers (16-byte loads, no barrier before the sums) takes 2 us over
// it (PERF.md, Findings).  The design:
// * One launch: the bias is added here, s + b in one f32 add, the bits of
//   the elementwise add it replaces.  b comes through a device pointer
//   (a 0-d tensor on the card, read by the kernel: no synchronisation) or
//   as a float (a number or a CPU tensor); b_ptr == NULL selects the float.
// * A grid that covers the card: each block owns kQ queries, kQ in 1, 2,
//   4, 8, chosen by plan_svm (kernels/svm/svm.py) so that the grid has at
//   least one block per SM wherever q allows (TinyBio: 1 query a block,
//   128 blocks); at large q, several queries share each support vector a
//   thread has loaded.  Each block sums over all m support vectors itself,
//   in an order fixed by m and d alone: no atomics, no sequential grid,
//   and neither kQ nor the rows' alignment changes any query's bits.
// * Thread t owns support vectors t, t + 256, ..: |sv|^2, the kQ dots and
//   the kQ |x|^2 in one pass over d, four features a step (16-byte loads
//   where every row is 16-byte aligned, d a multiple of 4 and aligned
//   bases; four 4-byte loads otherwise), as four partial sums combined as
//   (s0 + s1) + (s2 + s3), then the d % 4 tail in order.  The query rows
//   are read by every thread alike (one L1 line a warp).
// * CUDA cores, not tensor cores: at TinyBio the product is 2.4 MFLOP.  A
//   wgmma tile would buy nothing below the launch floor, and the 3xTF32
//   split it would need for f32 parity adds latency.
// * A warp's 32 sums meet by a shuffle tree, the 8 warps' sums in order by
//   one thread.  The q x m kernel matrix is never stored and nothing is
//   padded.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// features 4c .. 4c + 3 of a row
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* row, int c) {
  if constexpr (kVec) return __ldg(reinterpret_cast<const float4*>(row) + c);
  return make_float4(__ldg(row + 4 * c), __ldg(row + 4 * c + 1),
                     __ldg(row + 4 * c + 2), __ldg(row + 4 * c + 3));
}

__device__ __forceinline__ void fma4(float4& s, float4 a, float4 b) {
  s.x = fmaf(a.x, b.x, s.x);
  s.y = fmaf(a.y, b.y, s.y);
  s.z = fmaf(a.z, b.z, s.z);
  s.w = fmaf(a.w, b.w, s.w);
}

__device__ __forceinline__ float combine(float4 s) {
  return (s.x + s.y) + (s.z + s.w);
}

struct SvmArgs {
  const float* x;
  const float* sv;
  const float* alpha;
  const float* b_ptr;   // NULL: add b
  float* out;
  float b, gamma;
  int q, m, d, rbf;
};

template <int kQ, bool kVec>
__global__ void __launch_bounds__(kThreads) svm_kernel(const SvmArgs a) {
  __shared__ float partial[kQ][kWarps];
  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kQ;
  const int nq = min(kQ, a.q - q0);
  const float bias = t < nq && a.b_ptr != nullptr ? *a.b_ptr : a.b;
  const float* xq[kQ];   // the block's query rows (the last one repeated)
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    xq[i] = a.x + static_cast<size_t>(q0 + min(i, nq - 1)) * a.d;
  const int d4 = a.d / 4;

  float acc[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) acc[i] = 0.f;
  for (int r = t; r < a.m; r += kThreads) {
    const float al = __ldg(a.alpha + r);
    const float* v = a.sv + static_cast<size_t>(r) * a.d;
    float4 sq = make_float4(0.f, 0.f, 0.f, 0.f), dt[kQ], xx[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) dt[i] = xx[i] = sq;
#pragma unroll 4
    for (int c = 0; c < d4; ++c) {
      const float4 e = load4<kVec>(v, c);
      fma4(sq, e, e);
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const float4 u = load4<kVec>(xq[i], c);
        fma4(dt[i], u, e);
        fma4(xx[i], u, u);
      }
    }
    float vsq = combine(sq), dot[kQ], xsq[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      dot[i] = combine(dt[i]);
      xsq[i] = combine(xx[i]);
    }
    for (int c = 4 * d4; c < a.d; ++c) {
      const float e = __ldg(v + c);
      vsq = fmaf(e, e, vsq);
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const float u = __ldg(xq[i] + c);
        dot[i] = fmaf(u, e, dot[i]);
        xsq[i] = fmaf(u, u, xsq[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const float k = a.rbf
          ? expf(-a.gamma * fmaxf(xsq[i] + vsq - 2.f * dot[i], 0.f))
          : dot[i];
      acc[i] = fmaf(al, k, acc[i]);
    }
  }

  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) partial[i][warp] = v;
  }
  __syncthreads();
  if (t < nq) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[t][w];
    a.out[q0 + t] = __fadd_rn(s, bias);
  }
}

template <int kQ>
int launch_svm(const SvmArgs& a, bool vec, cudaStream_t stream) {
  const int blocks = (a.q + kQ - 1) / kQ;
  if (vec)
    svm_kernel<kQ, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    svm_kernel<kQ, false><<<blocks, kThreads, 0, stream>>>(a);
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

// gamma is ignored when rbf == 0.  b_ptr (a device float) or, when it is
// NULL, b is the bias.  `queries` (1, 2, 4 or 8 a block) comes from
// plan_svm.
REPRO_API int repro_svm_f32(const void* x, const void* sv, const void* alpha,
                            const void* b_ptr, float b, void* out, int q,
                            int m, int d, float gamma, int rbf, int queries,
                            int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (q <= 0) return 0;
  if (m < 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sv) % 16 == 0;
  const SvmArgs a{static_cast<const float*>(x), static_cast<const float*>(sv),
                  static_cast<const float*>(alpha),
                  static_cast<const float*>(b_ptr), static_cast<float*>(out),
                  b, gamma, q, m, d, rbf};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (queries) {
    case 1: return launch_svm<1>(a, vec, s);
    case 2: return launch_svm<2>(a, vec, s);
    case 4: return launch_svm<4>(a, vec, s);
    case 8: return launch_svm<8>(a, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
