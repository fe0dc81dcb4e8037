// SVM decision sums: out[q] = sum_i alpha[i] * K(x[q], sv[i]), with the RBF
// kernel K = exp(-gamma * max(|x|^2 + |sv|^2 - 2 x.sv, 0)) or the linear
// kernel K = x.sv.  The bias b is added by the wrapper.
//
// Replaces the TPU kernel src/repro/kernels/svm/svm.py:_svm_kernel (launched
// by svm_pallas), whose sequential grid walks blocks of support vectors and
// accumulates K_tile @ alpha_tile in a VMEM scratch, so the q x m kernel
// matrix never exists in HBM.
//
// What bounds it on the H100: operations, by a hair: TinyBio's q = 128
// queries, m = 256 support vectors and d = 36 features need about 2.6 M
// flops (0.04 us at 67 TFLOP/s) and 57 KB (0.02 us at 3.35 TB/s); the launch's
// few microseconds dwarf both.  Blocks run in no order on Hopper, so nothing
// carries a sum from one block to the next: instead each block owns
// kQueries queries and loops over ALL m support vectors itself, one support
// vector per thread per pass, keeping its queries' rows in shared memory.
// |x|^2 and |sv|^2 are computed here (the TPU wrapper precomputed them).  A
// fixed-order warp-shuffle and shared-memory reduction gives each query's
// sum, so repeated runs give the same bits.  The kernel matrix is never
// stored, and nothing is padded: the ragged query tail is masked.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQueries = 4;   // queries per block
constexpr int kWarps = kThreads / 32;

__global__ void svm_kernel(const float* __restrict__ x,
                           const float* __restrict__ sv,
                           const float* __restrict__ alpha,
                           float* __restrict__ out, int q, int m, int d,
                           float gamma, int rbf) {
  extern __shared__ __align__(16) float xs[];   // [kQueries * d]
  __shared__ float xsq[kQueries];
  __shared__ float partial[kQueries][kWarps];
  const int q0 = blockIdx.x * kQueries;
  const int nq = min(kQueries, q - q0);
  for (int k = threadIdx.x; k < kQueries * d; k += blockDim.x)
    xs[k] = k < nq * d ? x[static_cast<size_t>(q0) * d + k] : 0.f;
  __syncthreads();
  if (threadIdx.x < kQueries) {
    float s = 0.f;
    for (int c = 0; c < d; ++c) {
      const float v = xs[threadIdx.x * d + c];
      s = fmaf(v, v, s);
    }
    xsq[threadIdx.x] = s;
  }
  __syncthreads();

  float acc[kQueries];
#pragma unroll
  for (int a = 0; a < kQueries; ++a) acc[a] = 0.f;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float* v = sv + static_cast<size_t>(i) * d;
    float vsq = 0.f;
    float dot[kQueries];
#pragma unroll
    for (int a = 0; a < kQueries; ++a) dot[a] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float vc = v[c];
      vsq = fmaf(vc, vc, vsq);
#pragma unroll
      for (int a = 0; a < kQueries; ++a) dot[a] = fmaf(xs[a * d + c], vc, dot[a]);
    }
    const float al = alpha[i];
#pragma unroll
    for (int a = 0; a < kQueries; ++a) {
      float k;
      if (rbf) {
        const float d2 = xsq[a] + vsq - 2.f * dot[a];
        k = expf(-gamma * fmaxf(d2, 0.f));
      } else {
        k = dot[a];
      }
      acc[a] = fmaf(al, k, acc[a]);
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kQueries; ++a) {
    float v = acc[a];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) partial[a][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += partial[threadIdx.x][w];
    out[q0 + threadIdx.x] = s;
  }
}

}  // namespace

// gamma is ignored when rbf == 0.  The wrapper checks kQueries * d * 4 bytes
// fit in 48 KB of shared memory (d <= 3072).
REPRO_API int repro_svm_f32(const void* x, const void* sv, const void* alpha,
                            void* out, int q, int m, int d, float gamma,
                            int rbf, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (q <= 0) return 0;
  const int blocks = (q + kQueries - 1) / kQueries;
  const size_t smem = sizeof(float) * kQueries * static_cast<size_t>(d);
  svm_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(sv),
      static_cast<const float*>(alpha), static_cast<float*>(out), q, m, d,
      gamma, rbf);
  return REPRO_LAUNCH_STATUS();
}
