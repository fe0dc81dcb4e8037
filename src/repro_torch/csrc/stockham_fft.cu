// Batched radix-2 Stockham FFT: one complex transform of length n (a power
// of two) per row of re/im shaped (batch, n), output in natural order.
//
// Replaces the TPU kernel src/repro/kernels/stockham_fft/stockham_fft.py:
// _fft_kernel (launched by fft_pallas), which keeps both planes in VMEM for
// all log2(n) stages and computes the twiddles from an iota.
//
// What bounds it on the H100: bytes.  TinyBio transforms 128 windows of 512:
// 256 KB in, 512 KB out (about 0.23 us at 3.35 TB/s) against 2.9 M flops
// (about 0.04 us at 67 TFLOP/s), all far below the launch's few microseconds.
// The design keeps the transform out of device memory between stages, as
// the TPU kernel keeps it in VMEM: one block per signal loads its row into
// shared memory, ping-pongs re/im between two shared buffers (16 n bytes,
// 8 KB at n = 512) with one __syncthreads() per stage, and writes the row
// once at the end.
//
// Stage s works on the (2r, l) view of the previous stage (l = 2^s,
// r = n / 2l), the Van Loan recurrence of stockham_fft/ref.py: butterfly
// k < n/2 has j = k mod l, reads a = X[k] and b = X[k + n/2], and writes
// a + w_j b to 2k - j and a - w_j b to 2k - j + l, with w_j = exp(-i pi j / l).
// Twiddles follow the JAX kernel: the fp32 angle float(-pi / l) * j, then
// cosf/sinf (no fast math).  Products and sums are rounded one by one (no
// fused multiply-add), exactly as the plain PyTorch version computes them.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void stockham_fft_kernel(const float* __restrict__ re_in,
                                    const float* __restrict__ im_in,
                                    float* __restrict__ re_out,
                                    float* __restrict__ im_out, int n,
                                    int log2n) {
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;           // source planes of the current stage
  float* si = smem + n;
  float* dr = smem + 2 * n;   // destination planes
  float* di = smem + 3 * n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    sr[k] = re_in[row + k];
    si[k] = im_in != nullptr ? im_in[row + k] : 0.f;
  }
  __syncthreads();
  const int half = n >> 1;
  for (int s = 0; s < log2n; ++s) {
    const int l = 1 << s;
    const float step = static_cast<float>(-3.141592653589793 / static_cast<double>(l));
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int j = k & (l - 1);
      const float ang = __fmul_rn(step, static_cast<float>(j));
      const float wr = cosf(ang);
      const float wi = sinf(ang);
      const float ar = sr[k], ai = si[k];
      const float br = sr[k + half], bi = si[k + half];
      const float tr = __fsub_rn(__fmul_rn(wr, br), __fmul_rn(wi, bi));
      const float ti = __fadd_rn(__fmul_rn(wr, bi), __fmul_rn(wi, br));
      const int o = 2 * k - j;
      dr[o] = __fadd_rn(ar, tr);
      di[o] = __fadd_rn(ai, ti);
      dr[o + l] = __fsub_rn(ar, tr);
      di[o + l] = __fsub_rn(ai, ti);
    }
    __syncthreads();
    float* t = sr; sr = dr; dr = t;
    t = si; si = di; di = t;
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    re_out[row + k] = sr[k];
    im_out[row + k] = si[k];
  }
}

}  // namespace

// im may be NULL (a real input).  n must be a power of two whose four fp32
// planes fit in a block's shared memory (the wrapper checks n <= 8192).
REPRO_API int repro_stockham_fft_f32(const void* re, const void* im,
                                     void* re_out, void* im_out, int batch,
                                     int n, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (batch <= 0 || n <= 0) return 0;
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(n);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stockham_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int threads = n / 2;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  stockham_fft_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(re_out), static_cast<float*>(im_out), n, log2n);
  return REPRO_LAUNCH_STATUS();
}
