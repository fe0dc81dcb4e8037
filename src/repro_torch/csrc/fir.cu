// Causal FIR filter, y[i] = sum_t h[t] * x[i - t], zero history before x[0].
//
// Replaces the TPU kernel src/repro/kernels/fir/fir.py:_fir_kernel (launched
// by fir_pallas), which reads the previous block as a halo and unrolls the
// taps loop over VMEM.
//
// What bounds it on the H100: at TinyBio's size (65,536 samples, 128 taps)
// the arithmetic (2 x 8.4 M flops, about 0.25 us at 67 TFLOP/s fp32) outweighs
// the bytes (0.5 MB, about 0.16 us at 3.35 TB/s), and both are far below the
// few microseconds a launch takes, so the launch bounds it.  The design keeps
// every input byte read from device memory about once: a block loads its
// tile of 256 outputs' inputs plus the taps-1 halo before it, and the taps,
// into shared memory, then each thread runs the whole taps loop from there.
//
// Float path: fp32, taps added in order t = 0..taps-1 with every product
// and sum rounded on its own (no fused multiply-add), which is exactly what
// the plain PyTorch version computes.  Integer path: products and sums in
// uint32 (wraparound, defined behaviour), read back as int32, arithmetic
// shift right by the Q15 shift, then narrowed to the output type — exactly
// the int32 wraparound of the JAX kernel and of the plain version.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 256;  // outputs per block == threads per block

template <typename T, typename S>  // S: float (float path) or int32_t
__global__ void fir_kernel(const T* __restrict__ x, const S* __restrict__ h,
                           T* __restrict__ y, int n, int taps, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  S* hs = reinterpret_cast<S*>(smem);   // [taps]
  S* xs = hs + taps;                    // [kTile + taps - 1]: x[base-taps+1 ..]
  const int base = blockIdx.x * kTile;
  const int span = kTile + taps - 1;
  for (int k = threadIdx.x; k < taps; k += blockDim.x) hs[k] = h[k];
  for (int k = threadIdx.x; k < span; k += blockDim.x) {
    const long long g = static_cast<long long>(base) - (taps - 1) + k;
    xs[k] = (g >= 0 && g < n) ? static_cast<S>(x[g]) : S(0);
  }
  __syncthreads();
  const int i = base + threadIdx.x;
  if (i >= n) return;
  // x[i - t] sits at xs[threadIdx.x + taps - 1 - t]
  const S* w = xs + threadIdx.x + taps - 1;
  if constexpr (std::is_floating_point<S>::value) {
    float acc = 0.f;
    for (int t = 0; t < taps; ++t) acc = __fadd_rn(acc, __fmul_rn(hs[t], w[-t]));
    y[i] = static_cast<T>(acc);
  } else {  // int32 with wraparound
    uint32_t acc = 0u;
    for (int t = 0; t < taps; ++t)
      acc += static_cast<uint32_t>(hs[t]) * static_cast<uint32_t>(w[-t]);
    const int32_t r = static_cast<int32_t>(acc) >> shift;
    y[i] = static_cast<T>(r);
  }
}

template <typename T, typename S>
int launch_fir(const T* x, const S* h, T* y, int n, int taps, int shift,
               int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (n <= 0) return 0;
  const int blocks = (n + kTile - 1) / kTile;
  const size_t smem = sizeof(S) * (static_cast<size_t>(taps) + kTile + taps - 1);
  fir_kernel<T, S><<<blocks, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      x, h, y, n, taps, shift);
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

REPRO_API int repro_fir_f32(const void* x, const void* h, void* y, int n,
                            int taps, int device, void* stream) {
  return launch_fir(static_cast<const float*>(x), static_cast<const float*>(h),
                    static_cast<float*>(y), n, taps, 0, device, stream);
}

REPRO_API int repro_fir_i16(const void* x, const void* h, void* y, int n,
                            int taps, int shift, int device, void* stream) {
  return launch_fir(static_cast<const int16_t*>(x),
                    static_cast<const int32_t*>(h), static_cast<int16_t*>(y),
                    n, taps, shift, device, stream);
}

REPRO_API int repro_fir_i32(const void* x, const void* h, void* y, int n,
                            int taps, int shift, int device, void* stream) {
  return launch_fir(static_cast<const int32_t*>(x),
                    static_cast<const int32_t*>(h), static_cast<int32_t*>(y),
                    n, taps, shift, device, stream);
}
