// Peak/trough delineation: int8 flags, +1 where x[i] > x[i-1], x[i] >= x[i+1]
// and x[i] > thr; -1 where x[i] < x[i-1], x[i] <= x[i+1] and x[i] < -thr;
// 0 elsewhere and at both endpoints.
//
// Replaces the TPU kernel src/repro/kernels/delineate/delineate.py:
// _delineate_kernel (launched by delineate_pallas), which gets the previous,
// current and next block as three views so each lane sees its neighbours.
//
// What bounds it on the H100: bytes.  At TinyBio's 65,536 float samples it
// reads 256 KB and writes 64 KB (about 0.1 us at 3.35 TB/s) and does a few
// compares per sample, far below the launch's few microseconds.  The design
// is one thread per sample with clamped neighbour reads (prev of index 0 is
// x[0], next of index n-1 is x[n-1]); neighbouring threads read neighbouring
// addresses, so the three reads of a warp coalesce and hit the same lines.
// thr and -thr arrive already cast to x's type, as the JAX kernel compares.
// A thread owning the four samples of one 16-byte load (neighbours by
// shuffles, a grid four times smaller) was measured slower than this at
// TinyBio's 65,536 samples and faster only near 2^20, a size no path runs
// (PERF.md, Findings); a grid of one thread a sample already pays a single
// load round trip over the launch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void delineate_kernel(const T* __restrict__ x,
                                 int8_t* __restrict__ flags, int n, T thr,
                                 T neg_thr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T xc = x[i];
  const T prev = x[i > 0 ? i - 1 : 0];
  const T next = x[i < n - 1 ? i + 1 : n - 1];
  const bool interior = i > 0 && i < n - 1;
  const bool peak = interior && xc > prev && xc >= next && xc > thr;
  const bool trough = interior && xc < prev && xc <= next && xc < neg_thr;
  flags[i] = static_cast<int8_t>(static_cast<int>(peak) - static_cast<int>(trough));
}

template <typename T>
int launch_delineate(const void* x, void* flags, int n, T thr, T neg_thr,
                     int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  delineate_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(flags), n, thr, neg_thr);
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

REPRO_API int repro_delineate_f32(const void* x, void* flags, int n, float thr,
                                  float neg_thr, int device, void* stream) {
  return launch_delineate<float>(x, flags, n, thr, neg_thr, device, stream);
}

REPRO_API int repro_delineate_i16(const void* x, void* flags, int n, int thr,
                                  int neg_thr, int device, void* stream) {
  return launch_delineate<int16_t>(x, flags, n, static_cast<int16_t>(thr),
                                   static_cast<int16_t>(neg_thr), device, stream);
}

REPRO_API int repro_delineate_i32(const void* x, void* flags, int n, int thr,
                                  int neg_thr, int device, void* stream) {
  return launch_delineate<int32_t>(x, flags, n, thr, neg_thr, device, stream);
}
