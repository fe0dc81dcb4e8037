// Shared declarations for the hand-written Hopper kernels of repro_torch.
//
// Every entry point has a plain C interface: device pointers, sizes, the
// CUDA device index and the cudaStream_t (all pointers as void* from
// ctypes).  It launches on the given stream, never synchronizes, allocates
// nothing, and returns the cudaError_t of the launch (0 on success).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define REPRO_API extern "C" __attribute__((visibility("default")))

// Select the caller's device, then report the launch's own error.
#define REPRO_SET_DEVICE(dev)                         \
  do {                                                \
    cudaError_t _e = cudaSetDevice(dev);              \
    if (_e != cudaSuccess) return static_cast<int>(_e); \
  } while (0)

#define REPRO_LAUNCH_STATUS() static_cast<int>(cudaGetLastError())

// Device helpers shared by the scans' backward kernels.
//
// Sum K values over the lanes of a warp that differ in the lane bits M,
// M / 2, .., kLo (a reduce-scatter: each halving keeps half the values),
// leaving one value a lane and its index in idx; once one value is left,
// the remaining lane bits down to kLo add it whole.  The two lanes of a
// pair add the same two operands (in either order), so lanes that end with
// the same index hold the same bits.
template <int K, int M, int kLo, int K0>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[K0], int lane, int& idx) {
  if constexpr (M >= kLo) {
    if constexpr (K > 1) {
      constexpr int H = K / 2;
      const bool up = lane & M;
#pragma unroll
      for (int e = 0; e < H; ++e) {
        const float send = up ? v[e] : v[e + H];
        const float keep = up ? v[e + H] : v[e];
        v[e] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      if (up) idx += H;
      warp_reduce_scatter<H, M / 2, kLo>(v, lane, idx);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      warp_reduce_scatter<1, M / 2, kLo>(v, lane, idx);
    }
  }
}
