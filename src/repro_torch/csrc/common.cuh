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
