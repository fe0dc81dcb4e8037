// A kernel that does nothing, for the card's launch floor: the least device
// time a launch of `blocks` blocks of `threads` threads takes in a
// measurement (chip_smoke.py phase 3 times it the way it times the
// kernels, beside the TinyBio kernels, whose work is far below it).  It
// replaces no TPU kernel and no path of the port calls it.
#include "common.cuh"

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

REPRO_API int repro_launch_floor(int blocks, int threads, int device,
                                 void* stream) {
  REPRO_SET_DEVICE(device);
  launch_floor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return REPRO_LAUNCH_STATUS();
}
