// Error text for the cudaError_t codes the kernel entry points return.
#include "common.cuh"

REPRO_API const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
