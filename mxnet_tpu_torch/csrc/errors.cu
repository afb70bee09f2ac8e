// Error text for the CUDA codes the kernel entry points return.
#include <cuda_runtime.h>

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
