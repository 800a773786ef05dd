// Error text for the cudaError_t codes the kernel entry points return
// (the Python wrappers raise with it; see kernels/_common.py).
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
