// Error strings for the codes the library's launch functions return.
#include <cuda_runtime.h>

extern "C" const char* epk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
