// Helpers shared by the kernels' ctypes bindings (ops/cuda/_build.py).

#include <cuda_runtime.h>

extern "C" const char* snt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
