// C entry points shared by every kernel wrapper.
#include "common.cuh"

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
