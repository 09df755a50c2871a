#include "common.cuh"

// Text for an error code returned by one of the entry points.
extern "C" const char* fcn8s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
