// Included once by each .cu: every library built from csrc can name and
// describe the cudaError_t its entry points return.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* binf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" const char* binf_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
