// Library-level C entries shared by the kernel wrappers (ops/build.py).
#include "common.cuh"

extern "C" int cales_threads_per_block() { return CALES_THREADS; }

extern "C" const char* cales_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
