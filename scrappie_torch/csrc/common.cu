// Host-side helpers shared by the kernels' C entry points.
#include <cuda_runtime.h>

extern "C" {

// Text of a cudaError_t that an entry point returned.
const char* scrappie_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
