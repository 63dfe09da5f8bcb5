// Error text for the codes the kernel entry points return.
#include "common.cuh"

GVD_API const char* gvd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
