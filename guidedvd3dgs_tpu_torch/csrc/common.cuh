// Shared definitions of the port's CUDA kernels.
//
// Every kernel is compiled with -fmad=false: each multiply and add rounds
// on its own, as in the plain PyTorch versions the kernels are checked
// against, so the only differences left are those of expf/logf.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define GVD_API extern "C" __attribute__((visibility("default")))

namespace gvd {

constexpr int TILE = 16;
constexpr int TILE_PIX = TILE * TILE;
constexpr float NEAR_CLIP = 0.2f;
constexpr float COV2D_DILATION = 0.3f;
constexpr float ALPHA_EPS = (float)(1.0 / 255.0);
constexpr float T_EPS = 1e-4f;
constexpr float ALPHA_MAX = 0.99f;

// torch.clamp semantics: a NaN input stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  return clamp_max(clamp_min(x, lo), hi);
}

// The blocks of `kernel` (`threads` threads, `smem` bytes of dynamic
// shared memory) resident at once on the current device, for a grid of
// blocks that each walk their share of the work. The runtime's queries
// cost about as much host time as a launch, so each (kernel, device,
// smem) is asked once and kept; the kernel is allowed the most dynamic
// shared memory the device gives it beside its static shared memory, so
// that no later launch needs it set again.
inline cudaError_t resident_blocks(const void* kernel, int threads, int smem, int64_t* out) {
  struct Entry {
    const void* kernel;
    int dev, smem;
    int64_t blocks;
  };
  constexpr int CAP = 64;
  static std::mutex mu;
  static Entry cache[CAP];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < (used < CAP ? used : CAP); ++i) {
    if (cache[i].kernel == kernel && cache[i].dev == dev && cache[i].smem == smem) {
      *out = cache[i].blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0, optin = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *out = sms * per_sm > 0 ? (int64_t)sms * per_sm : 1;
  cache[used++ % CAP] = Entry{kernel, dev, smem, *out};
  return cudaSuccess;
}

}  // namespace gvd
