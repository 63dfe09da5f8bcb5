// Shared definitions of the port's CUDA kernels.
//
// Every kernel is compiled with -fmad=false: each multiply and add rounds
// on its own, as in the plain PyTorch versions the kernels are checked
// against, so the only differences left are those of expf/logf.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace gvd
