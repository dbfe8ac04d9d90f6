// Shared helpers for the port's hand-written kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vd3d {

// The cards whose one-time launch configuration (shared-memory attributes,
// SM counts, cluster sizes) a launcher keeps, indexed by device ordinal:
// CUDA keeps such settings per device, so a process that launches on
// several cards configures each.
constexpr int MAX_DEVICES = 16;

// The current device's ordinal, or -1 where it cannot be read or is not
// below MAX_DEVICES. The Python wrappers make the tensors' card current
// around each launch, so this is the launch's device.
inline int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return -1;
  return dev;
}

// Image planes are float32 or bfloat16; every kernel computes in float32
// and rounds once on store (round-to-nearest-even, as torch's .to(bf16)).
__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

}  // namespace vd3d
