// Shared helpers of the port's CUDA kernels. Each .cu file includes this
// once and is built into a shared library of its own with a plain C
// interface (see _build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define IVF_INF __int_as_float(0x7f800000)
#define IVF_FULL_MASK 0xffffffffu

extern "C" const char* ivfadc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Error of the launches just made (0 when they were accepted). Faults that
// happen while a kernel runs surface at the caller's next synchronisation.
static inline int ivf_launch_status() {
  return static_cast<int>(cudaGetLastError());
}

// Warp-wide argmin over (value, index) pairs: the smaller value wins, equal
// values go to the lower index, and index < 0 marks "no candidate". The
// result is returned in every lane.
__device__ __forceinline__ void ivf_warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(IVF_FULL_MASK, v, off);
    int oi = __shfl_down_sync(IVF_FULL_MASK, i, off);
    if (oi >= 0 && (i < 0 || ov < v || (ov == v && oi < i))) {
      v = ov;
      i = oi;
    }
  }
  v = __shfl_sync(IVF_FULL_MASK, v, 0);
  i = __shfl_sync(IVF_FULL_MASK, i, 0);
}

// Lane-local scan feeding ivf_warp_argmin: the first element a lane sees is
// its candidate, later ones replace it only when strictly smaller, so each
// lane keeps its lowest index among equal values (indices ascend per lane).
__device__ __forceinline__ void ivf_lane_argmin(const float* row, int n,
                                                int lane, float& v, int& i) {
  v = IVF_INF;
  i = -1;
  for (int j = lane; j < n; j += 32) {
    float x = row[j];
    if (i < 0 || x < v) {
      v = x;
      i = j;
    }
  }
}

static inline int ivf_set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}
