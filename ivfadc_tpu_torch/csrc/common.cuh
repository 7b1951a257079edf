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

// Warp-wide argmax over (value, index) pairs, every lane holding a
// candidate: the larger value wins, equal values go to the lower index.
// The result is returned in every lane.
__device__ __forceinline__ void ivf_warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(IVF_FULL_MASK, v, off);
    int oi = __shfl_down_sync(IVF_FULL_MASK, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  v = __shfl_sync(IVF_FULL_MASK, v, 0);
  i = __shfl_sync(IVF_FULL_MASK, i, 0);
}

// One min-extract pass of the exact merge (the TPU kernels' merge_pass) for
// one probe, by one warp: lane l holds the scores c[j] of group rows
// l + 32 j; buf_d / buf_p are the probe's 128-lane candidate buffer in
// shared memory. The group's minimum (lowest row among ties) replaces the
// buffer's maximum (lowest lane among ties) when strictly smaller, with
// payload slot0 + row, and its score is masked to +inf. Returns false when
// nothing was replaced: later passes cannot replace anything either.
__device__ __forceinline__ bool ivf_exact_pass(float (&c)[4], float* buf_d,
                                               int* buf_p, int slot0,
                                               int lane) {
  float cv = c[0];
  int ci = lane;
#pragma unroll
  for (int j = 1; j < 4; ++j)
    if (c[j] < cv) {
      cv = c[j];
      ci = lane + 32 * j;
    }
  ivf_warp_argmin(cv, ci);
  float rv = buf_d[lane];
  int ri = lane;
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const float x = buf_d[lane + 32 * j];
    if (x > rv) {
      rv = x;
      ri = lane + 32 * j;
    }
  }
  ivf_warp_argmax(rv, ri);
  if (!(cv < rv)) return false;
  if (lane == 0) {
    buf_d[ri] = cv;
    buf_p[ri] = slot0 + ci;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (lane + 32 * j == ci) c[j] = IVF_INF;
  __syncwarp();
  return true;
}

// Stage rows [row0, row0 + nvalid) of a decoded cache, features
// [k0, k0 + KT), into shared memory as bf16 (row stride `rstride`), zero
// rows from nvalid up to GROUP. int8 rows are dequantized as
// bf16(float(q) * scale[k]) (scale: the bf16-rounded column scales in
// f32); bf16 rows are copied as they are. NT threads, 16-byte loads.
template <int GROUP, int KT, int NT>
__device__ __forceinline__ void ivf_stage_rows(
    __nv_bfloat16* rs, int rstride, const int8_t* __restrict__ dec,
    const float* __restrict__ scale, size_t row0, int nvalid, int d, int k0,
    int tid) {
  for (int i = tid; i < GROUP * (KT / 16); i += NT) {
    const int r = i / (KT / 16), s = i - r * (KT / 16);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        rs + static_cast<size_t>(r) * rstride + s * 16);
    if (r < nvalid) {
      const uint4 raw = reinterpret_cast<const uint4*>(
          dec + (row0 + r) * d + k0)[s];
      const int8_t* q8 = reinterpret_cast<const int8_t*>(&raw);
      const float* sc = scale + k0 + s * 16;
#pragma unroll
      for (int e = 0; e < 16; e += 2)
        dst[e / 2] = __floats2bfloat162_rn(
            __fmul_rn(static_cast<float>(q8[e]), sc[e]),
            __fmul_rn(static_cast<float>(q8[e + 1]), sc[e + 1]));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = __floats2bfloat162_rn(0.f, 0.f);
    }
  }
}

template <int GROUP, int KT, int NT>
__device__ __forceinline__ void ivf_stage_rows(
    __nv_bfloat16* rs, int rstride, const __nv_bfloat16* __restrict__ dec,
    const float* __restrict__ /*scale*/, size_t row0, int nvalid, int d,
    int k0, int tid) {
  for (int i = tid; i < GROUP * (KT / 8); i += NT) {
    const int r = i / (KT / 8), s = i - r * (KT / 8);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        rs + static_cast<size_t>(r) * rstride + s * 8);
    if (r < nvalid) {
      const uint4 raw = reinterpret_cast<const uint4*>(
          dec + (row0 + r) * d + k0)[s];
      const __nv_bfloat162* src =
          reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = src[e];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = __floats2bfloat162_rn(0.f, 0.f);
    }
  }
}

static inline int ivf_set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}
