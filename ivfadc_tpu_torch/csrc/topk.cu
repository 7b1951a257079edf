// Smallest-k along the last dim, carrying an int32 payload or the index.
//
// Replaces ivfadc_tpu/ops/topk.py::_topk_payload_kernel (the final merge of
// the dense search: (B, w*nf) candidate distances with external-id
// payloads -> (B, k)) and ::_topk_kernel (the same passes returning the
// winners' indices: the small-batch merge over position payloads and the
// coarse quantizer's pairwise fallback, N = kc). Same semantics: k
// min-extract passes, the lowest index wins ties, the winner is set to +inf
// in the working copy, so rows with fewer than k finite entries re-select
// +inf lanes by lowest index.
//
// Bound: reading the (B, N) f32 values once from device memory (134 MB at
// B=16384, N=1024), plus k payload reads per row. Design: one warp per
// row, the row staged once in shared memory, each pass a lane-strided scan
// plus a warp-shuffle argmin — no block-wide barrier, and the k passes
// touch only shared memory. Any N >= k whose row fits shared memory.

#include "common.cuh"

template <bool kPayload>
__global__ void topk_kernel(const float* __restrict__ x,
                            const int* __restrict__ payload,
                            float* __restrict__ vals, int* __restrict__ out,
                            int B, int N, int k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * warps + warp;
  if (row >= B) return;  // whole warp leaves together; no block barrier
  float* xs = smem + static_cast<size_t>(warp) * N;
  const float* xr = x + row * N;
  for (int j = lane; j < N; j += 32) xs[j] = xr[j];
  __syncwarp();
  for (int p = 0; p < k; ++p) {
    float v;
    int i;
    ivf_lane_argmin(xs, N, lane, v, i);
    ivf_warp_argmin(v, i);
    if (lane == 0) {
      vals[row * k + p] = v;
      out[row * k + p] = kPayload ? payload[row * N + i] : i;
      xs[i] = IVF_INF;
    }
    __syncwarp();
  }
}

template <bool kPayload>
static int topk_launch(const void* x, const void* payload, void* vals,
                       void* out, int B, int N, int k, void* stream) {
  if (N < 1 || k < 1 || k > N) return cudaErrorInvalidValue;
  int warps = 8;
  while (warps > 1 && static_cast<size_t>(warps) * N * sizeof(float) >
                          (96u << 10))
    warps >>= 1;
  const size_t smem = static_cast<size_t>(warps) * N * sizeof(float);
  if (smem > 200u << 10) return cudaErrorInvalidValue;
  int err = ivf_set_smem(
      reinterpret_cast<const void*>(topk_kernel<kPayload>), smem);
  if (err) return err;
  const int blocks = (B + warps - 1) / warps;
  if (blocks > 0)
    topk_kernel<kPayload><<<blocks, warps * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int*>(payload),
        static_cast<float*>(vals), static_cast<int*>(out), B, N, k);
  return ivf_launch_status();
}

extern "C" int topk_payload(const void* x, const void* payload, void* vals,
                            void* pays, int B, int N, int k, void* stream) {
  return topk_launch<true>(x, payload, vals, pays, B, N, k, stream);
}

extern "C" int topk_index(const void* x, void* vals, void* idx, int B, int N,
                          int k, void* stream) {
  return topk_launch<false>(x, nullptr, vals, idx, B, N, k, stream);
}
