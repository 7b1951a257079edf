// Fused coarse probe that also emits the scan inputs.
//
// Replaces ivfadc_tpu/ops/coarse_scan.py::_coarse_vbase_kernel. For each
// query: f32 scores ||c||^2 - 2 q.c against every centroid, w argmin passes
// (lowest index wins ties, the winner is masked to +inf), and for each
// winning cell c: v = bf16(-2 * rot(q - c)) and ||rot(q - c)||^2.
//
// Bound: the score matmul, B*kc*d FMAs (2.1 G at B=16384, kc=1024, d=128),
// kept in exact f32 (fmaf, no TF32 or bf16) because the naive coarse
// quantizer is contractually the exact brute-force scan. The (kc, d) table
// (512 KB at the main shape) exceeds a block's shared memory, so it is
// streamed in 32-centroid tiles while each block keeps its (bq, kc) score
// rows in shared memory; only the (B, w) winners and the (B, w, d) v rows
// reach device memory. The winning centroid row is a plain global read
// (L2-resident), not the TPU kernel's one-hot matmul.

#include "common.cuh"

constexpr int CT = 32;          // centroids per streamed tile
constexpr int CS_THREADS = 256;

__global__ void __launch_bounds__(CS_THREADS) coarse_vbase_kernel(
    const float* __restrict__ q, const float* __restrict__ cents,
    const float* __restrict__ cn, const float* __restrict__ rot, int B, int d,
    int kc, int w, int bq, int apply_rot, float* __restrict__ vals,
    int* __restrict__ cells, __nv_bfloat16* __restrict__ v,
    float* __restrict__ rn) {
  extern __shared__ float sm[];
  const int dp = d + 1;  // padded tile row: conflict-free column reads
  float* qs = sm;                                   // bq * d
  float* ct = qs + static_cast<size_t>(bq) * d;     // CT * dp
  float* sc = ct + static_cast<size_t>(CT) * dp;    // bq * kc
  float* rb = sc + static_cast<size_t>(bq) * kc;    // warps * 2 * d
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, B - q0);

  for (int i = tid; i < bq * d; i += nthr) {
    const int r = i / d;
    qs[i] = r < nq ? q[static_cast<size_t>(q0 + r) * d + (i - r * d)] : 0.f;
  }
  for (int c0 = 0; c0 < kc; c0 += CT) {
    const int nc = min(CT, kc - c0);
    __syncthreads();  // queries staged / previous tile consumed
    for (int i = tid; i < CT * d; i += nthr) {
      const int r = i / d, k = i - r * d;
      ct[r * dp + k] =
          r < nc ? cents[static_cast<size_t>(c0 + r) * d + k] : 0.f;
    }
    __syncthreads();
    for (int pr = tid; pr < bq * CT; pr += nthr) {
      const int r = pr / CT, c = pr - r * CT;
      if (c < nc) {
        const float* qr = qs + static_cast<size_t>(r) * d;
        const float* cr = ct + static_cast<size_t>(c) * dp;
        float acc = 0.f;
        for (int k = 0; k < d; ++k) acc = fmaf(qr[k], cr[k], acc);
        sc[static_cast<size_t>(r) * kc + c0 + c] =
            __fsub_rn(cn[c0 + c], 2.0f * acc);
      }
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, warps = nthr >> 5;
  float* rr = rb + static_cast<size_t>(warp) * 2 * d;  // q - c
  float* ro = rr + d;                                   // rot(q - c)
  for (int r = warp; r < nq; r += warps) {
    float* srow = sc + static_cast<size_t>(r) * kc;
    const float* qr = qs + static_cast<size_t>(r) * d;
    const size_t qi = static_cast<size_t>(q0 + r);
    for (int j = 0; j < w; ++j) {
      float m;
      int a;
      ivf_lane_argmin(srow, kc, lane, m, a);
      ivf_warp_argmin(m, a);
      const float* cr = cents + static_cast<size_t>(a) * d;
      for (int k = lane; k < d; k += 32) rr[k] = __fsub_rn(qr[k], cr[k]);
      __syncwarp();
      const float* res = rr;
      if (apply_rot) {
        for (int col = lane; col < d; col += 32) {
          float acc = 0.f;
          for (int k = 0; k < d; ++k)
            acc = fmaf(rr[k], rot[static_cast<size_t>(k) * d + col], acc);
          ro[col] = acc;
        }
        __syncwarp();
        res = ro;
      }
      __nv_bfloat16* vo = v + (qi * w + j) * d;
      float part = 0.f;
      for (int k = lane; k < d; k += 32) {
        const float x = res[k];
        vo[k] = __float2bfloat16_rn(-2.0f * x);
        part = __fadd_rn(part, __fmul_rn(x, x));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_down_sync(IVF_FULL_MASK, part, off));
      if (lane == 0) {
        vals[qi * w + j] = m;
        cells[qi * w + j] = a;
        rn[qi * w + j] = part;
        srow[a] = IVF_INF;
      }
      __syncwarp();
    }
  }
}

static size_t coarse_smem(int bq, int d, int kc) {
  return sizeof(float) * (static_cast<size_t>(bq) * d +
                          static_cast<size_t>(CT) * (d + 1) +
                          static_cast<size_t>(bq) * kc +
                          static_cast<size_t>(CS_THREADS / 32) * 2 * d);
}

extern "C" int coarse_vbase(const void* q, const void* cents, const void* cn,
                            const void* rot, int B, int d, int kc, int w,
                            int apply_rot, void* vals, void* cells, void* v,
                            void* rn, void* stream) {
  const size_t limit = 200u << 10;
  int bq = 16;
  while (bq > 1 && coarse_smem(bq, d, kc) > limit) bq >>= 1;
  const size_t smem = coarse_smem(bq, d, kc);
  if (smem > limit || w < 1 || w > kc) return cudaErrorInvalidValue;
  int err =
      ivf_set_smem(reinterpret_cast<const void*>(coarse_vbase_kernel), smem);
  if (err) return err;
  const int blocks = (B + bq - 1) / bq;
  if (blocks > 0)
    coarse_vbase_kernel<<<blocks, CS_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(cents),
        static_cast<const float*>(cn), static_cast<const float*>(rot), B, d,
        kc, w, bq, apply_rot, static_cast<float*>(vals),
        static_cast<int*>(cells), static_cast<__nv_bfloat16*>(v),
        static_cast<float*>(rn));
  return ivf_launch_status();
}
