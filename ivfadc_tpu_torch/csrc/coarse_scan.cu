// Coarse probes: exact top-w cells, alone or with the scan inputs.
//
// coarse_vbase_kernel replaces
// ivfadc_tpu/ops/coarse_scan.py::_coarse_vbase_kernel. For each query: f32
// scores ||c||^2 - 2 q.c against every centroid, the w smallest by (score,
// index) in ascending order (lowest index wins ties), and for each winning
// cell c: v = bf16(-2 * rot(q - c)) and ||rot(q - c)||^2.
// coarse_topw_kernel replaces ::_coarse_kernel: the same scores and
// selection, emitting only the (B, w) winners (the LUT engine's and the
// unfused dense probe's coarse search). coarse_vbase_v2_kernel replaces
// ::_coarse_vbase_kernel_v2: the same selection, then per query
// rotq = q R once (f32, in shared memory), and per winning cell a
// v = bf16(-2 (rotq - (f32(hi[a]) + f32(lo[a])))) from the wrapper's bf16
// hi/lo split of the pre-rotated table rotC = C R; no ||r||^2 (the wrapper
// derives the base from the scores, valid for an orthogonal R). All three
// share coarse_select below, so they pick the same cells bit for bit.
//
// Bound: the score matmul, B*kc*d FMAs (2.1 G at B=16384, kc=1024, d=128),
// kept in exact f32 (fmaf, no TF32 or bf16) because the naive coarse
// quantizer is contractually the exact brute-force scan. The (kc, d) table
// (512 KB at the main shape) exceeds a block's shared memory, so it is
// streamed in 32-centroid tiles. A block scores its bq queries against one
// chunk of up to kch <= KCH_MAX centroids at a time and keeps a running
// top-w per query in shared memory, so any kc is taken; a table of at most
// KCH_MAX centroids is one chunk. Only the (B, w) winners and the (B, w, d)
// v rows reach device memory. The winning centroid row is a plain global
// read (L2-resident), not the TPU kernel's one-hot matmul.

#include "common.cuh"

constexpr int CT = 32;          // centroids per streamed tile
constexpr int CS_THREADS = 256;
constexpr int QROWS = CS_THREADS / CT;  // queries scored side by side
constexpr int BQ_MAX = 2 * QROWS;       // queries per block, two a thread
constexpr int KCH_MAX = 1024;   // centroids per chunk

// Shared memory of coarse_select, carved from one dynamic array.
struct CoarseSmem {
  float* qs;    // bq * d             the block's queries
  float* ct;    // CT * (d + 1)       one centroid tile, padded rows
  float* sc;    // bq * (w + kch)     per query: running top-w, chunk scores
  int* ridx;    // bq * w             centroid index of each running winner
  float* nval;  // bq * w             winners of the chunk being merged
  int* nidx;    // bq * w
  float* rest;  // what follows (the v/base variant's scratch)
};

__device__ __forceinline__ CoarseSmem coarse_carve(float* sm, int bq, int d,
                                                   int w, int kch) {
  CoarseSmem s;
  s.qs = sm;
  s.ct = s.qs + static_cast<size_t>(bq) * d;
  s.sc = s.ct + static_cast<size_t>(CT) * (d + 1);
  s.ridx = reinterpret_cast<int*>(s.sc + static_cast<size_t>(bq) * (w + kch));
  s.nval = reinterpret_cast<float*>(s.ridx + static_cast<size_t>(bq) * w);
  s.nidx = reinterpret_cast<int*>(s.nval + static_cast<size_t>(bq) * w);
  s.rest = reinterpret_cast<float*>(s.nidx + static_cast<size_t>(bq) * w);
  return s;
}

// Stage the block's bq queries and select, for each, the w smallest of
// ||c||^2 - 2 q.c over all kc centroids. On return row r of `sc` starts
// with the w winning scores in ascending order and `ridx` row r holds their
// centroid indices. Ends at a block barrier; returns the number of live
// queries of the block.
//
// A score row is [w running winners | the chunk's scores]. The running
// winners are sorted by (score, index) and every one has a lower index than
// the chunk's centroids, so positions order equal scores by centroid index
// and w position-argmin passes over the row give the merged top-w.
__device__ __forceinline__ int coarse_select(
    const float* __restrict__ q, const float* __restrict__ cents,
    const float* __restrict__ cn, int B, int d, int kc, int w, int bq,
    int kch, const CoarseSmem& s) {
  const int dp = d + 1;  // padded tile row: conflict-free column reads
  const int ld = w + kch;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = nthr >> 5;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, B - q0);
  // rows of the table start 16-byte aligned: tiles load as float4
  const bool vec4 =
      (d & 3) == 0 && (reinterpret_cast<uintptr_t>(cents) & 15) == 0;

  for (int i = tid; i < bq * d; i += nthr) {
    const int r = i / d;
    s.qs[i] = r < nq ? q[static_cast<size_t>(q0 + r) * d + (i - r * d)] : 0.f;
  }
  for (int i = tid; i < bq * w; i += nthr) {
    const int r = i / w;
    s.sc[static_cast<size_t>(r) * ld + (i - r * w)] = IVF_INF;
    s.ridx[i] = 0;
  }
  for (int ch0 = 0; ch0 < kc; ch0 += kch) {
    const int nch = min(kch, kc - ch0);
    for (int c0 = 0; c0 < nch; c0 += CT) {
      const int nc = min(CT, nch - c0);
      __syncthreads();  // queries staged / previous tile, chunk consumed
      const float* tile = cents + static_cast<size_t>(ch0 + c0) * d;
      if (vec4) {
        // four 16-byte loads in flight per thread before the first store:
        // one at a time, each store waits out a full memory round trip
        const float4* tile4 = reinterpret_cast<const float4*>(tile);
        const int d4 = d >> 2, n4 = CT * d4;
        for (int i0 = tid; i0 < n4; i0 += 4 * nthr) {
          float4 x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * nthr;
            x[u] = i < n4 && i / d4 < nc ? __ldg(tile4 + i)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * nthr;
            if (i < n4) {
              const int r = i / d4;
              float* dst = s.ct + r * dp + (i - r * d4) * 4;
              dst[0] = x[u].x;
              dst[1] = x[u].y;
              dst[2] = x[u].z;
              dst[3] = x[u].w;
            }
          }
        }
      } else {
#pragma unroll 4
        for (int i = tid; i < CT * d; i += nthr) {
          const int r = i / d, k = i - r * d;
          s.ct[r * dp + k] = r < nc ? tile[i] : 0.f;
        }
      }
      __syncthreads();
      // thread (r0, c) scores tile column c against queries r0 and
      // r0 + QROWS: two independent sums (each in k order) share the
      // centroid reads and hide each other's latency
      const int c = tid % CT, r0 = tid / CT;
      if (c < nc && r0 < bq) {
        const bool two = r0 + QROWS < bq;
        const float* qa = s.qs + static_cast<size_t>(r0) * d;
        const float* qb = two ? qa + static_cast<size_t>(QROWS) * d : qa;
        const float* cr = s.ct + static_cast<size_t>(c) * dp;
        float acc_a = 0.f, acc_b = 0.f;
#pragma unroll 8
        for (int k = 0; k < d; ++k) {
          const float cv = cr[k];
          acc_a = fmaf(qa[k], cv, acc_a);
          acc_b = fmaf(qb[k], cv, acc_b);
        }
        const float cnv = cn[ch0 + c0 + c];
        float* out = s.sc + static_cast<size_t>(r0) * ld + w + c0 + c;
        out[0] = __fsub_rn(cnv, 2.0f * acc_a);
        if (two)
          out[static_cast<size_t>(QROWS) * ld] = __fsub_rn(cnv, 2.0f * acc_b);
      }
    }
    __syncthreads();
    for (int r = warp; r < nq; r += warps) {
      float* srow = s.sc + static_cast<size_t>(r) * ld;
      int* ri = s.ridx + static_cast<size_t>(r) * w;
      float* nv = s.nval + static_cast<size_t>(r) * w;
      int* ni = s.nidx + static_cast<size_t>(r) * w;
      for (int j = 0; j < w; ++j) {
        float m;
        int a;
        ivf_lane_argmin(srow, w + nch, lane, m, a);
        ivf_warp_argmin(m, a);
        if (lane == 0) {
          nv[j] = m;
          ni[j] = a < w ? ri[a] : ch0 + a - w;
          srow[a] = IVF_INF;
        }
        __syncwarp();
      }
      for (int j = lane; j < w; j += 32) {
        srow[j] = nv[j];
        ri[j] = ni[j];
      }
    }
  }
  __syncthreads();
  return nq;
}

__global__ void __launch_bounds__(CS_THREADS) coarse_topw_kernel(
    const float* __restrict__ q, const float* __restrict__ cents,
    const float* __restrict__ cn, int B, int d, int kc, int w, int bq,
    int kch, float* __restrict__ vals, int* __restrict__ cells) {
  extern __shared__ float sm[];
  const CoarseSmem s = coarse_carve(sm, bq, d, w, kch);
  const int nq = coarse_select(q, cents, cn, B, d, kc, w, bq, kch, s);
  const int q0 = blockIdx.x * bq;
  for (int i = threadIdx.x; i < nq * w; i += blockDim.x) {
    const int r = i / w, j = i - r * w;
    const size_t o = static_cast<size_t>(q0 + r) * w + j;
    vals[o] = s.sc[static_cast<size_t>(r) * (w + kch) + j];
    cells[o] = s.ridx[i];
  }
}

__global__ void __launch_bounds__(CS_THREADS) coarse_vbase_kernel(
    const float* __restrict__ q, const float* __restrict__ cents,
    const float* __restrict__ cn, const float* __restrict__ rot, int B, int d,
    int kc, int w, int bq, int kch, int apply_rot, float* __restrict__ vals,
    int* __restrict__ cells, __nv_bfloat16* __restrict__ v,
    float* __restrict__ rn) {
  extern __shared__ float sm[];
  const CoarseSmem s = coarse_carve(sm, bq, d, w, kch);
  float* rb = s.rest;                                   // warps * 2 * d
  const int nq = coarse_select(q, cents, cn, B, d, kc, w, bq, kch, s);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int q0 = blockIdx.x * bq;

  const int warp = tid >> 5, lane = tid & 31, warps = nthr >> 5;
  float* rr = rb + static_cast<size_t>(warp) * 2 * d;  // q - c
  float* ro = rr + d;                                   // rot(q - c)
  for (int r = warp; r < nq; r += warps) {
    const float* srow = s.sc + static_cast<size_t>(r) * (w + kch);
    const int* ri = s.ridx + static_cast<size_t>(r) * w;
    const float* qr = s.qs + static_cast<size_t>(r) * d;
    const size_t qi = static_cast<size_t>(q0 + r);
    for (int j = 0; j < w; ++j) {
      const float m = srow[j];
      const int a = ri[j];
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
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(CS_THREADS) coarse_vbase_v2_kernel(
    const float* __restrict__ q, const float* __restrict__ cents,
    const float* __restrict__ cn, const float* __restrict__ rot,
    const __nv_bfloat16* __restrict__ hi, const __nv_bfloat16* __restrict__ lo,
    int B, int d, int kc, int w, int bq, int kch, int apply_rot,
    float* __restrict__ vals, int* __restrict__ cells,
    __nv_bfloat16* __restrict__ v) {
  extern __shared__ float sm[];
  const CoarseSmem s = coarse_carve(sm, bq, d, w, kch);
  const int nq = coarse_select(q, cents, cn, B, d, kc, w, bq, kch, s);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * bq;
  const int warp = tid >> 5, lane = tid & 31, warps = blockDim.x >> 5;
  float* rq = s.rest + static_cast<size_t>(warp) * 2 * d;   // rotq
  for (int r = warp; r < nq; r += warps) {
    const float* srow = s.sc + static_cast<size_t>(r) * (w + kch);
    const int* ri = s.ridx + static_cast<size_t>(r) * w;
    const float* qr = s.qs + static_cast<size_t>(r) * d;
    const size_t qi = static_cast<size_t>(q0 + r);
    if (apply_rot) {
      for (int col = lane; col < d; col += 32) {
        float acc = 0.f;
        for (int k = 0; k < d; ++k)
          acc = fmaf(qr[k], rot[static_cast<size_t>(k) * d + col], acc);
        rq[col] = acc;
      }
    } else {
      for (int k = lane; k < d; k += 32) rq[k] = qr[k];
    }
    __syncwarp();
    for (int j = 0; j < w; ++j) {
      const int a = ri[j];
      const __nv_bfloat16* hr = hi + static_cast<size_t>(a) * d;
      const __nv_bfloat16* lr = lo + static_cast<size_t>(a) * d;
      __nv_bfloat16* vo = v + (qi * w + j) * d;
      for (int k = lane; k < d; k += 32) {
        const float rc =
            __fadd_rn(__bfloat162float(hr[k]), __bfloat162float(lr[k]));
        vo[k] = __float2bfloat16_rn(-2.0f * __fsub_rn(rq[k], rc));
      }
      if (lane == 0) {
        vals[qi * w + j] = srow[j];
        cells[qi * w + j] = a;
      }
    }
    __syncwarp();
  }
}

// Shared memory of a block of bq queries over chunks of kch centroids;
// `scratch` adds the per-warp residual rows of the v/base variant.
static size_t coarse_smem(int bq, int d, int w, int kch, bool scratch) {
  return sizeof(float) *
         (static_cast<size_t>(bq) * d + static_cast<size_t>(CT) * (d + 1) +
          static_cast<size_t>(bq) * (w + kch) +
          static_cast<size_t>(bq) * w * 3 +
          (scratch ? static_cast<size_t>(CS_THREADS / 32) * 2 * d : 0));
}

// Largest power-of-two query block (<= BQ_MAX) that fits; 0 when none does
// (only a very large d: the chunk bounds the score rows).
static int coarse_pick_bq(int d, int w, int kch, bool scratch) {
  const size_t limit = 200u << 10;
  int bq = BQ_MAX;
  while (bq > 1 && coarse_smem(bq, d, w, kch, scratch) > limit) bq >>= 1;
  return coarse_smem(bq, d, w, kch, scratch) > limit ? 0 : bq;
}

extern "C" int coarse_vbase(const void* q, const void* cents, const void* cn,
                            const void* rot, int B, int d, int kc, int w,
                            int apply_rot, void* vals, void* cells, void* v,
                            void* rn, void* stream) {
  const int kch = kc < KCH_MAX ? kc : KCH_MAX;
  const int bq = coarse_pick_bq(d, w, kch, true);
  if (bq == 0 || w < 1 || w > kch) return cudaErrorInvalidValue;
  const size_t smem = coarse_smem(bq, d, w, kch, true);
  int err =
      ivf_set_smem(reinterpret_cast<const void*>(coarse_vbase_kernel), smem);
  if (err) return err;
  const int blocks = (B + bq - 1) / bq;
  if (blocks > 0)
    coarse_vbase_kernel<<<blocks, CS_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(cents),
        static_cast<const float*>(cn), static_cast<const float*>(rot), B, d,
        kc, w, bq, kch, apply_rot, static_cast<float*>(vals),
        static_cast<int*>(cells), static_cast<__nv_bfloat16*>(v),
        static_cast<float*>(rn));
  return ivf_launch_status();
}

extern "C" int coarse_vbase_v2(const void* q, const void* cents,
                               const void* cn, const void* rot,
                               const void* hi, const void* lo, int B, int d,
                               int kc, int w, int apply_rot, void* vals,
                               void* cells, void* v, void* stream) {
  const int kch = kc < KCH_MAX ? kc : KCH_MAX;
  const int bq = coarse_pick_bq(d, w, kch, true);
  if (bq == 0 || w < 1 || w > kch) return cudaErrorInvalidValue;
  const size_t smem = coarse_smem(bq, d, w, kch, true);
  int err = ivf_set_smem(reinterpret_cast<const void*>(coarse_vbase_v2_kernel),
                         smem);
  if (err) return err;
  const int blocks = (B + bq - 1) / bq;
  if (blocks > 0)
    coarse_vbase_v2_kernel<<<blocks, CS_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(cents),
        static_cast<const float*>(cn), static_cast<const float*>(rot),
        static_cast<const __nv_bfloat16*>(hi),
        static_cast<const __nv_bfloat16*>(lo), B, d, kc, w, bq, kch,
        apply_rot, static_cast<float*>(vals), static_cast<int*>(cells),
        static_cast<__nv_bfloat16*>(v));
  return ivf_launch_status();
}

extern "C" int coarse_topw(const void* q, const void* cents, const void* cn,
                           int B, int d, int kc, int w, void* vals,
                           void* cells, void* stream) {
  const int kch = kc < KCH_MAX ? kc : KCH_MAX;
  const int bq = coarse_pick_bq(d, w, kch, false);
  if (bq == 0 || w < 1 || w > kch) return cudaErrorInvalidValue;
  const size_t smem = coarse_smem(bq, d, w, kch, false);
  int err =
      ivf_set_smem(reinterpret_cast<const void*>(coarse_topw_kernel), smem);
  if (err) return err;
  const int blocks = (B + bq - 1) / bq;
  if (blocks > 0)
    coarse_topw_kernel<<<blocks, CS_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(cents),
        static_cast<const float*>(cn), B, d, kc, w, bq, kch,
        static_cast<float*>(vals), static_cast<int*>(cells));
  return ivf_launch_status();
}
