// Per-probe dense posting scan (the small-batch scan).
//
// Replaces ivfadc_tpu/ops/pallas_scan.py::_scan_kernel in every variant
// the JAX package reaches, as template parameters of one kernel: the
// decoded cache (ELEM: int8 with a per-column scale, or bf16 rows read as
// they are) and the merge (fold, or EXACT). Row norms are computed in the
// kernel. One block scans ONE probe's cell [start, start + size) in
// 128-row groups, in increasing order; thread l owns group row l and
// computes, in this order (the JAX kernel's arithmetic):
//   row   = bf16(float(int8) * float(bf16(scale)))  (int8 cache; bf16: as is)
//   dot   = sum_k float(v[k]) * float(row[k])              (f32, exact products)
//   norm  = sum_k float(bf16(row[k] * row[k]))             (bf16 squares, f32 sum)
//   s     = (dot + norm_coef * norm) + base                (norm_coef == 0: dot + base)
//   s     = +inf at or past the cell size
// then the merge:
//   fold:  group G belongs to bank G % (nf/128), lane l; strict '<' keeps
//          the earlier row on ties; payload = G, the cell-relative 128-row
//          block index; buffers start at +inf / -1.
//   exact: (nf = 128) after each group, warp 0 runs up to k_out passes
//          that move the group's minimum (lowest row among ties) into the
//          buffer's maximum lane (lowest lane among ties) when strictly
//          smaller, payload = the absolute slot. Per 128-row group instead
//          of the TPU's DMA chunk: the buffer still holds the probe's true
//          top-k_out distances (see csrc/dense_scan.cu).
// The row norms are NOT the grouped kernel's cached f32 norms: the two
// paths score a point slightly differently, as they do in the JAX package.
// Walking 128-row groups instead of the TPU's DMA chunks changes nothing
// for the fold (chunk % nf == 0, so a row's bank and block index are the
// same). Rows at or past the cell size are never read, so no guard rows
// are needed. Probes of size 0 write +inf / -1.
//
// Bound: at small batches (64 probes of ~1000 rows: 8 MB of int8 rows)
// neither bytes nor operations but latency: one launch and a short
// dependent chain of group loads per block. Design: no padding of the
// probe list and no segment launches (one launch over all B*w probes); a
// group is staged in shared memory with coalesced 16-byte loads (and
// dequantized once); a thread's fold state is one (score, block) register
// pair because each bank's groups are walked in turn (bank b takes groups
// b, b + nbank, ...), which keeps the in-bank order the tie rule needs.

#include "common.cuh"

constexpr int GROUP = 128;        // rows per fold group = lanes of a bank
constexpr int KT = 128;           // features staged per step
constexpr int RS = KT + 2;        // staged row stride (bf16): conflict-free
constexpr int PS_THREADS = GROUP; // one thread per group row

template <typename ELEM, bool EXACT>
__global__ void __launch_bounds__(PS_THREADS) probe_scan_kernel(
    const int* __restrict__ starts, const int* __restrict__ sizes,
    const float* __restrict__ base, const __nv_bfloat16* __restrict__ v,
    const ELEM* __restrict__ decoded, const float* __restrict__ scale,
    int d, int nf, int k_out, float norm_coef, float* __restrict__ out_d,
    int* __restrict__ out_p) {
  __shared__ __align__(16) __nv_bfloat16 rs[GROUP * RS];
  // EXACT: the group's scores and the probe's 128-lane candidate buffer
  __shared__ float sc_s[GROUP], bd_s[GROUP];
  __shared__ int bp_s[GROUP];
  extern __shared__ __align__(16) unsigned char smraw[];
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smraw);  // d

  const int tid = threadIdx.x;
  const size_t p = blockIdx.x;
  const int start = starts[p], size = sizes[p];
  const float b = base[p];
  const int nbank = nf / GROUP;
  const int ngroups = (size + GROUP - 1) / GROUP;
  const int nk = d / KT;
  const bool use_norm = norm_coef != 0.f;

  for (int i = tid; i < d / 8; i += PS_THREADS)
    reinterpret_cast<uint4*>(vs)[i] =
        reinterpret_cast<const uint4*>(v + p * d)[i];
  if (EXACT) {
    bd_s[tid] = IVF_INF;
    bp_s[tid] = -1;
  }

  const __nv_bfloat162* myrow =
      reinterpret_cast<const __nv_bfloat162*>(rs + tid * RS);
  for (int bank = 0; bank < nbank; ++bank) {
    float best = IVF_INF;
    int bestp = -1;
    for (int G = bank; G < ngroups; G += nbank) {
      const size_t row0 = static_cast<size_t>(start) + G * GROUP;
      const int nvalid = min(GROUP, size - G * GROUP);
      float dot = 0.f, nrm = 0.f;
      for (int kb = 0; kb < nk; ++kb) {
        const int k0 = kb * KT;
        __syncthreads();  // v staged / previous step's reads done
        ivf_stage_rows<GROUP, KT, PS_THREADS>(rs, RS, decoded, scale, row0,
                                              nvalid, d, k0, tid);
        __syncthreads();
        const __nv_bfloat162* vrow =
            reinterpret_cast<const __nv_bfloat162*>(vs + k0);
        for (int kk = 0; kk < KT / 2; ++kk) {
          const float2 r2 = __bfloat1622float2(myrow[kk]);
          const float2 v2 = __bfloat1622float2(vrow[kk]);
          dot = fmaf(v2.x, r2.x, dot);
          dot = fmaf(v2.y, r2.y, dot);
          if (use_norm) {
            nrm = __fadd_rn(nrm, __bfloat162float(__float2bfloat16_rn(
                                     __fmul_rn(r2.x, r2.x))));
            nrm = __fadd_rn(nrm, __bfloat162float(__float2bfloat16_rn(
                                     __fmul_rn(r2.y, r2.y))));
          }
        }
      }
      float s = use_norm ? __fadd_rn(dot, __fmul_rn(norm_coef, nrm)) : dot;
      s = __fadd_rn(s, b);
      s = tid < nvalid ? s : IVF_INF;
      if (EXACT) {
        // read by warp 0 before the next group's second barrier
        sc_s[tid] = s;
        __syncthreads();
        if (tid < 32) {
          float c[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) c[j] = sc_s[tid + 32 * j];
          for (int pass = 0; pass < k_out; ++pass)
            if (!ivf_exact_pass(c, bd_s, bp_s, static_cast<int>(row0), tid))
              break;
        }
      } else if (s < best) {
        best = s;
        bestp = G;
      }
    }
    if (EXACT) {
      __syncthreads();
      best = bd_s[tid];
      bestp = bp_s[tid];
    }
    out_d[p * nf + bank * GROUP + tid] = best;
    out_p[p * nf + bank * GROUP + tid] = bestp;
  }
}

template <typename ELEM, bool EXACT>
static int launch_probe_scan(const void* starts, const void* sizes,
                             const void* base, const void* v,
                             const void* decoded, const void* scale, int P,
                             int d, int nf, int k_out, float norm_coef,
                             void* out_d, void* out_p, void* stream) {
  if (nf <= 0 || nf % GROUP || d <= 0 || d % KT) return cudaErrorInvalidValue;
  if (EXACT && (nf != GROUP || k_out < 1 || k_out > GROUP))
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(d) * 2;
  if (smem > 160u * 1024u) return cudaErrorInvalidValue;
  int err = ivf_set_smem(
      reinterpret_cast<const void*>(probe_scan_kernel<ELEM, EXACT>), smem);
  if (err) return err;
  if (P > 0)
    probe_scan_kernel<ELEM, EXACT>
        <<<P, PS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(starts), static_cast<const int*>(sizes),
            static_cast<const float*>(base),
            static_cast<const __nv_bfloat16*>(v),
            static_cast<const ELEM*>(decoded),
            static_cast<const float*>(scale), d, nf, k_out, norm_coef,
            static_cast<float*>(out_d), static_cast<int*>(out_p));
  return ivf_launch_status();
}

// One C entry point per variant, all with one signature; `scale` may be
// null for bf16 rows, k_out is read by the exact merge.
#define PROBE_ENTRY(NAME, ELEM, EXACT)                                        \
  extern "C" int NAME(const void* starts, const void* sizes,                 \
                      const void* base, const void* v, const void* decoded,  \
                      const void* scale, int P, int d, int nf, int k_out,    \
                      float norm_coef, void* out_d, void* out_p,             \
                      void* stream) {                                        \
    return launch_probe_scan<ELEM, EXACT>(starts, sizes, base, v, decoded,   \
                                          scale, P, d, nf, k_out, norm_coef, \
                                          out_d, out_p, stream);             \
  }

PROBE_ENTRY(probe_scan, int8_t, false)
PROBE_ENTRY(probe_scan_exact, int8_t, true)
PROBE_ENTRY(probe_scan_bf16, __nv_bfloat16, false)
PROBE_ENTRY(probe_scan_exact_bf16, __nv_bfloat16, true)
