// Cell-grouped dense posting scan.
//
// Replaces ivfadc_tpu/ops/pallas_scan.py::_grouped_scan_kernel in every
// variant the JAX package reaches, as template parameters of one kernel:
//   ELEM     the decoded cache: int8 with a per-column scale, or bf16 rows
//            read as they are (the TPU kernel's `int8` switch);
//   KNORM    row norms from the cached norms2d stream, or computed here;
//   PAY      the fold payload: external ids from the ids2d stream
//            (emit_ids), or the candidate's 128-row block index within its
//            cell (position payloads; PT = int8 for pos8, else int32); the
//            exact merge stores absolute slots;
//   EXACT    merge="exact" instead of the fold;
//   EXTRACT  finish each tile with k_out min-extract passes (extract_k);
//   QC       derive each tile's v and base in the kernel (replaces
//            ::_grouped_scan_qc_kernel, IVFADC_VBASE=qc) from the queries
//            and centroids instead of reading placed v/base tiles; only with
//            in-kernel norms, id payloads and the fold.
// Each tile (one block) holds up to pb probes of ONE cell; the block walks
// the cell's live rows in 128-row groups, in increasing order, and for
// probe p and group row l computes, in this order (the JAX kernel's
// arithmetic):
//   row  = bf16(float(int8) * float(bf16(scale)))  (int8 cache; bf16: as is)
//   dot  = sum_k float(v[p][k]) * float(row[k])          (f32, exact products)
// cached norms:
//   s    = dot + base[p];  s = +inf past the cell size;  s = s + coef*norm[row]
// in-kernel norms (another order, as in the JAX kernel's branch):
//   norm = sum_k float(bf16(row[k] * row[k]))            (bf16 squares, f32 sum)
//   s    = (dot + coef * norm) + base[p]                 (coef == 0: dot + base)
//   s    = +inf past the cell size
// then the merge:
//   fold:  group G writes bank G % (nf/128), lane l, strict '<'; payload =
//          the row's external id, or G (block index); buffers start at
//          +inf / -1.
//   exact: a 128-lane buffer per probe; after each group, up to k_out
//          passes move the group's minimum (lowest row among ties) into
//          the buffer's maximum lane (lowest lane among ties) when strictly
//          smaller, payload = the absolute slot. The TPU runs its passes
//          per DMA chunk; per 128-row group keeps the same guarantee (the
//          buffer holds each probe's true top-k_out distances) without
//          holding a chunk's scores. Ids kept at a tied distance may
//          differ from the TPU's, as they differ between chunk sizes there.
//   extract: after the fold, k_out passes each emit the buffer's minimum
//          (the first lane among ties) with its id (-1 where the minimum
//          is +inf) and mask that lane; output (pb, k_out) per tile
//          instead of the TPU's packed 128-lane i32 row.
// QC prologue, per tile of cell c = ctile[t] and slot p with query
// qi = qidx[t * pb + p] (-1: an empty slot):
//   r    = q[qi] - c[c]                                  (f32)
//   r    = sum_k float(bf16(r[k])) * float(R[k][col])    (OPQ only; R bf16)
//   base = base_mult * sum_k r[k]^2 (f32; +inf for an empty slot)
//   v    = bf16(-2 r), held for all d features in shared memory
// then the in-kernel-norms scan above. One warp derives one slot at a time.
// A staged group's norms are computed once, two threads a row, and shared
// by the tile's pb probes. Probes whose base is +inf (the placement's empty
// slots, padded probes) score +inf on every row whatever their dot
// product, so their products are skipped; their buffers stay +inf / -1.
// Walking 128-row groups instead of the TPU's DMA chunks changes nothing
// for the fold: chunk % nf == 0, so a row's bank and block index are the
// same either way. Rows at or past the cell size are never read; cell
// starts need only 8-row (16-byte) alignment. Tiles of size 0 write +inf /
// -1.
//
// Bound: device-memory reads of the cell rows (int8: 1 B/dim, bf16: 2) and
// the output rows (pb x nf x 8 B per tile; at huge kc, where most slots of
// a tile are empty, those writes dominate) plus the per-group dot products
// (live probes x 128 x d FMAs per group). Design: a row group is staged
// once in shared memory (as bf16, 16-byte loads) and feeds all pb probes of
// the tile; each thread keeps an 8x4 register tile of scores, the rows of
// probes ty + 8i up to the last live one; the merges run in the warp that
// owns a probe's scores (shuffles, no block barriers); the candidate
// buffers of the tile stay in shared memory for the whole cell and reach
// device memory once. Plain CUDA-core FMAs, no tensor cores: the first
// version is the exact one.

#include "common.cuh"

constexpr int GROUP = 128;        // rows per fold group = lanes of a bank
constexpr int KT = 128;           // features staged per step
constexpr int RS = KT + 2;        // staged row stride (bf16): conflict-free
constexpr int GS_THREADS = 256;   // 8 probe rows x 32 row lanes
constexpr int MAX_PB = 64;

enum Payload { PAY_IDS = 0, PAY_BLOCK = 1, PAY_SLOT = 2 };

// The QC variant's extra inputs (null / zero for the other variants).
struct QcArgs {
  const int* ctile;              // (T,) the cell of each tile
  const int* qidx;               // (T * pb,) each slot's query, -1: empty
  const float* q;                // (B, d) queries, f32
  const float* c;                // (kc, d) centroids, f32
  const __nv_bfloat16* rot;      // (d, d) rotation, bf16
  float base_mult;
  int apply_rot;
};

// acc[i][j] += v[ty + 8i] . row[tx + 32j] over one staged feature step, for
// the thread's first NI probe rows; v rows lie `vstride` apart (KT: the
// step's slice; QC: whole rows, vs pointing at the step's first feature)
template <int NI, bool QC>
__device__ __forceinline__ void dot_step(float (&acc)[8][4],
                                         const __nv_bfloat16* rs,
                                         const __nv_bfloat16* vs, int vstride,
                                         int tx, int ty) {
  const int vst = QC ? vstride : KT;
  for (int kk = 0; kk < KT; ++kk) {
    float rv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      rv[j] = __bfloat162float(rs[static_cast<size_t>(tx + 32 * j) * RS + kk]);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float vv =
          __bfloat162float(vs[static_cast<size_t>(ty + 8 * i) * vst + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(vv, rv[j], acc[i][j]);
    }
  }
}

template <typename ELEM, bool KNORM, int PAY, typename PT, bool EXACT,
          bool EXTRACT, bool QC = false>
__global__ void __launch_bounds__(GS_THREADS) grouped_scan_kernel(
    const int* __restrict__ tstart, const int* __restrict__ tsize,
    const __nv_bfloat16* __restrict__ v_tiles,
    const float* __restrict__ base_tiles, const ELEM* __restrict__ decoded,
    const float* __restrict__ scale, const int* __restrict__ ids,
    const float* __restrict__ norms, int d, int pb, int nf, int k_out,
    float norm_coef, float* __restrict__ out_d, PT* __restrict__ out_p,
    QcArgs qa) {
  extern __shared__ __align__(16) unsigned char smraw[];
  float* bufd = reinterpret_cast<float*>(smraw);                // pb * nf
  int* bufp = reinterpret_cast<int*>(bufd + static_cast<size_t>(pb) * nf);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(
      bufp + static_cast<size_t>(pb) * nf);          // pb * KT (QC: pb * d)
  // GROUP * RS (QC: at least pb * d, the OPQ prologue's bf16(r) rows, then
  // pb floats, the tile's derived bases)
  __nv_bfloat16* rs = vs + static_cast<size_t>(pb) * (QC ? d : KT);
  __shared__ float nrm_s[GROUP];   // KNORM: the staged group's row norms
  // QC: the tile's bases sit in the staging area until they reach registers
  // (before the first group is staged); in static shared memory they would
  // cost an SM its second block at d = 128, pb = 64
  float* base_s =
      QC ? reinterpret_cast<float*>(rs + static_cast<size_t>(pb) * d)
         : nullptr;

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const size_t t = blockIdx.x;
  const int start = tstart[t], size = tsize[t];
  const int np = pb >> 3;          // probe rows per thread (ty + 8 * i)
  const int nbank = nf / GROUP;
  const int nk = d / KT;
  const bool use_norm = KNORM && norm_coef != 0.f;

  for (int i = tid; i < pb * nf; i += GS_THREADS) {
    bufd[i] = IVF_INF;
    bufp[i] = -1;
  }
  if (QC) {
    const float* crow = qa.c + static_cast<size_t>(qa.ctile[t]) * d;
    for (int p = ty; p < pb; p += GS_THREADS / 32) {
      const int qi = qa.qidx[t * pb + p];           // warp-uniform
      __nv_bfloat16* vrow = vs + static_cast<size_t>(p) * d;
      if (qi < 0) {
        for (int k = tx; k < d; k += 32) vrow[k] = __float2bfloat16_rn(0.f);
        if (tx == 0) base_s[p] = IVF_INF;
        continue;
      }
      const float* qrow = qa.q + static_cast<size_t>(qi) * d;
      float ss = 0.f;
      if (!qa.apply_rot) {
        for (int k = tx; k < d; k += 32) {
          const float r = __fsub_rn(qrow[k], crow[k]);
          ss = __fadd_rn(ss, __fmul_rn(r, r));
          vrow[k] = __float2bfloat16_rn(-2.0f * r);
        }
      } else {
        __nv_bfloat16* rb = rs + static_cast<size_t>(p) * d;
        for (int k = tx; k < d; k += 32)
          rb[k] = __float2bfloat16_rn(__fsub_rn(qrow[k], crow[k]));
        __syncwarp();
        for (int col = tx; col < d; col += 32) {
          float acc = 0.f;
          for (int k = 0; k < d; ++k)
            acc = fmaf(__bfloat162float(rb[k]),
                       __bfloat162float(qa.rot[static_cast<size_t>(k) * d +
                                               col]),
                       acc);
          ss = __fadd_rn(ss, __fmul_rn(acc, acc));
          vrow[col] = __float2bfloat16_rn(-2.0f * acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ss = __fadd_rn(ss, __shfl_xor_sync(IVF_FULL_MASK, ss, off));
      if (tx == 0) base_s[p] = __fmul_rn(qa.base_mult, ss);
    }
    __syncthreads();
  }
  float basev[8];
  int nlive = 0;                   // probe rows up to the last finite base
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    basev[i] = i >= np ? IVF_INF
               : QC    ? base_s[ty + 8 * i]
                       : base_tiles[t * pb + ty + 8 * i];
    if (basev[i] < IVF_INF) nlive = i + 1;
  }
  const __nv_bfloat16* vt = v_tiles + t * pb * d;
  const int ngroups = (size + GROUP - 1) / GROUP;

  for (int G = 0; G < ngroups; ++G) {
    const int row0 = start + G * GROUP;
    const int nvalid = min(GROUP, size - G * GROUP);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float nacc = 0.f;              // KNORM: this thread's half of a row norm

    for (int kb = 0; kb < nk; ++kb) {
      const int k0 = kb * KT;
      __syncthreads();  // buffers initialised / previous step's reads done
      if (!QC && (nk > 1 || G == 0)) {
        for (int i = tid; i < pb * (KT / 8); i += GS_THREADS) {
          const int p = i / (KT / 8), s = i - p * (KT / 8);
          reinterpret_cast<uint4*>(vs + static_cast<size_t>(p) * KT)[s] =
              reinterpret_cast<const uint4*>(
                  vt + static_cast<size_t>(p) * d + k0)[s];
        }
      }
      ivf_stage_rows<GROUP, KT, GS_THREADS>(rs, RS, decoded, scale,
                                            static_cast<size_t>(row0), nvalid,
                                            d, k0, tid);
      __syncthreads();
      if (use_norm) {
        // thread (row r, half h) sums the squares of words [16h, 16h + 16)
        // and [32 + 16h, 48 + 16h) of its row: a warp's 16 rows x 2 halves
        // touch 32 distinct banks at every step
        const __nv_bfloat162* rw = reinterpret_cast<const __nv_bfloat162*>(
            rs + static_cast<size_t>(tid >> 1) * RS);
        const int h16 = (tid & 1) * 16;
#pragma unroll
        for (int part = 0; part < 2; ++part)
          for (int wd = 0; wd < 16; ++wd) {
            const float2 r2 = __bfloat1622float2(rw[part * 32 + h16 + wd]);
            nacc = __fadd_rn(nacc, __bfloat162float(__float2bfloat16_rn(
                                       __fmul_rn(r2.x, r2.x))));
            nacc = __fadd_rn(nacc, __bfloat162float(__float2bfloat16_rn(
                                       __fmul_rn(r2.y, r2.y))));
          }
      }
      const __nv_bfloat16* vk = QC ? vs + k0 : vs;
      switch (nlive) {             // warp-uniform: one warp, one ty
        case 1: dot_step<1, QC>(acc, rs, vk, d, tx, ty); break;
        case 2: dot_step<2, QC>(acc, rs, vk, d, tx, ty); break;
        case 3: dot_step<3, QC>(acc, rs, vk, d, tx, ty); break;
        case 4: dot_step<4, QC>(acc, rs, vk, d, tx, ty); break;
        case 5: dot_step<5, QC>(acc, rs, vk, d, tx, ty); break;
        case 6: dot_step<6, QC>(acc, rs, vk, d, tx, ty); break;
        case 7: dot_step<7, QC>(acc, rs, vk, d, tx, ty); break;
        case 8: dot_step<8, QC>(acc, rs, vk, d, tx, ty); break;
        default: break;
      }
    }

    if (use_norm) {
      const float other = __shfl_xor_sync(IVF_FULL_MASK, nacc, 1);
      if ((tid & 1) == 0) nrm_s[tid >> 1] = __fadd_rn(nacc, other);
      __syncthreads();  // next written after the next group's two barriers
    }
    // scores, in place of the products
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 32 * j;
      const bool valid = r < nvalid;
      float nr = 0.f;
      if (KNORM) {
        if (use_norm) nr = nrm_s[r];
      } else {
        nr = valid ? norms[row0 + r] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float s;
        if (KNORM) {
          s = use_norm ? __fadd_rn(acc[i][j], __fmul_rn(norm_coef, nr))
                       : acc[i][j];
          s = __fadd_rn(s, basev[i]);
          s = valid ? s : IVF_INF;
        } else {
          s = __fadd_rn(acc[i][j], basev[i]);
          s = valid ? s : IVF_INF;
          s = __fadd_rn(s, __fmul_rn(norm_coef, nr));
        }
        acc[i][j] = s;
      }
    }
    if (EXACT) {
      // the warp holds all 128 rows of its probes ty + 8i
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < nlive) {
          const int p = ty + 8 * i;
          for (int pass = 0; pass < k_out; ++pass)
            if (!ivf_exact_pass(acc[i], bufd + p * GROUP, bufp + p * GROUP,
                                row0, tx))
              break;
        }
      }
    } else {
      const int bank = G % nbank;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 32 * j;
        int pay = G;                  // PAY_BLOCK
        if (PAY == PAY_IDS) pay = r < nvalid ? ids[row0 + r] : -1;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < np) {
            const int slot = (ty + 8 * i) * nf + bank * GROUP + r;
            if (acc[i][j] < bufd[slot]) {
              bufd[slot] = acc[i][j];
              bufp[slot] = pay;
            }
          }
        }
      }
    }
  }
  __syncthreads();
  if (EXTRACT) {
    float* od = out_d + t * pb * k_out;
    PT* op = out_p + t * pb * k_out;
    for (int i = 0; i < np; ++i) {
      const int p = ty + 8 * i;
      float* row = bufd + static_cast<size_t>(p) * nf;
      for (int e = 0; e < k_out; ++e) {
        float m;
        int a;
        ivf_lane_argmin(row, nf, tx, m, a);
        ivf_warp_argmin(m, a);
        if (tx == 0) {
          od[p * k_out + e] = m;
          op[p * k_out + e] =
              static_cast<PT>(m == IVF_INF ? -1 : bufp[p * nf + a]);
          row[a] = IVF_INF;
        }
        __syncwarp();
      }
    }
    return;
  }
  float* od = out_d + t * pb * nf;
  PT* op = out_p + t * pb * nf;
  for (int i = tid; i < pb * nf; i += GS_THREADS) {
    od[i] = bufd[i];
    op[i] = static_cast<PT>(bufp[i]);
  }
}

template <typename ELEM, bool KNORM, int PAY, typename PT, bool EXACT,
          bool EXTRACT, bool QC = false>
static int launch_grouped_scan(const void* tstart, const void* tsize,
                               const void* v_tiles, const void* base_tiles,
                               const void* decoded, const void* scale,
                               const void* ids, const void* norms, int T,
                               int d, int pb, int nf, int k_out,
                               float norm_coef, void* out_d, void* out_p,
                               void* stream, QcArgs qa = QcArgs{}) {
  if (pb <= 0 || pb % 8 || pb > MAX_PB || nf <= 0 || nf % GROUP ||
      d <= 0 || d % KT)
    return cudaErrorInvalidValue;
  if (EXACT && (nf != GROUP || k_out < 1 || k_out > GROUP))
    return cudaErrorInvalidValue;
  if (EXTRACT && (k_out < 1 || 2 * k_out > GROUP))
    return cudaErrorInvalidValue;
  const size_t vs_elems = static_cast<size_t>(pb) * (QC ? d : KT);
  const size_t qc_elems = static_cast<size_t>(pb) * (d + 2);  // r rows, bases
  const size_t rs_elems =
      QC && qc_elems > static_cast<size_t>(GROUP) * RS
          ? qc_elems
          : static_cast<size_t>(GROUP) * RS;
  const size_t smem =
      static_cast<size_t>(pb) * nf * 8 + (vs_elems + rs_elems) * 2;
  if (smem > 226u * 1024u) return cudaErrorInvalidValue;
  int err = ivf_set_smem(
      reinterpret_cast<const void*>(
          grouped_scan_kernel<ELEM, KNORM, PAY, PT, EXACT, EXTRACT, QC>),
      smem);
  if (err) return err;
  if (T > 0)
    grouped_scan_kernel<ELEM, KNORM, PAY, PT, EXACT, EXTRACT, QC>
        <<<T, GS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tstart), static_cast<const int*>(tsize),
        static_cast<const __nv_bfloat16*>(v_tiles),
        static_cast<const float*>(base_tiles),
        static_cast<const ELEM*>(decoded), static_cast<const float*>(scale),
        static_cast<const int*>(ids), static_cast<const float*>(norms), d, pb,
        nf, k_out, norm_coef, static_cast<float*>(out_d),
        static_cast<PT*>(out_p), qa);
  return ivf_launch_status();
}

// One C entry point per variant the JAX package reaches, all with one
// signature: the streams a variant does not read (scale for bf16 rows, ids
// without PAY_IDS, norms with KNORM) may be null; k_out is read by the
// exact merge and by extraction.
#define GROUPED_ENTRY(NAME, ...)                                              \
  extern "C" int NAME(const void* tstart, const void* tsize,                 \
                      const void* v_tiles, const void* base_tiles,           \
                      const void* decoded, const void* scale,                \
                      const void* ids, const void* norms, int T, int d,      \
                      int pb, int nf, int k_out, float norm_coef,            \
                      void* out_d, void* out_p, void* stream) {              \
    return launch_grouped_scan<__VA_ARGS__>(                                 \
        tstart, tsize, v_tiles, base_tiles, decoded, scale, ids, norms, T,   \
        d, pb, nf, k_out, norm_coef, out_d, out_p, stream);                  \
  }

#define GROUPED_ENTRIES(SUFFIX, ELEM)                                        \
  GROUPED_ENTRY(grouped_scan##SUFFIX, ELEM, false, PAY_IDS, int, false,      \
                false)                                                       \
  GROUPED_ENTRY(grouped_scan_knorm##SUFFIX, ELEM, true, PAY_IDS, int, false, \
                false)                                                       \
  GROUPED_ENTRY(grouped_scan_pos8##SUFFIX, ELEM, true, PAY_BLOCK, int8_t,    \
                false, false)                                                \
  GROUPED_ENTRY(grouped_scan_pos##SUFFIX, ELEM, true, PAY_BLOCK, int, false, \
                false)                                                       \
  GROUPED_ENTRY(grouped_scan_exact##SUFFIX, ELEM, true, PAY_SLOT, int, true, \
                false)                                                       \
  GROUPED_ENTRY(grouped_scan_extract##SUFFIX, ELEM, true, PAY_IDS, int,      \
                false, true)

GROUPED_ENTRIES(, int8_t)
GROUPED_ENTRIES(_bf16, __nv_bfloat16)

// The QC variant (in-kernel norms, id payloads, fold) with its own
// signature: the tile cells, slot queries, queries, centroids and bf16
// rotation replace the placed v/base tiles.
#define GROUPED_QC_ENTRY(NAME, ELEM)                                         \
  extern "C" int NAME(const void* tstart, const void* tsize,                 \
                      const void* ctile, const void* qidx, const void* q,    \
                      const void* c, const void* rot, const void* decoded,   \
                      const void* scale, const void* ids, int T, int d,      \
                      int pb, int nf, float norm_coef, float base_mult,      \
                      int apply_rot, void* out_d, void* out_p,               \
                      void* stream) {                                        \
    QcArgs qa{static_cast<const int*>(ctile), static_cast<const int*>(qidx), \
              static_cast<const float*>(q), static_cast<const float*>(c),    \
              static_cast<const __nv_bfloat16*>(rot), base_mult, apply_rot}; \
    return launch_grouped_scan<ELEM, true, PAY_IDS, int, false, false, true>( \
        tstart, tsize, nullptr, nullptr, decoded, scale, ids, nullptr, T, d, \
        pb, nf, 0, norm_coef, out_d, out_p, stream, qa);                     \
  }

GROUPED_QC_ENTRY(grouped_scan_qc, int8_t)
GROUPED_QC_ENTRY(grouped_scan_qc_bf16, __nv_bfloat16)
