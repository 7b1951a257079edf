// Cell-grouped dense posting scan with a fold merge.
//
// Replaces ivfadc_tpu/ops/pallas_scan.py::_grouped_scan_kernel in two
// variants, both with fold merge, emitted external ids (ids2d) and the int8
// decoded cache with a per-column scale: cached row norms (norms2d; entry
// point grouped_scan) and row norms computed in the kernel (entry point
// grouped_scan_knorm). Each tile (one block) holds up to pb probes of ONE
// cell; the block walks the cell's live rows in 128-row groups, in
// increasing order, and for probe p and group row l computes, in this
// order (the JAX kernel's arithmetic):
//   row  = bf16(float(int8) * float(bf16(scale)))        (per column)
//   dot  = sum_k float(v[p][k]) * float(row[k])          (f32, exact products)
// cached norms:
//   s    = dot + base[p];  s = +inf past the cell size;  s = s + coef*norm[row]
// in-kernel norms (another order, as in the JAX kernel's branch):
//   norm = sum_k float(bf16(row[k] * row[k]))            (bf16 squares, f32 sum)
//   s    = (dot + coef * norm) + base[p]                 (coef == 0: dot + base)
//   s    = +inf past the cell size
// then in both:
//   fold: group G writes bank G % (nf/128), lane l, strict '<', payload =
//         the row's external id; buffers start at +inf / -1.
// A staged group's norms are computed once, two threads a row, and shared
// by the tile's pb probes.
// Walking 128-row groups instead of the TPU's DMA chunks changes nothing:
// chunk % nf == 0, so a row's bank is the same either way. Rows at or past
// the cell size are never read. Tiles of size 0 write +inf / -1.
//
// Bound: device-memory reads of the cell rows (int8, 1 B/dim) plus the
// per-group dot products (pb x 128 x d FMAs per group). Design: a row group
// is staged once in shared memory (dequantized to bf16, 16-byte loads) and
// feeds all pb probes of the tile; each thread keeps an 8x4 register tile
// of scores; the nf-lane candidate buffers of the tile stay in shared
// memory for the whole cell and reach device memory once. Plain CUDA-core
// FMAs, no tensor cores: the first version is the exact one.

#include "common.cuh"

constexpr int GROUP = 128;        // rows per fold group = lanes of a bank
constexpr int KT = 128;           // features staged per step
constexpr int RS = KT + 2;        // staged row stride (bf16): conflict-free
constexpr int GS_THREADS = 256;   // 8 probe rows x 32 row lanes
constexpr int MAX_PB = 64;

template <bool KNORM>
__global__ void __launch_bounds__(GS_THREADS) grouped_scan_kernel(
    const int* __restrict__ tstart, const int* __restrict__ tsize,
    const __nv_bfloat16* __restrict__ v_tiles,
    const float* __restrict__ base_tiles, const int8_t* __restrict__ decoded,
    const float* __restrict__ scale, const int* __restrict__ ids,
    const float* __restrict__ norms, int d, int pb, int nf, float norm_coef,
    float* __restrict__ out_d, int* __restrict__ out_p) {
  extern __shared__ __align__(16) unsigned char smraw[];
  float* bufd = reinterpret_cast<float*>(smraw);                // pb * nf
  int* bufp = reinterpret_cast<int*>(bufd + static_cast<size_t>(pb) * nf);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(
      bufp + static_cast<size_t>(pb) * nf);                     // pb * KT
  __nv_bfloat16* rs = vs + static_cast<size_t>(pb) * KT;        // GROUP * RS
  __shared__ float nrm_s[GROUP];   // KNORM: the staged group's row norms

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int t = blockIdx.x;
  const int start = tstart[t], size = tsize[t];
  const int np = pb >> 3;          // probe rows per thread (ty + 8 * i)
  const int nbank = nf / GROUP;
  const int nk = d / KT;
  const bool use_norm = KNORM && norm_coef != 0.f;

  for (int i = tid; i < pb * nf; i += GS_THREADS) {
    bufd[i] = IVF_INF;
    bufp[i] = -1;
  }
  float basev[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    basev[i] = i < np ? base_tiles[static_cast<size_t>(t) * pb + ty + 8 * i]
                      : 0.f;
  const __nv_bfloat16* vt = v_tiles + static_cast<size_t>(t) * pb * d;
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
      if (nk > 1 || G == 0) {
        for (int i = tid; i < pb * (KT / 8); i += GS_THREADS) {
          const int p = i / (KT / 8), s = i - p * (KT / 8);
          reinterpret_cast<uint4*>(vs + static_cast<size_t>(p) * KT)[s] =
              reinterpret_cast<const uint4*>(
                  vt + static_cast<size_t>(p) * d + k0)[s];
        }
      }
      for (int i = tid; i < GROUP * (KT / 16); i += GS_THREADS) {
        const int r = i / (KT / 16), s = i - r * (KT / 16);
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
            rs + static_cast<size_t>(r) * RS + s * 16);
        if (r < nvalid) {
          const uint4 raw = reinterpret_cast<const uint4*>(
              decoded + static_cast<size_t>(row0 + r) * d + k0)[s];
          const int8_t* q8 = reinterpret_cast<const int8_t*>(&raw);
          const float* sc = scale + k0 + s * 16;
#pragma unroll
          for (int e = 0; e < 16; e += 2)
            dst[e / 2] = __floats2bfloat162_rn(
                __fmul_rn(static_cast<float>(q8[e]), sc[e]),
                __fmul_rn(static_cast<float>(q8[e + 1]), sc[e + 1]));
        } else {
#pragma unroll
          for (int e = 0; e < 16; e += 2)
            dst[e / 2] = __floats2bfloat162_rn(0.f, 0.f);
        }
      }
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
      for (int kk = 0; kk < KT; ++kk) {
        float rv[4], vv[8];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rv[j] = __bfloat162float(
              rs[static_cast<size_t>(tx + 32 * j) * RS + kk]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          vv[i] = i < np ? __bfloat162float(
                               vs[static_cast<size_t>(ty + 8 * i) * KT + kk])
                         : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(vv[i], rv[j], acc[i][j]);
      }
    }

    if (use_norm) {
      const float other = __shfl_xor_sync(IVF_FULL_MASK, nacc, 1);
      if ((tid & 1) == 0) nrm_s[tid >> 1] = __fadd_rn(nacc, other);
      __syncthreads();  // next written after the next group's two barriers
    }
    const int bank = G % nbank;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 32 * j;
      const bool valid = r < nvalid;
      const int id = valid ? ids[row0 + r] : -1;
      float nr = 0.f;
      if (KNORM) {
        if (use_norm) nr = nrm_s[r];
      } else {
        nr = valid ? norms[row0 + r] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < np) {
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
          const int slot = (ty + 8 * i) * nf + bank * GROUP + r;
          if (s < bufd[slot]) {
            bufd[slot] = s;
            bufp[slot] = id;
          }
        }
      }
    }
  }
  __syncthreads();
  float* od = out_d + static_cast<size_t>(t) * pb * nf;
  int* op = out_p + static_cast<size_t>(t) * pb * nf;
  for (int i = tid; i < pb * nf; i += GS_THREADS) {
    od[i] = bufd[i];
    op[i] = bufp[i];
  }
}

template <bool KNORM>
static int launch_grouped_scan(const void* tstart, const void* tsize,
                               const void* v_tiles, const void* base_tiles,
                               const void* decoded, const void* scale,
                               const void* ids, const void* norms, int T,
                               int d, int pb, int nf, float norm_coef,
                               void* out_d, void* out_p, void* stream) {
  if (pb <= 0 || pb % 8 || pb > MAX_PB || nf <= 0 || nf % GROUP ||
      d <= 0 || d % KT)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(pb) * nf * 8 +
                      static_cast<size_t>(pb) * KT * 2 +
                      static_cast<size_t>(GROUP) * RS * 2;
  if (smem > 226u * 1024u) return cudaErrorInvalidValue;
  int err = ivf_set_smem(
      reinterpret_cast<const void*>(grouped_scan_kernel<KNORM>), smem);
  if (err) return err;
  if (T > 0)
    grouped_scan_kernel<KNORM><<<T, GS_THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tstart), static_cast<const int*>(tsize),
        static_cast<const __nv_bfloat16*>(v_tiles),
        static_cast<const float*>(base_tiles),
        static_cast<const int8_t*>(decoded), static_cast<const float*>(scale),
        static_cast<const int*>(ids), static_cast<const float*>(norms), d, pb,
        nf, norm_coef, static_cast<float*>(out_d), static_cast<int*>(out_p));
  return ivf_launch_status();
}

extern "C" int grouped_scan(const void* tstart, const void* tsize,
                            const void* v_tiles, const void* base_tiles,
                            const void* decoded, const void* scale,
                            const void* ids, const void* norms, int T, int d,
                            int pb, int nf, float norm_coef, void* out_d,
                            void* out_p, void* stream) {
  return launch_grouped_scan<false>(tstart, tsize, v_tiles, base_tiles,
                                    decoded, scale, ids, norms, T, d, pb, nf,
                                    norm_coef, out_d, out_p, stream);
}

// The variant that computes the row norms itself: no norms stream.
extern "C" int grouped_scan_knorm(const void* tstart, const void* tsize,
                                  const void* v_tiles, const void* base_tiles,
                                  const void* decoded, const void* scale,
                                  const void* ids, int T, int d, int pb,
                                  int nf, float norm_coef, void* out_d,
                                  void* out_p, void* stream) {
  return launch_grouped_scan<true>(tstart, tsize, v_tiles, base_tiles,
                                   decoded, scale, ids, nullptr, T, d, pb, nf,
                                   norm_coef, out_d, out_p, stream);
}
