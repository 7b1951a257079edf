// Per-probe dense posting scan (the small-batch scan).
//
// Replaces ivfadc_tpu/ops/pallas_scan.py::_scan_kernel in every variant
// the JAX package reaches, as template parameters of one kernel: the
// decoded cache (ELEM: int8 with a per-column scale, or bf16 rows read as
// they are) and the merge (fold, or EXACT). Each probe scans its cell
// [start, start + size) in 128-row groups; a row's score is (the JAX
// kernel's arithmetic):
//   row   = bf16(float(int8) * bf16(scale))            (int8; bf16: as is)
//   dot   = sum_k float(v[k]) * float(row[k])          (f32 sums, exact
//                                                       products)
//   norm  = sum_k float(bf16(row[k] * row[k]))         (bf16 squares)
//   s     = (dot + norm_coef * norm) + base            (norm_coef == 0:
//                                                       dot + base)
//   s     = +inf at or past the cell size
// then the merge:
//   fold:  group G belongs to bank G % (nf/128), lane = row within the
//          group; strict '<' keeps the earlier G on ties; payload = G, the
//          cell-relative 128-row block index; buffers start at +inf / -1.
//          The (s, G) minimum is associative: any walk gives one result.
//   exact: (nf = 128) after each group, up to k_out passes move the
//          group's minimum (lowest row among ties) into the buffer's
//          maximum lane (lowest lane among ties) when strictly smaller,
//          payload = the absolute slot (ops/dense_scan._exact_merge).
// v may be narrower than the cache (dv <= d): its missing features are 0.
// Probes of size 0 write +inf / -1.
//
// Bound: bytes. At the large-kc posting shape (131,072 probes, cells of
// ~28 rows) and at B = 256 (2,048 probes, cells of ~1000 rows) the rows,
// v and the output rows are each touched once, and the products are a few
// percent of the tensor cores' rate; what a design must supply is memory
// parallelism and balance. So:
// - Persistent blocks of four warps; the grid is the card's resident-block
//   count (probe_scan_fit). A block walks the probes p = blockIdx.x + i *
//   gridDim.x. A probe's groups form u units of whole bank rounds (fold:
//   u = min(4, rounds); the exact merge: u = 1), handed to the block's
//   warps in turn, so a cell of 28 rows keeps one warp busy (not 128
//   threads) while the other warps take the next probes, and a cell of
//   4000 rows is scored by four warps. The units of a split probe merge
//   their (s, G) minima as u64 keys by shared-memory atomicMin into one of
//   SLOTS merge slots; the last unit (a ticket) writes the probe's lanes.
//   A slot is reused only after its probe is written (an epoch), and the
//   warps wait only on earlier probes, so the walk cannot deadlock.
// - A warp is its own producer: one lane issues Hopper bulk async copies
//   (cp.async.bulk, completing on an mbarrier) of exactly a stage's valid
//   rows (32 rows: two m16 tiles) and, with a unit's first stage, of its
//   v, into a ring of RING stages, up to RING - 1 stages ahead, across
//   probe boundaries. A stage's header (the task: probe, group, bank,
//   rows, flags) is written by the same lane before its arrive. No
//   zero-fill (rows past the size are masked to +inf after scoring), no
//   ld.global -> st.shared staging, no block barrier after the set-up.
//   The probes' starts, sizes and bases reach the producers 32 probes
//   ahead, in registers.
// - Scores on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums):
//   A = 16 rows, B = v for the dot and a ones column for the bf16 squares.
//   An int8 quad becomes two exact bf16 pairs (a float's mantissa byte)
//   and one __hmul2 by the bf16 scale pair rounds bf16(q * scale) once;
//   __hmul2 of a row by itself gives bf16(row^2). Rows are read from
//   shared memory as 16-byte chunks without bank conflicts: thread (g, t)
//   of the fragment reads row g's chunk 16 t of the 64-byte half h ^ (g &
//   1) of each 128-byte segment, so the two rows of a quarter-warp cover
//   all 32 banks. That permutes the features of odd rows against even
//   rows; B's column n holds v in the permutation of rows of parity n & 1,
//   and row r's dot is read from a column of its own parity. The norm's
//   ones column is the same under any permutation.
// - The exact merge runs in registers (thread l holds buffer lanes l + 32
//   j and the group's rows l + 32 j); a pass's minimum and maximum are
//   redux.sync reductions of order-preserving keys, and a pass stops the
//   group's walk as soon as no score is below the buffer's maximum.
// - Each probe's nf output lanes leave as whole 128-byte warp stores.

#include <algorithm>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int GROUP = 128;     // rows per fold group = lanes of a bank
constexpr int STAGE = 32;      // rows per ring stage (two m16 tiles)
constexpr int KB = 128;        // features per block of B fragments
constexpr int MAX_NW = 4;      // warps a block
constexpr int SLOTS = 2;       // merge slots of a block's split probes
constexpr int WARP_HEAD = 256; // a warp's mbarriers and task headers
constexpr int RING = 3;        // ring stages of a warp

enum : int {
  FIRST = 1, GROUP_END = 2, BANK_END = 4, UNIT_END = 8, SPLIT = 16
};

// One ring stage's task, written by the producer lane into the stage's
// header before its arrive. p < 0 ends the walk.
struct __align__(16) Task {
  int p, G, bank, rows;  // probe; group; its bank; valid rows (0..32)
  int info;              // flags | stage << 8 | v slot << 12 | units << 16
  int start;             // the probe's cell start
  int aux;               // split: the block's split-probe ordinal; else
                         // the probe's 128-row groups
  float base;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Bulk async copy (1-D TMA) of `bytes` (a 16-multiple) from global to
// shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Orders this thread's earlier shared-memory accesses (and the warp's,
// after __syncwarp) before later async-proxy (bulk copy) writes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// float(q) of byte b of a word whose bytes are int8 values XOR 0x80: the
// byte is the low mantissa byte of 2^23 + (q + 128)
__device__ __forceinline__ float int8_at(uint32_t biased, int b) {
  return __fsub_rn(
      __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + b)),
      8388736.0f);
}

// bf16(q * scale) of bytes b, b + 1 of a biased int8 word (one rounding:
// q and scale are exact bf16 values)
__device__ __forceinline__ uint32_t dequant_pair(uint32_t biased, int b,
                                                 uint32_t scale2) {
  return as_u32(__hmul2(
      __floats2bfloat162_rn(int8_at(biased, b), int8_at(biased, b + 1)),
      as_bf2(scale2)));
}

__device__ __forceinline__ uint32_t square_pair(uint32_t x) {
  return as_u32(__hmul2(as_bf2(x), as_bf2(x)));
}

// Byte offset, in a row, of the 16-byte chunk c (= segment * 2 + half) of
// feature block kb that thread t of a row of parity par reads.
template <int ES>
__device__ __forceinline__ int chunk_at(int kb, int c, int par, int t) {
  return kb * KB * ES + (c >> 1) * 128 + (((c & 1) ^ par) * 64) + 16 * t;
}

// The warp's B fragments of feature block kb: k-step ks (8 per block)
// pairs features (4j, 4j+1) and (4j+2, 4j+3) of the thread's chunk, as
// the A fragments do. `src` holds d bf16 values (v, or the scales).
template <int ES>
__device__ __forceinline__ void build_frags(uint32_t (&f)[8][2],
                                            const __nv_bfloat16* src, int kb,
                                            int par, int t) {
#pragma unroll
  for (int c = 0; c < 2 * ES; ++c) {
    const int f0 = chunk_at<ES>(kb, c, par, t) / ES;
    const uint4 w0 = *reinterpret_cast<const uint4*>(src + f0);
    if (ES == 1) {
      const uint4 w1 = *reinterpret_cast<const uint4*>(src + f0 + 8);
      f[4 * c + 0][0] = w0.x; f[4 * c + 0][1] = w0.y;
      f[4 * c + 1][0] = w0.z; f[4 * c + 1][1] = w0.w;
      f[4 * c + 2][0] = w1.x; f[4 * c + 2][1] = w1.y;
      f[4 * c + 3][0] = w1.z; f[4 * c + 3][1] = w1.w;
    } else {
      f[2 * c + 0][0] = w0.x; f[2 * c + 0][1] = w0.y;
      f[2 * c + 1][0] = w0.z; f[2 * c + 1][1] = w0.w;
    }
  }
}

// Dot (and norm) accumulators of m16 tile `m` of a stage over feature
// block kb: rows g and g + 8 of the tile, chunks read conflict-free.
template <typename ELEM>
__device__ __forceinline__ void score_tile(
    float (&dacc)[4], float (&nacc)[4], const unsigned char* tile, int rb,
    int kb, int g, int t, const uint32_t (&vb)[8][2],
    const uint32_t (&sc)[8][2], bool use_norm) {
  constexpr int ES = sizeof(ELEM);
  constexpr uint32_t ONES = 0x3F803F80u;  // bf16 (1, 1)
  const int par = g & 1;
  const unsigned char* r0 = tile + g * rb;
  const unsigned char* r1 = r0 + 8 * rb;
#pragma unroll
  for (int c = 0; c < 2 * ES; ++c) {
    const int off = chunk_at<ES>(kb, c, par, t);
    const uint4 x = *reinterpret_cast<const uint4*>(r0 + off);
    const uint4 y = *reinterpret_cast<const uint4*>(r1 + off);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int j = 0; j < 4 / ES; ++j) {
      const int ks = (4 / ES) * c + j;
      uint32_t a0, a1, a2, a3;
      if (ES == 1) {
        const uint32_t bx = xs[j] ^ 0x80808080u, by = ys[j] ^ 0x80808080u;
        a0 = dequant_pair(bx, 0, sc[ks][0]);
        a2 = dequant_pair(bx, 2, sc[ks][1]);
        a1 = dequant_pair(by, 0, sc[ks][0]);
        a3 = dequant_pair(by, 2, sc[ks][1]);
      } else {
        a0 = xs[2 * j];
        a2 = xs[2 * j + 1];
        a1 = ys[2 * j];
        a3 = ys[2 * j + 1];
      }
      mma_bf16(dacc, a0, a1, a2, a3, vb[ks][0], vb[ks][1]);
      if (use_norm)
        mma_bf16(nacc, square_pair(a0), square_pair(a1), square_pair(a2),
                 square_pair(a3), ONES, ONES);
    }
  }
}

// Order-preserving u32 of a score (no NaN): -0 and +0 share a key.
__device__ __forceinline__ uint32_t ordered(float x) {
  const uint32_t u = __float_as_uint(__fadd_rn(x, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// One pass of the exact merge over registers: thread l holds the group's
// scores c[j] of rows l + 32 j and the buffer lanes l + 32 j. The group's
// minimum (lowest row among ties) replaces the buffer's maximum (lowest
// lane among ties) when strictly smaller, and is masked to +inf. Minima
// and maxima are redux.sync reductions of order-preserving keys, ties to
// the lowest index by a second one. Returns false when nothing moved
// (later passes cannot move anything either).
__device__ __forceinline__ bool exact_pass(float (&c)[4], float (&bd)[4],
                                           int (&bp)[4], int slot0,
                                           int lane) {
  const uint32_t kb0 = ordered(bd[0]), kb1 = ordered(bd[1]),
                 kb2 = ordered(bd[2]), kb3 = ordered(bd[3]);
  const uint32_t kc0 = ordered(c[0]), kc1 = ordered(c[1]),
                 kc2 = ordered(c[2]), kc3 = ordered(c[3]);
  const uint32_t kmax = __reduce_max_sync(
      IVF_FULL_MASK, max(max(kb0, kb1), max(kb2, kb3)));
  const uint32_t kmin = __reduce_min_sync(
      IVF_FULL_MASK, min(min(kc0, kc1), min(kc2, kc3)));
  if (!(kmin < kmax)) return false;
  const uint32_t l = lane;
  const uint32_t ri = __reduce_min_sync(
      IVF_FULL_MASK, kb0 == kmax   ? l
                     : kb1 == kmax ? l + 32
                     : kb2 == kmax ? l + 64
                     : kb3 == kmax ? l + 96
                                   : 0xffffffffu);
  const uint32_t ci = __reduce_min_sync(
      IVF_FULL_MASK, kc0 == kmin   ? l
                     : kc1 == kmin ? l + 32
                     : kc2 == kmin ? l + 64
                     : kc3 == kmin ? l + 96
                                   : 0xffffffffu);
  const int cj = ci >> 5;
  const float cv = __shfl_sync(
      IVF_FULL_MASK, cj == 0 ? c[0] : cj == 1 ? c[1] : cj == 2 ? c[2] : c[3],
      ci & 31);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (ri == l + 32 * j) {
      bd[j] = cv;
      bp[j] = slot0 + static_cast<int>(ci);
    }
    if (ci == l + 32 * j) c[j] = IVF_INF;
  }
  return true;
}

// The fold's (s, G) lexicographic minimum as one u64 (G >= 0); all ones
// is the empty lane (+inf, -1).
__device__ __forceinline__ unsigned long long fold_key(float s, int G) {
  return (static_cast<unsigned long long>(ordered(s)) << 32) |
         static_cast<uint32_t>(G);
}

// The block's shared state: per warp its mbarriers and task headers
// (WARP_HEAD bytes), the merge slots' epochs and tickets, then the slots'
// keys (the fold: SLOTS x nf), the warps' rings, their v rings, the bf16
// scales.
struct Layout {
  size_t keys, ring, vbuf, sbuf, bytes;
};

template <typename ELEM, bool EXACT>
__host__ __device__ inline Layout probe_layout(int d, int nf, int nw) {
  Layout l;
  const size_t rb = static_cast<size_t>(d) * sizeof(ELEM);
  l.keys = nw * WARP_HEAD + 2 * SLOTS * sizeof(int);
  l.keys = (l.keys + 127) / 128 * 128;
  l.ring = l.keys + (EXACT ? 0 : static_cast<size_t>(SLOTS) * nf * 8);
  l.vbuf = l.ring + static_cast<size_t>(nw) * RING * STAGE * rb;
  l.sbuf = l.vbuf + static_cast<size_t>(nw) * RING * d * 2;
  l.bytes = l.sbuf + (sizeof(ELEM) == 1 ? static_cast<size_t>(d) * 2 : 0);
  return l;
}

template <typename ELEM, bool EXACT>
__global__ void __launch_bounds__(32 * MAX_NW) probe_scan_kernel(
    const int* __restrict__ starts, const int* __restrict__ sizes,
    const float* __restrict__ base, const __nv_bfloat16* __restrict__ v,
    const ELEM* __restrict__ decoded, const float* __restrict__ scale, int P,
    int d, int dv, int nf, int k_out, float norm_coef,
    float* __restrict__ out_d, int* __restrict__ out_p) {
  constexpr int ES = sizeof(ELEM);
  extern __shared__ __align__(128) unsigned char sm[];
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5;
  const Layout lay = probe_layout<ELEM, EXACT>(d, nf, nw);
  const int rb = d * ES;
  unsigned char* whead = sm + w * WARP_HEAD;
  Task* tasks = reinterpret_cast<Task*>(whead + 64);
  int* epoch = reinterpret_cast<int*>(sm + nw * WARP_HEAD);
  int* ticket = epoch + SLOTS;
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(sm + lay.keys);
  unsigned char* ring = sm + lay.ring + static_cast<size_t>(w) * RING *
                                            STAGE * rb;
  __nv_bfloat16* vbuf = reinterpret_cast<__nv_bfloat16*>(sm + lay.vbuf) +
                        static_cast<size_t>(w) * RING * d;
  __nv_bfloat16* sbuf = reinterpret_cast<__nv_bfloat16*>(sm + lay.sbuf);
  const uint32_t bar0 = smem_u32(whead);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3,
            par = g & 1;
  const int nbank = nf / GROUP, nkb = d / KB;
  const bool use_norm = norm_coef != 0.f;
  const unsigned char* dec = reinterpret_cast<const unsigned char*>(decoded);

  if (lane < RING) mbar_init(bar0 + 8 * lane, 1);
  // v's missing features read as 0; the bulk copies never write there
  for (int r = 0; r < RING; ++r)
    for (int i = dv + 2 * lane; i < d; i += 64)
      *reinterpret_cast<uint32_t*>(vbuf + r * d + i) = 0u;
  if (ES == 1)
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      sbuf[i] = __float2bfloat16_rn(scale[i]);
  if (!EXACT)
    for (int i = threadIdx.x; i < SLOTS * nf; i += blockDim.x)
      keys[i] = ~0ull;
  if (!EXACT && threadIdx.x < SLOTS) {
    epoch[threadIdx.x] = threadIdx.x;
    ticket[threadIdx.x] = 0;
  }
  if (lane == 0) {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();  // once: the scales and the merge slots

  uint32_t sc[8][2], vb[8][2];
  if (ES == 1 && nkb == 1) build_frags<ES>(sc, sbuf, 0, par, t);

  // ---- the producer's walk (warp-uniform state; lane 0 issues) ----
  // The block walks the probes p = blockIdx.x + i * gridDim.x. A probe's
  // 128-row groups form u units (the fold: u = min(nw, bank rounds), each
  // a run of whole bank rounds; the exact merge: u = 1), and unit k of
  // the probe whose units start at the block's running unit count U goes
  // to warp (U + k) % nw. Every warp walks the same list and counts.
  // Probe meta 32 at a time: lane j of batch k holds ordinal 32 k + j.
  int m_start = 0, m_size = 0, n_start = 0, n_size = 0;
  float m_base = 0.f, n_base = 0.f;
  auto load_batch = [&](int k, int& st, int& sz, float& bs) {
    const long long p =
        blockIdx.x + static_cast<long long>(32 * k + lane) * gridDim.x;
    if (p < P) {
      st = starts[p];
      sz = sizes[p];
      bs = base[p];
    }
  };
  load_batch(0, m_start, m_size, m_base);
  load_batch(1, n_start, n_size, n_base);

  int pi = 0, U = 0, nsplit = 0, p = 0, start = 0, size = 0, ngroups = 0,
      u = 1, gbeg = 0, gcnt = 0, nbk = 0, b = 0, G = 0, s = 0, vsl = 0,
      sidx = 0;
  float pbase = 0.f;
  bool pdone = false;
  // from ordinal pi on, the next probe with a unit of this warp
  auto seek = [&]() {
    for (;;) {
      if (pi > 0 && (pi & 31) == 0) {
        m_start = n_start;
        m_size = n_size;
        m_base = n_base;
        load_batch(pi / 32 + 1, n_start, n_size, n_base);
      }
      const long long pl =
          blockIdx.x + static_cast<long long>(pi) * gridDim.x;
      if (pl >= P) {
        p = -1;
        return;
      }
      p = static_cast<int>(pl);
      size = __shfl_sync(IVF_FULL_MASK, m_size, pi & 31);
      ngroups = (size + GROUP - 1) / GROUP;
      const int rounds =
          nbank == 1 ? ngroups : (ngroups + nbank - 1) / nbank;
      u = EXACT ? 1 : max(1, min(nw, rounds));
      const int k = (w - U) & (nw - 1);  // nw is a power of two
      if (k < u) {
        start = __shfl_sync(IVF_FULL_MASK, m_start, pi & 31);
        pbase = __shfl_sync(IVF_FULL_MASK, m_base, pi & 31);
        const int r0 = k * rounds / u, r1 = (k + 1) * rounds / u;
        gbeg = r0 * nbank;
        gcnt = min(r1 * nbank, ngroups) - gbeg;
        nbk = min(nbank, gcnt);
        b = s = 0;
        G = gbeg;
        sidx = nsplit;
        return;
      }
      U += u;
      nsplit += u > 1;
      ++pi;
    }
  };
  seek();

  int issued = 0;
  auto emit = [&]() {
    const int slot = issued % RING;
    const uint32_t bar = bar0 + 8 * slot;
    Task tk = {};
    int nrows = 0, flags = 0;
    if (p < 0) {
      tk.p = -1;
      pdone = true;
    } else {
      if (gcnt <= 0) {
        flags = FIRST | UNIT_END;
      } else {
        const int gl = G - gbeg;   // the group within the unit
        nrows = min(STAGE, size - G * GROUP - STAGE * s);
        const bool gend = s == GROUP / STAGE - 1 ||
                          G * GROUP + STAGE * (s + 1) >= size;
        const bool bend = gend && gl + nbank >= gcnt;
        flags = (b == 0 && gl == 0 && s == 0 ? FIRST : 0) |
                (gend ? GROUP_END : 0) | (bend ? BANK_END : 0) |
                (bend && b + 1 >= nbk ? UNIT_END : 0) |
                (u > 1 ? SPLIT : 0);
      }
      tk.p = p;
      tk.G = G;
      tk.bank = b;
      tk.rows = nrows;
      tk.info = flags | (s << 8) | (vsl << 12) | (u << 16);
      tk.start = start;
      tk.aux = u > 1 ? sidx : ngroups;
      tk.base = pbase;
    }
    if (lane == 0) {
      tasks[slot] = tk;
      fence_proxy_async();
      const int vbytes = (flags & FIRST) ? dv * 2 : 0;
      mbar_arrive_tx(bar, nrows * rb + vbytes);
      if (nrows)
        bulk_copy(smem_u32(ring + slot * STAGE * rb),
                  dec + (static_cast<size_t>(start) + G * GROUP +
                         STAGE * s) * rb,
                  nrows * rb, bar);
      if (vbytes)
        bulk_copy(smem_u32(vbuf + vsl * d),
                  v + static_cast<size_t>(p) * dv, vbytes, bar);
    }
    ++issued;
    if (pdone) return;
    if (flags & UNIT_END) {
      U += u;
      nsplit += u > 1;
      ++pi;
      vsl = (vsl + 1) % RING;
      seek();
    } else if (!(flags & GROUP_END)) {
      ++s;
    } else if (!(flags & BANK_END)) {
      G += nbank;
      s = 0;
    } else {
      ++b;
      G = gbeg + b;
      s = 0;
    }
  };

  // ---- the consumer ----
  float best[4], c[4], bd[4];
  int bestp[4], bp[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    best[j] = c[j] = bd[j] = IVF_INF;
    bestp[j] = bp[j] = -1;
  }
  // a split probe's merge slot: held from the unit's first merge (once the
  // slot's epoch is the probe's split ordinal), freed by its last unit
  bool slot_held = false;
  auto hold_slot = [&](int sidx) {
    if (slot_held) return;
    if (lane == 0)
      while (*reinterpret_cast<volatile int*>(epoch + sidx % SLOTS) != sidx)
        __nanosleep(32);
    __syncwarp();
    __threadfence_block();
    slot_held = true;
  };
  auto last_unit = [&](int sidx, int nu) {
    __syncwarp();
    int old = 0;
    if (lane == 0) {
      __threadfence_block();
      old = atomicAdd(ticket + sidx % SLOTS, 1);
    }
    old = __shfl_sync(IVF_FULL_MASK, old, 0);
    if (old == nu - 1) __threadfence_block();
    slot_held = false;
    return old == nu - 1;
  };
  auto free_slot = [&](int sidx) {
    __syncwarp();
    if (lane == 0) {
      ticket[sidx % SLOTS] = 0;
      __threadfence_block();
      *reinterpret_cast<volatile int*>(epoch + sidx % SLOTS) = sidx + SLOTS;
    }
  };
  for (int consumed = 0;; ++consumed) {
    while (!pdone && issued - consumed < RING) emit();
    const int slot = consumed % RING;
    mbar_wait(bar0 + 8 * slot, (consumed / RING) & 1);
    const Task tk = tasks[slot];
    if (tk.p < 0) break;
    const int flags = tk.info & 0xff, si = (tk.info >> 8) & 3;
    const __nv_bfloat16* vrow = vbuf + ((tk.info >> 12) & 3) * d;
    if (flags & FIRST) {
      if (nkb == 1) build_frags<ES>(vb, vrow, 0, par, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        best[j] = bd[j] = IVF_INF;
        bestp[j] = bp[j] = -1;
      }
    }
    float sc_l = IVF_INF;
    if (tk.rows > 0) {
      const unsigned char* stage = ring + slot * STAGE * rb;
      float dacc[2][4] = {}, nacc[2][4] = {};
      for (int kb = 0; kb < nkb; ++kb) {
        if (nkb > 1) {
          build_frags<ES>(vb, vrow, kb, par, t);
          if (ES == 1) build_frags<ES>(sc, sbuf, kb, par, t);
        }
        score_tile<ELEM>(dacc[0], nacc[0], stage, rb, kb, g, t, vb, sc,
                         use_norm);
        if (tk.rows > 16)
          score_tile<ELEM>(dacc[1], nacc[1], stage + 16 * rb, rb, kb, g, t,
                           vb, sc, use_norm);
      }
      // thread (g, t) scores row g + 8 t of the stage: tile t / 2, its
      // upper or lower 8 rows, the dot from a column of the row's parity
      // (selects, not an index: the accumulators stay in registers)
      const float dot =
          t == 0 ? (par ? dacc[0][1] : dacc[0][0])
          : t == 1 ? (par ? dacc[0][3] : dacc[0][2])
          : t == 2 ? (par ? dacc[1][1] : dacc[1][0])
                   : (par ? dacc[1][3] : dacc[1][2]);
      const float nrm = t == 0   ? nacc[0][0]
                        : t == 1 ? nacc[0][2]
                        : t == 2 ? nacc[1][0]
                                 : nacc[1][2];
      float sv = use_norm ? __fadd_rn(dot, __fmul_rn(norm_coef, nrm)) : dot;
      sv = __fadd_rn(sv, tk.base);
      // lane l takes row l = g' + 8 t' from thread (g', t')
      sv = __shfl_sync(IVF_FULL_MASK, sv, 4 * (lane & 7) + (lane >> 3));
      sc_l = lane < tk.rows ? sv : IVF_INF;
    }
    __syncwarp();  // the stage's reads are done: the producer may refill it
    if (EXACT) {
      if (si == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = IVF_INF;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j == si) c[j] = sc_l;
      if (flags & GROUP_END)
        for (int pass = 0; pass < k_out; ++pass)
          if (!exact_pass(c, bd, bp, tk.start + tk.G * GROUP, lane)) break;
      if (flags & UNIT_END) {
        const size_t o = static_cast<size_t>(tk.p) * nf + lane;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          out_d[o + 32 * j] = bd[j];
          out_p[o + 32 * j] = bp[j];
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j == si && sc_l < best[j]) {
        best[j] = sc_l;
        bestp[j] = tk.G;
      }
    const size_t orow = static_cast<size_t>(tk.p) * nf;
    if ((flags & BANK_END) && !(flags & SPLIT)) {
      const size_t o = orow + tk.bank * GROUP + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out_d[o + 32 * j] = best[j];
        out_p[o + 32 * j] = bestp[j];
      }
    } else if (flags & BANK_END) {
      // a unit of a split probe: its banks' (s, G) minima into the probe's
      // merge slot, once the slot holds this probe
      const int ms = tk.aux % SLOTS;
      hold_slot(tk.aux);
      unsigned long long* kr = keys + ms * nf + tk.bank * GROUP + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (bestp[j] >= 0)
          atomicMin(kr + 32 * j, fold_key(best[j], bestp[j]));
    }
    if (flags & BANK_END) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        best[j] = IVF_INF;
        bestp[j] = -1;
      }
    }
    if ((flags & UNIT_END) && !(flags & SPLIT)) {
      // banks no group reached
      for (int i = min(nbank, tk.aux) * GROUP + lane; i < nf; i += 32) {
        out_d[orow + i] = IVF_INF;
        out_p[orow + i] = -1;
      }
    } else if (flags & UNIT_END) {
      // the probe's last unit writes the merged lanes and frees the slot
      if (last_unit(tk.aux, (tk.info >> 16) & 7)) {
        unsigned long long* kr = keys + (tk.aux % SLOTS) * nf;
        for (int i = lane; i < nf; i += 32) {
          const unsigned long long k = kr[i];
          kr[i] = ~0ull;
          out_d[orow + i] =
              k == ~0ull ? IVF_INF : unordered(static_cast<uint32_t>(k >> 32));
          out_p[orow + i] = k == ~0ull ? -1 : static_cast<int>(k);
        }
        free_slot(tk.aux);
      }
    }
  }
}

template <typename ELEM, bool EXACT>
static int check_args(int d, int dv, int nf, int k_out) {
  if (nf <= 0 || nf % GROUP || d <= 0 || d % KB || dv <= 0 || dv > d ||
      dv % 8)
    return cudaErrorInvalidValue;
  if (EXACT && (nf != GROUP || k_out < 1 || k_out > GROUP))
    return cudaErrorInvalidValue;
  return 0;
}

// The launch shape at (d, nf): warps a block (the most that fit, up to
// MAX_NW), its shared bytes, resident blocks per SM, the SM count. Worked
// out once per (device, d, nf) and kept, with the kernel's dynamic
// shared-memory limit on each device raised to the most any plan needs.
struct Plan {
  int dev, d, nf, nw, per_sm, sms;
  size_t smem;
};

template <typename ELEM, bool EXACT>
static int plan(int d, int nf, int& nw, size_t& smem, int& per_sm,
                int& sms) {
  constexpr int MAX_PLANS = 64, MAX_DEVS = 64;
  static std::mutex mu;
  static Plan plans[MAX_PLANS];
  static int nplans = 0;
  static size_t smem_set[MAX_DEVS] = {};
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev >= MAX_DEVS) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < nplans; ++i)
    if (plans[i].dev == dev && plans[i].d == d && plans[i].nf == nf) {
      nw = plans[i].nw;
      smem = plans[i].smem;
      per_sm = plans[i].per_sm;
      sms = plans[i].sms;
      return 0;
    }
  const void* kern =
      reinterpret_cast<const void*>(probe_scan_kernel<ELEM, EXACT>);
  for (nw = MAX_NW; nw >= 1; nw /= 2) {
    smem = probe_layout<ELEM, EXACT>(d, nf, nw).bytes;
    if (smem <= 227u * 1024u) break;
  }
  if (nw < 1) return cudaErrorInvalidValue;
  if (smem > smem_set[dev]) {
    err = ivf_set_smem(kern, smem);
    if (err) return err;
    smem_set[dev] = smem;
  }
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, 32 * nw, smem));
  if (err) return err;
  err = static_cast<int>(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return err;
  if (nplans < MAX_PLANS)
    plans[nplans++] = {dev, d, nf, nw, per_sm, sms, smem};
  return 0;
}

template <typename ELEM, bool EXACT>
static int launch_probe_scan(const void* starts, const void* sizes,
                             const void* base, const void* v,
                             const void* decoded, const void* scale, int P,
                             int d, int dv, int nf, int k_out,
                             float norm_coef, void* out_d, void* out_p,
                             void* stream) {
  int err = check_args<ELEM, EXACT>(d, dv, nf, k_out);
  if (err) return err;
  int nw = 0, per_sm = 0, sms = 0;
  size_t smem = 0;
  err = plan<ELEM, EXACT>(d, nf, nw, smem, per_sm, sms);
  if (err) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(
      std::min<long long>(P, static_cast<long long>(per_sm) * sms));
  if (P > 0)
    probe_scan_kernel<ELEM, EXACT>
        <<<grid, 32 * nw, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(starts), static_cast<const int*>(sizes),
            static_cast<const float*>(base),
            static_cast<const __nv_bfloat16*>(v),
            static_cast<const ELEM*>(decoded),
            static_cast<const float*>(scale), P, d, dv, nf, k_out, norm_coef,
            static_cast<float*>(out_d), static_cast<int*>(out_p));
  return ivf_launch_status();
}

// The launch shape at (d, nf, k_out): out = resident blocks per SM,
// shared bytes a block, ring stages, rows per stage, threads a block,
// registers a thread, local (spilled) bytes a thread, SMs.
template <typename ELEM, bool EXACT>
static int fit_probe_scan(int d, int nf, int k_out, int* out) {
  int err = check_args<ELEM, EXACT>(d, 8, nf, k_out);
  if (err) return err;
  int nw = 0, per_sm = 0, sms = 0;
  size_t smem = 0;
  err = plan<ELEM, EXACT>(d, nf, nw, smem, per_sm, sms);
  if (err) return err;
  cudaFuncAttributes fa;
  err = static_cast<int>(cudaFuncGetAttributes(
      &fa, reinterpret_cast<const void*>(probe_scan_kernel<ELEM, EXACT>)));
  if (err) return err;
  out[0] = per_sm;
  out[1] = static_cast<int>(smem);
  out[2] = RING;
  out[3] = STAGE;
  out[4] = 32 * nw;
  out[5] = fa.numRegs;
  out[6] = static_cast<int>(fa.localSizeBytes);
  out[7] = sms;
  return 0;
}

}  // namespace

// One C entry point per variant, all with one signature; `scale` may be
// null for bf16 rows, k_out is read by the exact merge; v is (P, dv) with
// dv <= d. NAME_fit reports the launch shape.
#define PROBE_ENTRY(NAME, ELEM, EXACT)                                        \
  extern "C" int NAME(const void* starts, const void* sizes,                 \
                      const void* base, const void* v, const void* decoded,  \
                      const void* scale, int P, int d, int dv, int nf,       \
                      int k_out, float norm_coef, void* out_d, void* out_p,  \
                      void* stream) {                                        \
    return launch_probe_scan<ELEM, EXACT>(starts, sizes, base, v, decoded,   \
                                          scale, P, d, dv, nf, k_out,        \
                                          norm_coef, out_d, out_p, stream);  \
  }                                                                          \
  extern "C" int NAME##_fit(int d, int nf, int k_out, int* out) {            \
    return fit_probe_scan<ELEM, EXACT>(d, nf, k_out, out);                   \
  }

PROBE_ENTRY(probe_scan, int8_t, false)
PROBE_ENTRY(probe_scan_exact, int8_t, true)
PROBE_ENTRY(probe_scan_bf16, __nv_bfloat16, false)
PROBE_ENTRY(probe_scan_exact_bf16, __nv_bfloat16, true)
