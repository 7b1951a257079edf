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
// Bound: the score product, B*kc*d FMAs in exact f32 on the CUDA cores
// (1.0e10 at B=10240, kc=1024, d=960; 1.3e9 at d=128; 1.0e11 at B=4096,
// kc=2^18, d=96), 33.5e12 FMA/s on an H100: the naive coarse quantizer is
// contractually the exact brute-force scan, and Hopper's tensor cores have
// no f32 product (TF32 keeps about three digits). On the card the score
// loop runs near half that rate; the selection's offers (one a 128-centroid
// tile) and the epilogue's v rows take much of the rest at d = 128 (PERF.md).
// A split-TF32 prefilter with an exact f32 rescore would move the bulk to
// the tensor cores; it is not built.
//
// The design, a register-tiled f32 product whose operands both stream:
// 1. Register tile. A block's 256 threads stand as 16 x 16; each keeps a
//    TQ x 8 tile of sums, query rows ty + 16 i by centroids tx + 16 j of a
//    block tile of BQ = 16*TQ queries (TQ = 4 or 1) by BC = 128 centroids.
//    Per 4 features it reads TQ + 8 float4 (a query row broadcast to the 8
//    lanes that share it; 8 centroid rows on distinct banks through an odd
//    float4 row stride) for 32*TQ FMAs. Each sum is acc = fmaf(q[k], c[k],
//    acc) for k = 0..d-1 in order, then __fsub_rn(cn, 2 acc): the same bits
//    at every TQ and every plan.
// 2. Both operands in feature slabs. A slab is BK = 32 features of the
//    block's current BC centroid rows and, unless the query tile is held
//    whole, of its BQ query rows; slabs come in feature order, tile after
//    tile, through a ring of NSTAGE = 2 stages that cp.async fills one slab
//    ahead (a third stage measured 4-7 % slower on an H100, PERF.md). The
//    query tile is held whole where two blocks still fit a SM with it
//    (d = 128; 16-query tiles at d = 960), else it streams, so shared
//    memory does not grow with d (a whole 64-query tile at d = 960 needs
//    246,784 B, more than a block has).
// 3. The plan (ops/coarse_scan.py `choose`) picks TQ and S splits of the
//    table from B, kc, d, w, the SM count and each tile's fit (coarse_fit)
//    by a cost model fitted to the card: the grid is ceil(B / BQ) query
//    tiles x S, split fastest, so the blocks of one query tile run
//    together and share its rows in L2.
// 4. Selection without full merges. Each query keeps a sorted top-w list
//    whose last entry is a threshold: a score enters a per-query candidate
//    buffer (atomic slot, so in arbitrary order) only if it precedes the
//    threshold in the total order (score, index), and the buffer is merged
//    into the list by rank only when it would overflow and at the end of a
//    split. The last block of a query tile to finish (an atomic ticket)
//    merges the other splits' lists the same way. Every merge ranks by
//    (score, index), never by position, so the result does not depend on
//    the order in which atomics land, nor on the plan. That is the
//    selection up to w = 32. Past it (the large-w selection, chosen in
//    `launch`; w = 64 at k' = 8192), two lists and a 32-place buffer a row
//    would keep one block a SM; instead each row has one list, merged in
//    place, and a buffer of the places that two blocks a SM leave it with
//    the query tile held whole (22 at BQ = 64, d = 128, w = 64). Warps
//    stand as 16 columns x 2 rows, so a half-warp holds a row's 128 scores
//    of a tile and a warp owns its rows: a split's first tile fills the
//    lists by a sort of each row's 128 scores, later tiles offer without
//    an atomic or a block barrier, and a warp merges its full rows when a
//    buffer overflows.
// 5. The epilogues read each query row from the resident tile, else from
//    device memory, and the winning centroid rows from device memory
//    (L2-resident; not the TPU kernel's one-hot matmul). v/base without a
//    rotation keeps EU features a lane in flight before the first store
//    (one dependent round trip a feature costs as much as the score loop
//    at d = 960). Under a rotation, and in v2, each warp stages a row in
//    shared memory (q - c, or rotq) and walks it a feature a lane: batched
//    loads measured 7-11 % slower in v2 and the rotation's loop 2.5x
//    slower with its loads hoisted (PERF.md). Under the large-w selection,
//    up to d = 128, a warp keeps four winners' rows in flight. Each lane
//    sums its features l + 32 m in order.

#include "common.cuh"

namespace {

constexpr int NT = 256;        // threads per block: 16 x 16
constexpr int TC = 8;          // centroids per thread (register tile width)
constexpr int BC = 16 * TC;    // centroids per tile
constexpr int BK = 32;         // features per slab
constexpr int CSTR = BK + 4;   // slab row stride: 9 float4, odd
constexpr int NSTAGE = 2;      // ring stages; cp.async fills NSTAGE - 1 ahead
constexpr int CAP = 32;        // candidate buffer places per query: a warp
constexpr int EU = 16;         // epilogue features a lane loads ahead
constexpr int SENT = 0x7fffffff;  // index of an empty list place
constexpr size_t SMEM_MAX = 232448;
// The large-w selection (below) from w = WIDE_W + 1 to WMAX (four list
// entries a lane when a warp merges, a tile's 128 scores a row). Its
// buffer holds at most CAPW_MAX candidates a row (one a lane) and takes at
// least CAPW_MIN where it shares a SM with a second block: a SM has
// SMEM_SM bytes, of which each block reserves 1 KB.
constexpr int WIDE_W = 32;
constexpr int WMAX = 128;
constexpr int CAPW_MAX = 32;
constexpr int CAPW_MIN = 16;
constexpr size_t SMEM_SM = 233472;
constexpr size_t SMEM_TWO = SMEM_SM / 2 - 1024;

struct __align__(8) Ent {
  float s;
  int i;
};

__device__ __forceinline__ bool ent_less(float as, int ai, float bs,
                                         int bi) {
  return as < bs || (as == bs && ai < bi);
}

// Row stride of a query tile held whole, in floats: d rounded up to a
// slab, zero-filled past d, so that the last slab of a ragged d reads
// zeros and never the next row (whose inf would make NaN of 0 * inf), then
// 4 more: an odd number of float4, so that consecutive rows start on
// distinct banks.
static_assert(BK % 8 == 0, "a slab holds an even number of float4");
__host__ __device__ inline int qstride(int d) {
  return (d + BK - 1) / BK * BK + 4;
}

// The query tile held whole (qres), or nothing.
__host__ __device__ inline size_t qs_floats(int bq, int d, bool qres) {
  return qres ? static_cast<size_t>(bq) * qstride(d) : 0;
}

// One ring stage: a slab of the BQ query rows (unless the tile is held
// whole), then of the BC centroid rows.
__host__ __device__ inline size_t stage_floats(int bq, bool qres) {
  return static_cast<size_t>(qres ? BC : bq + BC) * CSTR;
}

// The ring, reused by the v/base epilogues as one row of d floats a warp.
__host__ __device__ inline size_t ring_floats(int bq, int d, bool scratch,
                                              bool qres) {
  const size_t ring = NSTAGE * stage_floats(bq, qres);
  const size_t rows = scratch ? static_cast<size_t>(NT / 32) * d : 0;
  return ring > rows ? ring : rows;
}

__host__ __device__ inline size_t sel_bytes(int bq, int d, int w,
                                            bool scratch, bool qres) {
  return 4 * (qs_floats(bq, d, qres) + ring_floats(bq, d, scratch, qres)) +
         8 * (2 * static_cast<size_t>(bq) * w +
              static_cast<size_t>(bq) * (CAP + 1)) +
         4 * (static_cast<size_t>(bq) + 1);
}

// Whether the query tile is held whole: where two blocks still fit a SM
// with it (at d = 128; at d = 960 for 16-query tiles), else it streams in
// slabs beside the centroids and shared memory does not grow with d.
__host__ __device__ inline bool resident(int bq, int d, int w, bool scratch) {
  return sel_bytes(bq, d, w, scratch, true) <= SMEM_MAX / 2;
}

// The large-w selection's shared memory: one list a row and a buffer of
// cap candidate places a row (+1, as above).
__host__ __device__ inline size_t wide_bytes(int bq, int d, int w,
                                             bool scratch, bool qres,
                                             int cap) {
  return 4 * (qs_floats(bq, d, qres) + ring_floats(bq, d, scratch, qres)) +
         8 * static_cast<size_t>(bq) * (w + cap + 1) +
         4 * (static_cast<size_t>(bq) + 1);
}

struct SelArgs {
  const float* q;      // (B, d)
  const float* cents;  // (kc, d)
  const float* cn;     // (kc,) ||c||^2
  int B, d, kc, w;
  int splits, tps;     // table splits, tiles per split
  int qres;            // the query tile held whole (resident)
  int cap;             // candidate places a row (the large-w selection)
  Ent* part;           // (B, splits, w) per-split lists (splits > 1)
  int* tickets;        // one per query tile, zero on entry (splits > 1)
};

// Shared memory, carved from one dynamic array.
// The current list is list(cur): a select by arithmetic, since an array
// of pointers indexed at run time would live in local memory.
struct Sel {
  float* qs;     // BQ x qstride(d)   the block's queries, when resident
  float* ring;   // NSTAGE x stage_floats slabs / epilogue rows
  Ent* lists;    // 2 x BQ x w        sorted top-w, and the merge target
                 //                   (one list under the large-w selection)
  int lstride;   // BQ x w
  Ent* buf;      // BQ x (CAP + 1)    candidates, unordered (+1: the
                 //                   rows of a warp's 8-lane groups on
                 //                   distinct banks); BQ x (cap + 1)
                 //                   under the large-w selection
  int* cnt;      // BQ                candidates offered per query
  int* flag;     // 1                  last block of the query tile
  __device__ __forceinline__ Ent* list(int cur) const {
    return lists + cur * lstride;
  }
};

template <bool WIDE>
__device__ __forceinline__ Sel sel_carve(float* sm, int bq, const SelArgs& a,
                                         bool scratch) {
  Sel s;
  s.qs = sm;
  s.ring = s.qs + qs_floats(bq, a.d, a.qres);
  s.lists = reinterpret_cast<Ent*>(s.ring +
                                   ring_floats(bq, a.d, scratch, a.qres));
  s.lstride = bq * a.w;
  s.buf = s.lists + (WIDE ? 1 : 2) * static_cast<size_t>(s.lstride);
  s.cnt = reinterpret_cast<int*>(s.buf + static_cast<size_t>(bq) *
                                             ((WIDE ? a.cap : CAP) + 1));
  s.flag = s.cnt + bq;
  return s;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Features [k0, k0 + BK) of rows [r0, r0 + n) of a (rows, d) matrix into
// a slab (rows of CSTR floats); places of rows from rend on, or past d, are
// zero-filled (a zero product leaves a sum unchanged).
__device__ __forceinline__ void load_slab(float* dst, const float* src,
                                          int r0, int rend, int n, int k0,
                                          int d, bool vec4, int tid) {
  if (vec4) {
    for (int ch = tid; ch < n * (BK / 4); ch += NT) {
      const int r = ch / (BK / 4), s4 = ch % (BK / 4);
      const int k = k0 + 4 * s4;
      const bool ok = r0 + r < rend && k < d;
      cp_async16(dst + r * CSTR + 4 * s4,
                 ok ? src + static_cast<size_t>(r0 + r) * d + k : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < n * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const bool ok = r0 + r < rend && k0 + kk < d;
      cp_async4(dst + r * CSTR + kk,
                ok ? src + static_cast<size_t>(r0 + r) * d + k0 + kk : src,
                ok ? 4 : 0);
    }
  }
}

// The register tile's places: thread (tx, ty) holds query rows ty + 16 i
// and centroids tx + 16 j of the block tile.
__device__ __forceinline__ int qrow(int ty, int i) { return ty + 16 * i; }

__device__ __forceinline__ int ccol(int tx, int j) { return tx + 16 * j; }

// One slab of the register tile, 4 features a step, each sum in ascending
// feature order: per step a thread reads TQ + 8 float4 (its query rows,
// each broadcast to the 8 lanes that share it; its 8 centroid rows, on
// distinct banks through the odd float4 row stride) for 32 TQ FMAs.
template <int TQ>
__device__ __forceinline__ void fma_slab(float (&acc)[TQ][TC],
                                         const float* qs, int qstr,
                                         const float* cs, int tx, int ty) {
#pragma unroll
  for (int kq = 0; kq < BK / 4; ++kq) {
    float4 a[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
      a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * qstr +
                                              4 * kq);
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(
          cs + (tx + 16 * j) * CSTR + 4 * kq);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

// Number of entries of the sorted run r[0..n) that precede x.
__device__ __forceinline__ int lower_bound(const Ent* r, int n, float xs,
                                           int xi) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ent_less(r[mid].s, r[mid].i, xs, xi))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Compare-exchange toward the lesser entry (keep_min) or the greater.
__device__ __forceinline__ void cmpx(float& s, int& i, float os, int oi,
                                     bool keep_min) {
  if (keep_min ? ent_less(os, oi, s, i) : ent_less(s, i, os, oi)) {
    s = os;
    i = oi;
  }
}

// Sort a warp's 32 entries (one a lane) ascending by (score, index): a
// bitonic network of shuffles. `merge` keeps its own copy: calling this
// changes the instructions the w <= 32 kernels compile to.
__device__ __forceinline__ void warp_sort(float& s, int& i, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float os = __shfl_xor_sync(IVF_FULL_MASK, s, j);
      const int oi = __shfl_xor_sync(IVF_FULL_MASK, i, j);
      cmpx(s, i, os, oi, ((lane & k) == 0) == ((lane & j) == 0));
    }
  }
}

// Merge every live query row's buffered candidates into its list, one
// warp a row: the warp sorts the row's CAP = 32 places (one a lane, empty
// places as (+inf, SENT)) by a bitonic network of shuffles in the total
// order (score, index), then every entry lands at its rank: a candidate at
// its place in the sorted buffer plus the list entries before it, a list
// entry at its place plus the candidates before it (binary searches).
// Ranks below w land in the other list, which becomes current. Entries are
// distinct (each index is offered once per query) but for the list's empty
// places, which sort last by place. Called after a block barrier; ends at
// one.
template <int TQ>
__device__ __forceinline__ void merge(const Sel& s, int w, int nq,
                                      int& cur) {
  constexpr int BQ = 16 * TQ;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nq; r += NT / 32) {
    const Ent* L = s.list(cur) + static_cast<size_t>(r) * w;
    Ent* O = s.list(cur ^ 1) + static_cast<size_t>(r) * w;
    Ent* Bf = s.buf + static_cast<size_t>(r) * (CAP + 1);
    const int n = min(s.cnt[r], CAP);
    float xs = IVF_INF;
    int xi = SENT;
    if (lane < n) {
      xs = Bf[lane].s;
      xi = Bf[lane].i;
    }
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const float os = __shfl_xor_sync(IVF_FULL_MASK, xs, j);
        const int oi = __shfl_xor_sync(IVF_FULL_MASK, xi, j);
        const bool keep_min = ((lane & k) == 0) == ((lane & j) == 0);
        if (keep_min ? ent_less(os, oi, xs, xi) : ent_less(xs, xi, os, oi)) {
          xs = os;
          xi = oi;
        }
      }
    }
    Bf[lane] = Ent{xs, xi};
    __syncwarp();
    if (lane < n) {
      const int rank = lane + lower_bound(L, w, xs, xi);
      if (rank < w) O[rank] = Ent{xs, xi};
    }
    for (int e = lane; e < w; e += 32) {
      const Ent l = L[e];
      const int rank = e + lower_bound(Bf, n, l.s, l.i);
      if (rank < w) O[rank] = l;
    }
    __syncwarp();
  }
  __syncthreads();
  for (int q = threadIdx.x; q < BQ; q += NT) s.cnt[q] = 0;
  cur ^= 1;
  __syncthreads();
}

__device__ __forceinline__ uint32_t bit(int i, int j) {
  return 1u << (i * TC + j);
}

// Offer each thread's TQ x TC candidates (scores sc, indices id(i, j); bit
// i*TC + j of `pend` set: a live candidate for query row qrow(ty, i)) to
// their queries. Those that
// precede the query's threshold take a buffer place; when a buffer is
// full the block merges and the rest are filtered again against the new
// thresholds. The 8 lanes sharing a query row reserve their places with
// one atomic. Block-wide: every thread calls it.
template <int TQ, class Id>
__device__ __forceinline__ void offer_body(const float (&sc)[TQ][TC], Id id,
                                      uint32_t pend,
                                      const Sel& s, int w, int nq, int& cur,
                                      int ty, int lane) {
  const int jw = (w + 7) >> 3;
  for (bool first = true;; first = false) {
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const Ent t =
          s.list(cur)[static_cast<size_t>(qrow(ty, i)) * w + w - 1];
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (!ent_less(sc[i][j], id(i, j), t.s, t.i)) pend &= ~bit(i, j);
    }
    // In each 8-lane group sharing a query row, let every lane take the j-th
    // of its own candidates, j = ceil(w / 8), and the group the last of those
    // (while every lane has j): the group then holds w candidates up to it,
    // so one after it can not be in the row's top-w. This cuts a flood (the
    // first tile, whose every score passes the empty list) to about 2w a row.
    if (first && jw < TC) {
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const uint32_t bits = (pend >> (i * TC)) & ((1u << TC) - 1);
        if (!__any_sync(IVF_FULL_MASK, __popc(bits) > jw)) continue;
        float gs = IVF_INF;
        int gi = SENT;
#pragma unroll
        for (int a = 0; a < TC; ++a) {
          int r = 0;
#pragma unroll
          for (int b = 0; b < TC; ++b)
            r += b != a && ((bits >> b) & 1) &&
                         ent_less(sc[i][b], id(i, b), sc[i][a], id(i, a))
                     ? 1 : 0;
          if (((bits >> a) & 1) && r == jw - 1) {
            gs = sc[i][a];
            gi = id(i, a);
          }
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          const float os = __shfl_xor_sync(IVF_FULL_MASK, gs, off, 8);
          const int oi = __shfl_xor_sync(IVF_FULL_MASK, gi, off, 8);
          if (ent_less(gs, gi, os, oi)) {
            gs = os;
            gi = oi;
          }
        }
#pragma unroll
        for (int a = 0; a < TC; ++a)
          if (ent_less(gs, gi, sc[i][a], id(i, a))) pend &= ~bit(i, a);
      }
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const uint32_t bits = (pend >> (i * TC)) & ((1u << TC) - 1);
      const int n = __popc(bits);
      int incl = n;
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        const int t = __shfl_up_sync(IVF_FULL_MASK, incl, off, 8);
        if ((lane & 7) >= off) incl += t;
      }
      const int total = __shfl_sync(IVF_FULL_MASK, incl, 7, 8);
      int base = 0;
      if ((lane & 7) == 0 && total > 0)
        base = atomicAdd(s.cnt + qrow(ty, i), total);
      base = __shfl_sync(IVF_FULL_MASK, base, 0, 8);
      int pos = base + incl - n;
      Ent* row = s.buf + static_cast<size_t>(qrow(ty, i)) * (CAP + 1);
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if ((bits >> j) & 1) {
          if (pos < CAP) {
            row[pos] = Ent{sc[i][j], id(i, j)};
            pend &= ~bit(i, j);
          }
          ++pos;
        }
    }
    if (!__syncthreads_or(pend != 0)) return;
    merge<TQ>(s, w, nq, cur);
  }
}

template <int TQ, class Id>
__device__ __noinline__ void offer_far(const float (&sc)[TQ][TC], Id id,
                                       uint32_t pend, const Sel& s, int w,
                                       int nq, int& cur, int ty, int lane) {
  offer_body<TQ>(sc, id, pend, s, w, nq, cur, ty, lane);
}

// The offer: inline where the query tile is resident; out of line where it
// streams, so that the score loop's registers are not shaped by it (each
// way measured faster in its own place on an H100).
template <int TQ, bool QRES, class Id>
__device__ __forceinline__ void offer(const float (&sc)[TQ][TC], Id id,
                                      uint32_t pend, const Sel& s, int w,
                                      int nq, int& cur, int ty, int lane) {
  if constexpr (QRES)
    offer_body<TQ>(sc, id, pend, s, w, nq, cur, ty, lane);
  else
    offer_far<TQ>(sc, id, pend, s, w, nq, cur, ty, lane);
}

// ---- The large-w selection (w > WIDE_W) ----
// A warp holds 16 centroid columns x 2 query rows of the register tile, so
// the 16 lanes of a half-warp hold a row's 128 scores of a tile, and the
// warp owns its 2 TQ rows' lists, buffers and counts: offers and merges
// take no block barrier. A split's first tile fills the empty lists by a
// sort of each row's 128 scores; later ones offer, and when a buffer
// overflows the warp merges its full rows, in place, one row at a time.

// Merge a warp's buffered candidates into its rows' lists, in place, a
// row at a time, the rows holding at least `need` of them (the full ones
// while offers overflow, every non-empty one at the end of a split): the
// row's n <= CAPW_MAX candidates sorted (one a lane), then every entry at
// its rank, as in `merge`: a candidate after the list entries before it,
// a list entry (four a lane) after the candidates before it (binary
// searches). All of a row's reads come before its writes. Warp-wide.
template <int TQ>
__device__ __noinline__ void merge_wide(Ent* lists, Ent* buf, int* cnt,
                                        int cap, int w, int warp, int lane,
                                        int need) {
  __syncwarp();
  for (int h = 0; h < 2; ++h)
    for (int i = 0; i < TQ; ++i) {
      const int r = qrow((warp << 1) | h, i);
      const int n = min(cnt[r], cap);
      if (n == 0 || n < need) continue;
      Ent* L = lists + static_cast<size_t>(r) * w;
      Ent* Bf = buf + static_cast<size_t>(r) * (cap + 1);
      float xs = IVF_INF;
      int xi = SENT;
      if (lane < n) {
        xs = Bf[lane].s;
        xi = Bf[lane].i;
      }
      warp_sort(xs, xi, lane);
      if (lane < n) Bf[lane] = Ent{xs, xi};
      __syncwarp();
      const int rx = lane < n ? lane + lower_bound(L, w, xs, xi) : w;
      Ent le[WMAX / 32];
      int rl[WMAX / 32];
#pragma unroll
      for (int m = 0; m < WMAX / 32; ++m) {
        const int e = lane + 32 * m;
        le[m] = Ent{IVF_INF, SENT};
        rl[m] = w;
        if (e < w) {
          le[m] = L[e];
          rl[m] = e + lower_bound(Bf, n, le[m].s, le[m].i);
        }
      }
      __syncwarp();
      if (rx < w) L[rx] = Ent{xs, xi};
#pragma unroll
      for (int m = 0; m < WMAX / 32; ++m)
        if (rl[m] < w) L[rl[m]] = le[m];
      if (lane == 0) cnt[r] = 0;
      __syncwarp();
    }
}

// Offer each thread's TQ x TC candidates (as `offer_body`) to its warp's
// rows: those that precede the row's threshold take buffer places in lane
// order, counted by a scan over the half-warp; while a buffer is full the
// warp merges its full rows and the rest are filtered again. Warp-wide.
template <int TQ, class Id>
__device__ __forceinline__ void offer_wide(const float (&sc)[TQ][TC], Id id,
                                           uint32_t pend, const Sel& s,
                                           int w, int cap, int ty, int warp,
                                           int lane) {
  const int hl = lane & 15;
  for (;;) {
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int r = qrow(ty, i);
      const Ent t = s.lists[static_cast<size_t>(r) * w + w - 1];
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (!ent_less(sc[i][j], id(i, j), t.s, t.i)) pend &= ~bit(i, j);
      const uint32_t bits = (pend >> (i * TC)) & ((1u << TC) - 1);
      const int n = __popc(bits);
      int incl = n;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const int u = __shfl_up_sync(IVF_FULL_MASK, incl, off, 16);
        if (hl >= off) incl += u;
      }
      const int total = __shfl_sync(IVF_FULL_MASK, incl, 15, 16);
      const int base = s.cnt[r];
      int pos = base + incl - n;
      Ent* row = s.buf + static_cast<size_t>(r) * (cap + 1);
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if ((bits >> j) & 1) {
          if (pos < cap) {
            row[pos] = Ent{sc[i][j], id(i, j)};
            pend &= ~bit(i, j);
          }
          ++pos;
        }
      __syncwarp();
      if (hl == 0) s.cnt[r] = base + total;
    }
    if (!__any_sync(IVF_FULL_MASK, pend != 0)) return;
    merge_wide<TQ>(s.lists, s.buf, s.cnt, cap, w, warp, lane, cap);
  }
}

// A split's first tile into the empty lists: each half-warp sorts its
// row's 128 candidates (8 a lane, place 8 hl + j) by a bitonic network,
// across lanes by shuffles within the half-warp and within a lane in
// registers, and writes the first w places. A candidate that would not
// pass an empty list (a NaN score, a place past the table or the batch)
// sorts last as an empty place. Warp-wide.
template <int TQ>
__device__ __forceinline__ void fill_wide(const float (&sc)[TQ][TC], int c0,
                                          int tx, uint32_t pend,
                                          const Sel& s, int w, int ty,
                                          int lane) {
  const int hl = lane & 15;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    float vs[TC];
    int vi[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = c0 + ccol(tx, j);
      const bool ok = ((pend >> (i * TC + j)) & 1) &&
                      ent_less(sc[i][j], c, IVF_INF, SENT);
      vs[j] = ok ? sc[i][j] : IVF_INF;
      vi[j] = ok ? c : SENT;
    }
#pragma unroll
    for (int k = 2; k <= 16 * TC; k <<= 1) {
#pragma unroll
      for (int jj = k >> 1; jj > 0; jj >>= 1) {
        if (jj < TC) {
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const int o = j ^ jj;
            if (o > j) {   // places 8 hl + j < 8 hl + o
              const bool up = ((TC * hl + j) & k) == 0;
              if (up ? ent_less(vs[o], vi[o], vs[j], vi[j])
                     : ent_less(vs[j], vi[j], vs[o], vi[o])) {
                const float ts = vs[j];
                const int ti = vi[j];
                vs[j] = vs[o];
                vi[j] = vi[o];
                vs[o] = ts;
                vi[o] = ti;
              }
            }
          }
        } else {
          const int lj = jj / TC;
          const bool lo = (hl & lj) == 0;
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const float os = __shfl_xor_sync(IVF_FULL_MASK, vs[j], lj);
            const int oi = __shfl_xor_sync(IVF_FULL_MASK, vi[j], lj);
            cmpx(vs[j], vi[j], os, oi, (((TC * hl + j) & k) == 0) == lo);
          }
        }
      }
    }
    Ent* L = s.lists + static_cast<size_t>(qrow(ty, i)) * w;
#pragma unroll
    for (int j = 0; j < TC; ++j)
      if (TC * hl + j < w) L[TC * hl + j] = Ent{vs[j], vi[j]};
  }
  __syncwarp();
}

struct Pos {
  int q0, nq, split, qtile;
};

template <int TQ>
__device__ __forceinline__ Pos block_pos(const SelArgs& a) {
  constexpr int BQ = 16 * TQ;
  Pos p;
  p.split = blockIdx.x % a.splits;  // split fastest: the blocks of a query
  p.qtile = blockIdx.x / a.splits;  // tile run together, its rows in L2
  p.q0 = p.qtile * BQ;
  p.nq = min(BQ, a.B - p.q0);
  return p;
}

// Select, for each of the block's queries, the w smallest of
// ||c||^2 - 2 q.c over its split of the table; with more than one split,
// the last block of the query tile to finish merges the others' lists.
// Returns true in the block that holds the final lists (list(cur), each
// ascending by (score, index)); the others return false and exit. Ends at
// a block barrier. WIDE: the large-w selection, on its own thread layout
// (a warp 16 columns x 2 rows, not 8 x 4); each sum is the same.
template <int TQ, bool QRES, bool WIDE>
__device__ __forceinline__ bool coarse_select(const SelArgs& a, const Sel& s,
                                              const Pos& p, int& cur) {
  constexpr int BQ = 16 * TQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = WIDE ? lane & 15 : ((warp & 1) << 3) | (lane & 7);
  const int ty = WIDE ? (warp << 1) | (lane >> 4)
                      : ((warp >> 1) << 2) | (lane >> 3);
  const int d = a.d, w = a.w;
  const bool qv4 =
      (d & 3) == 0 && (reinterpret_cast<uintptr_t>(a.q) & 15) == 0;
  const bool cv4 =
      (d & 3) == 0 && (reinterpret_cast<uintptr_t>(a.cents) & 15) == 0;

  for (int i = tid; i < BQ * w; i += NT) s.lists[i] = Ent{IVF_INF, SENT};
  for (int i = tid; i < BQ; i += NT) s.cnt[i] = 0;
  cur = 0;

  const int ntiles = (a.kc + BC - 1) / BC;
  const int t0 = p.split * a.tps;
  const int nt = max(0, min(a.tps, ntiles - t0));
  const int cend = min(a.kc, (t0 + nt) * BC);
  const int nsl = (d + BK - 1) / BK;
  const int total = nt * nsl;
  // slab `it`: features (it % nsl) * BK on of the queries and of centroid
  // tile t0 + it / nsl, into ring stage it % NSTAGE
  constexpr int cofs = QRES ? 0 : BQ * CSTR;  // centroid rows in a stage
  const size_t stage = stage_floats(BQ, QRES);
  const auto load = [&](int it) {
    float* st = s.ring + (it % NSTAGE) * stage;
    const int tl = it / nsl, k0 = (it - tl * nsl) * BK;
    if (!QRES) load_slab(st, a.q, p.q0, p.q0 + p.nq, BQ, k0, d, qv4, tid);
    load_slab(st + cofs, a.cents, (t0 + tl) * BC, cend, BC, k0, d, cv4, tid);
  };
  // a resident query tile arrives with the first slab (zero-filled past d
  // and past the batch)
  const int qstr = QRES ? qstride(d) : CSTR;
  if (QRES) {
    if (qv4) {
      const int c4 = qstr >> 2;
      for (int i = tid; i < BQ * c4; i += NT) {
        const int r = i / c4, k = 4 * (i - r * c4);
        const bool ok = r < p.nq && k < d;
        cp_async16(s.qs + r * qstr + k,
                   ok ? a.q + static_cast<size_t>(p.q0 + r) * d + k : a.q,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BQ * qstr; i += NT) {
        const int r = i / qstr, k = i - r * qstr;
        const bool ok = r < p.nq && k < d;
        cp_async4(s.qs + i,
                  ok ? a.q + static_cast<size_t>(p.q0 + r) * d + k : a.q,
                  ok ? 4 : 0);
      }
    }
  }
  float acc[TQ][TC];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int it = 0; it < NSTAGE - 1; ++it) {
    if (it < total) load(it);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // slab `it` landed; slab it - 1's stage is free
    if (it + NSTAGE - 1 < total) load(it + NSTAGE - 1);
    cp_async_commit();
    const int tl = it / nsl, ks = it - tl * nsl;
    const float* st = s.ring + (it % NSTAGE) * stage;
    fma_slab<TQ>(acc, QRES ? s.qs + ks * BK : st, qstr, st + cofs, tx, ty);
    if (ks == nsl - 1) {
      const int c0 = (t0 + tl) * BC;
      uint32_t pend = 0;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = c0 + ccol(tx, j);
        const float cnv = c < cend ? __ldg(a.cn + c) : 0.f;
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          acc[i][j] = __fsub_rn(cnv, 2.0f * acc[i][j]);
          if (c < cend && qrow(ty, i) < p.nq) pend |= bit(i, j);
        }
      }
      float sc[TQ][TC];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          sc[i][j] = acc[i][j];
          acc[i][j] = 0.f;
        }
      const auto cid = [=](int, int j) { return c0 + ccol(tx, j); };
      if constexpr (!WIDE)
        offer<TQ, QRES>(sc, cid, pend, s, w, p.nq, cur, ty, lane);
      else if (tl == 0)
        fill_wide<TQ>(sc, c0, tx, pend, s, w, ty, lane);
      else
        offer_wide<TQ>(sc, cid, pend, s, w, a.cap, ty, warp, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (WIDE) {
    merge_wide<TQ>(s.lists, s.buf, s.cnt, a.cap, w, warp, lane, 1);
    __syncthreads();
  } else {
    merge<TQ>(s, w, p.nq, cur);
  }
  if (a.splits == 1) return true;

  // publish this split's lists; the last block of the query tile merges
  const int S = a.splits;
  const Ent* L = s.list(cur);
  for (int e = tid; e < p.nq * w; e += NT) {
    const int r = e / w, j = e - r * w;
    a.part[(static_cast<size_t>(p.q0 + r) * S + p.split) * w + j] = L[e];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s.flag[0] = atomicAdd(a.tickets + p.qtile, 1) == S - 1;
  __syncthreads();
  if (!s.flag[0]) return false;
  __threadfence();
  const int E = S * w;
  for (int e0 = 0; e0 < E; e0 += BC) {
    float sc[TQ][TC];
    int id[TQ][TC];
    uint32_t pend = 0;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int r = qrow(ty, i);
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        // every load issued (a dead one from the tile's first entry), so
        // they overlap instead of waiting on one another
        const int e = e0 + tx + 16 * j;
        const bool ok = r < p.nq && e < E && e / w != p.split;
        const int2 v = __ldcg(reinterpret_cast<const int2*>(
            a.part + static_cast<size_t>(p.q0) * E +
            (ok ? static_cast<size_t>(r) * E + e : 0)));
        sc[i][j] = ok ? __int_as_float(v.x) : IVF_INF;
        id[i][j] = ok ? v.y : SENT;
        if (ok) pend |= bit(i, j);
      }
    }
    const auto eid = [&](int i, int j) { return id[i][j]; };
    if constexpr (WIDE)
      offer_wide<TQ>(sc, eid, pend, s, w, a.cap, ty, warp, lane);
    else
      offer<TQ, QRES>(sc, eid, pend, s, w, p.nq, cur, ty, lane);
  }
  if constexpr (WIDE) {
    merge_wide<TQ>(s.lists, s.buf, s.cnt, a.cap, w, warp, lane, 1);
    __syncthreads();
  } else {
    merge<TQ>(s, w, p.nq, cur);
  }
  return true;
}

__device__ __forceinline__ int cell_of(const Ent& e) {
  return e.i == SENT ? 0 : e.i;  // only for a table of +inf / NaN scores
}

template <int TQ, bool QRES, bool WIDE>
__global__ void __launch_bounds__(NT, 2)
    coarse_topw_kernel(SelArgs a, float* __restrict__ vals,
                       int* __restrict__ cells) {
  extern __shared__ __align__(16) float sm[];
  const Sel s = sel_carve<WIDE>(sm, 16 * TQ, a, false);
  const Pos p = block_pos<TQ>(a);
  int cur;
  if (!coarse_select<TQ, QRES, WIDE>(a, s, p, cur)) return;
  const Ent* L = s.list(cur);
  for (int i = threadIdx.x; i < p.nq * a.w; i += NT) {
    const size_t o = static_cast<size_t>(p.q0) * a.w + i;
    vals[o] = L[i].s;
    cells[o] = cell_of(L[i]);
  }
}

template <int TQ, bool QRES, bool WIDE>
__global__ void __launch_bounds__(NT, 2)
    coarse_vbase_kernel(SelArgs a, const float* __restrict__ rot,
                        int apply_rot, float* __restrict__ vals,
                        int* __restrict__ cells,
                        __nv_bfloat16* __restrict__ v,
                        float* __restrict__ rn) {
  extern __shared__ __align__(16) float sm[];
  const Sel s = sel_carve<WIDE>(sm, 16 * TQ, a, true);
  const Pos p = block_pos<TQ>(a);
  int cur;
  if (!coarse_select<TQ, QRES, WIDE>(a, s, p, cur)) return;
  const int d = a.d, w = a.w;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, warps = NT >> 5;
  // Under the large-w selection without a rotation, up to d = 32 EW: JU
  // winners' rows in flight a warp (each winner's loads before the first
  // store, as below, but w of them a row); the same sums.
  constexpr int EW = 4, JU = 4;
  if (WIDE && !apply_rot && d <= 32 * EW) {
    for (int r = warp; r < p.nq; r += warps) {
      const Ent* L = s.list(cur) + static_cast<size_t>(r) * w;
      const size_t qi = static_cast<size_t>(p.q0 + r);
      const float* qr = QRES ? s.qs + static_cast<size_t>(r) * qstride(d)
                             : a.q + qi * d;
      float qv[EW];
#pragma unroll
      for (int u = 0; u < EW; ++u) {
        const int k = lane + 32 * u;
        qv[u] = k < d ? (QRES ? qr[k] : __ldg(qr + k)) : 0.f;
      }
      for (int j0 = 0; j0 < w; j0 += JU) {
        float x[JU][EW];
        int cs[JU];
#pragma unroll
        for (int jj = 0; jj < JU; ++jj) {
          const int j = min(j0 + jj, w - 1);
          cs[jj] = cell_of(L[j]);
          const float* cr = a.cents + static_cast<size_t>(cs[jj]) * d;
#pragma unroll
          for (int u = 0; u < EW; ++u) {
            const int k = lane + 32 * u;
            x[jj][u] = k < d ? __fsub_rn(qv[u], __ldg(cr + k)) : 0.f;
          }
        }
#pragma unroll
        for (int jj = 0; jj < JU; ++jj) {
          const int j = j0 + jj;
          if (j >= w) break;
          __nv_bfloat16* vo = v + (qi * w + j) * d;
          float part = 0.f;
#pragma unroll
          for (int u = 0; u < EW; ++u) {
            const int k = lane + 32 * u;
            if (k < d) {
              vo[k] = __float2bfloat16_rn(-2.0f * x[jj][u]);
              part = __fadd_rn(part, __fmul_rn(x[jj][u], x[jj][u]));
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part = __fadd_rn(part, __shfl_down_sync(IVF_FULL_MASK, part, off));
          if (lane == 0) {
            vals[qi * w + j] = L[j].s;
            cells[qi * w + j] = cs[jj];
            rn[qi * w + j] = part;
          }
        }
      }
    }
    return;
  }
  float* rr = s.ring + static_cast<size_t>(warp) * d;  // q - c, to rotate
  for (int r = warp; r < p.nq; r += warps) {
    const Ent* L = s.list(cur) + static_cast<size_t>(r) * w;
    const size_t qi = static_cast<size_t>(p.q0 + r);
    const float* qr = QRES ? s.qs + static_cast<size_t>(r) * qstride(d)
                           : a.q + qi * d;
    for (int j = 0; j < w; ++j) {
      const float m = L[j].s;
      const int a_ = cell_of(L[j]);
      const float* cr = a.cents + static_cast<size_t>(a_) * d;
      __nv_bfloat16* vo = v + (qi * w + j) * d;
      float part = 0.f;
      if (apply_rot) {
        for (int k = lane; k < d; k += 32) rr[k] = __fsub_rn(qr[k], cr[k]);
        __syncwarp();
        for (int col = lane; col < d; col += 32) {
          float x = 0.f;
          for (int k = 0; k < d; ++k)
            x = fmaf(rr[k], rot[static_cast<size_t>(k) * d + col], x);
          vo[col] = __float2bfloat16_rn(-2.0f * x);
          part = __fadd_rn(part, __fmul_rn(x, x));
        }
      } else {
        // EU loads a lane in flight before the first store
        for (int k0 = lane; k0 < d; k0 += 32 * EU) {
          float x[EU];
#pragma unroll
          for (int u = 0; u < EU; ++u) {
            const int k = k0 + 32 * u;
            x[u] = k < d ? __fsub_rn(QRES ? qr[k] : __ldg(qr + k),
                                     __ldg(cr + k))
                         : 0.f;
          }
#pragma unroll
          for (int u = 0; u < EU; ++u)
            if (k0 + 32 * u < d) {
              vo[k0 + 32 * u] = __float2bfloat16_rn(-2.0f * x[u]);
              part = __fadd_rn(part, __fmul_rn(x[u], x[u]));
            }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_down_sync(IVF_FULL_MASK, part, off));
      if (lane == 0) {
        vals[qi * w + j] = m;
        cells[qi * w + j] = a_;
        rn[qi * w + j] = part;
      }
      __syncwarp();
    }
  }
}

template <int TQ, bool QRES, bool WIDE>
__global__ void __launch_bounds__(NT, 2)
    coarse_vbase_v2_kernel(SelArgs a, const float* __restrict__ rot,
                           const __nv_bfloat16* __restrict__ hi,
                           const __nv_bfloat16* __restrict__ lo,
                           int apply_rot, float* __restrict__ vals,
                           int* __restrict__ cells,
                           __nv_bfloat16* __restrict__ v) {
  extern __shared__ __align__(16) float sm[];
  const Sel s = sel_carve<WIDE>(sm, 16 * TQ, a, true);
  const Pos p = block_pos<TQ>(a);
  int cur;
  if (!coarse_select<TQ, QRES, WIDE>(a, s, p, cur)) return;
  const int d = a.d, w = a.w;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, warps = NT >> 5;
  float* rq = s.ring + static_cast<size_t>(warp) * d;  // rotq, or q
  for (int r = warp; r < p.nq; r += warps) {
    const Ent* L = s.list(cur) + static_cast<size_t>(r) * w;
    const size_t qi = static_cast<size_t>(p.q0 + r);
    const float* qr = QRES ? s.qs + static_cast<size_t>(r) * qstride(d)
                           : a.q + qi * d;
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
      const int a_ = cell_of(L[j]);
      const __nv_bfloat16* hr = hi + static_cast<size_t>(a_) * d;
      const __nv_bfloat16* lr = lo + static_cast<size_t>(a_) * d;
      __nv_bfloat16* vo = v + (qi * w + j) * d;
      for (int k = lane; k < d; k += 32) {
        const float rc =
            __fadd_rn(__bfloat162float(hr[k]), __bfloat162float(lr[k]));
        vo[k] = __float2bfloat16_rn(-2.0f * __fsub_rn(rq[k], rc));
      }
      if (lane == 0) {
        vals[qi * w + j] = L[j].s;
        cells[qi * w + j] = a_;
      }
    }
    __syncwarp();
  }
}

enum Kind { TOPW = 0, VBASE = 1, VBASE_V2 = 2 };

bool valid_tq(int tq) { return tq == 1 || tq == 4; }

template <int TQ, bool QRES, bool WIDE>
const void* kernel_of(int kind) {
  switch (kind) {
    case TOPW:
      return reinterpret_cast<const void*>(
          coarse_topw_kernel<TQ, QRES, WIDE>);
    case VBASE:
      return reinterpret_cast<const void*>(
          coarse_vbase_kernel<TQ, QRES, WIDE>);
    default:
      return reinterpret_cast<const void*>(
          coarse_vbase_v2_kernel<TQ, QRES, WIDE>);
  }
}

template <bool WIDE>
const void* kernel_for(int kind, int tq, bool qres) {
  if (tq == 4)
    return qres ? kernel_of<4, true, WIDE>(kind)
                : kernel_of<4, false, WIDE>(kind);
  return qres ? kernel_of<1, true, WIDE>(kind)
              : kernel_of<1, false, WIDE>(kind);
}

// A launch's block for (d, w), a kind and query tiles of bq rows: the
// large-w selection where w > WIDE_W, whether the query tile is held
// whole, the buffer's candidate places a row, the shared bytes. The
// large-w selection holds the query tile whole with the most places (even,
// so that rows of cap + 1 places start on distinct banks; at most
// CAPW_MAX) with which two blocks still share a SM, at least CAPW_MIN;
// else streams it likewise; else takes one block a SM with CAPW_MAX
// places, the query tile held whole where it fits.
struct Shape {
  bool wide, qres;
  int cap;
  size_t smem;
  const void* kernel;
};

Shape shape_of(int kind, int bq, int d, int w) {
  const bool scratch = kind != TOPW;
  Shape sh;
  sh.wide = w > WIDE_W;
  if (!sh.wide) {
    sh.qres = resident(bq, d, w, scratch);
    sh.cap = CAP;
    sh.smem = sel_bytes(bq, d, w, scratch, sh.qres);
    sh.kernel = kernel_for<false>(kind, bq / 16, sh.qres);
    return sh;
  }
  sh.qres = wide_bytes(bq, d, w, scratch, true, CAPW_MAX) <= SMEM_MAX;
  sh.cap = CAPW_MAX;
  for (int qres = 1; qres >= 0; --qres) {
    const size_t base = wide_bytes(bq, d, w, scratch, qres, 0);
    if (base > SMEM_TWO) continue;
    const size_t fit = (SMEM_TWO - base) / (8 * static_cast<size_t>(bq));
    const int cap = static_cast<int>(fit < CAPW_MAX ? fit : CAPW_MAX) & ~1;
    if (cap >= CAPW_MIN) {
      sh.qres = qres == 1;
      sh.cap = cap;
      break;
    }
  }
  sh.smem = wide_bytes(bq, d, w, scratch, sh.qres, sh.cap);
  sh.kernel = kernel_for<true>(kind, bq / 16, sh.qres);
  return sh;
}

// Validate a launch plan, fill the kernel arguments and launch the kind's
// kernel at query tiles of 16 * tq rows; 0 or an error. `rest` points at
// the arguments after the SelArgs, in the kernel's order.
int launch(int kind, const void* q, const void* cents, const void* cn,
           int B, int d, int kc, int w, int tq, int splits, void* part,
           void* tickets, void** rest, int nrest, void* stream) {
  const int ntiles = (kc + BC - 1) / BC;
  if (!valid_tq(tq) || d < 1 || w < 1 || w > WMAX || w > kc ||
      splits < 1 || splits > ntiles || (splits > 1 && (!part || !tickets)))
    return cudaErrorInvalidValue;
  const Shape sh = shape_of(kind, 16 * tq, d, w);
  if (sh.smem > SMEM_MAX) return cudaErrorInvalidValue;
  SelArgs a;
  a.q = static_cast<const float*>(q);
  a.cents = static_cast<const float*>(cents);
  a.cn = static_cast<const float*>(cn);
  a.B = B;
  a.d = d;
  a.kc = kc;
  a.w = w;
  a.splits = splits;
  a.tps = (ntiles + splits - 1) / splits;
  a.qres = sh.qres;
  a.cap = sh.cap;
  a.part = static_cast<Ent*>(part);
  a.tickets = static_cast<int*>(tickets);
  const void* k = sh.kernel;
  int err = ivf_set_smem(k, sh.smem);
  if (err) return err;
  const int grid = (B + 16 * tq - 1) / (16 * tq) * splits;
  if (grid > 0) {
    void* args[8] = {&a};
    for (int i = 0; i < nrest; ++i) args[1 + i] = rest[i];
    cudaLaunchKernel(k, dim3(grid), dim3(NT), args, sh.smem,
                     static_cast<cudaStream_t>(stream));
  }
  return ivf_launch_status();
}

}  // namespace

// A block shape's fit for (d, w) and a kernel kind (0 top-w, 1 v/base,
// 2 v2), with query tiles of 16 * tq rows (tq 4 or 1): out = {bq, bc,
// shared bytes, resident blocks per SM, registers a thread, local (spilled)
// bytes a thread, 1 where the query tile is held whole, 1 where the
// large-w selection runs, its candidate places a row (else 0)}, shared
// bytes and blocks 0 where the shared memory would exceed a block's.
extern "C" int coarse_fit(int d, int w, int kind, int tq, int* out) {
  if (d < 1 || w < 1 || w > WMAX || kind < TOPW || kind > VBASE_V2 ||
      !valid_tq(tq))
    return cudaErrorInvalidValue;
  const Shape sh = shape_of(kind, 16 * tq, d, w);
  const size_t smem = sh.smem;
  const void* k = sh.kernel;
  cudaFuncAttributes fa;
  int err = static_cast<int>(cudaFuncGetAttributes(&fa, k));
  if (err) return err;
  out[0] = 16 * tq;
  out[1] = BC;
  out[2] = out[3] = 0;
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  out[6] = sh.qres;
  out[7] = sh.wide;
  out[8] = sh.wide ? sh.cap : 0;
  if (smem > SMEM_MAX) return 0;
  err = ivf_set_smem(k, smem);
  if (err) return err;
  int blocks = 0;
  err = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, NT, smem));
  if (err) return err;
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return 0;
}

extern "C" int coarse_vbase(const void* q, const void* cents, const void* cn,
                            const void* rot, int B, int d, int kc, int w,
                            int apply_rot, int tq, int splits,
                            void* part, void* tickets, void* vals,
                            void* cells, void* v, void* rn, void* stream) {
  void* rest[] = {&rot, &apply_rot, &vals, &cells, &v, &rn};
  return launch(VBASE, q, cents, cn, B, d, kc, w, tq, splits, part, tickets,
                rest, 6, stream);
}

extern "C" int coarse_vbase_v2(const void* q, const void* cents,
                               const void* cn, const void* rot,
                               const void* hi, const void* lo, int B, int d,
                               int kc, int w, int apply_rot, int tq,
                               int splits, void* part, void* tickets,
                               void* vals, void* cells, void* v,
                               void* stream) {
  void* rest[] = {&rot, &hi, &lo, &apply_rot, &vals, &cells, &v};
  return launch(VBASE_V2, q, cents, cn, B, d, kc, w, tq, splits, part,
                tickets, rest, 7, stream);
}

extern "C" int coarse_topw(const void* q, const void* cents, const void* cn,
                           int B, int d, int kc, int w, int tq, int splits,
                           void* part, void* tickets, void* vals,
                           void* cells, void* stream) {
  void* rest[] = {&vals, &cells};
  return launch(TOPW, q, cents, cn, B, d, kc, w, tq, splits, part, tickets,
                rest, 2, stream);
}
