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
// probe p and group row l computes (the JAX kernel's arithmetic):
//   row  = bf16(float(int8) * float(bf16(scale)))  (int8 cache; bf16: as is)
//   dot  = sum_k float(v[p][k]) * float(row[k])   (bf16 products, f32 sums)
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
// Probes whose base is +inf (the placement's empty slots, padded probes)
// score +inf on every row whatever their dot product; their buffers stay
// +inf / -1. Walking 128-row groups instead of the TPU's DMA chunks
// changes nothing for the fold: chunk % nf == 0, so a row's bank and block
// index are the same either way. Rows at or past the cell size are never
// read; cell starts need only 8-row (16-byte) alignment.
// Output rows: slot p of tile t writes its buffer (or its extracted row) to
// row slot_row[t * pb + p] of an (n_rows, width) output, and nothing where
// that is n_rows or more (an empty slot). The tile prep's map (`inv_row`)
// puts each probe's row at the probe's own index, so the output is in
// probe order and needs no gather; the identity map keeps tile order.
// Tiles of size 0 write +inf / -1 to their live slots' rows; tiles past the
// last one a batch needs hold no live slot and return at once.
//
// Bound and design. Per tile the kernel reads its cell's rows once (int8:
// 1 B a feature, bf16: 2) and writes nf x 8 B of buffers a live slot (at
// huge kc, where most tiles hold a few probes, those writes and the
// per-tile start bind). The products, pb x 128 x d MACs a group, are a
// bf16 matrix product with f32 sums, as on the TPU's matrix unit; on CUDA
// cores (67 TFLOP/s f32) they alone would take 4x the byte bound. They run
// on the tensor cores (wgmma), and what binds is the rest of a group's
// work: staging rows (int8 -> bf16), the in-kernel norms, and scoring and
// folding each of the pb x 128 products. So the block's 16
// warps split into two roles (warp specialization; setmaxnreg gives the
// producers 64 registers a thread, the consumers 192), handing tiles over
// by named barriers (FULL: staged, EMPTY: free), so that staging and
// scoring overlap instead of taking turns at a block barrier:
// - producers (warps 0-7) copy a step's rows by cp.async (16 B) into a ring
//   (int8: two slots, rows 144 B apart; bf16: ntile + 1 slots already in
//   the tile layout, the copy two steps ahead), convert int8 rows with the
//   TPU's rounding into one of two bf16 tiles, compute the in-kernel norms
//   from the converted values (a pairwise f32 sum of bf16 squares a chunk,
//   then a fixed shuffle order), and stage the group's ids and cached
//   norms. Tiles are in the layout wgmma reads without a swizzle (8 x 8
//   core matrices of 128 B); a quarter warp writes one core matrix, so its
//   stores fall on distinct banks.
// - consumers (warps 8-15, two warpgroups) each multiply the tile's 64
//   probes by 64 rows of the group: 8 wgmma.m64n64k16 a step, A = the
//   warp's 16 probes of v from registers (loaded once a tile by ldmatrix),
//   B = the staged tile from shared memory. Each thread then scores its 32
//   products and folds them: at nf = 128 (every default route) its buffer
//   slots are exactly its accumulator elements, so the fold buffer lives in
//   registers beside them; at nf > 128 in shared memory (row stride
//   nf + 8), each slot updated by the one thread that scores it. The exact
//   merge writes the group's scores to shared memory and all 16 warps run
//   the per-probe passes. Rows past the cell size are never copied and
//   their products are masked; a 16-probe m-tile whose bases are all +inf
//   is multiplied (wgmma's M is 64) but not scored (warp-uniform), and a
//   tile without a live probe skips its products.
// - The buffers leave through shared memory: whole output rows, 16 bytes a
//   thread, all 512 threads (or the extraction passes, one warp a probe),
//   each live slot's to its row of the slot map. An empty cell's tile
//   writes +inf / -1 to its live slots' rows at once.
// On an H100 (80GB HBM3, 700 W; `utils/scan_ab.py`, one process, device
// time) kernel 3 at the SIFT1M shape's B = 16384 tiles takes 0.388 ms
// against the CUDA-core version's 1.717 (its byte bound: 0.11 ms); the
// rest is in PERF.md (kernel table rows 3, 8a-8e, 9).

#include "common.cuh"

namespace {

constexpr int GROUP = 128;        // rows per fold group = lanes of a bank
constexpr int KT = 128;           // features staged per step
// A staged bf16 tile (128 rows x KT features) is laid out as wgmma reads
// its B operand without a swizzle: 8 x 8 core matrices of 128 contiguous
// bytes (8 rows of 16), KT / 8 of them along the features, then the next
// 8 rows (CMG bytes on).
constexpr int CMB = 128;                  // bytes of a core matrix
constexpr int CMG = KT / 8 * CMB;         // bytes of 8 rows: 2048
constexpr int TILE_BYTES = GROUP / 8 * CMG;
constexpr int RAW8_ROWB = KT + 16;        // int8 ring row stride: 144 B
constexpr int SCS = GROUP + 8;    // the exact merge's score row stride (f32)
constexpr int NTH = 512;          // threads per block: producers, consumers
constexpr int NWARP = NTH / 32;
// registers a thread after the split (setmaxnreg): 256 producer and 256
// consumer threads share the block's NTH * 128
constexpr int PROD_REGS = 64;
constexpr int CONS_REGS = 192;
constexpr int MAX_PB = 64;
constexpr size_t SMEM_MAX = 232448;   // a block's shared memory on an H100

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

// 16-probe m-tiles holding a tile's pb probes (a consumer warp's share).
__host__ __device__ inline int m_tiles(int pb) { return (pb + 15) / 16; }

__host__ __device__ inline bool fold_in_registers(int nf, bool exact) {
  return !exact && nf == GROUP;
}

// Row stride (elements) of the per-probe buffers in shared memory.
__host__ __device__ inline int fold_stride(int nf, bool exact) {
  return exact ? GROUP : nf + 8;
}

// Byte offset of row n's 16-byte chunk q (8 bf16 features) in a tile.
__host__ __device__ constexpr int tile_at(int n, int q) {
  return (n >> 3) * CMG + q * CMB + (n & 7) * 16;
}

// Rows of a ring slot: int8 rows as they are, RAW8_ROWB apart (converted
// into a bf16 tile), or bf16 rows already in the tile layout (the slot is
// the tile the products read); then the group's ids and cached norms.
template <typename ELEM>
__host__ __device__ constexpr int slot_rows_bytes() {
  return sizeof(ELEM) == 1 ? GROUP * RAW8_ROWB : TILE_BYTES;
}

template <typename ELEM>
__host__ __device__ constexpr int raw_bytes() {
  return slot_rows_bytes<ELEM>() + 2 * GROUP * 4;
}

// Ring slots: the int8 ring holds the next step's rows while one is
// converted into one of ntile tiles; the bf16 ring's slots are the tiles,
// ntile + 1 of them (with 3: one multiplied, one staged, one arriving).
template <typename ELEM>
__host__ __device__ constexpr int ring_slots(int ntile) {
  return sizeof(ELEM) == 1 ? 2 : ntile + 1;
}

constexpr int MAX_GROUPS = 3;     // groups in flight (their ids and norms)

// Byte offsets of the block's shared memory.
struct Layout {
  size_t fold, vs, scale, base, nrm, ids, sc, stage, total;
};

template <typename ELEM, bool EXACT, bool EXTRACT, bool QC>
__host__ __device__ inline Layout scan_layout(int d, int pb, int nf,
                                              int ntile) {
  const bool reg = fold_in_registers(nf, EXACT);
  const size_t P = static_cast<size_t>(pb);
  const size_t mrows = 16 * m_tiles(pb);
  const size_t fs = fold_stride(nf, EXACT);
  Layout L;
  size_t o = 0;
  L.fold = o;
  o += reg ? 0 : P * fs * 8;                 // bufd, bufp
  L.vs = o;
  o += mrows * (d + 8) * 2;                  // the tile's v rows, bf16
  L.scale = o;
  o += static_cast<size_t>(d) * 4;
  L.base = o;
  o += mrows * 4;
  L.nrm = o;                                 // row norms and ids of the
  o += MAX_GROUPS * GROUP * 4;               // groups in flight
  L.ids = o;
  o += MAX_GROUPS * GROUP * 4;
  L.sc = o;
  o += EXACT ? P * SCS * 4 : 0;              // a group's scores
  o = (o + 127) & ~static_cast<size_t>(127);
  L.stage = o;                               // ring slots and tiles
  size_t st = ring_slots<ELEM>(ntile) *
                  static_cast<size_t>(raw_bytes<ELEM>()) +
              (sizeof(ELEM) == 1 ? ntile * static_cast<size_t>(TILE_BYTES)
                                 : 0);
  if (QC) st = st > P * d * 2 ? st : P * d * 2;      // bf16(r) rows (OPQ)
  if (reg) st = st > P * fs * 8 ? st : P * fs * 8;    // the buffers, at the end
  L.total = o + st;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_group1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// Shared-memory matrix descriptor of a tile slice for wgmma: no swizzle,
// core matrices CMB apart along the features (leading byte offset) and CMG
// apart along the rows (stride byte offset).
__device__ __forceinline__ uint64_t tile_desc(const unsigned char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(CMB >> 4) << 16) |
         (static_cast<uint64_t>(CMG >> 4) << 32);
}

// d (64 probes x 64 rows of the warpgroup, this warp's 16 x 64 in the mma
// accumulator layout: d[j] holds n8-tile j) (+)= a (this warp's 16 probes x
// 16 features, bf16, registers) . the tile slice `desc` (16 features x 64
// rows); f32 sums
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[8][4],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving uses of d across the wait above.
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// The f32 sum of the bf16-rounded squares of 8 pairs, pairwise (a tree).
__device__ __forceinline__ float squares8(const __nv_bfloat162 (&x)[8]) {
  float s[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float2 q = __bfloat1622float2(__hmul2(x[e], x[e]));
    s[e] = __fadd_rn(q.x, q.y);
  }
#pragma unroll
  for (int w = 1; w < 8; w *= 2)
#pragma unroll
    for (int e = 0; e < 8; e += 2 * w) s[e] = __fadd_rn(s[e], s[e + w]);
  return s[0];
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(x.y)) << 16);
}

__device__ __forceinline__ __nv_bfloat162 pair_of(uint32_t u) {
  return __halves2bfloat162(
      __ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu)),
      __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16)));
}

// float(x) of byte b of a word whose bytes are int8 values XOR 0x80: the
// byte is the low mantissa byte of 2^23 + (x + 128)
__device__ __forceinline__ float int8_at(uint32_t biased, int b) {
  return __fsub_rn(
      __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + b)),
      8388736.0f);
}

// Named barriers: 0 is __syncthreads; the producer / consumer handoff of
// bf16 tile b (< 3) uses FULL + b (producers arrive, consumers wait) and
// EMPTY + b (consumers arrive, producers wait), each over all NTH threads;
// PROD and CONS join one role's NTH / 2 threads; SCORES / PASSED bracket
// the exact merge's passes over a group's scores and DUMPED the buffers'
// way out, where both roles share the work (all NTH threads).
enum Barrier {
  FULL = 1, EMPTY = 4, PROD = 7, CONS = 8, SCORES = 9, PASSED = 10,
  DUMPED = 11
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The m-tile's A fragments for features [kb * KT, kb * KT + KT).
__device__ __forceinline__ void load_a(uint32_t (&a)[8][4],
                                       const __nv_bfloat16* vs, int vst,
                                       int m0, int kb, int lane) {
  const __nv_bfloat16* src = vs +
                             (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * vst +
                             kb * KT + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) ldsm_x4(a[ks], src + 16 * ks);
}

template <typename ELEM, bool KNORM, int PAY, typename PT, bool EXACT,
          bool EXTRACT, bool QC = false>
__global__ void __launch_bounds__(NTH, 1) grouped_scan_kernel(
    const int* __restrict__ tstart, const int* __restrict__ tsize,
    const __nv_bfloat16* __restrict__ v_tiles,
    const float* __restrict__ base_tiles, const ELEM* __restrict__ decoded,
    const float* __restrict__ scale, const int* __restrict__ ids,
    const float* __restrict__ norms, const int64_t* __restrict__ slot_row,
    int d, int pb, int nf, int k_out, int n_rows, float norm_coef, int ntile,
    float* __restrict__ out_d, PT* __restrict__ out_p, QcArgs qa) {
  extern __shared__ __align__(128) unsigned char smraw[];
  constexpr int RAWB = raw_bytes<ELEM>();
  constexpr int ROWS = slot_rows_bytes<ELEM>();
  constexpr bool INT8 = sizeof(ELEM) == 1;
  constexpr int HALF = NTH / 2;    // threads a role
  const Layout L = scan_layout<ELEM, EXACT, EXTRACT, QC>(d, pb, nf, ntile);
  const bool regfold = fold_in_registers(nf, EXACT);
  const int FS = fold_stride(nf, EXACT);
  float* bufd = reinterpret_cast<float*>(smraw + L.fold);
  int* bufp = reinterpret_cast<int*>(bufd + static_cast<size_t>(pb) * FS);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smraw + L.vs);
  float* scale_s = reinterpret_cast<float*>(smraw + L.scale);
  float* base_s = reinterpret_cast<float*>(smraw + L.base);
  float* nrm_s = reinterpret_cast<float*>(smraw + L.nrm);
  int* ids_s = reinterpret_cast<int*>(smraw + L.ids);
  float* sc_s = reinterpret_cast<float*>(smraw + L.sc);
  unsigned char* stage = smraw + L.stage;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t t = blockIdx.x;
  const int start = tstart[t], size = tsize[t];
  const int64_t* tile_rows = slot_row + t * pb;   // the slots' output rows
  if (size == 0) {
    // an empty cell's tile: its live slots' rows as the buffers start,
    // +inf / -1; a tile without a live slot (past the last one the batch
    // needs) writes nothing
    if (!__syncthreads_or(tid < pb && tile_rows[tid] < n_rows)) return;
    const int width = EXTRACT ? k_out : nf;
    for (int i = tid; i < pb * width; i += NTH) {
      const int p = i / width;
      const int64_t r = tile_rows[p];
      if (r >= n_rows) continue;
      out_d[r * width + i - p * width] = IVF_INF;
      out_p[r * width + i - p * width] = static_cast<PT>(-1);
    }
    return;
  }
  const int mt = m_tiles(pb), mrows = 16 * mt;
  const int vst = d + 8;
  const int nk = d / KT;
  const int nsteps = (size + GROUP - 1) / GROUP * nk;
  const int nbank = nf / GROUP;
  const bool use_norm = KNORM && norm_coef != 0.f;
  // bf16 tiles in turn: int8 rows are converted into ntile (1 or 2) tiles
  // of their own, bf16 rows land in the three ring slots, which are the
  // tiles
  const int nslot = ring_slots<ELEM>(ntile);
  const int nbuf = INT8 ? ntile : nslot;

  // byte offset of row n's 16-byte chunk q in a ring slot
  auto slot_at = [](int n, int q) {
    return INT8 ? n * RAW8_ROWB + 16 * q : tile_at(n, q);
  };

  // step c = (group G, feature block kb): its rows into ring slot c % nslot by
  // threads t0, t0 + nt, ... (rows past the cell size are not copied:
  // their scores are masked)
  auto issue = [&](int c, int t0, int nt) {
    const int G = c / nk, kb = c - G * nk;
    const int row0 = start + G * GROUP;
    const int nvalid = min(GROUP, size - G * GROUP);
    unsigned char* slot = stage + (c % nslot) * RAWB;
    constexpr int CPR = KT * static_cast<int>(sizeof(ELEM)) / 16;
    for (int i = t0; i < nvalid * CPR; i += nt) {
      const int r = i / CPR, q = i - r * CPR;
      cp_async16(slot + slot_at(r, q),
                 reinterpret_cast<const unsigned char*>(
                     decoded + static_cast<size_t>(row0 + r) * d + kb * KT) +
                     16 * q,
                 16);
    }
    if (kb == nk - 1 && t0 < 64) {
      // the group's ids (PAY_IDS) and cached norms (!KNORM), 4 a copy
      const bool is_ids = t0 < 32;
      const int j = t0 & 31;
      const int n = max(0, min(4, nvalid - 4 * j));
      if (is_ids && PAY == PAY_IDS)
        cp_async16(slot + ROWS + 16 * j, n ? ids + row0 + 4 * j : ids, 4 * n);
      if (!is_ids && !KNORM)
        cp_async16(slot + ROWS + GROUP * 4 + 16 * j,
                   n ? norms + row0 + 4 * j : norms, 4 * n);
    }
  };

  // the bf16 tile the products of step s read
  auto tile_of = [&](int s) {
    return INT8 ? stage + nslot * RAWB + (s % nbuf) * TILE_BYTES
                : stage + (s % nslot) * RAWB;
  };

  // the exact merge's passes over step s's group: warp w takes probes w,
  // w + NWARP, ...; the producers join the consumers' for each group
  auto exact_passes = [&](int s) {
    const int row0 = start + s / nk * GROUP;
    for (int p = warp; p < pb; p += NWARP) {
      if (!(base_s[p] < IVF_INF)) continue;               // warp-uniform
      float cc[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) cc[jj] = sc_s[p * SCS + lane + 32 * jj];
      for (int pass = 0; pass < k_out; ++pass)
        if (!ivf_exact_pass(cc, bufd + p * GROUP, bufp + p * GROUP, row0,
                            lane))
          break;
    }
  };
  auto join_passes = [&](int s) {
    if (!EXACT || s < 0 || s % nk != nk - 1) return;
    bar_sync(SCORES, NTH);
    exact_passes(s);
    bar_sync(PASSED, NTH);
  };

  // the buffers, in shared memory (xd, xp, row stride FS), leave the block
  // through all NTH threads: extraction passes, or whole rows, 16 bytes a
  // thread; each live slot's to its output row, empty slots' nowhere
  float* xd = regfold ? reinterpret_cast<float*>(stage) : bufd;
  int* xp = regfold ? reinterpret_cast<int*>(xd + static_cast<size_t>(pb) * FS)
                    : bufp;
  auto finish = [&]() {
    if (EXTRACT) {
      for (int p = warp; p < pb; p += NWARP) {
        const int64_t r = tile_rows[p];
        if (r >= n_rows) continue;                          // warp-uniform
        float* od = out_d + r * k_out;
        PT* op = out_p + r * k_out;
        float* row = xd + static_cast<size_t>(p) * FS;
        for (int e = 0; e < k_out; ++e) {
          float m;
          int x;
          ivf_lane_argmin(row, nf, lane, m, x);
          ivf_warp_argmin(m, x);
          if (lane == 0) {
            od[e] = m;
            op[e] = static_cast<PT>(m == IVF_INF ? -1 : xp[p * FS + x]);
            row[x] = IVF_INF;
          }
          __syncwarp();
        }
      }
      return;
    }
    const int f4 = nf / 4;
    for (int i = tid; i < pb * f4; i += NTH) {
      const int p = i / f4, u = i - p * f4;
      const int64_t r = tile_rows[p];
      if (r >= n_rows) continue;
      reinterpret_cast<float4*>(out_d + r * nf)[u] =
          reinterpret_cast<const float4*>(xd + p * FS)[u];
      if (sizeof(PT) == 4)
        reinterpret_cast<int4*>(out_p + r * nf)[u] =
            reinterpret_cast<const int4*>(xp + p * FS)[u];
    }
    if (sizeof(PT) == 1) {
      const int b16 = nf / 16;
      for (int i = tid; i < pb * b16; i += NTH) {
        const int p = i / b16, u = i - p * b16;
        const int64_t r = tile_rows[p];
        if (r >= n_rows) continue;
        const int* src = xp + p * FS + 16 * u;
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = (src[4 * k] & 0xff) | ((src[4 * k + 1] & 0xff) << 8) |
                 ((src[4 * k + 2] & 0xff) << 16) |
                 (static_cast<uint32_t>(src[4 * k + 3] & 0xff) << 24);
        reinterpret_cast<uint4*>(out_p + r * nf)[u] =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  // ---- the tile's probes (all threads): v rows and bases, or the QC
  // prologue, and the first step's rows
  if (!regfold)
    for (int i = tid; i < pb * FS; i += NTH) {
      bufd[i] = IVF_INF;
      bufp[i] = -1;
    }
  if (QC) {
    const float* crow = qa.c + static_cast<size_t>(qa.ctile[t]) * d;
    __nv_bfloat16* rbuf = reinterpret_cast<__nv_bfloat16*>(stage);
    for (int p = warp; p < mrows; p += NWARP) {
      const int qi = p < pb ? qa.qidx[t * pb + p] : -1;    // warp-uniform
      __nv_bfloat16* vrow = vs + static_cast<size_t>(p) * vst;
      if (qi < 0) {
        for (int k = lane; k < d; k += 32) vrow[k] = __float2bfloat16_rn(0.f);
        if (lane == 0) base_s[p] = IVF_INF;
        continue;
      }
      const float* qrow = qa.q + static_cast<size_t>(qi) * d;
      float ss = 0.f;
      if (!qa.apply_rot) {
        for (int k = lane; k < d; k += 32) {
          const float r = __fsub_rn(qrow[k], crow[k]);
          ss = __fadd_rn(ss, __fmul_rn(r, r));
          vrow[k] = __float2bfloat16_rn(-2.0f * r);
        }
      } else {
        __nv_bfloat16* rb = rbuf + static_cast<size_t>(p) * d;
        for (int k = lane; k < d; k += 32)
          rb[k] = __float2bfloat16_rn(__fsub_rn(qrow[k], crow[k]));
        __syncwarp();
        for (int col = lane; col < d; col += 32) {
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
      if (lane == 0) base_s[p] = __fmul_rn(qa.base_mult, ss);
    }
    __syncthreads();             // the staging area held the bf16(r) rows
  } else {
    const int c8 = d / 8;
    for (int i = tid; i < mrows * c8; i += NTH) {
      const int p = i / c8, s8 = i - p * c8;
      const bool ok = p < pb;
      cp_async16(vs + static_cast<size_t>(p) * vst + 8 * s8,
                 ok ? v_tiles + (t * pb + p) * static_cast<size_t>(d) + 8 * s8
                    : v_tiles,
                 ok ? 16 : 0);
    }
    for (int i = tid; i < pb / 4; i += NTH)
      cp_async16(base_s + 4 * i, base_tiles + t * pb + 4 * i, 16);
    for (int p = pb + tid; p < mrows; p += NTH) base_s[p] = IVF_INF;
  }
  if (INT8)
    for (int i = tid; i < d / 4; i += NTH)
      cp_async16(scale_s + 4 * i, scale + 4 * i, 16);
  if (nsteps > 0) issue(0, tid, NTH);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  if (warp < NWARP / 2) {
    // ---- producers: copy rows, convert them into bf16 tiles (int8),
    // compute the in-kernel norms, hand each tile over. A quarter warp
    // takes the same 16-byte chunk of 8 consecutive rows: one core matrix
    // row each, so its tile stores (and its ring loads, 144 B apart) fall
    // on distinct banks. Thread (warp pw, lane): rows 16 pw + (lane & 7)
    // and 16 pw + 8 + (lane & 7), chunks (lane >> 3) + 4 u.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS));
    const int rlo = 16 * warp + (lane & 7), qlo = lane >> 3;
    float npart[2] = {0.f, 0.f};
    // int8 rows travel one step ahead; bf16 rows nslot - 1 (1 or 2)
    const int ahead = INT8 ? 1 : nslot - 1;
    if (ahead == 2 && nsteps > 1) issue(1, tid, HALF);
    cp_async_commit();
    for (int c = 0; c < nsteps; ++c) {
      const int G = c / nk, kb = c - G * nk;
      const int nvalid = min(GROUP, size - G * GROUP);
      const unsigned char* slot = stage + (c % nslot) * RAWB;
      if (ahead == 2 && c + 1 < nsteps)
        cp_async_wait_group1();
      else
        cp_async_wait_all();
      bar_sync(PROD, HALF);      // step c landed; step c - 1 is converted
      if (INT8) {
        if (c + 1 < nsteps) issue(c + 1, tid, HALF);
        cp_async_commit();
        if (nbuf == 1) join_passes(c - 1);
        if (c >= nbuf) bar_sync(EMPTY + c % nbuf, NTH);   // its tile is free
      }
      if (kb == 0) npart[0] = npart[1] = 0.f;
      if (INT8) {
        unsigned char* tile = tile_of(c);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = qlo + 4 * u;               // 16 features: 2 chunks
          float4 s4[4];                            // their column scales
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4)
            s4[e4] = reinterpret_cast<const float4*>(scale_s + kb * KT +
                                                     16 * q)[e4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = rlo + 8 * h;
            if (n >= nvalid) break;
            const uint4 w = *reinterpret_cast<const uint4*>(slot +
                                                            slot_at(n, q));
            const uint32_t ws[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                    w.z ^ 0x80808080u, w.w ^ 0x80808080u};
            __nv_bfloat162 o[8];
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              o[2 * e4] = __floats2bfloat162_rn(
                  __fmul_rn(int8_at(ws[e4], 0), s4[e4].x),
                  __fmul_rn(int8_at(ws[e4], 1), s4[e4].y));
              o[2 * e4 + 1] = __floats2bfloat162_rn(
                  __fmul_rn(int8_at(ws[e4], 2), s4[e4].z),
                  __fmul_rn(int8_at(ws[e4], 3), s4[e4].w));
            }
#pragma unroll
            for (int x = 0; x < 2; ++x)
              *reinterpret_cast<uint4*>(tile + tile_at(n, 2 * q + x)) =
                  make_uint4(bits(o[4 * x]), bits(o[4 * x + 1]),
                             bits(o[4 * x + 2]), bits(o[4 * x + 3]));
            if (use_norm) npart[h] = __fadd_rn(npart[h], squares8(o));
          }
        }
      } else if (use_norm) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = rlo + 8 * h;
          if (n >= nvalid) break;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint4 w0 = *reinterpret_cast<const uint4*>(
                slot + slot_at(n, qlo + 8 * u));
            const uint4 w1 = *reinterpret_cast<const uint4*>(
                slot + slot_at(n, qlo + 8 * u + 4));
            const __nv_bfloat162 x[8] = {
                pair_of(w0.x), pair_of(w0.y), pair_of(w0.z), pair_of(w0.w),
                pair_of(w1.x), pair_of(w1.y), pair_of(w1.z), pair_of(w1.w)};
            npart[h] = __fadd_rn(npart[h], squares8(x));
          }
        }
      }
      if (kb == nk - 1) {
        const int buf = G % MAX_GROUPS * GROUP;
        if (use_norm) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = npart[h];
            x = __fadd_rn(x, __shfl_xor_sync(IVF_FULL_MASK, x, 8));
            x = __fadd_rn(x, __shfl_xor_sync(IVF_FULL_MASK, x, 16));
            if (qlo == 0) nrm_s[buf + rlo + 8 * h] = x;
          }
        }
        if (tid < GROUP) {
          if (!KNORM)
            nrm_s[buf + tid] =
                reinterpret_cast<const float*>(slot + ROWS + GROUP * 4)[tid];
          if (PAY == PAY_IDS)
            ids_s[buf + tid] = reinterpret_cast<const int*>(slot + ROWS)[tid];
        }
      }
      // the tile's generic-proxy writes (stores, cp.async) before wgmma's
      // async-proxy reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(FULL + c % nbuf, NTH);
      if (nbuf > 1) join_passes(c - 1);
      if (!INT8 && c + ahead < nsteps) {
        // step c + ahead's slot is the tile the consumers read at step c - 1
        if (c >= 1) bar_sync(EMPTY + (c + ahead) % nslot, NTH);
        issue(c + ahead, tid, HALF);
        cp_async_commit();
      }
    }
    join_passes(nsteps - 1);
    bar_sync(DUMPED, NTH);
    finish();
    return;
  }

  // ---- consumers: warpgroup cg multiplies rows 64 cg .. 64 cg + 63 of each
  // group by wgmma; its warp w4 holds m-tile w4 (probes 16 w4 ..) as A
  // fragments, then scores and merges them
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS));
  const int cw = warp - NWARP / 2, cg = cw >> 2, w4 = cw & 3;
  const int nb = 64 * cg, m0 = 16 * w4;
  const int g = lane >> 2, tq = lane & 3;
  const bool mrow = w4 < mt;       // the m-tile holds probes of the tile
  const float base0 = mrow ? base_s[m0 + g] : IVF_INF;
  const float base1 = mrow ? base_s[m0 + g + 8] : IVF_INF;
  const bool live = __any_sync(IVF_FULL_MASK, base0 < IVF_INF ||
                                                  base1 < IVF_INF);
  bool tile_live = false;          // any live probe: block-uniform
  for (int p = 0; p < mrows; ++p) tile_live |= base_s[p] < IVF_INF;
  uint32_t a[8][4];
  float acc[8][4];
  float fd[8][4];                  // the fold buffer, nf == 128
  int fp[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[j][e] = 0u;
      acc[j][e] = 0.f;
      fd[j][e] = IVF_INF;
      fp[j][e] = -1;
    }
  for (int s = 0; s < nsteps; ++s) {
    const int G = s / nk, kb = s - G * nk;
    const int nvalid = min(GROUP, size - G * GROUP);
    if (mrow && (nk > 1 || s == 0)) load_a(a, vs, vst, m0, kb, lane);
    bar_sync(FULL + s % nbuf, NTH);          // tile s is staged
    if (tile_live && nb < nvalid) {
      const unsigned char* tb = tile_of(s) + (nb >> 3) * CMG;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        wgmma_64x64x16(acc, a[ks], tile_desc(tb + 2 * CMB * ks),
                       kb > 0 || ks > 0);
      wgmma_commit_wait();
      fence_acc(acc);
    }
    if (kb == nk - 1) {
      // scores of group G, then the merge
      const float* nr_s = nrm_s + G % MAX_GROUPS * GROUP;
      const int* id_s = ids_s + G % MAX_GROUPS * GROUP;
      const int bank = G % nbank;
      if (live) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // rows past the cell size score +inf: the fold skips them
          if (!EXACT && nb + 8 * j >= nvalid) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = nb + 8 * j + 2 * tq + (e & 1);
            const int p = m0 + g + 8 * (e >> 1);
            const bool valid = n < nvalid;
            const float bv = e >> 1 ? base1 : base0;
            float sc;
            if (KNORM) {
              sc = use_norm
                       ? __fadd_rn(acc[j][e], __fmul_rn(norm_coef, nr_s[n]))
                       : acc[j][e];
              sc = __fadd_rn(sc, bv);
              sc = valid ? sc : IVF_INF;
            } else {
              sc = __fadd_rn(acc[j][e], bv);
              sc = valid ? sc : IVF_INF;
              sc = __fadd_rn(sc, __fmul_rn(norm_coef, valid ? nr_s[n] : 0.f));
            }
            if (EXACT) {
              if (p < pb) sc_s[p * SCS + n] = sc;
            } else {
              const int pay = PAY == PAY_IDS ? (valid ? id_s[n] : -1) : G;
              if (regfold) {
                if (sc < fd[j][e]) {
                  fd[j][e] = sc;
                  fp[j][e] = pay;
                }
              } else if (p < pb) {
                const int slot = p * FS + bank * GROUP + n;
                if (sc < bufd[slot]) {
                  bufd[slot] = sc;
                  bufp[slot] = pay;
                }
              }
            }
          }
        }
      }
      if (EXACT) {
        bar_sync(SCORES, NTH);   // the group's scores are in sc_s
        exact_passes(s);
        bar_sync(PASSED, NTH);   // sc_s is free for the next group
      }
    }
    if (s + nbuf < nsteps) bar_arrive(EMPTY + s % nbuf, NTH);
  }

  // the buffers leave through shared memory (the fold in registers meets it
  // here), so that the output rows are written whole
  if (regfold) {
    bar_sync(CONS, HALF);        // every consumer is done with the tiles
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + g + 8 * h;
        if (p < pb) {
          const int x = p * FS + nb + 8 * j + 2 * tq;
          *reinterpret_cast<float2*>(xd + x) =
              make_float2(fd[j][2 * h], fd[j][2 * h + 1]);
          *reinterpret_cast<int2*>(xp + x) =
              make_int2(fp[j][2 * h], fp[j][2 * h + 1]);
        }
      }
  }
  bar_sync(DUMPED, NTH);
  finish();
}

// The launch shape: two bf16 tiles where shared memory holds them, else one.
template <typename ELEM, bool EXACT, bool EXTRACT, bool QC>
int plan_scan(int d, int pb, int nf, int k_out, int& ntile, size_t& smem) {
  if (pb <= 0 || pb % 8 || pb > MAX_PB || nf <= 0 || nf % GROUP ||
      d <= 0 || d % KT)
    return cudaErrorInvalidValue;
  if (EXACT && (nf != GROUP || k_out < 1 || k_out > GROUP))
    return cudaErrorInvalidValue;
  if (EXTRACT && (k_out < 1 || 2 * k_out > GROUP))
    return cudaErrorInvalidValue;
  for (ntile = 2; ntile >= 1; --ntile) {
    smem = scan_layout<ELEM, EXACT, EXTRACT, QC>(d, pb, nf, ntile).total;
    if (smem <= SMEM_MAX) return 0;
  }
  return cudaErrorInvalidValue;
}

template <typename ELEM, bool KNORM, int PAY, typename PT, bool EXACT,
          bool EXTRACT, bool QC = false>
int launch_grouped_scan(const void* tstart, const void* tsize,
                        const void* v_tiles, const void* base_tiles,
                        const void* decoded, const void* scale,
                        const void* ids, const void* norms,
                        const void* slot_row, int T, int d, int pb, int nf,
                        int k_out, int n_rows, float norm_coef, void* out_d,
                        void* out_p, void* stream, QcArgs qa = QcArgs{}) {
  int ntile;
  size_t smem;
  int err = plan_scan<ELEM, EXACT, EXTRACT, QC>(d, pb, nf, k_out, ntile, smem);
  if (err) return err;
  auto* kern = grouped_scan_kernel<ELEM, KNORM, PAY, PT, EXACT, EXTRACT, QC>;
  err = ivf_set_smem(reinterpret_cast<const void*>(kern), smem);
  if (err) return err;
  if (T > 0)
    kern<<<T, NTH, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tstart), static_cast<const int*>(tsize),
        static_cast<const __nv_bfloat16*>(v_tiles),
        static_cast<const float*>(base_tiles),
        static_cast<const ELEM*>(decoded), static_cast<const float*>(scale),
        static_cast<const int*>(ids), static_cast<const float*>(norms),
        static_cast<const int64_t*>(slot_row), d, pb, nf, k_out, n_rows,
        norm_coef, ntile, static_cast<float*>(out_d), static_cast<PT*>(out_p),
        qa);
  return ivf_launch_status();
}

// out = {resident blocks per SM (occupancy API), shared bytes a block, bf16
// tiles, fold buffer in registers (1) or shared memory (0), registers a
// thread, local (spilled) bytes a thread}
template <typename ELEM, bool KNORM, int PAY, typename PT, bool EXACT,
          bool EXTRACT, bool QC = false>
int fit_grouped_scan(int d, int pb, int nf, int k_out, int* out) {
  int ntile;
  size_t smem;
  int err = plan_scan<ELEM, EXACT, EXTRACT, QC>(d, pb, nf, k_out, ntile, smem);
  if (err) return err;
  const void* kern = reinterpret_cast<const void*>(
      grouped_scan_kernel<ELEM, KNORM, PAY, PT, EXACT, EXTRACT, QC>);
  err = ivf_set_smem(kern, smem);
  if (err) return err;
  int blocks = 0;
  err = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, NTH, smem));
  if (err) return err;
  cudaFuncAttributes fa;
  err = static_cast<int>(cudaFuncGetAttributes(&fa, kern));
  if (err) return err;
  out[0] = blocks;
  out[1] = static_cast<int>(smem);
  out[2] = sizeof(ELEM) == 1 ? ntile : ntile + 1;   // tiles in turn
  out[3] = fold_in_registers(nf, EXACT);
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  return 0;
}

}  // namespace

// One C entry point per variant the JAX package reaches, all with one
// signature: the streams a variant does not read (scale for bf16 rows, ids
// without PAY_IDS, norms with KNORM) may be null; k_out is read by the
// exact merge and by extraction; slot_row (T * pb,) int64 maps each slot
// to its row of the (n_rows, width) outputs, n_rows or more: none. NAME_fit
// reports the launch shape.
#define GROUPED_ENTRY(NAME, ...)                                              \
  extern "C" int NAME(const void* tstart, const void* tsize,                 \
                      const void* v_tiles, const void* base_tiles,           \
                      const void* decoded, const void* scale,                \
                      const void* ids, const void* norms,                    \
                      const void* slot_row, int T, int d, int pb, int nf,    \
                      int k_out, int n_rows, float norm_coef, void* out_d,   \
                      void* out_p, void* stream) {                           \
    return launch_grouped_scan<__VA_ARGS__>(                                 \
        tstart, tsize, v_tiles, base_tiles, decoded, scale, ids, norms,      \
        slot_row, T, d, pb, nf, k_out, n_rows, norm_coef, out_d, out_p,      \
        stream);                                                             \
  }                                                                          \
  extern "C" int NAME##_fit(int d, int pb, int nf, int k_out, int* out) {    \
    return fit_grouped_scan<__VA_ARGS__>(d, pb, nf, k_out, out);             \
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
// rotation replace the placed v/base tiles; the slot map as above.
#define GROUPED_QC_ENTRY(NAME, ELEM)                                         \
  extern "C" int NAME(const void* tstart, const void* tsize,                 \
                      const void* ctile, const void* qidx, const void* q,    \
                      const void* c, const void* rot, const void* decoded,   \
                      const void* scale, const void* ids,                    \
                      const void* slot_row, int T, int d, int pb, int nf,    \
                      int n_rows, float norm_coef, float base_mult,          \
                      int apply_rot, void* out_d, void* out_p,               \
                      void* stream) {                                        \
    QcArgs qa{static_cast<const int*>(ctile), static_cast<const int*>(qidx), \
              static_cast<const float*>(q), static_cast<const float*>(c),    \
              static_cast<const __nv_bfloat16*>(rot), base_mult, apply_rot}; \
    return launch_grouped_scan<ELEM, true, PAY_IDS, int, false, false, true>( \
        tstart, tsize, nullptr, nullptr, decoded, scale, ids, nullptr,       \
        slot_row, T, d, pb, nf, 0, n_rows, norm_coef, out_d, out_p, stream,  \
        qa);                                                                 \
  }                                                                          \
  extern "C" int NAME##_fit(int d, int pb, int nf, int k_out, int* out) {    \
    return fit_grouped_scan<ELEM, true, PAY_IDS, int, false, false, true>(   \
        d, pb, nf, k_out, out);                                              \
  }

GROUPED_QC_ENTRY(grouped_scan_qc, int8_t)
GROUPED_QC_ENTRY(grouped_scan_qc_bf16, __nv_bfloat16)
