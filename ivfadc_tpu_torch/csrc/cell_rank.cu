// Stable rank of each probe among the probes of the same cell, the per-cell
// histogram and, in tile mode, the grouped scan's whole tile layout, in one
// launch.
//
// Replaces ivfadc_tpu/ops/cell_rank.py::_rank_kernel (entry cell_ranks) and
// ::_rank_kernel_v2 (entry cell_ranks_v2): one function, whose TPU v2 only
// moved its transposes out of the kernel. On this card both entry points
// run the one design below; they stay apart so that a run can tell which
// engine its path took (each has its launch counter in ops/cell_rank.py).
// (A token passed from warp to warp in shared memory instead of a block
// barrier a turn was slower at every shape measured: utils/rank_ab.py.)
//
// The TPU kernel walks the probes in one sequential grid and carries
// per-cell counters from step to step. Here one persistent cooperative
// grid (every block resident, so blocks may wait on each other) does the
// carry in three phases split by two grid barriers. Blocks [0, H) own
// contiguous ranges of 1024-probe sub-blocks (H = the sub-blocks, at most
// the resident grid); where the strips of 32 cells or the tile slots are
// more, extra blocks (up to one an SM) share only the scans.
//   1. each owner counts the cells of its range into a shared histogram
//      (integer atomics, aggregated per warp by __match_any_sync: the
//      counts do not depend on their order) and writes it as row b of an
//      (H, kc) scratch table;
//   2. the blocks split the cells in strips of 32; for each strip the 32
//      warps each sum a run of rows, a shuffle scan over the warps' sums
//      joins them, and each warp rewrites its rows as the owners'
//      carried-in counts; the totals are `counts`;
//   3. each owner loads its carried-in counts as running counters and
//      walks its sub-blocks in order: within a warp __match_any_sync
//      groups the lanes of one cell, the popcount of the group's lower
//      lanes is the rank inside the warp, and the 32 warps take turns on
//      the running counters (only the group's lowest lane adds the group's
//      size), one block barrier a turn. rank[p] = #{p' < p : cells[p'] ==
//      cells[p]} exactly, with no order-dependent value anywhere.
// In tile mode phase 3 also redoes, in every block, the exclusive scan of
// ceil(counts / pb) in shared memory (tile_base, cheaper than a third
// barrier), writes each probe's tile row row[p] = tile_base[c] * pb +
// rank and scatters inv_row[row[p]] = p; the slots are split over the
// grid, and the block owning a slot fills it with P when it is empty and,
// for a tile's first slot, writes the tile's cell (the last cell whose
// tile_base <= t, kc - 1 past the last tile), start and size (0 past the
// last tile): the bits of ops/cell_rank.py::tile_layout.
//
// Probes whose cell lies outside [0, kc) (the TPU kernel's padding
// sentinel) are counted in no histogram and, in ranks mode, get the number
// of earlier equal cells in their own 32-aligned warp of probes, the same
// in both engines (the earlier three-launch kernels counted their whole
// 1024-probe block). Tile mode requires cells in range: such a probe gets
// row -1 and no slot.
//
// The barrier is a counter and a generation word in the scratch buffer;
// the last block to arrive resets the counter, so the buffer is zero
// between calls with no host memset and the launch can be captured in a
// CUDA graph. Writes read by other blocks are fenced before the arrival
// and read with ld.global.cg (L2, never a stale L1 line).
//
// Bound: a few MB (P = 131072: cells in, ranks or row + inv_row out, kc
// counts; 0.3-0.6 us at the card's memory rate). The kernel is bound by
// latency: one launch, two grid barriers and the 32-turn warp walk per
// sub-block; the design keeps the whole tile prep in that one launch.

#include "common.cuh"

constexpr int RANK_BLK = 1024;     // probes per sub-block = threads a block
constexpr int RANK_WARPS = RANK_BLK / 32;
constexpr int RANK_PART = 32 * 33;  // phase 2's 32 x 32 sums, padded rows

struct RankArgs {
  const int* cells;
  int P, kc;
  int* ranks;                      // (P,), ranks mode
  int* counts;                     // (kc,)
  const int* offsets;              // tile mode: (kc,) cell slot offsets
  const int* sizes;                // tile mode: (kc,) cell sizes
  int pb, T_max;
  int* c_t;                        // (T_max,)
  int* tile_start;                 // (T_max,)
  int* tile_size;                  // (T_max,)
  long long* row;                  // (P,) int64: torch's index type
  long long* inv_row;              // (T_max * pb,) int64
  int* hist;                       // (grid, kc) scratch
  unsigned* bar;                   // [arrivals, generation]
};

__device__ __forceinline__ unsigned ivf_ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier of a cooperative launch. Arrivals count up to the grid
// size; the last block resets the count and bumps the generation the
// others wait on.
__device__ __forceinline__ void ivf_grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ivf_ld_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (ivf_ld_acquire(bar + 1) == gen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Exclusive scan of one int a thread over the block (RANK_BLK threads);
// wsum holds 33 ints of shared memory. Returns the thread's exclusive
// prefix; `total` gets the block's sum.
__device__ __forceinline__ int ivf_block_excl_scan(int v, int* wsum,
                                                   int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(IVF_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int s = wsum[lane];
    int t = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(IVF_FULL_MASK, t, o);
      if (lane >= o) t += y;
    }
    wsum[lane] = t - s;
    if (lane == 31) wsum[32] = t;
  }
  __syncthreads();
  total = wsum[32];
  return wsum[warp] + x - v;
}

static size_t rank_smem(int kc, bool tiles) {
  return (static_cast<size_t>(tiles ? 3 : 1) * kc + RANK_PART + 33) *
         sizeof(int);
}

// Blocks [0, H) own the 1024-probe sub-blocks, H = min(sub-blocks, grid);
// the rest only help with the scans over the cells and the tile slots.
template <bool TILES>
__global__ void __launch_bounds__(RANK_BLK) rank_tiles(const RankArgs a) {
  extern __shared__ int smem[];
  const int kc = a.kc, P = a.P;
  int* run = smem;                           // kc: histogram, then counters
  int* tb = run + kc;                        // kc: tile_base (tile mode)
  int* cn = tb + (TILES ? kc : 0);           // kc: counts (tile mode)
  int* part = cn + (TILES ? kc : 0);         // RANK_PART: phase 2 sums
  int* wsum = part + RANK_PART;              // 33
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int G = gridDim.x, b = blockIdx.x;
  const int nsub = (P + RANK_BLK - 1) / RANK_BLK;
  const int H = max(1, min(nsub, G));
  const bool owner = b < H;
  const int s_lo = owner ? static_cast<int>(
      static_cast<long long>(b) * nsub / H) : 0;
  const int s_hi = owner ? static_cast<int>(
      static_cast<long long>(b + 1) * nsub / H) : 0;
  const int p_lo = s_lo * RANK_BLK, p_hi = min(P, s_hi * RANK_BLK);

  // ---- 1. histogram of the block's range
  if (owner) {
    for (int c = tid; c < kc; c += RANK_BLK) run[c] = 0;
    __syncthreads();
    for (int base = p_lo; base < p_hi; base += RANK_BLK) {
      const int p = base + tid;
      const int c = p < p_hi ? __ldg(a.cells + p) : -1;
      const unsigned peers = __match_any_sync(IVF_FULL_MASK, c);
      if (c >= 0 && c < kc && (peers & below) == 0)
        atomicAdd(&run[c], __popc(peers));
    }
    __syncthreads();
    for (int c = tid; c < kc; c += RANK_BLK)
      a.hist[static_cast<size_t>(b) * kc + c] = run[c];
  }
  ivf_grid_sync(a.bar);

  // ---- 2. per cell, the exclusive scan of the rows over the owners:
  // warp w sums a run of rows for the strip's 32 cells, then warp w scans
  // cell w over the 32 warps' sums (a shuffle scan), then each warp
  // rewrites its rows as carried-in counts
  {
    const int rows = (H + RANK_WARPS - 1) / RANK_WARPS;
    const int g0 = min(H, warp * rows), g1 = min(H, g0 + rows);
    for (int st = b; st < (kc + 31) / 32; st += G) {
      const int c = st * 32 + lane;
      int sum = 0;
      if (c < kc)
        for (int g = g0; g < g1; ++g)
          sum += __ldcg(a.hist + static_cast<size_t>(g) * kc + c);
      part[warp * 33 + lane] = sum;
      __syncthreads();
      {
        const int v = part[lane * 33 + warp];
        int x = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(IVF_FULL_MASK, x, o);
          if (lane >= o) x += y;
        }
        part[lane * 33 + warp] = x - v;
        if (lane == 31 && st * 32 + warp < kc) a.counts[st * 32 + warp] = x;
      }
      __syncthreads();
      if (c < kc) {
        int acc = part[warp * 33 + lane];
        for (int g = g0; g < g1; ++g) {
          const size_t at = static_cast<size_t>(g) * kc + c;
          const int e = __ldcg(a.hist + at);
          a.hist[at] = acc;
          acc += e;
        }
      }
      __syncthreads();
    }
  }
  ivf_grid_sync(a.bar);

  // ---- 3. running counters, tile bases, ranks and slots
  if (owner)
    for (int c = tid; c < kc; c += RANK_BLK)
      run[c] = __ldcg(a.hist + static_cast<size_t>(b) * kc + c);
  int total = 0;
  if (TILES) {
    const int pb = a.pb;
    const int per = (kc + RANK_BLK - 1) / RANK_BLK;
    const int c0 = min(kc, tid * per), c1 = min(kc, c0 + per);
    int loc = 0;
    for (int c = c0; c < c1; ++c) {
      const int n = __ldcg(a.counts + c);
      cn[c] = n;
      loc += (n + pb - 1) / pb;
    }
    int ex = ivf_block_excl_scan(loc, wsum, total);
    for (int c = c0; c < c1; ++c) {
      tb[c] = ex;
      ex += (cn[c] + pb - 1) / pb;
    }
  }
  __syncthreads();

  for (int s = s_lo; s < s_hi; ++s) {
    const int p = s * RANK_BLK + tid;
    const int c = p < P ? __ldg(a.cells + p) : -1;
    const bool inr = c >= 0 && c < kc;
    const unsigned peers = __match_any_sync(IVF_FULL_MASK, c);
    const unsigned lower = peers & below;
    int carried = 0;
    for (int wi = 0; wi < RANK_WARPS; ++wi) {  // the warps take turns
      if (warp == wi) {
        if (inr) carried = run[c];
        __syncwarp();
        if (inr && lower == 0) run[c] = carried + __popc(peers);
      }
      __syncthreads();
    }
    if (p >= P) continue;
    const int r = __popc(lower) + carried;
    if (TILES) {
      const int slot = inr ? tb[c] * a.pb + r : -1;
      a.row[p] = static_cast<long long>(slot);
      if (inr) a.inv_row[slot] = p;
    } else {
      a.ranks[p] = r;
    }
  }

  if (TILES) {
    const int pb = a.pb;
    const int nslots = a.T_max * pb;
    for (int s = b * RANK_BLK + tid; s < nslots; s += G * RANK_BLK) {
      const int t = s / pb, j = s - t * pb;
      int ct = kc - 1;
      bool live = false;
      if (t < total) {
        int lo = 0, hi = kc;         // first cell whose tile_base > t
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (tb[mid] <= t) lo = mid + 1; else hi = mid;
        }
        ct = lo - 1;
        live = j < cn[ct] - (t - tb[ct]) * pb;
      }
      if (!live) a.inv_row[s] = static_cast<long long>(P);
      if (j == 0) {
        a.c_t[t] = ct;
        a.tile_start[t] = t < total ? __ldg(a.offsets + ct) : 0;
        a.tile_size[t] = t < total ? __ldg(a.sizes + ct) : 0;
      }
    }
  }
}

static const void* rank_fn(bool tiles) {
  return tiles ? reinterpret_cast<const void*>(&rank_tiles<true>)
               : reinterpret_cast<const void*>(&rank_tiles<false>);
}

static int sm_count(int& sms) {
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (!err)
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  return err;
}

// Launch shape for kc: out[0] resident blocks per SM, [1] SMs, [2] the
// largest grid (the scratch table's rows), [3] shared bytes, [4]
// registers, [5] spilled (local) bytes a thread. Raises the kernels'
// shared-memory limit to what kc = 4096 needs, once.
extern "C" int cell_rank_fit(int kc, int tiles, int* out) {
  static bool raised = false;
  if (!raised) {
    int err = ivf_set_smem(rank_fn(true), rank_smem(4096, true));
    if (!err) err = ivf_set_smem(rank_fn(false), rank_smem(4096, false));
    if (err) return err;
    raised = true;
  }
  const void* fn = rank_fn(tiles != 0);
  const size_t smem = rank_smem(kc, tiles != 0);
  int sms = 0, blocks = 0;
  int err = sm_count(sms);
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, RANK_BLK, smem));
  cudaFuncAttributes attr;
  if (!err) err = static_cast<int>(cudaFuncGetAttributes(&attr, fn));
  if (err) return err;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  out[0] = blocks;
  out[1] = sms;
  out[2] = blocks * sms;
  out[3] = static_cast<int>(smem);
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// scratch: 4 + max_grid * kc int32, its first two words zero between calls
// (the barrier); max_grid from cell_rank_fit. offsets == null: ranks mode
// (ranks and counts); otherwise tile mode (counts, c_t, tile_start,
// tile_size, row, inv_row). One block a 1024-probe
// sub-block up to max_grid; when the strips of 32 cells or, in tile mode,
// the slots are more, extra blocks up to one an SM (a second block on an
// SM slows the owner's walk).
static int cell_rank_launch(const void* cells, int P, int kc, void* ranks,
                            void* counts, const void* offsets,
                            const void* sizes, int pb, int T_max, void* c_t,
                            void* tile_start, void* tile_size, void* row,
                            void* inv_row, void* scratch, int max_grid,
                            void* stream) {
  const bool tiles = offsets != nullptr;
  int sms = 0;
  int err = sm_count(sms);
  if (err) return err;
  int extra = (kc + 31) / 32;
  if (tiles) extra = max(extra, (T_max * pb + RANK_BLK - 1) / RANK_BLK);
  const int grid = max(1, max(min((P + RANK_BLK - 1) / RANK_BLK, max_grid),
                              min(extra, min(sms, max_grid))));
  RankArgs a;
  a.cells = static_cast<const int*>(cells);
  a.P = P;
  a.kc = kc;
  a.ranks = static_cast<int*>(ranks);
  a.counts = static_cast<int*>(counts);
  a.offsets = static_cast<const int*>(offsets);
  a.sizes = static_cast<const int*>(sizes);
  a.pb = pb;
  a.T_max = T_max;
  a.c_t = static_cast<int*>(c_t);
  a.tile_start = static_cast<int*>(tile_start);
  a.tile_size = static_cast<int*>(tile_size);
  a.row = static_cast<long long*>(row);
  a.inv_row = static_cast<long long*>(inv_row);
  a.bar = static_cast<unsigned*>(scratch);
  a.hist = static_cast<int*>(scratch) + 4;
  void* params[] = {&a};
  err = static_cast<int>(cudaLaunchCooperativeKernel(
      rank_fn(tiles), dim3(grid), dim3(RANK_BLK), params,
      rank_smem(kc, tiles), static_cast<cudaStream_t>(stream)));
  return err ? err : ivf_launch_status();
}

extern "C" int cell_ranks(const void* cells, int P, int kc, void* ranks,
                          void* counts, const void* offsets,
                          const void* sizes, int pb, int T_max, void* c_t,
                          void* tile_start, void* tile_size, void* row,
                          void* inv_row, void* scratch, int max_grid,
                          void* stream) {
  return cell_rank_launch(cells, P, kc, ranks, counts, offsets, sizes, pb,
                          T_max, c_t, tile_start, tile_size, row, inv_row,
                          scratch, max_grid, stream);
}

extern "C" int cell_ranks_v2(const void* cells, int P, int kc, void* ranks,
                             void* counts, const void* offsets,
                             const void* sizes, int pb, int T_max,
                             void* c_t, void* tile_start, void* tile_size,
                             void* row, void* inv_row, void* scratch,
                             int max_grid, void* stream) {
  return cell_rank_launch(cells, P, kc, ranks, counts, offsets, sizes, pb,
                          T_max, c_t, tile_start, tile_size, row, inv_row,
                          scratch, max_grid, stream);
}
