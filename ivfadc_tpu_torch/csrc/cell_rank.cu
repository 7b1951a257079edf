// Stable rank of each probe among the probes of the same cell, plus the
// per-cell histogram.
//
// Replaces ivfadc_tpu/ops/cell_rank.py::_rank_kernel. The TPU kernel walks
// the probes in one sequential grid and carries per-cell counters from step
// to step; blocks on this card run in no order, so the carry becomes three
// launches over fixed blocks of 1024 probes:
//   1. rank_hist:  per-block cell histogram (shared-memory integer atomics,
//                  whose result does not depend on their order);
//   2. rank_scan:  per cell, an exclusive scan of the block histograms in
//                  block order -> each block's carried-in count, and the
//                  final counts;
//   3. rank_local: carried-in count + the number of EARLIER probes of the
//                  same cell inside the block (a compare loop over the
//                  block's cells staged in shared memory).
// rank[p] = #{p' < p : cells[p'] == cells[p]} exactly and deterministically.
// Probes whose cell is outside [0, kc) (the TPU kernel's padding sentinel)
// are counted in no histogram.
//
// cell_ranks_v2 replaces ivfadc_tpu/ops/cell_rank.py::_rank_kernel_v2 (the
// same function: the TPU's v2 only moves its transposes out of the kernel).
// It shares passes 1 and 2 and replaces pass 3's compare loop:
//   3'. rank_local_v2: one thread per probe, 1024 a block. Within a warp,
//       __match_any_sync groups the lanes of one cell and the popcount of
//       the group's lower lanes is the within-warp rank; across the warps
//       of the block, the warps walk in order against a per-cell counter
//       array in shared memory (kc ints), to which only the lowest lane of
//       each group adds the group's size. Cells outside [0, kc) keep v1's
//       rule (earlier equal cells of the block, no carried-in count) by
//       v1's compare loop, over the earlier warps only.
// Its bits equal rank_local's.
//
// Bound: tiny (P=131072 int32 in, the same out, a (P/1024, kc) scratch).
// Launch latency dominates; the design keeps every pass a single launch.

#include "common.cuh"

constexpr int RANK_BLK = 1024;
constexpr int RANK_THREADS = 256;

__global__ void rank_hist(const int* __restrict__ cells, int P, int kc,
                          int* __restrict__ hist) {
  extern __shared__ int h[];
  for (int c = threadIdx.x; c < kc; c += blockDim.x) h[c] = 0;
  __syncthreads();
  const int base = blockIdx.x * RANK_BLK;
  for (int i = threadIdx.x; i < RANK_BLK; i += blockDim.x) {
    const int p = base + i;
    if (p < P) {
      const int c = cells[p];
      if (c >= 0 && c < kc) atomicAdd(&h[c], 1);
    }
  }
  __syncthreads();
  int* out = hist + static_cast<size_t>(blockIdx.x) * kc;
  for (int c = threadIdx.x; c < kc; c += blockDim.x) out[c] = h[c];
}

__global__ void rank_scan(int* __restrict__ hist, int nblk, int kc,
                          int* __restrict__ counts) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= kc) return;
  int run = 0;
  for (int b = 0; b < nblk; ++b) {
    const size_t at = static_cast<size_t>(b) * kc + c;
    const int n = hist[at];
    hist[at] = run;
    run += n;
  }
  counts[c] = run;
}

__global__ void rank_local(const int* __restrict__ cells, int P, int kc,
                           const int* __restrict__ prefix,
                           int* __restrict__ ranks) {
  __shared__ int cs[RANK_BLK];
  const int base = blockIdx.x * RANK_BLK;
  for (int i = threadIdx.x; i < RANK_BLK; i += blockDim.x) {
    const int p = base + i;
    cs[i] = p < P ? cells[p] : -1;
  }
  __syncthreads();
  const int* pre = prefix + static_cast<size_t>(blockIdx.x) * kc;
  for (int i = threadIdx.x; i < RANK_BLK; i += blockDim.x) {
    const int p = base + i;
    if (p >= P) continue;
    const int c = cs[i];
    int r = 0;
    for (int j = 0; j < i; ++j) r += (cs[j] == c);
    ranks[p] = (c >= 0 && c < kc ? pre[c] : 0) + r;
  }
}

__global__ void __launch_bounds__(RANK_BLK) rank_local_v2(
    const int* __restrict__ cells, int P, int kc,
    const int* __restrict__ prefix, int* __restrict__ ranks) {
  extern __shared__ int cnt[];      // kc running counts of the block
  __shared__ int cs[RANK_BLK];      // the block's cells (out-of-range rule)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x * RANK_BLK + tid;
  const int c = p < P ? cells[p] : -1;
  cs[tid] = c;
  for (int i = tid; i < kc; i += RANK_BLK) cnt[i] = 0;
  const unsigned peers = __match_any_sync(IVF_FULL_MASK, c);
  const unsigned lower = peers & ((1u << lane) - 1u);
  const bool inr = c >= 0 && c < kc;
  int carried = 0;
  __syncthreads();
  for (int wi = 0; wi < RANK_BLK / 32; ++wi) {
    if (warp == wi && inr) {
      carried = cnt[c];
      __syncwarp(peers);
      if (lower == 0) cnt[c] = carried + __popc(peers);
    }
    __syncthreads();
  }
  if (p >= P) return;
  if (inr) {
    carried += prefix[static_cast<size_t>(blockIdx.x) * kc + c];
  } else {
    for (int j = 0; j < warp * 32; ++j) carried += (cs[j] == c);
  }
  ranks[p] = carried + __popc(lower);
}

// scratch: (ceil(P/1024), kc) int32.
static int cell_ranks_impl(const void* cells, int P, int kc, void* ranks,
                           void* counts, void* scratch, void* stream,
                           bool v2) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (P + RANK_BLK - 1) / RANK_BLK;
  const size_t hsmem = static_cast<size_t>(kc) * sizeof(int);
  int err = ivf_set_smem(reinterpret_cast<const void*>(rank_hist), hsmem);
  if (err) return err;
  const int* c = static_cast<const int*>(cells);
  int* hist = static_cast<int*>(scratch);
  if (nblk > 0)
    rank_hist<<<nblk, RANK_THREADS, hsmem, s>>>(c, P, kc, hist);
  err = ivf_launch_status();
  if (err) return err;
  rank_scan<<<(kc + 255) / 256, 256, 0, s>>>(hist, nblk, kc,
                                             static_cast<int*>(counts));
  err = ivf_launch_status();
  if (err) return err;
  if (nblk > 0 && v2) {
    err = ivf_set_smem(reinterpret_cast<const void*>(rank_local_v2), hsmem);
    if (err) return err;
    rank_local_v2<<<nblk, RANK_BLK, hsmem, s>>>(c, P, kc, hist,
                                                static_cast<int*>(ranks));
  } else if (nblk > 0) {
    rank_local<<<nblk, RANK_THREADS, 0, s>>>(c, P, kc, hist,
                                             static_cast<int*>(ranks));
  }
  return ivf_launch_status();
}

extern "C" int cell_ranks(const void* cells, int P, int kc, void* ranks,
                          void* counts, void* scratch, void* stream) {
  return cell_ranks_impl(cells, P, kc, ranks, counts, scratch, stream, false);
}

extern "C" int cell_ranks_v2(const void* cells, int P, int kc, void* ranks,
                             void* counts, void* scratch, void* stream) {
  return cell_ranks_impl(cells, P, kc, ranks, counts, scratch, stream, true);
}
