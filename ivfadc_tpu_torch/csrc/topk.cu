// Smallest-k along the last dim, carrying an int32 payload or the index.
//
// Replaces ivfadc_tpu/ops/topk.py::_topk_payload_kernel (the final merge of
// the dense search and the two-level stage-2 merge: (B, w*nf) candidate
// distances with id payloads -> (B, k)) and ::_topk_kernel (the same
// selection returning the winners' indices: the small-batch and large-kc
// final merges over position payloads, the two-level stage 1, and the
// coarse quantizer's pairwise fallback, N = kc). Result, as the TPU
// kernels' k min-extract passes give it: the k smallest (value, index)
// pairs of each row in ascending order, values compared as IEEE floats
// (-0.0 == +0.0) and the lower index first among equal values; each
// winner's value keeps its own bits; a row with f < k entries below +inf
// gives (+inf, index 0) at places f..k-1 (kernel 4: payload[row, 0]).
// NaN is outside the contract.
//
// Bound: reading the (B, N) f32 values once from device memory (64 MB at
// B=16384, N=1024), the k winners' payloads and writing the (B, k)
// outputs: 4BN + 4Bk (payloads) + 8Bk bytes. The selection is B*N
// compares, far below any peak rate: bytes bind.
//
// What held the first design back (one warp a row, the whole row staged in
// shared memory: warps x N x 4 bytes, 64 KB a block at N = 4096, so about
// 12 warps an SM; one float a lane per staging step, each shared store
// waiting on its own load; then k argmin passes over the staged row, N/32
// dependent steps a lane and a shuffle tree each, and a dependent payload
// load by lane 0 per pass: 6-13x the bound), and what this design does:
// 1. One streamed read of each row. Every lane issues U = 4 16-byte loads
//    before it looks at any (a scalar step takes the head and tail of a
//    row that does not start or end on 16 bytes), and shared memory is
//    O(k) a warp, so an SM holds tens of warps with 2 KB each in flight.
// 2. A running top-k list per row, sorted in (value, index) order, in
//    shared memory; its last entry is the threshold. An element enters a
//    32-place candidate buffer only if it precedes the threshold (its place
//    from a ballot prefix: deterministic, no atomics); a full buffer, and
//    the row's last one, is sorted by a bitonic network of shuffles and
//    merged into the list by rank (each entry's rank from a binary search
//    in the other run), as csrc/coarse_scan.cu's selection does. +inf
//    never enters: the list's empty places are the (+inf, index 0) tail.
//    At the row's first step (an empty list), and whenever more of a
//    step's elements pass than the buffer holds, the lanes' minima enter
//    first and are merged (k <= 32): the k-th of them bounds the rest. Merge
//    rows hold w probes' fold buffers in ascending probe order, so the
//    threshold is tight after the row's first step and about k ln(N / k)
//    elements enter; a row in descending order floods every step, and
//    each flood costs one or two merges.
// 3. Payloads read only for the k winners, by k lanes at once.
// One warp a row (the smallest batch on any path, B = 256, reads 1 MB);
// the block's warp count shrinks for small batches so that the grid
// covers the card. Any N >= k, k <= 128.

#include <limits.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int CAP = 32;          // candidate buffer places a warp
constexpr int U = 4;             // 16-byte loads a lane keeps in flight
constexpr int SLOTS = 4 * U;     // elements a lane holds per body step
constexpr int MAX_WARPS = 8;     // warps a block
constexpr int MAX_K = 128;
constexpr int EMPTY = -1;        // index of an empty list place (+inf)

struct __align__(8) Ent {
  float s;
  int i;
};

__device__ __forceinline__ bool ent_less(float as, int ai, float bs,
                                         int bi) {
  return as < bs || (as == bs && ai < bi);
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

__device__ __forceinline__ float comp(const float4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// One warp's selection state: its list pair and candidate buffer in shared
// memory, the buffer's fill and the threshold (warp-uniform registers).
struct Sel {
  Ent* lists;    // 2 x k: the current sorted list and the merge target
  Ent* buf;      // CAP candidates, unordered
  int k, cur, cnt, lane;
  int filled;    // real entries of the list; the places after them are
                 // empty in both lists
  float ts;      // threshold: the current list's last entry
  int ti;

  __device__ __forceinline__ bool passes(float v, int j) const {
    return ent_less(v, j, ts, ti);
  }

  // Merge the buffer's cnt candidates into the list, one warp: sort them
  // (one a lane, empty places as (+inf, INT_MAX)) by a bitonic network of
  // shuffles in (value, index) order, then every entry lands at its rank
  // in the other list: a candidate at its place plus the real list
  // entries before it, a real list entry at its place plus the candidates
  // before it. Entries are distinct: each index is offered once.
  __device__ __forceinline__ void merge() {
    const Ent* L = lists + cur * k;
    Ent* O = lists + (cur ^ 1) * k;
    const int n = cnt;
    float xs = IVF_INF;
    int xi = INT_MAX;
    if (lane < n) {
      xs = buf[lane].s;
      xi = buf[lane].i;
    }
#pragma unroll
    for (int b = 2; b <= 32; b <<= 1) {
#pragma unroll
      for (int j = b >> 1; j > 0; j >>= 1) {
        const float os = __shfl_xor_sync(IVF_FULL_MASK, xs, j);
        const int oi = __shfl_xor_sync(IVF_FULL_MASK, xi, j);
        const bool keep_min = ((lane & b) == 0) == ((lane & j) == 0);
        if (keep_min ? ent_less(os, oi, xs, xi) : ent_less(xs, xi, os, oi)) {
          xs = os;
          xi = oi;
        }
      }
    }
    buf[lane] = Ent{xs, xi};
    __syncwarp();
    if (lane < n) {
      const int rank = lane + lower_bound(L, filled, xs, xi);
      if (rank < k) O[rank] = Ent{xs, xi};
    }
    for (int e = lane; e < filled; e += 32) {
      const Ent l = L[e];
      const int rank = e + lower_bound(buf, n, l.s, l.i);
      if (rank < k) O[rank] = l;
    }
    __syncwarp();
    cur ^= 1;
    cnt = 0;
    filled = min(k, filled + n);
    const Ent t = O[k - 1];
    ts = t.s;
    ti = t.i;
  }

  // Offer a lane's S elements (value v(s), index j(s); bit s of m set: it
  // passed the threshold) to the buffer, slot by slot (a group of four
  // slots that no lane passes is skipped with one vote), each slot's
  // candidates at places from a ballot prefix. A slot that would overflow
  // the buffer merges it first; the elements still pending are then
  // filtered again against the new threshold.
  template <int S, class V, class J>
  __device__ __forceinline__ void offer(uint32_t m, V v, J j) {
    const uint32_t below = (1u << lane) - 1;
    while (__any_sync(IVF_FULL_MASK, m)) {
      bool full = false;  // warp-uniform: once set, the remaining slots wait
#pragma unroll
      for (int g = 0; g < (S + 3) / 4; ++g) {
        if (full || !__any_sync(IVF_FULL_MASK, (m >> (4 * g)) & 15u))
          continue;
#pragma unroll
        for (int s = 4 * g; s < S && s < 4 * g + 4; ++s) {
          const uint32_t b =
              __ballot_sync(IVF_FULL_MASK, !full && ((m >> s) & 1u));
          if (b) {
            if (cnt + __popc(b) > CAP) {
              full = true;
            } else {
              if ((m >> s) & 1u)
                buf[cnt + __popc(b & below)] = Ent{v(s), j(s)};
              cnt += __popc(b);
              m &= ~(1u << s);
            }
          }
        }
      }
      if (full) {
        __syncwarp();
        merge();
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (((m >> s) & 1u) && !passes(v(s), j(s))) m &= ~(1u << s);
      }
    }
  }
};

// 4 blocks an SM: at most 64 registers a thread, which the kernel fits
// without spills (ptxas would otherwise trade a few spills for occupancy).
template <bool kPayload>
__global__ void __launch_bounds__(MAX_WARPS * 32, 4)
    topk_kernel(const float* __restrict__ x, const int* __restrict__ payload,
                float* __restrict__ vals, int* __restrict__ out, int B,
                int N, int k) {
  extern __shared__ Ent smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= B) return;  // whole warp leaves together; no block barrier
  Sel sel;
  sel.lists = smem + static_cast<size_t>(warp) * (2 * k + CAP);
  sel.buf = sel.lists + 2 * k;
  sel.k = k;
  sel.cur = 0;
  sel.cnt = 0;
  sel.lane = lane;
  sel.ts = IVF_INF;
  sel.ti = EMPTY;
  sel.filled = 0;
  for (int e = lane; e < 2 * k; e += 32) sel.lists[e] = Ent{IVF_INF, EMPTY};
  __syncwarp();

  const float* xr = x + row * N;
  // elements before the row's first 16-byte boundary, then whole float4s,
  // then the tail: lanes [0, head) take the head, the next ones the tail
  const int head = min(
      N, static_cast<int>(
             ((16u - (reinterpret_cast<uintptr_t>(xr) & 15u)) & 15u) >> 2));
  const int nv = (N - head) >> 2;
  const int tail0 = head + 4 * nv;
  {
    const int j = lane < head ? lane : tail0 + lane - head;
    const float v = j < N ? __ldg(xr + j) : IVF_INF;
    sel.offer<1>(sel.passes(v, j) ? 1u : 0u, [&](int) { return v; },
                 [&](int) { return j; });
  }
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  for (int f0 = 0; f0 < nv; f0 += 32 * U) {
    float4 r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int f = f0 + lane + 32 * u;
      r[u] = f < nv ? __ldg(xv + f)
                    : make_float4(IVF_INF, IVF_INF, IVF_INF, IVF_INF);
    }
    // slot s: element 4 (f0 + lane + 32 (s / 4)) + s % 4 after the head
    const int jb = head + 4 * (f0 + lane);
    auto val = [&](int s) { return comp(r[s >> 2], s & 3); };
    auto idx = [&](int s) { return jb + 128 * (s >> 2) + (s & 3); };
    // A flood (more elements pass than the buffer holds: the first probe's
    // lanes against an empty list, or a row in descending order): the lane
    // minima of the passing elements enter first and are merged, so the
    // k-th of them bounds the rest (k <= 32). The row's first step always
    // starts so, over all its slots. A minimum's value is a tree of fminf,
    // its slot the first equal one (the lowest index, the element's own
    // bits).
    bool prime = f0 == 0 && k <= 32;
    uint32_t m = 0;
    if (prime) {
      m = (1u << SLOTS) - 1;
    } else {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (sel.passes(val(s), idx(s))) m |= 1u << s;
    }
    while (prime ||
           (k <= 32 && __reduce_add_sync(IVF_FULL_MASK, __popc(m)) > CAP)) {
      prime = false;
      float q[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[e] = (m >> (4 * u + e)) & 1u ? val(4 * u + e) : IVF_INF;
        q[u] = fminf(fminf(c[0], c[1]), fminf(c[2], c[3]));
      }
#pragma unroll
      for (int w = U / 2; w > 0; w >>= 1)
#pragma unroll
        for (int u = 0; u < w; ++u) q[u] = fminf(q[u], q[u + w]);
      float mv = IVF_INF;
      int ms = 0;
#pragma unroll
      for (int s = SLOTS - 1; s >= 0; --s)
        if (((m >> s) & 1u) && val(s) == q[0]) {
          mv = val(s);
          ms = s;
        }
      const int mi = idx(ms);
      const bool pass = sel.passes(mv, mi);
      sel.offer<1>(pass ? 1u : 0u, [&](int) { return mv; },
                   [&](int) { return mi; });
      if (sel.cnt > 0) {
        __syncwarp();
        sel.merge();
      }
      if (pass) m &= ~(1u << ms);  // offered once
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (((m >> s) & 1u) && !sel.passes(val(s), idx(s))) m &= ~(1u << s);
    }
    sel.offer<SLOTS>(m, val, idx);
  }
  if (sel.cnt > 0) {
    __syncwarp();
    sel.merge();
  }

  const Ent* L = sel.lists + sel.cur * k;
  for (int e = lane; e < k; e += 32) {
    const Ent l = L[e];
    const int i = l.i == EMPTY ? 0 : l.i;
    vals[row * k + e] = l.s;
    out[row * k + e] = kPayload ? __ldg(payload + row * N + i) : i;
  }
}

// Block shape: MAX_WARPS warps (rows) a block, fewer while the grid would
// not give every SM two blocks.
int warps_for(int B, int sms) {
  int warps = MAX_WARPS;
  while (warps > 1 && (B + warps - 1) / warps < 2 * sms) warps >>= 1;
  return warps;
}

size_t smem_for(int warps, int k) {
  return static_cast<size_t>(warps) * (2 * k + CAP) * sizeof(Ent);
}

// The SM count of a device, asked once per device.
int sm_count(int dev) {
  static std::atomic<int> cache[64];
  if (dev < 0 || dev >= 64) return 0;
  int sms = cache[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    cache[dev].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

int current_sms(int* sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  *sms = sm_count(dev);
  return *sms > 0 ? 0 : static_cast<int>(cudaErrorInvalidDevice);
}

template <bool kPayload>
int topk_launch(const void* x, const void* payload, void* vals, void* out,
                int B, int N, int k, void* stream) {
  if (B < 0 || N < 1 || k < 1 || k > N || k > MAX_K)
    return cudaErrorInvalidValue;
  if (B == 0) return ivf_launch_status();
  int sms = 0;
  const int err = current_sms(&sms);
  if (err) return err;
  const int warps = warps_for(B, sms);
  const int blocks = (B + warps - 1) / warps;
  topk_kernel<kPayload><<<blocks, warps * 32, smem_for(warps, k),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(payload),
      static_cast<float*>(vals), static_cast<int*>(out), B, N, k);
  return ivf_launch_status();
}

}  // namespace

extern "C" int topk_payload(const void* x, const void* payload, void* vals,
                            void* pays, int B, int N, int k, void* stream) {
  return topk_launch<true>(x, payload, vals, pays, B, N, k, stream);
}

extern "C" int topk_index(const void* x, void* vals, void* idx, int B, int N,
                          int k, void* stream) {
  return topk_launch<false>(x, nullptr, vals, idx, B, N, k, stream);
}

// Launch shape of a (B, N) selection of k on the current device (payload:
// kernel 4, else kernel 6): out[0] warps a block, [1] resident blocks per
// SM (the occupancy API), [2] shared bytes a block, [3] registers a
// thread, [4] local (spilled) bytes a thread, [5] the grid, [6] the SMs.
extern "C" int topk_fit(int B, int N, int k, int payload, int* out) {
  if (B < 1 || N < 1 || k < 1 || k > N || k > MAX_K)
    return cudaErrorInvalidValue;
  int sms = 0;
  int err = current_sms(&sms);
  if (err) return err;
  const void* kern = payload
                         ? reinterpret_cast<const void*>(topk_kernel<true>)
                         : reinterpret_cast<const void*>(topk_kernel<false>);
  const int warps = warps_for(B, sms);
  const size_t smem = smem_for(warps, k);
  int per_sm = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, warps * 32, smem));
  if (err) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, kern));
  if (err) return err;
  out[0] = warps;
  out[1] = per_sm;
  out[2] = static_cast<int>(smem);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  out[5] = (B + warps - 1) / warps;
  out[6] = sms;
  return 0;
}
