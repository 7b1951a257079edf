#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ivfadc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `ivfadc_tpu_torch/csrc/`, then runs in
phases, printing one JSON line per phase; any failure raises (exit != 0):

  setup    card name and power limit, versions, kernel build time
  build    IVFADCIndex.build at the SIFT1M shape (n=1M, d=128, kc=1024,
           m=8, k=256, pq, seed 0, kmeanspp_sample=65536) on cuda
  kernels  kernels 1-11 and the scan variants 8a-8e against their plain
           PyTorch versions on their paths' own inputs (8a and 8b: in the
           two_level phase, and here on kernel 3's tiles). At B=16384
           queries, w=8: coarse probe, the cell-rank kernel's fused tile
           prep (ranks, counts, tile map, row, inv_row in one launch; two
           calls in a row, both bit-equal to the plain version) and its
           ranks-only call (device times of both, the fused call's device
           operations and launch shape), grouped fold scan, its
           exact-merge, extraction (k=10), bf16-cache and pos8 variants
           (each with an integer-valued case that must be bit-exact; exact
           merge: sorted top-10 distances agree, untied payloads equal) and
           the top-k merge. At B=256, w=8 (2048 probes): per-probe fold
           scan and its exact-merge and bf16 variants, top-k with indices
           on that scan's candidate rows, exact top-w probe (also against
           the fused probe's cells). The opt-in engines: v2 cell ranks on
           the B=16384 probe's cells, ranks-only and fused (bit-equal
           to kernel 2 and the plain version), the v2 coarse probe at B=16384 with and without a
           random orthogonal rotation (kernel 1's cells; v within one bf16
           ulp; base = 2 cdist), the qc scan (int8 and bf16 caches, and
           under the rotation) on every tile of a B=8192 batch, beside
           kernel 3, 8a and the placement's gathers at the same tiles. For
           each: kernel time, plain time, the time of the nearest PyTorch
           library call where there is one, and the card's bound; for the
           coarse kernels 1, 7 and 10 also the launch plan (query tile,
           centroid tile, splits of the table, grid) and the share of the
           bound, and at B=256 an integer-valued table on which kernels 7,
           1 and 10 must equal the plain versions bit for bit; for the
           grouped scans (3, 8a-8e, 9) the kernel's device time, its share
           of the bound and its launch shape (blocks per SM, shared bytes,
           staged tiles, fold buffer, registers, spills); for kernel 5
           and its per-probe 8c / 8d (and kernel 5 at the posting shape)
           the device time, its share of the bound and the launch shape
           (`probe_fit`: blocks per SM, the persistent grid,
           shared bytes, ring stages, registers, spills); for kernels 4
           and 6 at each of their five shapes (here and in two_level) the
           device time, its share of the bound (bytes: the values once, the
           winners' payloads, the outputs) and the launch shape (`topk_fit`:
           warps a block, blocks per SM, shared bytes, registers, spills),
           and torch.topk's device time at B=256
  search   with every launch count zeroed: search_padded of 1000 queries,
           recall@10 against brute force and against the NumPy oracle of
           the reference algorithm, QPS over back-to-back B=16384 batches
           and the p50 batch latency; kernels 1-4 must have launched
  small_batch  counts zeroed: single-point search and search_padded at
           B=8/64/256 (B*w < 4*kc: per-probe scan + top-k with indices);
           recall@10 and id overlap against the grouped path on the same
           1000 queries; p50/p99 of 200 synchronised single-query searches,
           p50 per batch size, device idle share of a single-query search
  norms_off  counts zeroed: the search phase's 1000 queries (B*w >= 4*kc:
           the grouped route) under IVFADC_NORMS=off, which sends the
           posting scan through kernel 8a (row norms computed in the
           kernel) instead of kernel 3; the variable is read when the dense
           view is built, so the view is dropped before and after
  lut      counts zeroed: scan_mode="lut" at k=10 (256 queries, against the
           oracle) and k=200 through the default configuration (k > 128
           routes to the LUT engine)
  unfused  counts zeroed: a second index (n=200k, kc=256) scored by inner
           product: exact top-w probe, then the per-probe scan (B=16) and
           the grouped scan (B=4096; no norm term, so kernel 8a without a
           norms stream); recall against brute-force inner product, dense
           routes against the LUT route
  variants counts zeroed before each part: scan_cache="bf16" (grouped,
           also under IVFADC_NORMS=off, and small batches; recall@10 within
           0.01 of the oracle, top-10 overlap with the int8 routes >= 0.9),
           scan_merge="exact" (grouped and small batches; recall within
           0.01, distances never above the fold routes' of the same
           arithmetic, tie-aware overlap >= 0.99 with a 1024-lane fold,
           which loses almost no neighbour to lane collisions, and >= 0.95
           with the default 128-lane fold) and
           IVFADC_EXTRACT=1 on the grouped route (distances bit-equal to
           IVFADC_NORMS=off's, ids equal but at exact ties); batch ms each
  engines  counts zeroed before each route, B=8192 batches: the default
           placement route, IVFADC_VBASE=qc (kernel 9), IVFADC_COARSE_ENGINE
           =v2 (kernel 10), IVFADC_RANK_ENGINE=v2 (kernel 11), all three,
           and qc over the bf16 cache: recall@10, top-10 overlap with the
           default, median batch ms, launch counts; rank v2 bit-equal to
           the default, qc and coarse v2 within 0.01 recall of the oracle
           and overlap >= 0.99; at B=16384 qc's gate fails (kernel 3); the
           qc and placement batches profiled
  persist  save -> load(device="cuda") -> identical search_padded output;
           the same file loaded on the CPU (kernels' plain versions) agrees
  profile  device time per kernel and idle share over three B=16384
           searches (torch.profiler)
  dynamic  counts zeroed: a fork of the SIFT1M index takes push_batch of
           262,144 points (synthetic_clustered, seed 7: cells must grow),
           1000 single push, 1000 single delete, one 2048-id delete (the
           incremental path), one 10,000-id delete (the bulk path), 100
           pop, 100 pop_front and 10 push_front; after each step its views
           (patched in place, or rebuilt where a grow or the bulk delete
           dropped them) equal views built afresh from the same host state
           bit for bit, and a B=16384 (grouped: kernels 1-4) and a B=256
           (per probe: kernels 1, 5, 6) search equal the fresh views'
           results bit for bit; ids stay 0..n-1; recall@10 of the mutated
           index within 0.01 of the NumPy oracle's on its own contents;
           the parent's B=16384 results bit-equal to those before the
           fork; kernels 7 (cell assignment), 1-6 launched. Printed: the
           push_batch rate, p50 of single push and delete, the view access
           (flush or rebuild) time of the first search after each step
  opq      an OPQ index over the first 200,000 points (kc=1024, m=8):
           rotation orthogonal to 1e-4, counts zeroed: a B=4096 batch
           through the fused probe with the rotation and kernels 2-4; top-10
           overlap with the same index's LUT route >= 0.95 (C.11's bound
           for the default fold); recall@10 and build time
  streaming  the 1M base points written as one .fvecs file (516 MB) and
           indexed out of core by IVFADCIndex.build_from_files
           (chunk_rows=262144): with the in-memory points as train_data
           the store, the build digest and a B=16384 search (counts
           zeroed: kernels 1-4) must equal the build phase's bit for bit;
           on the default 2^18-point reservoir recall@10 within 0.02 of
           the full build's, printed beside its oracle's; build_timings,
           host peak RSS and device peak memory of both builds
  tune     IVFADCIndex.autotune on a B=16384 batch over the JAX package's
           default candidates (pb 16/32/64/128 x chunk 512/1024/2048):
           12 timed rows, none an error (pb = 128 runs 64-row tiles),
           every candidate's ids and distances bit-equal to the default
           config's, and at pb = 4 / 20 / 100 / 256 too; the candidates'
           times; memory_stats, its scan-cache bytes equal to the dense
           view's own tensors'
  serving  counts zeroed: a BatchingSearcher(max_batch=1024,
           max_wait_ms=2, pipeline=2) over the SIFT1M index and 8 client
           threads for 5 s (6 send single queries, 2 arrays of 256):
           served QPS, p50 / p99 request latency, dispatches and mean batch
           size; every served row's top-10 overlap with a direct search of
           its rows >= 0.99 (coalesced batches cross the B*w >= 4*kc
           route boundary); kernels 1-6 launched. Then, the clients still
           running, 10 push_batch mutations (1000 points the index stores
           exactly) and 10 deletes (1000 ids) through the searcher: each
           mutation's fork time, the clients' latency meanwhile, and every
           pushed point at rank 0 for a query submitted after its mutate
           returned; kernel 7 (the pushes' cells) and 1-4 launched
  sharded  ShardedIVFADCIndex over the SIFT1M index (`phase_sharded`,
           one line a part): views of 4 shards on one card and of
           make_mesh() (1 shard), counts zeroed per batch: the search
           phase's 1000 queries, a B=16384 (grouped: kernels 1-4, the
           merge on 6) and a B=256 batch (per probe: 1, 5, 6), one coarse
           probe a search (the shards share the card); distances bit-equal
           to the single card's, ids but at exact ties, recall@10 equal but
           at ties; median B=16384 batch ms at S=1 and S=4 beside the
           single card's, device peak. sharded_mutations: a fork of the
           4-shard view takes push, a 1000-id delete (the rows of the
           largest cells), push_front and pop (each an incremental
           refresh), then push_batch of 65,536 points (a full one: the
           share of cells that outgrew their per-shard capacity); each step
           bit-equal to a fresh view; the parent view unchanged.
           sharded_wide: under IVFADC_DEVICE_ID_CAP=2^20 a value-mode view
           of the 1M points takes the 65,536-point push_batch, upgrades to
           wide ids, and its uint64 ids and distances equal an uncapped
           twin's; the capped base's own search raises. sharded_serving: a
           BatchingSearcher(max_batch=1024, max_wait_ms=2) over a fork of
           the 4-shard view, 16 single queries, 8 closed-loop clients for
           2 s, then 2 push_batch (pushed points at rank 0) and 2 deletes
           through it; served QPS, p50 / p99, top-10 overlap with the
           view's own search >= 0.995
  distributed  `phase_distributed`, one line a part, at the build phase's
           shape: ShardedIVFADCIndex.build of the 1M points over
           make_mesh(n_shards=4) on one card (seconds per stage); counts
           zeroed per batch: the 1000 queries and a B=16384 batch
           (kernel 1 once, 2-4 four times each, 6 once to merge) and a
           B=256 batch (1 once, 5 four times, 6 five times); recall@10 at
           least the single card's - 0.01, beside the oracle's; the view's
           directory consolidated into an IVFADCIndex on the card:
           B=16384 and B=256 distances bit-equal, ids but at exact ties;
           batch ms, device peak. distributed_persist: save, load onto
           S=4 (bit-equal) and S=2 (a reshard: distances bit-equal),
           consolidate_sharded_to_file then IVFADCIndex.load on the card
           (equal to the in-memory consolidation); bytes and seconds.
           distributed_mutations: a fork takes push_batch of 65,536 points
           (a regrow; kernel 7 gives the cells), a 1000-id delete,
           push_front, pop, pop_front and reconstruct, each held to a
           fresh view over its consolidated state (distances bit-equal,
           ids but at ties; ids 0..n-1); the parent unchanged; ms of each.
           distributed_ranks: two ranks spawned by torch.multiprocessing
           on the card (gloo: NCCL refuses two ranks on one card), a
           global 1 x 4 mesh: build, search, owner-only save, then a
           fresh group loads and searches; every rank bit-equal to the
           single-process view; a rank that fails or outlasts its limit
           fails the phase
  multichip  `phase_multichip`, after distributed, one line a part: the
           entry point (`ivfadc_tpu_torch/dryrun.py`: the LUT forward on
           the card against the CPU, the tiny dry run over a 2 x 4 mesh
           and its OK line), then the dry run's sequence at the build
           phase's width over make_mesh(n_shards=4, n_data=2) on one card:
           train_step against the one-position step, the (2, 4) view of
           the index (B=16384: kernel 1 twice, 2-4 eight times, 6 twice;
           B=256: 1 twice, 5 eight times, 6 ten times) against the single
           card, ShardedIVFADCIndex.build over (2, 4) (seconds by stage,
           recall@10 within 0.01 of the 1 x 4 build's, its consolidated
           twin), push_batch / delete / pop on a fork each held to a fresh
           view, a save and a load onto (1, 2), build_streaming over
           (2, 4), a wide-id build under a cap below n equal to the
           uncapped build; batch ms beside the single card's, device peak
  two_level  the large-kc configuration at the Deep1B-shard shape: n=2M,
           d=96, kc=2^18 (k-means|| seeding, 8-row cells), m=16, k=256,
           coarse_quantizer="hnsw"; kernel 8a and kernels 2 (and 11: the
           fused prep at stage 2's group ids, pb=64), 4, 5, 6
           against their plain versions at this path's shapes, kernels 7
           and 1 over the whole centroid table (the naive-coarse checks'
           shape, split over blocks; with an integer-valued table they
           must equal the plain versions bit for bit on 256 queries); counts
           zeroed: search_padded of 4096 queries at w=32, k=10 (stage 1 ->
           cell ranks -> grouped scan with in-kernel norms -> merge ->
           per-probe posting scan -> top-k); the probed cells against the
           exact top-w, stage-2 distances against true ones, recall@10
           against brute force and against the same index under the naive
           coarse quantizer (counts zeroed: kernels 7 and 1 must launch),
           overlap with the LUT engine, a single search,
           save -> load, batch time, QPS, the coarse share and idle share;
           then one batch under IVFADC_RANK_ENGINE=v2 (kernel 11 at stage
           2, bit-equal results), stage 2 under IVFADC_EXTRACT=1 (kernel 8e
           at g=512, gp=32: the buffered route's cells but at ties); then
           one batch of 32768
           queries (B*w = 4*kc: sort-based tile prep -> grouped scan with
           pos8 block payloads, kernel 8b, launched once -> top-k), held to
           the same queries in 8 per-probe batches (tie-aware overlap
           >= 0.999, distances within 1e-3, recall within 0.005), 8b
           against its plain version on every 128th tile, batch ms, QPS,
           peak device memory, device time per kernel and idle share
  sharded_two_level  two shards of the large-kc index on one card,
           counts zeroed: the B=4096 batch at w=32 (kernels 6, 2, 8a, 4 in
           the replicated coarse probe, 5 and 6 per shard, 6 to merge),
           distances bit-equal to the single card's, ids but at exact ties
  dynamic_two_level  counts zeroed: on the large-kc index (8-row cells, no
           norm stream) push_batch of 65,536 points (some grows must move
           their rows inside the views, with no rebuild) and a 2048-id
           delete, each held to fresh views and a B=4096 search bit for
           bit (kernels 6, 2, 8a, 4 assign the cells; 5 and 6 search);
           then the gathered engine (scan_gather_win=32, or the p95 cell
           capacity where 32 leaves its plan off) on the same batch: top-10
           overlap with the per-probe route >= 0.99, its device time beside
           kernel 5's on the same probes

The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the repository beside it, the script fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N, D, KC, M, KQ = 1_000_000, 128, 1024, 8, 256
TOPK, W, BATCH = 10, 8, 16384
BATCH_QC = 8192                     # the engines phase's batch (qc gate: <= 12288)
N_SEARCH, N_ORACLE = 1000, 500
B_SMALL = 256                       # largest small-batch size: 2048 probes
N2, KC2 = 200_000, 256              # the inner-product index
# the large-kc index (the shape of benchmarks/deep1b_shape.py)
N3, D3, KC3, M3, W3, NQ3 = 2_000_000, 96, 1 << 18, 16, 32, 4096
NQ3_BIG = 32768                     # B*w = 4*kc: the grouped posting scan

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates): device
# memory bytes/s, f32 FLOP/s outside the tensor cores, bf16 FLOP/s.
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12


def bound(nbytes: float, ops: float, peak_ops: float) -> dict:
    """Least time the card could take: bytes moved once over the memory
    rate, or operations over the peak rate of their type, whichever is
    larger."""
    t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * ops / peak_ops
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=float(nbytes), bound_ops=float(ops))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median device time of fn() over `reps` runs after one warm-up;
    `inner` back-to-back calls per run for kernels of a few microseconds."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, calls: int = 10, match: str | None = None) -> float:
    """Device time of fn() per call: the summed device time of the
    operations it launches (torch.profiler's CUDA trace), after one
    warm-up; with `match`, of the kernels whose name holds it. Unlike CUDA
    events around back-to-back calls it leaves out the host's time, which
    bounds calls of a few microseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA and (
                match is None or match in e.key):
            t = getattr(e, "self_device_time_total", None)
            us += t if t is not None else getattr(e, "self_cuda_time_total",
                                                  0.0)
    return us / 1e3 / calls


@contextlib.contextmanager
def env(**values):
    """Environment variables set for the block, restored after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


@contextlib.contextmanager
def norms_off(index):
    """IVFADC_NORMS=off for the block. The variable is read when the dense
    view is built (as in the JAX package), so the view is dropped before
    and after."""
    index.store._invalidate()
    try:
        with env(IVFADC_NORMS="off"):
            yield
    finally:
        index.store._invalidate()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def close_scan(kern, plain, what: str, min_agree: float = 0.999,
               rtol: float = 1e-5):
    """A scan kernel's (scores, payloads) against its plain version's on
    real data: the same +inf pattern, scores to `rtol` relative (bf16
    products summed in f32 in another order; scores ~1e2), payloads equal
    on >= min_agree. Returns (max abs error, payload agreement)."""
    import torch
    kd, kp = kern
    pd, pp = plain
    fin = torch.isfinite(pd)
    check(torch.equal(torch.isfinite(kd), fin), f"{what}: +inf pattern")
    torch.testing.assert_close(kd[fin], pd[fin], rtol=rtol, atol=1e-3)
    agree = (kp == pp).float().mean().item()
    check(agree >= min_agree, f"{what}: payloads agree on {agree:.5f}")
    return (kd[fin] - pd[fin]).abs().max().item(), agree


def exact_topk(kern, plain, k: int, what: str):
    """Exact-merge buffers against the plain version's on real data: per
    probe the sorted k smallest distances agree (1e-5 relative: another
    f32 summation order) and their payloads are equal wherever the
    distance is not tied (within 1e-3) with a neighbour. Returns (max abs
    error, payload agreement over the untied places)."""
    import torch
    kd, kp = (a.reshape(-1, a.shape[-1]) for a in kern)
    pd, pp = (a.reshape(-1, a.shape[-1]) for a in plain)
    ks, ki = torch.sort(kd, dim=1)
    ps, pi = torch.sort(pd, dim=1)
    ks, ps = ks[:, :k], ps[:, :k]
    fin = torch.isfinite(ps)
    check(torch.equal(torch.isfinite(ks), fin), f"{what}: +inf pattern")
    torch.testing.assert_close(ks[fin], ps[fin], rtol=1e-5, atol=1e-3)
    kpay = torch.gather(kp, 1, ki[:, :k])
    ppay = torch.gather(pp, 1, pi[:, :k])
    gap = torch.diff(ps, dim=1).abs() <= 1e-3
    tied = torch.zeros_like(fin)
    tied[:, 1:] |= gap
    tied[:, :-1] |= gap
    live = fin & ~tied
    agree = (kpay == ppay)[live].float().mean().item()
    check(agree >= 0.999, f"{what}: untied payloads agree on {agree:.5f}")
    return (ks[fin] - ps[fin]).abs().max().item(), agree


def coarse_layout(rec: dict, kind: str, B: int, kc: int, d: int,
                  w: int) -> dict:
    """A coarse kernel record with its launch plan (query tile bq,
    centroid tile bc, splits S of the table, grid) and its share of the
    bound (bound_ms / ms)."""
    import torch
    from ivfadc_tpu_torch.ops import coarse_scan
    p = coarse_scan.plan(B, d, kc, w, kind, torch.device("cuda"))
    return dict(rec, plan=p, bq=p["bq"], bc=p["bc"], splits=p["splits"],
                grid=p["grid"], share_of_bound=rec["bound_ms"] / rec["ms"])


def scan_layout(rec: dict, fn, kern, d: int, pb: int, nf: int,
                k_out: int = 0, calls: int = 10) -> dict:
    """A grouped-scan record with the kernel's device time per call, its
    share of the bound (bound_ms / device_ms) and its launch shape
    (resident blocks per SM from the occupancy API, shared bytes, staged
    tiles, fold buffer, registers, spilled bytes)."""
    from ivfadc_tpu_torch.ops import dense_scan
    return dict(rec, **scan_device_ms(rec, fn, "grouped_scan", calls),
                launch_shape=dense_scan.scan_fit(kern.fn, d, pb, nf, k_out))


def scan_device_ms(rec: dict, fn, match: str, calls: int) -> dict:
    """A kernel's device time per call of fn and its share of the bound.
    torch.profiler's trace at times keeps no event of the kernel (seen in
    the two_level phase), so it is asked up to five times; then CUDA
    events around single calls stand in, which hold host time too and are
    close to the kernel's only where it runs long (the scans)."""
    for _ in range(5):
        dms = device_ms(fn, calls, match=match)
        if dms > 0.0:
            return dict(device_ms=dms, device_ms_by="profiler",
                        share_of_bound=rec["bound_ms"] / dms)
    dms = cuda_ms(fn, reps=calls)
    return dict(device_ms=dms, device_ms_by="cuda_events",
                share_of_bound=rec["bound_ms"] / dms)


def probe_layout(rec: dict, fn, kern, d: int, nf: int, k_out: int = 0,
                 calls: int = 10) -> dict:
    """A per-probe scan record with the kernel's device time per call, its
    share of the bound (bound_ms / device_ms) and its launch shape
    (`dense_scan.probe_fit`: resident blocks per SM, the
    persistent grid, shared bytes, ring stages, registers, spills)."""
    from ivfadc_tpu_torch.ops import dense_scan
    return dict(rec, **scan_device_ms(rec, fn, "probe_scan", calls),
                launch_shape=dense_scan.probe_fit(kern.fn, d, nf, k_out))


def topk_layout(rec: dict, fn, B: int, N: int, k: int, payload: bool,
                calls: int = 10) -> dict:
    """A top-k record with the kernel's device time per call, its share of
    the bound (bound_ms / device_ms) and its launch shape
    (`topk.topk_fit`: warps a block, resident blocks per SM, shared bytes,
    registers, spills, the grid)."""
    from ivfadc_tpu_torch.ops import topk
    return dict(rec, **scan_device_ms(rec, fn, "topk", calls),
                launch_shape=topk.topk_fit(B, N, k, payload))


def topk_bytes(B: int, N: int, k: int, payload: bool) -> int:
    """Bytes a top-k call must move: the (B, N) values once, the k
    winners' payloads (kernel 4) and the (B, k) outputs."""
    return 4 * B * N + (4 * B * k if payload else 0) + 8 * B * k


def rank_record(cells, offsets, sizes, kc: int, pb: int,
                engine: str) -> dict:
    """Kernel 2 (engine v1) or 11 (v2) on one path's cells: the fused tile
    prep (`cell_rank.tile_slots`, one launch: counts, tile map, row,
    inv_row) and the ranks-mode call (`cell_ranks`), each bit-equal to its
    plain version, the fused call twice in a row (the grid barrier resets
    itself); CUDA-event and device times (torch.profiler) of both, the
    fused call's device operations, bounds and launch shape."""
    import torch
    from ivfadc_tpu_torch.ops import cell_rank
    P = cells.numel()
    T = cell_rank.t_max(P, kc, pb)

    def fused():
        return cell_rank.tile_slots(cells, offsets, sizes, kc=kc, pb=pb,
                                    engine=engine)

    def plain():
        return cell_rank.tile_slots_plain(cells, offsets, sizes, kc=kc,
                                          pb=pb)

    def ranks():
        return cell_rank.cell_ranks(cells, kc=kc, engine=engine)

    first, second, want = fused(), fused(), plain()
    check(all(torch.equal(a, b) and torch.equal(a, c)
              for a, b, c in zip(first, second, want)),
          f"fused tile prep ({engine}, P={P}, kc={kc}, pb={pb}) differs")
    kr, pr = ranks(), cell_rank.cell_ranks_plain(cells, kc)
    check(torch.equal(kr[0], pr[0]) and torch.equal(kr[1], pr[1]),
          f"cell ranks ({engine}, P={P}, kc={kc}) differ")

    def library():
        # nearest library route: a stable sort by cell and the histogram
        return (torch.sort(cells, stable=True),
                torch.bincount(cells, minlength=kc))

    lib_ms = cuda_ms(library)
    ranks_mode = dict(
        ms=cuda_ms(ranks), plain_ms=cuda_ms(
            lambda: cell_rank.cell_ranks_plain(cells, kc)),
        library_ms=lib_ms, **bound(8 * P + 4 * kc, P, PEAK_F32))
    ranks_mode.update(scan_device_ms(ranks_mode, ranks, "rank", 10))
    ops = device_ops(fused)
    # cells in, int64 row and inv_row out, offsets and sizes in, counts
    # and the three tile arrays out
    rec = dict(
        source="ivfadc_tpu_torch/csrc/cell_rank.cu", max_abs_err=0.0,
        engine=engine, probes=P, kc=kc, pb=pb, T_max=T, bit_equal=True,
        repeat_bit_equal=True, ms=cuda_ms(fused), plain_ms=cuda_ms(plain),
        device_ms_all_ops=ops["device_ms"], device_ops=ops["ops"],
        library_ms=lib_ms, ranks_mode=ranks_mode,
        launch_shape=cell_rank.rank_fit(cells.device, kc, True),
        **bound(12 * P + 12 * kc + 12 * T + 8 * T * pb, P, PEAK_F32))
    return dict(rec, **scan_device_ms(rec, fused, "rank", 10))


def device_ops(fn, calls: int = 10) -> dict:
    """Device operations fn() launches per call and their device time
    (torch.profiler's CUDA trace), after one warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us += t if t is not None else getattr(e, "self_cuda_time_total",
                                                  0.0)
            n += e.count
    return dict(device_ms=us / 1e3 / calls, ops=n / calls)


def coarse_integer_ties(B: int, kc: int, d: int, w: int, n_plain: int,
                        seed: int) -> dict:
    """Kernels 7, 1 and 10 on an integer-valued table (entries in -2..2:
    every f32 sum exact, most scores tied, copies of one centroid row on
    both sides of every split boundary) against the plain versions on the
    first n_plain queries, bit for bit; all three kernels' cells equal."""
    import torch
    from ivfadc_tpu_torch.ops import coarse_scan
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-2, 3, (B, d), generator=g, device=dev).float()
    c = torch.randint(-2, 3, (kc, d), generator=g, device=dev).float()
    p = coarse_scan.plan(B, d, kc, w, "vbase", dev)
    span = p["bc"] * p["tiles_per_split"]
    for edge in range(span, kc, span):
        c[edge - 1] = c[edge] = c[0]
    cn = torch.sum(c * c, dim=1)
    eye = torch.eye(d, device=dev)
    k7 = coarse_scan.coarse_topw(q, c, w)
    k1 = coarse_scan.coarse_vbase(q, c, cn, eye, w, False)
    hi, lo = coarse_scan.hi_lo_split(c, eye, False)
    k10 = coarse_scan.coarse_vbase_v2(q, c, cn, eye, hi, lo, w, False)
    check(torch.equal(k7[0], k1[1]) and torch.equal(k10[1], k1[1]),
          f"integer ties at ({B}, {kc}): kernels 7, 1, 10 cells differ")
    qs = q[:n_plain]
    p7 = coarse_scan.coarse_topw_plain(qs, c, cn, w)
    p1 = coarse_scan.coarse_vbase_plain(qs, c, cn, eye, w, False)
    qn = torch.sum(qs * qs, dim=1, keepdim=True)
    check(torch.equal(k7[0][:n_plain], p7[1])
          and torch.equal(k7[1][:n_plain], torch.clamp_min(p7[0] + qn, 0.0)),
          f"integer ties at ({B}, {kc}): kernel 7 is not bit-equal")
    check(all(torch.equal(a[:n_plain], b) for a, b in zip(k1, p1)),
          f"integer ties at ({B}, {kc}): kernel 1 is not bit-equal")
    return dict(shape=[B, kc], d=d, w=w, plain_queries=n_plain,
                splits=p["splits"], bit_equal=True)


def tie_overlap(ids_a, d_a, ids_b, d_b) -> float:
    """Top-k overlap of result a with result b that also counts an id of a
    whose distance ties b's k-th distance (to 1e-4 relative): points with
    one PQ code in one cell score alike, and two routes may keep different
    ones of them at the k-th place."""
    hits = []
    for ia, da, ib, db in zip(ids_a, d_a, ids_b, d_b):
        hit = np.isin(ia, ib)
        tied = np.abs(da - db[-1]) <= 1e-4 * abs(db[-1])
        hits.append((hit | tied).mean())
    return float(np.mean(hits))


def ties_only(ids_a, d_a, ids_b, d_b) -> int:
    """Two top-k results with bit-equal distances whose ids may differ only
    among exactly tied distances: per row, every distance below the row's
    last holds the same set of ids in both. Returns the rows whose ids
    differ (at ties)."""
    check(np.array_equal(d_a, d_b), "distances differ")
    rows = 0
    for ia, da, ib in zip(ids_a, d_a, ids_b):
        if np.array_equal(ia, ib):
            continue
        rows += 1
        for val in np.unique(da[da < da[-1]]):
            check(set(ia[da == val]) == set(ib[da == val]),
                  f"ids differ at an untied distance {val}")
    return rows


def phase_kernels(index, queries):
    """Hold each kernel against its plain version on the main path's own
    inputs; returns the kernel records (launch counts filled in later)."""
    import torch
    from ivfadc_tpu_torch.ops import cell_rank, coarse_scan, dense_scan, topk

    dev = queries.device
    q = queries[:BATCH]
    c32 = index.coarse.centroids
    cn = torch.sum(c32 * c32, dim=1)
    rot = torch.eye(D, device=dev)
    records = {}

    # 1. coarse probe. Scores are f32 sums in another order than cuBLAS's,
    # so cells may differ where two centroids tie to a few ulps: require
    # >= 99.9% equal cells; where equal, v = bf16(-2(q - c)) is exact and
    # ||q - c||^2 agrees to 1e-5 relative.
    kv = coarse_scan.coarse_vbase(q, c32, cn, rot, W, False)
    pv = coarse_scan.coarse_vbase_plain(q, c32, cn, rot, W, False)
    same = kv[1] == pv[1]
    agree = same.float().mean().item()
    check(agree >= 0.999, f"coarse cells agree on {agree:.5f} < 0.999")
    check(torch.equal(kv[2][same], pv[2][same]), "coarse v differs")
    torch.testing.assert_close(kv[3][same], pv[3][same], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(kv[0], pv[0], rtol=1e-5, atol=1e-3)
    err = max((kv[3][same] - pv[3][same]).abs().max().item(),
              (kv[0] - pv[0]).abs().max().item())

    def lib_probe(qq):
        # nearest library route: score matmul + topk + centroid gather
        _, idx = torch.topk(cn[None, :] - 2.0 * (qq @ c32.T), W, dim=1,
                            largest=False)
        return c32[idx]

    records["coarse_probe"] = dict(
        source="ivfadc_tpu_torch/csrc/coarse_scan.cu",
        replaces="ivfadc_tpu/ops/coarse_scan.py:95", max_abs_err=err,
        cells_agree=agree,
        ms=cuda_ms(lambda: coarse_scan.coarse_vbase(q, c32, cn, rot, W,
                                                    False)),
        plain_ms=cuda_ms(lambda: coarse_scan.coarse_vbase_plain(
            q, c32, cn, rot, W, False)),
        library_ms=cuda_ms(lambda: lib_probe(q)),
        device_ms=device_ms(lambda: coarse_scan.coarse_vbase(
            q, c32, cn, rot, W, False)),
        library_device_ms=device_ms(lambda: lib_probe(q)),
        **bound(4 * (BATCH * D + KC * D + KC + D * D)
                + BATCH * W * (12 + 2 * D), 2.0 * BATCH * KC * D, PEAK_F32))
    records["coarse_probe"] = coarse_layout(records["coarse_probe"], "vbase",
                                            BATCH, KC, D, W)

    # 2. cell ranks and the fused tile prep on the probe's own cells and
    # the view's cells: exact
    view = index.store.device_view_dense(index.quantizer,
                                         index.config.scan_chunk)
    pb, nf = index.config.scan_pb, index.config.scan_fold_lanes
    records["cell_rank"] = dict(
        rank_record(kv[1].reshape(-1), view["offsets"], view["sizes"], KC,
                    pb, "v1"), replaces="ivfadc_tpu/ops/cell_rank.py:54")

    # 3. grouped scan on the main path's own tiles
    cells_q, _, v_q, base_q = coarse_scan.coarse_probe_vbase(
        q, c32, W, rot, False, True)
    tstart, tsize, v_t, b_t, row = dense_scan.place_tiles(
        cells_q, view["offsets"], view["sizes"], v_q, base_q, kc=KC, pb=pb)
    scan_args = (tstart, tsize, v_t, b_t, view["decoded"], view["scale"],
                 view["ids2d"], view["norms2d"])
    kw = dict(pb=pb, nf=nf, norm_coef=1.0)
    kd, kp = dense_scan.grouped_scan(*scan_args, **kw)
    pd, pp = dense_scan.grouped_scan_plain(*scan_args, **kw)
    fin = torch.isfinite(pd)
    check(torch.equal(torch.isfinite(kd), fin), "scan +inf pattern differs")
    # real data: bf16 products summed in f32 in another order than the
    # plain version's matmul; scores are ~1e2, hold them to 1e-5 relative
    torch.testing.assert_close(kd[fin], pd[fin], rtol=1e-5, atol=1e-3)
    id_agree = (kp == pp).float().mean().item()
    check(id_agree >= 0.999, f"scan ids agree on {id_agree:.5f} < 0.999")
    err = (kd[fin] - pd[fin]).abs().max().item()
    # integer-valued case on the same tiles: every f32 sum is exact, so the
    # kernel must match the plain version bit for bit
    g = torch.Generator(device=dev).manual_seed(7)
    dec_i = torch.randint(-3, 4, view["decoded"].shape, generator=g,
                          device=dev).to(torch.int8)
    v_i = torch.randint(-4, 5, v_t.shape, generator=g, device=dev) \
        .to(torch.bfloat16)
    b_i = torch.where(torch.isfinite(b_t),
                      torch.randint(0, 100, b_t.shape, generator=g,
                                    device=dev).float(), float("inf"))
    n_i = torch.randint(0, 50, view["norms2d"].shape, generator=g,
                        device=dev).float()
    int_args = (tstart, tsize, v_i, b_i, dec_i, torch.ones(D, device=dev),
                view["ids2d"], n_i)
    ki = dense_scan.grouped_scan(*int_args, **kw)
    pi = dense_scan.grouped_scan_plain(*int_args, **kw)
    check(torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1]),
          "integer-valued grouped scan is not bit-exact")
    # bound: every probed cell's rows (int8 row, id, norm) read once, the
    # live tiles' v and base rows, every output row written; the products
    # of each probe with each row of its cell at the bf16 rate
    sizes64 = view["sizes"].to(torch.int64)
    live_tiles = int((tsize > 0).sum().item())
    cell_rows = int(sizes64[torch.unique(cells_q)].sum().item())
    probe_rows = int(sizes64[cells_q.to(torch.int64)].sum().item())
    records["grouped_scan"] = dict(
        source="ivfadc_tpu_torch/csrc/dense_scan.cu",
        replaces="ivfadc_tpu/ops/pallas_scan.py:171", max_abs_err=err,
        ids_agree=id_agree, integer_case_bit_exact=True,
        tiles=int(tsize.shape[0]), live_tiles=live_tiles,
        ms=cuda_ms(lambda: dense_scan.grouped_scan(*scan_args, **kw)),
        plain_ms=cuda_ms(lambda: dense_scan.grouped_scan_plain(*scan_args,
                                                               **kw), reps=3),
        library_ms=None,             # no single PyTorch call scans CSR cells
        **bound(cell_rows * (D + 8) + live_tiles * pb * (2 * D + 4)
                + 8 * tsize.numel() + kd.numel() * 8,
                2.0 * D * probe_rows, PEAK_BF16))
    records["grouped_scan"] = scan_layout(
        records["grouped_scan"],
        lambda: dense_scan.grouped_scan(*scan_args, **kw), dense_scan.KERNEL,
        D, pb, nf)

    # 8a at these tiles (what IVFADC_NORMS=off runs): the same scan with the
    # row norms computed in the kernel; its record is completed at stage 2's
    # shape in the two_level phase
    knorm_args = scan_args[:7] + (None,)
    nd, np_ = dense_scan.grouped_scan(*knorm_args, **kw)
    qd, qp = dense_scan.grouped_scan_plain(*knorm_args, **kw)
    check(torch.equal(torch.isfinite(nd), torch.isfinite(qd)),
          "in-kernel-norms scan +inf pattern differs")
    fin_n = torch.isfinite(qd)
    torch.testing.assert_close(nd[fin_n], qd[fin_n], rtol=1e-5, atol=1e-3)
    knorm_agree = (np_ == qp).float().mean().item()
    check(knorm_agree >= 0.999, f"in-kernel-norms scan ids agree on "
                                f"{knorm_agree:.5f} < 0.999")
    ki = dense_scan.grouped_scan(*int_args[:7], None, **kw)
    pi = dense_scan.grouped_scan_plain(*int_args[:7], None, **kw)
    check(torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1]),
          "integer-valued in-kernel-norms scan is not bit-exact")
    records["grouped_scan_knorm@posting"] = dict(
        max_abs_err=(nd[fin_n] - qd[fin_n]).abs().max().item(),
        ids_agree=knorm_agree, integer_case_bit_exact=True,
        ms=cuda_ms(lambda: dense_scan.grouped_scan(*knorm_args, **kw)),
        plain_ms=cuda_ms(lambda: dense_scan.grouped_scan_plain(
            *knorm_args, **kw), reps=3),
        **bound(cell_rows * (D + 4) + live_tiles * pb * (2 * D + 4)
                + 8 * tsize.numel() + nd.numel() * 8,
                2.0 * D * probe_rows + 2.0 * D * int(
                    (tsize.to(torch.int64)).sum().item()), PEAK_BF16))
    records["grouped_scan_knorm@posting"] = scan_layout(
        records["grouped_scan_knorm@posting"],
        lambda: dense_scan.grouped_scan(*knorm_args, **kw),
        dense_scan.NORMS_KERNEL, D, pb, nf)

    # 8b at these tiles, without the id stream: pos8 block-index payloads
    # (the variant large-kc batches run, checked at their own shape in the
    # two_level phase): here the integer-valued case, bit for bit
    pos_args = int_args[:6] + (None, None)
    ki = dense_scan.grouped_scan(*pos_args, **kw, pos8=True)
    pi = dense_scan.grouped_scan_plain(*pos_args, **kw, pos8=True)
    check(ki[1].dtype == torch.int8 and torch.equal(ki[0], pi[0])
          and torch.equal(ki[1], pi[1]),
          "integer-valued pos8 grouped scan is not bit-exact")
    pos8_int_blocks = int(ki[1].max().item())

    # 8d: the exact merge on these tiles (in-kernel norms, slot payloads)
    ekw = dict(pb=pb, nf=128, norm_coef=1.0, merge="exact", k_out=TOPK)
    ex_args = scan_args[:6] + (None, None)
    ek = dense_scan.grouped_scan(*ex_args, **ekw)
    ep = dense_scan.grouped_scan_plain(*ex_args, **ekw)
    ex_err, ex_agree = exact_topk(ek, ep, TOPK, "exact grouped scan")
    ki = dense_scan.grouped_scan(*pos_args, **ekw)
    pi = dense_scan.grouped_scan_plain(*pos_args, **ekw)
    check(torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1]),
          "integer-valued exact grouped scan is not bit-exact")
    tile_rows = int(tsize.to(torch.int64).sum().item())
    records["grouped_scan_exact"] = dict(
        source="ivfadc_tpu_torch/csrc/dense_scan.cu",
        replaces="ivfadc_tpu/ops/pallas_scan.py:355", max_abs_err=ex_err,
        topk_payloads_agree=ex_agree, integer_case_bit_exact=True,
        ms=cuda_ms(lambda: dense_scan.grouped_scan(*ex_args, **ekw)),
        plain_ms=cuda_ms(lambda: dense_scan.grouped_scan_plain(
            *ex_args, **ekw), reps=3),
        library_ms=None,
        **bound(cell_rows * D + live_tiles * pb * (2 * D + 4)
                + 8 * tsize.numel() + ek[0].numel() * 8,
                2.0 * D * (probe_rows + tile_rows), PEAK_BF16))
    records["grouped_scan_exact"] = scan_layout(
        records["grouped_scan_exact"],
        lambda: dense_scan.grouped_scan(*ex_args, **ekw),
        dense_scan.GROUPED_KERNELS["exact", "int8"], D, pb, 128, TOPK)
    del ek, ep

    # 8e: in-kernel extraction at k = 10 (ids2d, in-kernel norms): each
    # probe's 10 best leave the kernel. Integer-valued: bit for bit
    xkw = dict(kw, extract_k=TOPK)
    xk = dense_scan.grouped_scan(*knorm_args, **xkw)
    xp = dense_scan.grouped_scan_plain(*knorm_args, **xkw)
    x_err, x_agree = close_scan(xk, xp, "extraction")
    ki = dense_scan.grouped_scan(*int_args[:7], None, **xkw)
    pi = dense_scan.grouped_scan_plain(*int_args[:7], None, **xkw)
    check(torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1]),
          "integer-valued extraction is not bit-exact")
    records["grouped_scan_extract"] = dict(
        source="ivfadc_tpu_torch/csrc/dense_scan.cu",
        replaces="ivfadc_tpu/ops/pallas_scan.py:372", max_abs_err=x_err,
        ids_agree=x_agree, integer_case_bit_exact=True, k=TOPK,
        ms=cuda_ms(lambda: dense_scan.grouped_scan(*knorm_args, **xkw)),
        plain_ms=cuda_ms(lambda: dense_scan.grouped_scan_plain(
            *knorm_args, **xkw), reps=3),
        library_ms=None,
        **bound(cell_rows * (D + 4) + live_tiles * pb * (2 * D + 4)
                + 8 * tsize.numel() + xk[0].numel() * 8,
                2.0 * D * (probe_rows + tile_rows), PEAK_BF16))
    records["grouped_scan_extract"] = scan_layout(
        records["grouped_scan_extract"],
        lambda: dense_scan.grouped_scan(*knorm_args, **xkw),
        dense_scan.GROUPED_KERNELS["extract", "int8"], D, pb, nf, TOPK)
    del xk, xp

    # 8c: the bf16 cache (rows read as they are) through kernel 3's and
    # 8a's variants, on the same tiles; integer-valued bf16 rows bit for bit
    bview = index.store.device_view_dense(index.quantizer,
                                          index.config.scan_chunk,
                                          cache="bf16")
    b_args = (tstart, tsize, v_t, b_t, bview["decoded"], None,
              bview["ids2d"], bview["norms2d"])
    dec_b = dec_i.to(torch.bfloat16)
    for name, args_b, int_b, nbytes, nops, variant in (
            ("grouped_scan_bf16", b_args,
             (tstart, tsize, v_i, b_i, dec_b, None, view["ids2d"], n_i),
             cell_rows * (2 * D + 8), 2.0 * D * probe_rows, "ids"),
            ("grouped_scan_knorm_bf16", b_args[:7] + (None,),
             (tstart, tsize, v_i, b_i, dec_b, None, view["ids2d"], None),
             cell_rows * (2 * D + 4), 2.0 * D * (probe_rows + tile_rows),
             "knorm")):
        bk = dense_scan.grouped_scan(*args_b, **kw)
        bp = dense_scan.grouped_scan_plain(*args_b, **kw)
        b_err, b_agree = close_scan(bk, bp, name)
        ki = dense_scan.grouped_scan(*int_b, **kw)
        pi = dense_scan.grouped_scan_plain(*int_b, **kw)
        check(torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1]),
              f"integer-valued {name} is not bit-exact")
        records[name] = dict(
            source="ivfadc_tpu_torch/csrc/dense_scan.cu",
            replaces="ivfadc_tpu/ops/pallas_scan.py:299", max_abs_err=b_err,
            ids_agree=b_agree, integer_case_bit_exact=True,
            ms=cuda_ms(lambda: dense_scan.grouped_scan(*args_b, **kw)),
            plain_ms=cuda_ms(lambda: dense_scan.grouped_scan_plain(
                *args_b, **kw), reps=3),
            library_ms=None,
            **bound(nbytes + live_tiles * pb * (2 * D + 4)
                    + 8 * tsize.numel() + bk[0].numel() * 8, nops,
                    PEAK_BF16))
        records[name] = scan_layout(
            records[name], lambda: dense_scan.grouped_scan(*args_b, **kw),
            dense_scan.GROUPED_KERNELS[variant, "bf16"], D, pb, nf)
        del bk, bp
    records["grouped_scan_pos8@sift1m_integer"] = dict(
        integer_case_bit_exact=True, max_block=pos8_int_blocks)

    # 4. top-k merge of the scan's candidates (ties and +inf included):
    # exact, payloads too.
    flat_d = kd[row].reshape(BATCH, W * nf)
    flat_p = kp[row].reshape(BATCH, W * nf)
    kt = topk.topk_lastdim_payload(flat_d, flat_p, TOPK)
    pt = topk.topk_lastdim_payload_plain(flat_d, flat_p, TOPK)
    check(torch.equal(kt[0], pt[0]) and torch.equal(kt[1], pt[1]),
          "top-k differs")
    records["topk_payload"] = dict(
        source="ivfadc_tpu_torch/csrc/topk.cu",
        replaces="ivfadc_tpu/ops/topk.py:79", max_abs_err=0.0,
        ms=cuda_ms(lambda: topk.topk_lastdim_payload(flat_d, flat_p, TOPK)),
        plain_ms=cuda_ms(lambda: topk.topk_lastdim_payload_plain(
            flat_d, flat_p, TOPK)),
        library_ms=cuda_ms(lambda: torch.gather(
            flat_p, 1, torch.topk(flat_d, TOPK, dim=1, largest=False)[1])),
        **bound(topk_bytes(BATCH, W * nf, TOPK, True),
                float(flat_d.numel()), PEAK_F32))
    records["topk_payload"] = topk_layout(
        records["topk_payload"],
        lambda: topk.topk_lastdim_payload(flat_d, flat_p, TOPK), BATCH,
        W * nf, TOPK, True)
    records.update(phase_kernels_small(index, queries, bview))
    records.update(phase_kernels_engines(index, queries, kv[1], view, bview))
    return records


def phase_kernels_engines(index, queries, cells16k, view, bview):
    """Kernels 9-11 (the opt-in engines) against their plain versions on
    their paths' inputs: v2 cell ranks on the B=16384 probe's cells, the v2
    coarse probe at B=16384 (and under a random orthogonal rotation), the
    qc scan on every tile of a B=8192 batch (int8 and bf16 caches, and
    under the rotation), with kernel 3, 8a and the placement's gathers at
    the same tiles beside it."""
    import torch
    from ivfadc_tpu_torch.ops import cell_rank, coarse_scan, dense_scan

    dev = queries.device
    records = {}
    # 11. v2 cell ranks and fused prep: kernel 2's bits and the plain
    # version's
    cells = cells16k.reshape(-1)
    pb = index.config.scan_pb
    k2 = cell_rank.cell_ranks(cells, kc=KC, engine="v2")
    k1 = cell_rank.cell_ranks(cells, kc=KC, engine="v1")
    t2 = cell_rank.tile_slots(cells, view["offsets"], view["sizes"], kc=KC,
                              pb=pb, engine="v2")
    t1 = cell_rank.tile_slots(cells, view["offsets"], view["sizes"], kc=KC,
                              pb=pb, engine="v1")
    check(all(torch.equal(a, b) for a, b in zip(k2 + t2, k1 + t1)),
          "v2 cell ranks differ from kernel 2's")
    records["cell_rank_v2"] = dict(
        rank_record(cells, view["offsets"], view["sizes"], KC, pb, "v2"),
        replaces="ivfadc_tpu/ops/cell_rank.py:101", equal_to_kernel_2=True)

    # 10. v2 coarse probe at B=16384: kernel 1's cells bit for bit; v within
    # one bf16 ulp of the plain version (bit-equal without a rotation, where
    # the cells agree); base = 2 cdist, the wrapper's formula
    q = queries[:BATCH]
    c32 = index.coarse.centroids
    cn = torch.sum(c32 * c32, dim=1)
    g = torch.Generator(device="cpu").manual_seed(11)
    rot_r = torch.linalg.qr(torch.randn(D, D, generator=g))[0].to(dev)
    eye = torch.eye(D, device=dev)
    v2 = {}
    for tag, rot, apply_rot in (("", eye, False), ("@rotated", rot_r, True)):
        hi, lo = coarse_scan.hi_lo_split(c32, rot, apply_rot)
        kv = coarse_scan.coarse_vbase_v2(q, c32, cn, rot, hi, lo, W,
                                         apply_rot)
        pv = coarse_scan.coarse_vbase_v2_plain(q, c32, cn, rot, hi, lo, W,
                                               apply_rot)
        v1cells = coarse_scan.coarse_vbase(q, c32, cn, rot, W, apply_rot)[1]
        check(torch.equal(kv[1], v1cells), f"v2{tag} cells differ from "
                                           f"kernel 1's")
        same = kv[1] == pv[1]
        agree = same.float().mean().item()
        check(agree >= 0.999, f"v2{tag} cells agree on {agree:.5f}")
        torch.testing.assert_close(kv[0], pv[0], rtol=1e-5, atol=1e-3)
        if apply_rot:
            torch.testing.assert_close(kv[2][same].float(),
                                       pv[2][same].float(), rtol=2 ** -7,
                                       atol=1e-6)
        else:
            check(torch.equal(kv[2][same], pv[2][same]), "v2 v differs")
        cells_w, cd_w, _, base_w = coarse_scan.coarse_probe_vbase(
            q, c32, W, rot, apply_rot, True, engine="v2",
            rot_orthogonal=True)
        check(torch.equal(cells_w, kv[1]) and torch.equal(base_w, cd_w + cd_w),
              f"v2{tag} base is not 2 cdist")
        v_err = (kv[2][same].float() - pv[2][same].float()).abs().max().item()
        v2[tag] = dict(
            cells_agree_plain=agree, cells_equal_kernel_1=True,
            v_max_abs_err=v_err,
            max_abs_err=max(v_err, (kv[0] - pv[0]).abs().max().item()),
            ms=cuda_ms(lambda: coarse_scan.coarse_vbase_v2(
                q, c32, cn, rot, hi, lo, W, apply_rot)),
            plain_ms=cuda_ms(lambda: coarse_scan.coarse_vbase_v2_plain(
                q, c32, cn, rot, hi, lo, W, apply_rot)),
            hi_lo_split_ms=cuda_ms(lambda: coarse_scan.hi_lo_split(
                c32, rot, apply_rot)),
            **bound(4 * (BATCH * D + KC * D + KC + D * D) + 4 * KC * D
                    + BATCH * W * (8 + 2 * D),
                    2.0 * BATCH * KC * D + (2.0 * BATCH * D * D
                                            if apply_rot else 0.0),
                    PEAK_F32))
        del kv, pv, hi, lo

    def lib_probe(qq):
        # nearest library route: score matmul + topk + centroid gather
        _, idx = torch.topk(cn[None, :] - 2.0 * (qq @ c32.T), W, dim=1,
                            largest=False)
        return c32[idx]

    def lib_probe_rot(qq):
        # the same route with the rotation applied to each winner's residual
        _, idx = torch.topk(cn[None, :] - 2.0 * (qq @ c32.T), W, dim=1,
                            largest=False)
        return (qq[:, None, :] - c32[idx]) @ rot_r

    hi0, lo0 = coarse_scan.hi_lo_split(c32, eye, False)
    records["coarse_probe_v2"] = coarse_layout(dict(
        v2[""], source="ivfadc_tpu_torch/csrc/coarse_scan.cu",
        replaces="ivfadc_tpu/ops/coarse_scan.py:169",
        library_ms=cuda_ms(lambda: lib_probe(q)),
        device_ms=device_ms(lambda: coarse_scan.coarse_vbase_v2(
            q, c32, cn, eye, hi0, lo0, W, False)),
        library_device_ms=device_ms(lambda: lib_probe(q)),
        rotated=dict(v2["@rotated"],
                     library_ms=cuda_ms(lambda: lib_probe_rot(q)))),
        "vbase_v2", BATCH, KC, D, W)

    # 9. the qc scan on every tile of a B=8192 batch (the engines phase's
    # batch), against its plain version; kernel 3, 8a and the placement's
    # two gathers (what qc removes) at the same tiles
    bq = queries[:BATCH_QC]
    pb, nf = index.config.scan_pb, index.config.scan_fold_lanes
    cells_q, _, v_q, base_q = coarse_scan.coarse_probe_vbase(
        bq, c32, W, eye, False, True)
    P = BATCH_QC * W
    sizes64 = view["sizes"].to(torch.int64)
    cell_rows = int(sizes64[torch.unique(cells_q)].sum().item())
    probe_rows = int(sizes64[cells_q.to(torch.int64)].sum().item())
    for name, vw, dec_ok in (("grouped_scan_qc", view, True),
                             ("grouped_scan_qc_bf16", bview, False)):
        rots = ((False, None),) if not dec_ok else ((False, None),
                                                   (True, rot_r))
        rec = {}
        for apply_rot, rot in rots:
            args = dense_scan.qc_tile_inputs(
                cells_q, vw["offsets"], vw["sizes"], bq, c32, rot, D, kc=KC,
                pb=pb)[:7] + (vw["decoded"], vw["scale"], vw["ids2d"])
            kw = dict(pb=pb, nf=nf, norm_coef=1.0, base_mult=2.0,
                      apply_rot=apply_rot)
            kd, kp = dense_scan.grouped_scan_qc(*args, **kw)
            pd, pp = dense_scan.grouped_scan_qc_plain(*args, **kw)
            # under the rotation the kernel sums r R in another order than
            # the plain matmul, and bf16(-2 r R) may round the other way:
            # one bf16 ulp of one v element moves a score by 2^-8 of its
            # term, so 1e-4 relative and 99.9% of the payloads there
            err, agree = close_scan(
                (kd, kp), (pd, pp), f"{name} (rotation {apply_rot})",
                min_agree=0.999 if apply_rot else 0.99999,
                rtol=1e-4 if apply_rot else 1e-5)
            tstart, tsize = args[0], args[1]
            T = tstart.numel()
            tile_rows = int(tsize.to(torch.int64).sum().item())
            live_slots = int((args[3] >= 0).sum().item())
            part = dict(
                max_abs_err=err, ids_agree=agree, tiles=T,
                live_tiles=int((tsize > 0).sum().item()),
                ms=cuda_ms(lambda: dense_scan.grouped_scan_qc(*args, **kw)),
                plain_ms=cuda_ms(lambda: dense_scan.grouped_scan_qc_plain(
                    *args, **kw), reps=3),
                # cell rows (row, id) read once, each slot's query index and
                # each tile's cell, start and size, the probed queries and
                # centroids, every output row written; the products of each
                # probe with each row of its cell and each tile's row
                # squares at the bf16 rate (the rotation in the prologue)
                **bound(cell_rows * ((D if dec_ok else 2 * D) + 4)
                        + 4 * T * pb + 12 * T + 4 * (BATCH_QC + KC) * D
                        + (2 * D * D if apply_rot else 0) + kd.numel() * 8,
                        2.0 * D * (probe_rows + tile_rows)
                        + (2.0 * D * D * live_slots if apply_rot else 0.0),
                        PEAK_BF16))
            part = scan_layout(
                part, lambda: dense_scan.grouped_scan_qc(*args, **kw),
                dense_scan.QC_KERNELS["int8" if dec_ok else "bf16"], D, pb,
                nf)
            # integer-valued inputs on the same tiles: bit for bit
            gi = torch.Generator(device=dev).manual_seed(17)
            dec_i = torch.randint(-3, 4, vw["decoded"].shape, generator=gi,
                                  device=dev)
            dec_i = dec_i.to(torch.int8 if dec_ok else torch.bfloat16)
            q_i = torch.randint(-4, 5, args[4].shape, generator=gi,
                                device=dev).float()
            c_i = torch.randint(-4, 5, args[5].shape, generator=gi,
                                device=dev).float()
            rot_i = torch.zeros((D, D), device=dev)
            rot_i[torch.arange(D, device=dev),
                  torch.randperm(D, generator=g).to(dev)] = 1
            int_args = args[:4] + (q_i, c_i, rot_i.to(torch.bfloat16), dec_i,
                                   torch.ones(D, device=dev) if dec_ok
                                   else None, args[9])
            ki = dense_scan.grouped_scan_qc(*int_args, **kw)
            pi = dense_scan.grouped_scan_qc_plain(*int_args, **kw)
            check(torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1]),
                  f"integer-valued {name} (rotation {apply_rot}) is not "
                  f"bit-exact")
            part["integer_case_bit_exact"] = True
            if apply_rot:
                rec["rotated"] = part
            else:
                rec.update(part)
            del kd, kp, pd, pp, ki, pi, dec_i
        rec.update(source="ivfadc_tpu_torch/csrc/dense_scan.cu",
                   replaces="ivfadc_tpu/ops/pallas_scan.py:407",
                   batch=BATCH_QC, library_ms=None)
        records[name] = rec
    # the placement route at the same B=8192 tiles: its two gathers, kernel
    # 3 (cached norms) and 8a (in-kernel norms, qc's arithmetic)
    c_t, tstart, tsize, row, inv_row = dense_scan._tile_slots(
        cells_q, view["offsets"], view["sizes"], kc=KC, pb=pb,
        rank_engine="v1")
    v_pad = torch.cat([v_q.reshape(P, D),
                       torch.zeros((1, D), dtype=torch.bfloat16, device=dev)])
    base_pad = torch.cat([base_q.reshape(P, 1),
                          torch.full((1, 1), float("inf"), device=dev)])
    v_t, b_t = v_pad[inv_row], base_pad[inv_row]
    pl_args = (tstart, tsize, v_t, b_t, view["decoded"], view["scale"],
               view["ids2d"])
    kw = dict(pb=pb, nf=nf, norm_coef=1.0)
    records["grouped_scan_qc"]["at_b8192"] = dict(
        placement_gathers_ms=cuda_ms(lambda: (v_pad[inv_row],
                                              base_pad[inv_row])),
        grouped_scan_ms=cuda_ms(lambda: dense_scan.grouped_scan(
            *pl_args, view["norms2d"], **kw)),
        grouped_scan_knorm_ms=cuda_ms(lambda: dense_scan.grouped_scan(
            *pl_args, None, **kw)))
    return records


def phase_kernels_small(index, queries, bview):
    """Kernels 5-7 and kernel 5's exact-merge and bf16 variants against
    their plain versions on the small-batch path's own inputs at B=256,
    w=8 (2048 probes); `bview` is the bf16 dense view."""
    import torch
    from ivfadc_tpu_torch.ops import coarse_scan, dense_scan, topk

    dev = queries.device
    q = queries[:B_SMALL]
    c32 = index.coarse.centroids
    cn = torch.sum(c32 * c32, dim=1)
    rot = torch.eye(D, device=dev)
    nf = index.config.scan_fold_lanes
    view = index.store.device_view_dense(index.quantizer,
                                         index.config.scan_chunk)
    records = {}

    # 7. exact top-w probe: against its plain version (cells may differ
    # only at few-ulp ties; distances to 1e-5 relative), and against the
    # fused probe kernel, whose score code it shares: equal cells
    kcells, kd = coarse_scan.coarse_topw(q, c32, W)
    pvals, pcells = coarse_scan.coarse_topw_plain(q, c32, cn, W)
    pd = torch.clamp_min(pvals + torch.sum(q * q, dim=1, keepdim=True), 0.0)
    agree = (kcells == pcells).float().mean().item()
    check(agree >= 0.999, f"top-w cells agree on {agree:.5f} < 0.999")
    torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-3)
    cells_q, _, v_q, base_q = coarse_scan.coarse_probe_vbase(
        q, c32, W, rot, False, True)
    check(torch.equal(kcells, cells_q), "top-w cells differ from kernel 1's")

    def lib_topw():
        return torch.topk(cn[None, :] - 2.0 * (q @ c32.T), W, dim=1,
                          largest=False)

    records["coarse_topw"] = dict(
        source="ivfadc_tpu_torch/csrc/coarse_scan.cu",
        replaces="ivfadc_tpu/ops/coarse_scan.py:47",
        max_abs_err=(kd - pd).abs().max().item(), cells_agree=agree,
        equals_fused_probe_cells=True,
        ms=cuda_ms(lambda: coarse_scan.coarse_topw(q, c32, W), inner=10),
        plain_ms=cuda_ms(lambda: coarse_scan.coarse_topw_plain(q, c32, cn,
                                                               W)),
        library_ms=cuda_ms(lib_topw, inner=10),
        device_ms=device_ms(lambda: coarse_scan.coarse_topw(q, c32, W)),
        library_device_ms=device_ms(lib_topw),
        integer_ties=coarse_integer_ties(B_SMALL, KC, D, W, B_SMALL, 7),
        **bound(4 * (B_SMALL * D + KC * D + KC) + 8 * B_SMALL * W,
                2.0 * B_SMALL * KC * D, PEAK_F32))
    records["coarse_topw"] = coarse_layout(records["coarse_topw"], "topw",
                                           B_SMALL, KC, D, W)

    # 5. per-probe scan on the path's own probes
    cells64 = cells_q.to(torch.int64)
    P = B_SMALL * W
    starts, sizes = view["offsets"][cells64], view["sizes"][cells64]
    scale = view["scale"].to(torch.bfloat16).to(torch.float32)
    plain_args = (starts.reshape(P), sizes.reshape(P), base_q.reshape(P),
                  v_q.reshape(P, D), view["decoded"], scale)
    kw = dict(k_out=TOPK, chunk=index.config.scan_chunk, nf=nf)
    ksd, ksp = dense_scan.dense_scan(starts, sizes, v_q, base_q,
                                     view["decoded"], view["scale"],
                                     norm_coef=1.0, **kw)
    psd, psp = dense_scan.probe_scan_plain(*plain_args, nf=nf, norm_coef=1.0)
    ksd, ksp = ksd.reshape(P, nf), ksp.reshape(P, nf)
    fin = torch.isfinite(psd)
    check(torch.equal(torch.isfinite(ksd), fin), "probe scan +inf pattern")
    # bf16 products and bf16 squares summed in f32 in another order than
    # the plain version's matmul and sum; scores are ~1e2
    torch.testing.assert_close(ksd[fin], psd[fin], rtol=1e-5, atol=1e-3)
    blk_agree = (ksp == psp).float().mean().item()
    check(blk_agree >= 0.999, f"probe scan blocks agree {blk_agree:.5f}")
    err = (ksd[fin] - psd[fin]).abs().max().item()
    # integer-valued case on the same probes, with and without the norm
    # term: every f32 sum is exact, so kernel == plain bit for bit
    g = torch.Generator(device=dev).manual_seed(11)
    dec_i = torch.randint(-3, 4, view["decoded"].shape, generator=g,
                          device=dev).to(torch.int8)
    v_i = torch.randint(-4, 5, v_q.shape, generator=g, device=dev).float()
    b_i = torch.randint(0, 100, base_q.shape, generator=g, device=dev).float()
    ones = torch.ones(D, device=dev)
    for coef in (1.0, 0.0):
        ki = dense_scan.dense_scan(starts, sizes, v_i, b_i, dec_i, ones,
                                   norm_coef=coef, **kw)
        pi = dense_scan.probe_scan_plain(
            starts.reshape(P), sizes.reshape(P), b_i.reshape(P),
            v_i.reshape(P, D), dec_i, ones, nf=nf, norm_coef=coef)
        check(torch.equal(ki[0].reshape(P, nf), pi[0])
              and torch.equal(ki[1].reshape(P, nf), pi[1]),
              f"integer-valued probe scan (norm_coef={coef}) not bit-exact")
    # bound: every probed cell's int8 rows read once, v / start / size /
    # base per probe, every output row written; dot and norm products of
    # each probe with each row of its cell at the bf16 rate
    sizes64 = view["sizes"].to(torch.int64)
    cell_rows = int(sizes64[torch.unique(cells64)].sum().item())
    probe_rows = int(sizes.to(torch.int64).sum().item())
    records["probe_scan"] = dict(
        source="ivfadc_tpu_torch/csrc/probe_scan.cu",
        replaces="ivfadc_tpu/ops/pallas_scan.py:62", max_abs_err=err,
        blocks_agree=blk_agree, integer_case_bit_exact=True, probes=P,
        ms=cuda_ms(lambda: dense_scan.dense_scan(
            starts, sizes, v_q, base_q, view["decoded"], view["scale"],
            norm_coef=1.0, **kw)),
        plain_ms=cuda_ms(lambda: dense_scan.probe_scan_plain(
            *plain_args, nf=nf, norm_coef=1.0), reps=3),
        library_ms=None,             # no single PyTorch call scans CSR cells
        **bound(cell_rows * D + P * (2 * D + 12) + P * nf * 8,
                4.0 * D * probe_rows, PEAK_BF16))
    records["probe_scan"] = probe_layout(
        records["probe_scan"], lambda: dense_scan.dense_scan(
            starts, sizes, v_q, base_q, view["decoded"], view["scale"],
            norm_coef=1.0, **kw), dense_scan.PROBE_KERNEL, D, nf)

    # 8d per probe: the exact merge (slot payloads); 8c per probe: the bf16
    # cache. Integer-valued inputs bit for bit
    ekw = dict(kw, merge="exact", nf=128)
    ek = dense_scan.dense_scan(starts, sizes, v_q, base_q, view["decoded"],
                               view["scale"], norm_coef=1.0, **ekw)
    ep = dense_scan.probe_scan_plain(*plain_args, nf=128, norm_coef=1.0,
                                     merge="exact", k_out=TOPK)
    ex_err, ex_agree = exact_topk(ek, ep, TOPK, "exact probe scan")
    ki = dense_scan.dense_scan(starts, sizes, v_i, b_i, dec_i, ones,
                               norm_coef=1.0, **ekw)
    pi = dense_scan.probe_scan_plain(
        starts.reshape(P), sizes.reshape(P), b_i.reshape(P),
        v_i.reshape(P, D), dec_i, ones, nf=128, norm_coef=1.0,
        merge="exact", k_out=TOPK)
    check(torch.equal(ki[0].reshape(P, 128), pi[0])
          and torch.equal(ki[1].reshape(P, 128), pi[1]),
          "integer-valued exact probe scan is not bit-exact")
    records["probe_scan_exact"] = dict(
        source="ivfadc_tpu_torch/csrc/probe_scan.cu",
        replaces="ivfadc_tpu/ops/pallas_scan.py:153", max_abs_err=ex_err,
        topk_payloads_agree=ex_agree, integer_case_bit_exact=True, probes=P,
        ms=cuda_ms(lambda: dense_scan.dense_scan(
            starts, sizes, v_q, base_q, view["decoded"], view["scale"],
            norm_coef=1.0, **ekw)),
        plain_ms=cuda_ms(lambda: dense_scan.probe_scan_plain(
            *plain_args, nf=128, norm_coef=1.0, merge="exact", k_out=TOPK),
            reps=3),
        library_ms=None,
        **bound(cell_rows * D + P * (2 * D + 12) + P * 128 * 8,
                4.0 * D * probe_rows, PEAK_BF16))
    records["probe_scan_exact"] = probe_layout(
        records["probe_scan_exact"], lambda: dense_scan.dense_scan(
            starts, sizes, v_q, base_q, view["decoded"], view["scale"],
            norm_coef=1.0, **ekw), dense_scan.PROBE_KERNELS["exact", "int8"],
        D, 128, TOPK)
    b_plain = plain_args[:4] + (bview["decoded"], None)
    bk = dense_scan.dense_scan(starts, sizes, v_q, base_q, bview["decoded"],
                               None, norm_coef=1.0, **kw)
    bp = dense_scan.probe_scan_plain(*b_plain, nf=nf, norm_coef=1.0)
    b_err, b_agree = close_scan((bk[0].reshape(P, nf), bk[1].reshape(P, nf)),
                                bp, "bf16 probe scan")
    dec_b = dec_i.to(torch.bfloat16)
    ki = dense_scan.dense_scan(starts, sizes, v_i, b_i, dec_b, None,
                               norm_coef=1.0, **kw)
    pi = dense_scan.probe_scan_plain(
        starts.reshape(P), sizes.reshape(P), b_i.reshape(P),
        v_i.reshape(P, D), dec_b, None, nf=nf, norm_coef=1.0)
    check(torch.equal(ki[0].reshape(P, nf), pi[0])
          and torch.equal(ki[1].reshape(P, nf), pi[1]),
          "integer-valued bf16 probe scan is not bit-exact")
    records["probe_scan_bf16"] = dict(
        source="ivfadc_tpu_torch/csrc/probe_scan.cu",
        replaces="ivfadc_tpu/ops/pallas_scan.py:117", max_abs_err=b_err,
        blocks_agree=b_agree, integer_case_bit_exact=True, probes=P,
        ms=cuda_ms(lambda: dense_scan.dense_scan(
            starts, sizes, v_q, base_q, bview["decoded"], None,
            norm_coef=1.0, **kw)),
        plain_ms=cuda_ms(lambda: dense_scan.probe_scan_plain(
            *b_plain, nf=nf, norm_coef=1.0), reps=3),
        library_ms=None,
        **bound(cell_rows * 2 * D + P * (2 * D + 12) + P * nf * 8,
                4.0 * D * probe_rows, PEAK_BF16))
    records["probe_scan_bf16"] = probe_layout(
        records["probe_scan_bf16"], lambda: dense_scan.dense_scan(
            starts, sizes, v_q, base_q, bview["decoded"], None,
            norm_coef=1.0, **kw), dense_scan.PROBE_KERNELS["fold", "bf16"],
        D, nf)

    # 6. top-k with indices on the scan's candidate rows (ties and +inf
    # included): exact
    flat_d = ksd.reshape(B_SMALL, W * nf)
    kt = topk.topk_lastdim(flat_d, TOPK)
    pt = topk.topk_lastdim_plain(flat_d, TOPK)
    check(torch.equal(kt[0], pt[0]) and torch.equal(kt[1], pt[1]),
          "top-k with indices differs")
    records["topk_index"] = dict(
        source="ivfadc_tpu_torch/csrc/topk.cu",
        replaces="ivfadc_tpu/ops/topk.py:31", max_abs_err=0.0,
        ms=cuda_ms(lambda: topk.topk_lastdim(flat_d, TOPK), inner=10),
        plain_ms=cuda_ms(lambda: topk.topk_lastdim_plain(flat_d, TOPK)),
        library_ms=cuda_ms(lambda: torch.topk(flat_d, TOPK, dim=1,
                                              largest=False), inner=10),
        library_device_ms=device_ms(lambda: torch.topk(flat_d, TOPK, dim=1,
                                                       largest=False)),
        **bound(topk_bytes(B_SMALL, W * nf, TOPK, False),
                float(flat_d.numel()), PEAK_F32))
    records["topk_index"] = topk_layout(
        records["topk_index"], lambda: topk.topk_lastdim(flat_d, TOPK),
        B_SMALL, W * nf, TOPK, False)
    return records


def phase_variants(index, qs, gt, ref, zero_counts, read_counts) -> dict:
    """The scan variants through the index's entry points, counts zeroed
    before each part: scan_cache="bf16" and scan_merge="exact" on the
    grouped and the small-batch routes, IVFADC_EXTRACT=1 on the grouped
    route. `ref` holds the routes already run on the same queries: ids
    (grouped), s_ids (small batches), n_ids / n_dists (IVFADC_NORMS=off)
    and the oracle's recall on the first N_ORACLE queries."""
    import torch
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.evaluation import recall_at_r

    def variant(**changes):
        return IVFADCIndex(dataclasses.replace(index.config, **changes),
                           index.coarse, index.quantizer, index.store,
                           index.data_dtype, index.dim)

    def small_batches(idx):
        return np.concatenate([idx.search_padded(qs[s:s + B_SMALL], TOPK,
                                                 w=W)[0]
                               for s in range(0, N_SEARCH, B_SMALL)])

    def overlap(a, b):
        return float(np.mean([len(set(x) & set(y)) / TOPK
                              for x, y in zip(a, b)]))

    def recall(ids_):
        r = recall_at_r(ids_[:N_ORACLE], gt[:N_ORACLE], TOPK)
        check(abs(r - ref["recall_oracle"]) <= 0.01,
              f"recall {r} vs oracle {ref['recall_oracle']}")
        return r

    def batch_ms(idx):
        ts = []
        for _ in range(4):                        # first: warm-up
            t1 = time.perf_counter()
            idx._device_search(ref["batch"], TOPK, W)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t1))
        return float(np.median(ts[1:]))

    out = {}
    # bf16 cache: grouped (cached norms, and IVFADC_NORMS=off), small batches
    zero_counts()
    bidx = variant(scan_cache="bf16")
    b_ids, _ = bidx.search_padded(qs, TOPK, w=W)
    b_small = small_batches(bidx)
    with norms_off(index):
        bn_ids, _ = bidx.search_padded(qs, TOPK, w=W)
    out["bf16"] = dict(launches=read_counts(
        "variants_bf16", ["grouped_scan_bf16", "probe_scan_bf16",
                          "grouped_scan_knorm_bf16"],
        idle=["grouped_scan", "probe_scan", "grouped_scan_knorm"]))
    out["bf16"].update(
        recall_at_10_grouped=recall(b_ids),
        recall_at_10_small_batch=recall(b_small),
        top10_overlap_int8_grouped=overlap(b_ids, ref["ids"]),
        top10_overlap_int8_small_batch=overlap(b_small, ref["s_ids"]),
        top10_overlap_norms_off=overlap(bn_ids, ref["n_ids"]),
        batch_ms_b16384=batch_ms(bidx))
    for key in ("grouped", "small_batch"):
        val = out["bf16"][f"top10_overlap_int8_{key}"]
        check(val >= 0.9, f"bf16 / int8 {key} overlap {val}")
    # exact merge: against the fold routes of the same arithmetic (in-kernel
    # norms: IVFADC_NORMS=off grouped, and the small batches). The exact
    # top-k can only be closer; the default 128-lane fold loses neighbours
    # that collide in a lane (cells of ~1000 rows: 8 rows a lane), a
    # 1024-lane fold almost none, so that one is the referee
    widx = variant(scan_fold_lanes=1024, scan_pb=16)
    with norms_off(index):
        w_ids, w_dists = widx.search_padded(qs, TOPK, w=W)
    ws_ids, ws_dists = map(np.concatenate, zip(*[
        widx.search_padded(qs[s:s + B_SMALL], TOPK, w=W)
        for s in range(0, N_SEARCH, B_SMALL)]))
    zero_counts()
    eidx = variant(scan_merge="exact")
    with norms_off(index):                  # the fold route it is held to
        e_ids, e_dists = eidx.search_padded(qs, TOPK, w=W)
    e_small, e_sd = map(np.concatenate, zip(*[
        eidx.search_padded(qs[s:s + B_SMALL], TOPK, w=W)
        for s in range(0, N_SEARCH, B_SMALL)]))
    check(bool((e_dists <= ref["n_dists"] + 1e-4).all()
               and (e_sd <= ref["s_dists"] + 1e-4).all()),
          "exact-merge distances above the fold's")
    out["exact"] = dict(launches=read_counts(
        "variants_exact", ["grouped_scan_exact", "probe_scan_exact",
                           "topk_index"],
        idle=["grouped_scan", "probe_scan", "grouped_scan_knorm",
              "topk_payload"]))
    out["exact"].update(
        recall_at_10_grouped=recall(e_ids),
        recall_at_10_small_batch=recall(e_small),
        top10_overlap_fold_grouped=overlap(e_ids, ref["n_ids"]),
        top10_overlap_fold_small_batch=overlap(e_small, ref["s_ids"]),
        top10_overlap_fold_grouped_tie_aware=tie_overlap(
            e_ids, e_dists, ref["n_ids"], ref["n_dists"]),
        top10_overlap_fold_small_batch_tie_aware=tie_overlap(
            e_small, e_sd, ref["s_ids"], ref["s_dists"]),
        top10_overlap_fold1024_grouped_tie_aware=tie_overlap(
            e_ids, e_dists, w_ids, w_dists),
        top10_overlap_fold1024_small_batch_tie_aware=tie_overlap(
            e_small, e_sd, ws_ids, ws_dists),
        batch_ms_b16384=batch_ms(eidx))
    for key in ("grouped", "small_batch"):
        val = out["exact"][f"top10_overlap_fold1024_{key}_tie_aware"]
        check(val >= 0.99, f"exact / 1024-lane fold {key} overlap {val}")
        val = out["exact"][f"top10_overlap_fold_{key}_tie_aware"]
        check(val >= 0.95, f"exact / fold {key} overlap {val}")
    # extraction: exact against the buffered fold with the same in-kernel
    # norms (IVFADC_NORMS=off): bit-equal distances, ids equal but at ties
    zero_counts()
    os.environ["IVFADC_EXTRACT"] = "1"
    try:
        x_ids, x_dists = index.search_padded(qs, TOPK, w=W)
        out["extract"] = dict(launches=read_counts(
            "variants_extract", ["grouped_scan_extract", "topk_payload"],
            idle=["grouped_scan", "grouped_scan_knorm"]))
        out["extract"]["batch_ms_b16384"] = batch_ms(index)
    finally:
        del os.environ["IVFADC_EXTRACT"]
    out["extract"].update(
        rows_differing_at_ties=ties_only(x_ids, x_dists, ref["n_ids"],
                                         ref["n_dists"]),
        distances_bit_equal_norms_off=True)
    return out


def phase_engines(index, queries, gt, ref, zero_counts, read_counts) -> dict:
    """The opt-in engines through the index's entry points on B=8192
    batches (w=8, k=10), counts zeroed before each route: the default
    placement route, IVFADC_VBASE=qc, IVFADC_COARSE_ENGINE=v2,
    IVFADC_RANK_ENGINE=v2, all three, qc over the bf16 cache; then qc at
    B=16384, where its gate fails. Per route: recall@10 (first N_SEARCH
    queries; the first N_ORACLE against the oracle's), top-10 overlap with
    the default route, the median of 5 synchronised batch times and the
    launch counts; the qc and placement batches profiled. `ref` holds the
    oracle's recall."""
    import torch
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.evaluation import recall_at_r

    batch = queries[:BATCH_QC]
    bidx = IVFADCIndex(dataclasses.replace(index.config, scan_cache="bf16"),
                       index.coarse, index.quantizer, index.store,
                       index.data_dtype, index.dim)
    qc, v2c, v2r = (dict(IVFADC_VBASE="qc"), dict(IVFADC_COARSE_ENGINE="v2"),
                    dict(IVFADC_RANK_ENGINE="v2"))
    # (route, index, environment, launched, idle)
    routes = [
        ("default", index, {}, ["coarse_probe", "cell_rank", "grouped_scan",
                                "topk_payload"],
         ["grouped_scan_qc", "coarse_probe_v2", "cell_rank_v2"]),
        ("qc", index, qc, ["coarse_probe", "cell_rank", "grouped_scan_qc",
                           "topk_payload"],
         ["grouped_scan", "grouped_scan_knorm", "coarse_probe_v2",
          "cell_rank_v2"]),
        ("coarse_v2", index, v2c, ["coarse_probe_v2", "cell_rank",
                                   "grouped_scan", "topk_payload"],
         ["coarse_probe", "grouped_scan_qc", "cell_rank_v2"]),
        ("rank_v2", index, v2r, ["coarse_probe", "cell_rank_v2",
                                 "grouped_scan", "topk_payload"],
         ["cell_rank", "grouped_scan_qc", "coarse_probe_v2"]),
        ("all", index, {**qc, **v2c, **v2r},
         ["coarse_probe_v2", "cell_rank_v2", "grouped_scan_qc",
          "topk_payload"],
         ["coarse_probe", "cell_rank", "grouped_scan",
          "grouped_scan_knorm"]),
        ("qc_bf16", bidx, qc, ["coarse_probe", "cell_rank",
                               "grouped_scan_qc_bf16", "topk_payload"],
         ["grouped_scan_qc", "grouped_scan_bf16",
          "grouped_scan_knorm_bf16"]),
    ]

    def overlap(a, b):
        return float(np.mean([len(set(x) & set(y)) / TOPK
                              for x, y in zip(a, b)]))

    out, res = {}, {}
    for name, idx, values, launched, idle in routes:
        with env(**values):
            zero_counts()
            ids, dists = idx.search_padded(batch, TOPK, w=W)
            counts = read_counts(f"engines_{name}", launched, idle)
            ts = []
            for _ in range(6):                    # first: warm-up
                t1 = time.perf_counter()
                idx._device_search(batch, TOPK, W)
                torch.cuda.synchronize()
                ts.append(1e3 * (time.perf_counter() - t1))
        res[name] = (ids, dists)
        check(ids.shape == (BATCH_QC, TOPK) and np.isfinite(dists).all()
              and (ids >= 0).all(), f"engines {name} output")
        r_oracle = recall_at_r(ids[:N_ORACLE], gt[:N_ORACLE], TOPK)
        out[name] = dict(
            recall_at_10=recall_at_r(ids[:N_SEARCH], gt, TOPK),
            recall_at_10_oracle_queries=r_oracle,
            top10_overlap_default=overlap(ids, res["default"][0]),
            batch_ms_median_of_5=float(np.median(ts[1:])), launches=counts)
    # rank v2: one function, so kernel 2's route bit for bit
    check(np.array_equal(res["rank_v2"][0], res["default"][0])
          and np.array_equal(res["rank_v2"][1], res["default"][1]),
          "rank v2 results differ from v1's")
    for name in ("qc", "coarse_v2", "all", "qc_bf16"):
        r = out[name]["recall_at_10_oracle_queries"]
        check(abs(r - ref["recall_oracle"]) <= 0.01,
              f"engines {name}: recall {r} vs oracle {ref['recall_oracle']}")
    for name in ("qc", "coarse_v2", "all"):
        val = out[name]["top10_overlap_default"]
        check(val >= 0.99, f"engines {name}: overlap with the default {val}")
    # B=16384: B * d * 4 = 8 MiB of queries, past the qc gate's 6 MiB: the
    # placement route with kernel 3
    with env(**qc):
        zero_counts()
        index.search_padded(queries[:BATCH], TOPK, w=W)
        out["qc_b16384_falls_through"] = dict(launches=read_counts(
            "engines_qc_b16384", ["coarse_probe", "cell_rank",
                                  "grouped_scan", "topk_payload"],
            ["grouped_scan_qc"]))
    out["profile_placement"] = phase_profile(
        lambda i: index._device_search(batch, TOPK, W), 3)
    with env(**qc):
        out["profile_qc"] = phase_profile(
            lambda i: index._device_search(batch, TOPK, W), 3)
    return out


def phase_profile(search, calls: int) -> dict:
    """Device time per kernel and the device's idle share over `calls`
    back-to-back searches `search(i)`, from torch.profiler's CUDA trace
    (profiler overhead included in the wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = range(calls)
    search(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            search(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / len(batches)
    wall_ms = 1e3 * wall / len(batches)
    return dict(
        calls=len(batches), wall_ms_per_batch=wall_ms,
        device_busy_ms_per_batch=busy_ms if rows else None,
        device_idle_share=(1.0 - busy_ms / wall_ms) if rows else None,
        device_ops_per_batch=sum(r[1] for r in rows) / len(batches),
        top=[dict(kernel=k[:80], ms_per_batch=us / 1e3 / len(batches),
                  calls_per_batch=c / len(batches))
             for us, c, k in rows[:12]])


def phase_two_level(zero_counts, read_counts, posting: dict) -> dict:
    """Build, check and search the large-kc two-level index; returns kernel
    8a's record (stage 2's shape; `posting` holds its numbers at kernel 3's
    shape)."""
    import torch
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.models.coarse import NaiveCoarseQuantizer
    from ivfadc_tpu_torch.models.index import _dense_probe
    from ivfadc_tpu_torch.ops import cell_rank, coarse_scan, dense_scan, topk
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    from ivfadc_tpu_torch.utils.evaluation import brute_force_topk, recall_at_r
    from ivfadc_tpu_torch.utils.repro import index_digest

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    data = synthetic_clustered(N3, D3, seed=0)
    gen_s = time.perf_counter() - t0
    base = torch.as_tensor(data, device=dev)
    del data
    t1 = time.perf_counter()
    index = IVFADCIndex.build(base, kc=KC3, k=KQ, m=M3, seed=0,
                              coarse_quantizer="hnsw", kmeanspp_sample=65536)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    cq = index.coarse
    g, gp = cq.group_centers.shape[0], cq.n_probe_groups
    check(len(index) == N3 and cq.kind == "two_level"
          and index.store.align == 8, "two-level build")
    gq = torch.Generator(device=dev).manual_seed(2)
    qidx = torch.randint(0, N3, (NQ3,), generator=gq, device=dev)
    q = base[qidx] + 0.05 * torch.randn((NQ3, D3), generator=gq, device=dev)
    emit("two_level_build", n=N3, d=D3, kc=KC3, m=M3, k=KQ, groups=g,
         probe_groups=gp, coarse=repr(cq), data_gen_s=gen_s, build_s=build_s,
         build_digest=index_digest(index),
         build_phases={k: round(v, 3) for k, v in
                       index.build_timings.items()},
         posting_rows=int(index.store.total_cap),
         seconds=time.perf_counter() - t0)

    # ---- this path's kernels against their plain versions, at its shapes
    t0 = time.perf_counter()
    shapes = {}
    # 6 at stage 1: (NQ3, g), k = gp
    gdist = cq.metric.pairwise(q, cq.group_centers)
    kv, gids = topk.topk_lastdim(gdist, gp)
    pv, pg = topk.topk_lastdim_plain(gdist, gp)
    check(torch.equal(kv, pv) and torch.equal(gids, pg), "stage-1 top-k")
    shapes["topk_index@stage1"] = dict(
        shape=[NQ3, g], k=gp,
        ms=cuda_ms(lambda: topk.topk_lastdim(gdist, gp)),
        plain_ms=cuda_ms(lambda: topk.topk_lastdim_plain(gdist, gp)),
        library_ms=cuda_ms(lambda: torch.topk(gdist, gp, dim=1,
                                              largest=False)),
        **bound(topk_bytes(NQ3, g, gp, False), float(gdist.numel()),
                PEAK_F32))
    shapes["topk_index@stage1"] = topk_layout(
        shapes["topk_index@stage1"], lambda: topk.topk_lastdim(gdist, gp),
        NQ3, g, gp, False)
    # 2 on stage 2's group ids and the groups' slot ranges: "kc" = g,
    # pb = 64 (models/coarse.py)
    gflat = gids.reshape(-1).to(torch.int32)
    shapes["cell_rank@stage2"] = rank_record(
        gflat, cq.csr_offsets, cq.csr_sizes, g, 64, "v1")
    # 11 on the same group ids: kernel 2's bits
    kr, kr2 = (cell_rank.tile_slots(gflat, cq.csr_offsets, cq.csr_sizes,
                                    kc=g, pb=64, engine=e)
               for e in ("v1", "v2"))
    check(all(torch.equal(a, b) for a, b in zip(kr, kr2)),
          "stage-2 v2 tile prep differs")
    shapes["cell_rank_v2@stage2"] = dict(
        rank_record(gflat, cq.csr_offsets, cq.csr_sizes, g, 64, "v2"),
        equal_to_kernel_2=True)
    # 8a on stage 2's own tiles
    d_pad = cq.cent_scan.shape[1]
    pb, nf = 64, 128
    v = torch.nn.functional.pad(
        (-2.0 * q)[:, None, :].expand(NQ3, gp, D3), (0, d_pad - D3))
    qbase = torch.sum(q * q, dim=1)[:, None].expand(NQ3, gp)
    tstart, tsize, v_t, b_t, row = dense_scan.place_tiles(
        gids, cq.csr_offsets, cq.csr_sizes, v, qbase, kc=g, pb=pb)
    args = (tstart, tsize, v_t, b_t, cq.cent_scan, cq.cent_scale, cq.perm2d,
            None)
    kw = dict(pb=pb, nf=nf, norm_coef=1.0)
    kd, kp = dense_scan.grouped_scan(*args, **kw)
    pd, pp = dense_scan.grouped_scan_plain(*args, **kw)
    fin = torch.isfinite(pd)
    check(torch.equal(torch.isfinite(kd), fin), "stage-2 scan +inf pattern")
    # bf16 products and bf16 squares summed in f32 in another order than
    # the plain version's matmul and sum
    torch.testing.assert_close(kd[fin], pd[fin], rtol=1e-5, atol=1e-3)
    id_agree = (kp == pp).float().mean().item()
    check(id_agree >= 0.999, f"stage-2 scan ids agree on {id_agree:.5f}")
    err = (kd[fin] - pd[fin]).abs().max().item()
    # integer-valued case on the same tiles: every f32 sum is exact
    gi = torch.Generator(device=dev).manual_seed(13)
    dec_i = torch.randint(-3, 4, cq.cent_scan.shape, generator=gi,
                          device=dev).to(torch.int8)
    v_i = torch.randint(-4, 5, v_t.shape, generator=gi, device=dev) \
        .to(torch.bfloat16)
    b_i = torch.where(torch.isfinite(b_t),
                      torch.randint(0, 100, b_t.shape, generator=gi,
                                    device=dev).float(), float("inf"))
    int_args = (tstart, tsize, v_i, b_i, dec_i, torch.ones(d_pad, device=dev),
                cq.perm2d, None)
    ki = dense_scan.grouped_scan(*int_args, **kw)
    pi = dense_scan.grouped_scan_plain(*int_args, **kw)
    check(torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1]),
          "integer-valued stage-2 scan is not bit-exact")
    # bound: every probed group's rows (int8 row, id) read once, the live
    # tiles' v and base rows, every output row written; the products of
    # each probe with each row of its group, and each tile's row squares,
    # at the bf16 rate
    sizes64 = cq.csr_sizes.to(torch.int64)
    live_tiles = int((tsize > 0).sum().item())
    group_rows = int(sizes64[torch.unique(gids)].sum().item())
    probe_rows = int(sizes64[gids.to(torch.int64)].sum().item())
    tile_rows = int(tsize.to(torch.int64).sum().item())
    record = dict(
        source="ivfadc_tpu_torch/csrc/dense_scan.cu",
        replaces="ivfadc_tpu/ops/pallas_scan.py:304", max_abs_err=err,
        ids_agree=id_agree, integer_case_bit_exact=True,
        tiles=int(tsize.shape[0]), live_tiles=live_tiles,
        ms=cuda_ms(lambda: dense_scan.grouped_scan(*args, **kw)),
        plain_ms=cuda_ms(lambda: dense_scan.grouped_scan_plain(*args, **kw),
                         reps=3),
        library_ms=None,             # no single PyTorch call scans CSR cells
        **bound(group_rows * (d_pad + 4) + live_tiles * pb * (2 * d_pad + 4)
                + 8 * tsize.numel() + kd.numel() * 8,
                2.0 * d_pad * (probe_rows + tile_rows), PEAK_BF16),
        posting_shape=posting)
    record = scan_layout(record, lambda: dense_scan.grouped_scan(*args, **kw),
                         dense_scan.NORMS_KERNEL, d_pad, pb, nf)
    # 8e at stage 2's tiles (IVFADC_EXTRACT=1): each group probe's W3 best
    # leave the kernel; integer-valued, bit for bit
    xkw = dict(kw, extract_k=W3)
    xk = dense_scan.grouped_scan(*args, **xkw)
    xp = dense_scan.grouped_scan_plain(*args, **xkw)
    x_err, x_agree = close_scan(xk, xp, "stage-2 extraction")
    xi = dense_scan.grouped_scan(*int_args, **xkw)
    xq = dense_scan.grouped_scan_plain(*int_args, **xkw)
    check(torch.equal(xi[0], xq[0]) and torch.equal(xi[1], xq[1]),
          "integer-valued stage-2 extraction is not bit-exact")
    extract_stage2 = dict(
        groups=g, probe_groups=gp, k=W3, max_abs_err=x_err, ids_agree=x_agree,
        integer_case_bit_exact=True,
        ms=cuda_ms(lambda: dense_scan.grouped_scan(*args, **xkw)),
        plain_ms=cuda_ms(lambda: dense_scan.grouped_scan_plain(*args, **xkw),
                         reps=3),
        **bound(group_rows * (d_pad + 4) + live_tiles * pb * (2 * d_pad + 4)
                + 8 * tsize.numel() + xk[0].numel() * 8,
                2.0 * d_pad * (probe_rows + tile_rows), PEAK_BF16))
    extract_stage2 = scan_layout(
        extract_stage2, lambda: dense_scan.grouped_scan(*args, **xkw),
        dense_scan.GROUPED_KERNELS["extract", "int8"], d_pad, pb, nf, W3)
    del xk, xp, xi, xq
    # 4 at the stage-2 merge: (NQ3, gp * nf), k = W3
    flat_d = kd[row].reshape(NQ3, gp * nf)
    flat_p = kp[row].reshape(NQ3, gp * nf)
    kt = topk.topk_lastdim_payload(flat_d, flat_p, W3)
    pt = topk.topk_lastdim_payload_plain(flat_d, flat_p, W3)
    check(torch.equal(kt[0], pt[0]) and torch.equal(kt[1], pt[1]),
          "stage-2 merge top-k differs")
    shapes["topk_payload@stage2"] = dict(
        shape=[NQ3, gp * nf], k=W3,
        ms=cuda_ms(lambda: topk.topk_lastdim_payload(flat_d, flat_p, W3)),
        plain_ms=cuda_ms(lambda: topk.topk_lastdim_payload_plain(
            flat_d, flat_p, W3), reps=3),
        library_ms=cuda_ms(lambda: torch.gather(
            flat_p, 1, torch.topk(flat_d, W3, dim=1, largest=False)[1])),
        **bound(topk_bytes(NQ3, gp * nf, W3, True), float(flat_d.numel()),
                PEAK_F32))
    shapes["topk_payload@stage2"] = topk_layout(
        shapes["topk_payload@stage2"],
        lambda: topk.topk_lastdim_payload(flat_d, flat_p, W3), NQ3,
        gp * nf, W3, True)
    del flat_d, flat_p, kd, kp, pd, pp, ki, pi, dec_i, v_i, b_i, v_t, b_t, v
    # 5 on the posting scan's own probes (cells of ~8 rows at any 8-row
    # start); the plain version on every 16th probe, first to last
    view = index.store.device_view_dense(index.quantizer,
                                         index.config.scan_chunk)
    check(view["ids2d"] is None and view["norms2d"] is None,
          "8-row cells expose no (rows/128, 128) streams")
    cells, v_q, base_q, _ = _dense_probe(
        cq, index.quantizer.rotation, q, w=W3, metric=index.quant_metric,
        include_base=index.config.score_mode == "reference",
        apply_rot=False, residual_based=True)
    cells64 = cells.to(torch.int64)
    P = NQ3 * W3
    starts, sizes = view["offsets"][cells64], view["sizes"][cells64]
    skw = dict(k_out=TOPK, chunk=index.config.scan_chunk,
               nf=index.config.scan_fold_lanes, norm_coef=1.0)
    nfp = index.config.scan_fold_lanes
    ksd, ksp = dense_scan.dense_scan(starts, sizes, v_q, base_q,
                                     view["decoded"], view["scale"], **skw)
    sub = torch.arange(0, P, 16, device=dev)
    scale = view["scale"].to(torch.bfloat16).to(torch.float32)
    v_sub = torch.nn.functional.pad(v_q.reshape(P, -1)[sub],
                                    (0, view["decoded"].shape[1] - D3))
    plain_args = (starts.reshape(P)[sub], sizes.reshape(P)[sub],
                  base_q.reshape(P)[sub], v_sub, view["decoded"], scale)
    psd, psp = dense_scan.probe_scan_plain(*plain_args, nf=nfp,
                                           norm_coef=1.0)
    ksd_s, ksp_s = ksd.reshape(P, nfp)[sub], ksp.reshape(P, nfp)[sub]
    fin = torch.isfinite(psd)
    check(torch.equal(torch.isfinite(ksd_s), fin), "probe scan +inf pattern")
    torch.testing.assert_close(ksd_s[fin], psd[fin], rtol=1e-5, atol=1e-3)
    blk_agree = (ksp_s == psp).float().mean().item()
    check(blk_agree >= 0.999, f"probe scan blocks agree {blk_agree:.5f}")
    vsizes = view["sizes"].to(torch.int64)
    shapes["probe_scan@posting"] = dict(
        probes=P, mean_cell_rows=float(sizes.float().mean().item()),
        max_abs_err=(ksd_s[fin] - psd[fin]).abs().max().item(),
        blocks_agree=blk_agree, plain_probes=int(sub.numel()),
        ms=cuda_ms(lambda: dense_scan.dense_scan(
            starts, sizes, v_q, base_q, view["decoded"], view["scale"],
            **skw)),
        plain_ms_8192_probes=cuda_ms(lambda: dense_scan.probe_scan_plain(
            *plain_args, nf=nfp, norm_coef=1.0), reps=3),
        library_ms=None,
        **bound(int(vsizes[torch.unique(cells64)].sum().item()) * 128
                + P * (2 * v_q.shape[-1] + 12) + P * nfp * 8,
                4.0 * 128 * int(sizes.to(torch.int64).sum().item()),
                PEAK_BF16))
    shapes["probe_scan@posting"] = probe_layout(
        shapes["probe_scan@posting"], lambda: dense_scan.dense_scan(
            starts, sizes, v_q, base_q, view["decoded"], view["scale"],
            **skw), dense_scan.PROBE_KERNEL, view["decoded"].shape[1], nfp)
    # 6 at the final merge: (NQ3, W3 * nf), k = TOPK
    fd = ksd.reshape(NQ3, W3 * nfp)
    kt = topk.topk_lastdim(fd, TOPK)
    pt = topk.topk_lastdim_plain(fd, TOPK)
    check(torch.equal(kt[0], pt[0]) and torch.equal(kt[1], pt[1]),
          "final merge top-k differs")
    shapes["topk_index@merge"] = dict(
        shape=[NQ3, W3 * nfp], k=TOPK,
        ms=cuda_ms(lambda: topk.topk_lastdim(fd, TOPK)),
        plain_ms=cuda_ms(lambda: topk.topk_lastdim_plain(fd, TOPK)),
        library_ms=cuda_ms(lambda: torch.topk(fd, TOPK, dim=1,
                                              largest=False)),
        **bound(topk_bytes(NQ3, W3 * nfp, TOPK, False), float(fd.numel()),
                PEAK_F32))
    shapes["topk_index@merge"] = topk_layout(
        shapes["topk_index@merge"], lambda: topk.topk_lastdim(fd, TOPK),
        NQ3, W3 * nfp, TOPK, False)
    del fd, ksd, ksp, psd, psp, v_sub, plain_args, v_q
    # 7 and 1 over the whole centroid table, the shape of the naive-coarse
    # checks below: the kernels split the table over blocks, each with a
    # running top-w. Plain versions on the first 256 queries (a (256, kc)
    # score matrix); cells may differ only at few-ulp ties
    c32 = cq.centroids
    cn = torch.sum(c32 * c32, dim=1)
    nsub = 256
    qs_, rot = q[:nsub], torch.eye(D3, device=dev)
    kcells, kdist = coarse_scan.coarse_topw(qs_, c32, W3)
    pvals, pcells = coarse_scan.coarse_topw_plain(qs_, c32, cn, W3)
    pdist = torch.clamp_min(pvals + torch.sum(qs_ * qs_, dim=1, keepdim=True),
                            0.0)
    agree7 = (kcells == pcells).float().mean().item()
    check(agree7 >= 0.999, f"large-kc top-w cells agree on {agree7:.5f}")
    torch.testing.assert_close(kdist, pdist, rtol=1e-5, atol=1e-3)
    kv = coarse_scan.coarse_vbase(qs_, c32, cn, rot, W3, False)
    pv = coarse_scan.coarse_vbase_plain(qs_, c32, cn, rot, W3, False)
    check(torch.equal(kv[1], kcells), "large-kc kernel 1 and 7 cells differ")
    same = kv[1] == pv[1]
    check(torch.equal(kv[2][same], pv[2][same]), "large-kc coarse v differs")
    torch.testing.assert_close(kv[3][same], pv[3][same], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(kv[0], pv[0], rtol=1e-5, atol=1e-3)

    def lib_topw():
        return torch.topk(cn[None, :] - 2.0 * (q @ c32.T), W3, dim=1,
                          largest=False)

    shapes["coarse_topw@large_kc"] = dict(
        shape=[NQ3, KC3], w=W3, cells_agree=agree7, plain_queries=nsub,
        max_abs_err=(kdist - pdist).abs().max().item(),
        ms=cuda_ms(lambda: coarse_scan.coarse_topw(q, c32, W3), reps=3),
        plain_ms_256_queries=cuda_ms(lambda: coarse_scan.coarse_topw_plain(
            qs_, c32, cn, W3), reps=3),
        library_ms=cuda_ms(lib_topw, reps=3),
        integer_ties=coarse_integer_ties(NQ3, KC3, D3, W3, nsub, 3),
        **bound(4 * (NQ3 * D3 + KC3 * D3 + KC3) + 8 * NQ3 * W3,
                2.0 * NQ3 * KC3 * D3, PEAK_F32))
    shapes["coarse_topw@large_kc"] = coarse_layout(
        shapes["coarse_topw@large_kc"], "topw", NQ3, KC3, D3, W3)
    shapes["coarse_probe@large_kc"] = dict(
        shape=[NQ3, KC3], w=W3, cells_agree=same.float().mean().item(),
        plain_queries=nsub,
        max_abs_err=max((kv[3][same] - pv[3][same]).abs().max().item(),
                        (kv[0] - pv[0]).abs().max().item()),
        ms=cuda_ms(lambda: coarse_scan.coarse_vbase(q, c32, cn, rot, W3,
                                                    False), reps=3),
        plain_ms_256_queries=cuda_ms(lambda: coarse_scan.coarse_vbase_plain(
            qs_, c32, cn, rot, W3, False), reps=3),
        library_ms=None,                 # timed above, for kernel 7
        **bound(4 * (NQ3 * D3 + KC3 * D3 + KC3 + D3 * D3)
                + NQ3 * W3 * (12 + 2 * D3), 2.0 * NQ3 * KC3 * D3, PEAK_F32))
    shapes["coarse_probe@large_kc"] = coarse_layout(
        shapes["coarse_probe@large_kc"], "vbase", NQ3, KC3, D3, W3)
    del kv, pv, pvals, pcells, kcells, kdist, pdist, same
    emit("two_level_kernels", kernels_at_this_path=shapes,
         seconds=time.perf_counter() - t0)

    # ---- the main path, with every launch count zeroed first
    t0 = time.perf_counter()
    zero_counts()
    ids, dists = index.search_padded(q, TOPK, w=W3)
    counts = read_counts("two_level", ["topk_index", "cell_rank",
                                       "grouped_scan_knorm", "topk_payload",
                                       "probe_scan"],
                         idle=["coarse_probe", "grouped_scan",
                               "coarse_topw"])
    check(ids.shape == (NQ3, TOPK) and np.isfinite(dists).all()
          and (ids >= 0).all() and (ids < N3).all(), "two-level output")
    check(bool((np.diff(dists, axis=1) >= 0).all()), "distances not sorted")
    # the probed cells against the exact top-w of the same centroids, and
    # the stage-2 distances (bf16 products) against true squared distances
    naive = NaiveCoarseQuantizer(cq.centroids, cq.metric)
    tl_cells, tl_d = cq.search(q, W3)
    zero_counts()                     # the naive-coarse checks: kernels 7, 1
    ex_cells, _ = naive.search(q, W3)
    hit = (tl_cells[:, :, None] == ex_cells[:, None, :]).any(dim=2) \
        .float().mean().item()
    check(hit >= 0.8, f"two-level cells overlap the exact top-{W3} on {hit}")
    tl_cent = cq.centroids[tl_cells.to(torch.int64)]
    true_d = torch.sum((q[:, None, :] - tl_cent) ** 2, dim=-1)
    # |q|^2 - 2 q.c + |c|^2 over an int8 table with bf16 products: the error
    # scales with the terms, not with the distance (on clustered data a
    # query lies close to its cells: distances far below |q|^2 + |c|^2), so
    # the bf16-level bound is taken against the terms' magnitude
    # the bound is set from the first readings of this phase (0.0017 of
    # the terms on this data; H100 80GB HBM3, 700 W)
    mag = torch.sum(q * q, dim=1)[:, None] + torch.sum(tl_cent ** 2, dim=-1)
    err_mag = ((tl_d - true_d).abs() / mag).max().item()
    check(err_mag <= 3e-3, f"stage-2 distances off the true ones by "
                           f"{err_mag} of |q|^2 + |c|^2")
    del tl_cent
    # and tightly against the scan's own decomposition evaluated in f32 on
    # the same table: |q|^2 + bf16(-2q).row + sum bf16(row^2), row =
    # bf16(int8 * bf16(scale)) at the returned cell's slot
    flat_perm = cq.perm2d.reshape(-1)
    live = torch.nonzero(flat_perm >= 0).reshape(-1)
    slot = torch.empty(KC3, dtype=torch.int64, device=dev)
    slot[flat_perm[live].to(torch.int64)] = live
    sc16 = cq.cent_scale.to(torch.bfloat16).to(torch.float32)
    rows = (cq.cent_scan[slot[tl_cells.to(torch.int64)]].to(torch.float32)
            * sc16).to(torch.bfloat16).to(torch.float32)   # (NQ3, W3, d_pad)
    vq = torch.nn.functional.pad(
        (-2.0 * q).to(torch.bfloat16).to(torch.float32),
        (0, rows.shape[-1] - D3))
    dec_d = (torch.sum(vq[:, None, :] * rows, dim=-1)
             + torch.sum((rows * rows).to(torch.bfloat16).to(torch.float32),
                         dim=-1)) + torch.sum(q * q, dim=1)[:, None]
    torch.testing.assert_close(tl_d, dec_d, rtol=1e-5, atol=1e-3)
    err_dec = (tl_d - dec_d).abs().max().item()
    del rows, vq, dec_d
    _, gt = brute_force_topk(base, q, TOPK)
    recall = recall_at_r(ids, gt, TOPK)
    naive_index = IVFADCIndex(
        dataclasses.replace(index.config, coarse_quantizer="naive"), naive,
        index.quantizer, index.store, index.data_dtype, index.dim)
    n_ids, _ = naive_index.search_padded(q, TOPK, w=W3)
    counts_naive = read_counts(
        "two_level_naive_checks", ["coarse_topw", "coarse_probe",
                                   "probe_scan", "topk_index"],
        idle=["cell_rank", "grouped_scan", "grouped_scan_knorm",
              "topk_payload"])
    recall_naive = recall_at_r(n_ids, gt, TOPK)
    check(recall >= recall_naive - 0.02,
          f"two-level recall {recall} vs naive-coarse {recall_naive}")
    lut_index = IVFADCIndex(
        dataclasses.replace(index.config, scan_mode="lut"), cq,
        index.quantizer, index.store, index.data_dtype, index.dim)
    n_lut = 512
    l_ids, _ = lut_index.search_padded(q[:n_lut], TOPK, w=W3)
    overlap_lut = float(np.mean([len(set(a) & set(b)) / TOPK
                                 for a, b in zip(ids[:n_lut], l_ids)]))
    check(overlap_lut >= 0.95, f"two-level dense / LUT overlap {overlap_lut}")
    one_i, one_d = index.search(q[0], TOPK, w=W3)
    check(one_i.shape == one_d.shape == (TOPK,)
          and bool((np.diff(one_d) >= 0).all())
          and len(set(one_i.tolist()) & set(ids[0].tolist())) >= TOPK - 1,
          "two-level single-point search")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "two_level.npz")
        index.save(path)
        file_mb = os.path.getsize(path) / 1e6
        loaded = IVFADCIndex.load(path, device="cuda")
    check(loaded.coarse.kind == "two_level"
          and torch.equal(loaded.coarse.cent_scan, cq.cent_scan)
          and torch.equal(loaded.coarse.perm2d, cq.perm2d),
          "two-level arrays changed across save/load")
    ids2, dists2 = loaded.search_padded(q, TOPK, w=W3)
    check(np.array_equal(ids, ids2) and np.array_equal(dists, dists2),
          "save/load changed two-level search results")
    del loaded
    times = []
    for _ in range(7):                        # first two: warm-up
        t1 = time.perf_counter()
        index._device_search(q, TOPK, W3)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    batch_ms = 1e3 * float(np.median(times[2:]))
    prof = phase_profile(lambda i: index._device_search(q, TOPK, W3), 3)
    prof_coarse = phase_profile(lambda i: cq.search(q, W3), 3)
    coarse_share = None
    if prof["device_busy_ms_per_batch"]:
        coarse_share = (prof_coarse["device_busy_ms_per_batch"]
                        / prof["device_busy_ms_per_batch"])
    emit("two_level", queries=NQ3, w=W3, k=TOPK, recall_at_10=recall,
         recall_at_10_naive_coarse=recall_naive,
         cells_overlap_exact_topw=hit,
         stage2_dist_max_err_of_terms=err_mag,
         stage2_dist_max_abs_err_vs_decomposition=err_dec,
         stage2_dist_max_abs_err=float((tl_d - true_d).abs().max()),
         stage2_dist_range=[float(true_d.min()), float(true_d.max())],
         top10_overlap_lut=overlap_lut, lut_queries=n_lut,
         save_load_identical=True, file_mb=file_mb, batch_ms=batch_ms,
         qps=NQ3 / (batch_ms / 1e3), coarse_share_of_device_time=coarse_share,
         device_idle_share=prof["device_idle_share"], launches=counts,
         launches_naive_checks=counts_naive,
         profile=prof, coarse_profile_top=prof_coarse["top"][:6],
         seconds=time.perf_counter() - t0)

    # ---- one batch under IVFADC_RANK_ENGINE=v2: stage 2's counting prep on
    # kernel 11, bit-equal results
    t0 = time.perf_counter()
    zero_counts()
    with env(IVFADC_RANK_ENGINE="v2"):
        r_ids, r_dists = index.search_padded(q, TOPK, w=W3)
    counts_r = read_counts("two_level_rank_v2", ["cell_rank_v2",
                                                 "grouped_scan_knorm"],
                           idle=["cell_rank"])
    check(np.array_equal(r_ids, ids) and np.array_equal(r_dists, dists),
          "two-level results under rank v2 differ from v1's")
    emit("two_level_rank_v2", launches=counts_r, bit_equal_v1=True,
         seconds=time.perf_counter() - t0)

    # ---- stage 2 under IVFADC_EXTRACT=1: the cells of the buffered route
    # (bit-equal distances; ids may differ only at exact ties), counts zeroed
    t0 = time.perf_counter()
    zero_counts()
    os.environ["IVFADC_EXTRACT"] = "1"
    try:
        x_ids, x_dists = index.search_padded(q, TOPK, w=W3)
        counts_x = read_counts("two_level_extract", ["grouped_scan_extract",
                                                     "probe_scan"],
                               idle=["grouped_scan_knorm"])
    finally:
        del os.environ["IVFADC_EXTRACT"]
    x_cells, x_d = cq.search(q, W3, extract=True)
    cell_tie_rows = ties_only(x_cells.cpu().numpy(), x_d.cpu().numpy(),
                              tl_cells.cpu().numpy(), tl_d.cpu().numpy())
    search_tie_rows = ties_only(x_ids, x_dists, ids, dists)
    emit("two_level_extract", launches=counts_x,
         stage2_cells_rows_differing_at_ties=cell_tie_rows,
         search_rows_differing_at_ties=search_tie_rows,
         seconds=time.perf_counter() - t0)
    del x_cells, x_d, tl_cells, tl_d

    # ---- one batch of NQ3_BIG queries: B*w >= 4*kc, so the posting scan is
    # the grouped one (sort-based tile prep -> 8b with pos8 payloads ->
    # kernel 6), held to the per-probe route on the same queries
    t0 = time.perf_counter()
    check(NQ3_BIG * W3 >= 4 * KC3 > NQ3 * W3, "batch sizes and routes")
    gq2 = torch.Generator(device=dev).manual_seed(3)
    extra = NQ3_BIG - NQ3
    qidx2 = torch.randint(0, N3, (extra,), generator=gq2, device=dev)
    q_big = torch.cat([q, base[qidx2] + 0.05 * torch.randn(
        (extra, D3), generator=gq2, device=dev)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    g_ids, g_dists = index.search_padded(q_big, TOPK, w=W3)
    counts_g = read_counts("two_level_grouped", [
        "grouped_scan_pos8", "grouped_scan_knorm", "cell_rank",
        "topk_payload", "topk_index"],
        idle=["probe_scan", "grouped_scan", "coarse_probe", "coarse_topw"])
    check(counts_g["grouped_scan_pos8"] == 1, "8b launched once")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(g_ids.shape == (NQ3_BIG, TOPK) and np.isfinite(g_dists).all()
          and (g_ids >= 0).all() and (g_ids < N3).all()
          and bool((np.diff(g_dists, axis=1) >= 0).all()),
          "grouped large-kc output")
    p_ids, p_dists = zip(*[index.search_padded(q_big[s0:s0 + NQ3], TOPK,
                                               w=W3)
                           for s0 in range(0, NQ3_BIG, NQ3)])
    p_ids, p_dists = np.concatenate(p_ids), np.concatenate(p_dists)
    overlap_raw = float(np.mean([len(set(a) & set(b)) / TOPK
                                 for a, b in zip(g_ids, p_ids)]))
    overlap_pp = tie_overlap(g_ids, g_dists, p_ids, p_dists)
    check(overlap_pp >= 0.999, f"grouped / per-probe overlap {overlap_pp}")
    same = g_ids == p_ids
    dist_diff = float(np.abs(g_dists - p_dists)[same].max())
    check(dist_diff <= 1e-3, f"grouped / per-probe distances {dist_diff}")
    recall_g = recall_at_r(g_ids[:NQ3], gt, TOPK)
    check(abs(recall_g - recall) <= 0.005,
          f"grouped recall {recall_g} vs per-probe {recall}")
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        index._device_search(q_big, TOPK, W3)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    big_ms = 1e3 * float(np.median(times))
    prof_big = phase_profile(lambda i: index._device_search(q_big, TOPK, W3),
                             2)
    del p_ids, p_dists

    # 8b against its plain version on the batch's own tiles: every tile's
    # rows are written (empty slots too); the plain version on a strided
    # sample of tiles, first to last
    view = index.store.device_view_dense(index.quantizer,
                                         index.config.scan_chunk)
    cells_b, v_b, base_b, _ = _dense_probe(
        cq, index.quantizer.rotation, q_big, w=W3, metric=index.quant_metric,
        include_base=index.config.score_mode == "reference",
        apply_rot=False, residual_based=True)
    d_dec = view["decoded"].shape[1]
    pbp, nfp = index.config.scan_pb, index.config.scan_fold_lanes
    tstart, tsize, v_t, b_t, _ = dense_scan.place_tiles(
        cells_b, view["offsets"], view["sizes"],
        torch.nn.functional.pad(v_b, (0, d_dec - v_b.shape[-1])), base_b,
        kc=KC3, pb=pbp)
    del v_b
    T = tstart.shape[0]
    pargs = (tstart, tsize, v_t, b_t, view["decoded"], view["scale"], None,
             None)
    pkw = dict(pb=pbp, nf=nfp, norm_coef=1.0, pos8=True)
    kd, kp = dense_scan.grouped_scan(*pargs, **pkw)
    check(kp.dtype == torch.int8, "pos8 payloads")
    sub = torch.unique(torch.cat([torch.arange(0, T, 128, device=dev),
                                  torch.tensor([T - 1], device=dev)]))
    sargs = (tstart[sub], tsize[sub],
             v_t.reshape(T, pbp, d_dec)[sub].reshape(-1, d_dec),
             b_t.reshape(T, pbp, 1)[sub].reshape(-1, 1), view["decoded"],
             view["scale"], None, None)
    pd, pp = dense_scan.grouped_scan_plain(*sargs, **pkw)
    err8b, agree8b = close_scan(
        (kd.reshape(T, pbp, nfp)[sub].reshape(-1, nfp),
         kp.reshape(T, pbp, nfp)[sub].reshape(-1, nfp)), (pd, pp),
        "8b grouped scan")
    out_gb = (kd.numel() * 4 + kp.numel()) / 1e9
    del kd, kp, pd, pp
    sizes64 = view["sizes"].to(torch.int64)
    live_tiles = int((tsize > 0).sum().item())
    cell_rows = int(sizes64[torch.unique(cells_b)].sum().item())
    probe_rows = int(sizes64[cells_b.to(torch.int64)].sum().item())
    tile_rows = int(tsize.to(torch.int64).sum().item())
    record8b = dict(
        source="ivfadc_tpu_torch/csrc/dense_scan.cu",
        replaces="ivfadc_tpu/ops/pallas_scan.py:347", max_abs_err=err8b,
        blocks_agree=agree8b, batch=NQ3_BIG, w=W3, tiles=T,
        live_tiles=live_tiles, slot_rows_written=T * pbp,
        probes=NQ3_BIG * W3, plain_tiles=int(sub.numel()),
        output_gb=out_gb,
        ms=cuda_ms(lambda: dense_scan.grouped_scan(*pargs, **pkw), reps=3),
        plain_ms=cuda_ms(lambda: dense_scan.grouped_scan_plain(*sargs,
                                                               **pkw),
                         reps=3),
        library_ms=None,             # no single PyTorch call scans CSR cells
        # every slot row's outputs are written (4 + 1 B a lane); v rows of
        # live tiles and every base are read
        **bound(cell_rows * d_dec + live_tiles * pbp * 2 * d_dec
                + T * pbp * 4 + 8 * T + T * pbp * nfp * 5,
                2.0 * d_dec * (probe_rows + tile_rows), PEAK_BF16))
    record8b = scan_layout(
        record8b, lambda: dense_scan.grouped_scan(*pargs, **pkw),
        dense_scan.GROUPED_KERNELS["pos8", "int8"], d_dec, pbp, nfp,
        calls=3)
    del pargs, sargs, v_t, b_t, tstart, tsize
    emit("two_level_grouped", queries=NQ3_BIG, w=W3, k=TOPK,
         route="sort prep -> 8b pos8 -> kernel 6", launches=counts_g,
         top10_overlap_per_probe_tie_aware=overlap_pp,
         top10_overlap_per_probe=overlap_raw,
         max_dist_diff_per_probe=dist_diff,
         recall_at_10_first_4096=recall_g, recall_at_10_per_probe=recall,
         batch_ms=big_ms, qps=NQ3_BIG / (big_ms / 1e3),
         max_memory_allocated_gb=peak_gb, tiles=T, live_tiles=live_tiles,
         device_idle_share=prof_big["device_idle_share"], profile=prof_big,
         seconds=time.perf_counter() - t0)
    return {"grouped_scan_knorm": record, "grouped_scan_pos8": record8b,
            "grouped_scan_extract@stage2": extract_stage2,
            "index": index, "queries": q}


def rebuilt(index):
    """An index over a copy of `index`'s host state, whose views are built
    afresh (the mutated index's own views stay untouched)."""
    import torch
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.models.inverted import PostingStore
    st = index.store
    store = PostingStore(st.kc, st.m, st.code_dtype,
                         offsets=st.offsets.copy(), caps=st.caps.copy(),
                         sizes=st.sizes.copy(), codes=st.codes.copy(),
                         ids=st.ids.copy(), device=st.device)
    torch.cuda.synchronize()
    return IVFADCIndex(index.config, index.coarse, index.quantizer, store,
                       index.data_dtype, index.dim)


def hold_to_rebuild(index, batches, w: int, what: str) -> dict:
    """The mutated index's views (patched in place, or rebuilt where a
    mutation dropped them) against views built afresh from the same host
    state: every array bit-equal, and each batch's search results (ids
    and distances) bit-equal. Returns the view access time (the flush or
    rebuild of the first search after the mutation) and the search
    times."""
    import torch
    st = index.store
    t1 = time.perf_counter()
    view = st.device_view_dense(index.quantizer, index.config.scan_chunk,
                                cache=index._resolve_cache())
    torch.cuda.synchronize()
    access_ms = 1e3 * (time.perf_counter() - t1)
    lut = st._device
    fresh = rebuilt(index)
    want = fresh.store.device_view_dense(index.quantizer,
                                         index.config.scan_chunk,
                                         cache=index._resolve_cache())
    for key, a in want.items():
        if isinstance(a, torch.Tensor):
            check(torch.equal(view[key], a), f"{what}: dense view {key} "
                                             f"differs from a rebuild")
        elif key in ("ids2d", "norms2d"):
            check(view[key] is None, f"{what}: {key}")
    if lut is not None:
        want = fresh.store.device_view()
        for key in ("codes", "ids", "offsets", "sizes"):
            check(torch.equal(lut[key], want[key]),
                  f"{what}: LUT view {key} differs from a rebuild")
    search_ms = {}
    for qq in batches:
        t1 = time.perf_counter()
        got = index.search_padded(qq, TOPK, w=w)
        search_ms[qq.shape[0]] = 1e3 * (time.perf_counter() - t1)
        ref = fresh.search_padded(qq, TOPK, w=w)
        check(np.array_equal(got[0], ref[0]) and np.array_equal(got[1],
                                                                ref[1]),
              f"{what}: B={qq.shape[0]} results differ from a rebuild's")
    ids = st.ids
    check(np.array_equal(np.sort(ids[ids >= 0]), np.arange(len(index))),
          f"{what}: ids not the range 0..n-1")
    del fresh
    return dict(view_access_ms=access_ms, search_ms=search_ms,
                lut_view=lut is not None)


N_PUSH = 262144                      # the dynamic phase's push_batch
N_PUSH3 = 65536                      # the same on the large-kc index
N_OPQ = 200_000                      # the OPQ index


def phase_dynamic(index, base, queries, zero_counts, read_counts) -> dict:
    """Mutate a fork of the SIFT1M index through every dynamic op; after
    each step hold its views and searches (B=16384 grouped, B=256 per
    probe) to a rebuild; then recall against the oracle of its own
    contents, and the parent's results unchanged."""
    import torch
    from benchmarks.oracle import ReferenceOracle
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    from ivfadc_tpu_torch.utils.evaluation import brute_force_topk, recall_at_r

    dev = base.device
    qa, qs = queries[:BATCH], queries[:B_SMALL]
    parent_before = index.search_padded(qa, TOPK, w=W)
    new = torch.as_tensor(synthetic_clustered(N_PUSH, D, seed=7), device=dev)
    extra = torch.as_tensor(synthetic_clustered(1010, D, seed=8), device=dev)
    pool = torch.cat([base, new, extra])
    tokens = np.arange(N, dtype=np.int64)          # id -> row of `pool`
    rng = np.random.RandomState(11)
    steps = {}
    zero_counts()
    t0 = time.perf_counter()
    fork = index.fork()
    caps0 = fork.store.caps.copy()
    t1 = time.perf_counter()
    fork.push_batch(new)
    torch.cuda.synchronize()
    push_batch_s = time.perf_counter() - t1
    tokens = np.concatenate([tokens, N + np.arange(N_PUSH)])
    grown = int((fork.store.caps != caps0).sum())
    check(grown > 0, "push_batch grew no cell")
    steps["push_batch"] = hold_to_rebuild(fork, (qa, qs), W, "push_batch")
    push_ms = []
    for i in range(1000):
        t1 = time.perf_counter()
        fork.push(extra[i].cpu().numpy())
        push_ms.append(1e3 * (time.perf_counter() - t1))
    tokens = np.concatenate([tokens, N + N_PUSH + np.arange(1000)])
    steps["push"] = hold_to_rebuild(fork, (qa, qs), W, "push")
    delete_ms = []
    for _ in range(1000):
        target = int(rng.randint(len(fork)))
        t1 = time.perf_counter()
        fork.delete([target])
        delete_ms.append(1e3 * (time.perf_counter() - t1))
        tokens = np.delete(tokens, target)
    steps["delete"] = hold_to_rebuild(fork, (qa, qs), W, "delete")
    for name, count in (("delete_2048", 2048), ("delete_10000", 10000)):
        dels = rng.choice(len(fork), count, replace=False)
        t1 = time.perf_counter()
        fork.delete(dels)
        steps[name] = dict(op_ms=1e3 * (time.perf_counter() - t1))
        tokens = np.delete(tokens, dels)
        steps[name].update(hold_to_rebuild(fork, (qa, qs), W, name))
    for _ in range(100):
        fork.pop()
    tokens = tokens[:-100]
    steps["pop"] = hold_to_rebuild(fork, (qa, qs), W, "pop")
    for _ in range(100):
        fork.pop_front()
    tokens = tokens[100:]
    steps["pop_front"] = hold_to_rebuild(fork, (qa, qs), W, "pop_front")
    for i in range(10):
        fork.push_front(extra[1000 + i].cpu().numpy())
    tokens = np.concatenate([N + N_PUSH + 1000 + np.arange(10)[::-1],
                             tokens])
    steps["push_front"] = hold_to_rebuild(fork, (qa, qs), W, "push_front")
    counts = read_counts("dynamic", ["coarse_topw", "coarse_probe",
                                     "cell_rank", "grouped_scan",
                                     "topk_payload", "probe_scan",
                                     "topk_index"])
    ops_s = time.perf_counter() - t0
    # recall of the mutated index against the oracle of its own contents
    check(len(fork) == len(tokens), "model of the ids")
    contents = pool[torch.as_tensor(tokens, device=dev)]
    gq = torch.Generator(device=dev).manual_seed(12)
    pick = torch.randint(0, len(tokens), (N_SEARCH,), generator=gq,
                         device=dev)
    qr = contents[pick] + 0.05 * torch.randn((N_SEARCH, D), generator=gq,
                                             device=dev)
    ids, _ = fork.search_padded(qr, TOPK, w=W)
    _, gt = brute_force_topk(contents, qr, TOPK)
    oracle = ReferenceOracle(
        fork.coarse.centroids.cpu().numpy(),
        fork.quantizer.codebooks.cpu().numpy(),
        *zip(*[fork.store.cell_entries(c) for c in range(KC)]))
    o_ids, _ = oracle.search_batch(qr[:N_ORACLE].cpu().numpy(), TOPK, W)
    o_pad = np.full((N_ORACLE, TOPK), -1, np.int64)
    for i, row in enumerate(o_ids):
        o_pad[i, :len(row)] = row
    recall = recall_at_r(ids[:N_ORACLE], gt[:N_ORACLE], TOPK)
    recall_oracle = recall_at_r(o_pad, gt[:N_ORACLE], TOPK)
    check(abs(recall - recall_oracle) <= 0.01,
          f"mutated index recall {recall} vs oracle {recall_oracle}")
    parent_after = index.search_padded(qa, TOPK, w=W)
    check(np.array_equal(parent_before[0], parent_after[0])
          and np.array_equal(parent_before[1], parent_after[1]),
          "the fork's mutations reached the parent's results")
    del fork, pool, contents, new, extra
    torch.cuda.empty_cache()
    return dict(n_start=N, n_end=len(tokens), push_batch=N_PUSH,
                push_batch_s=push_batch_s,
                push_batch_points_per_s=N_PUSH / push_batch_s,
                cells_grown=grown, push_p50_ms=float(np.median(push_ms)),
                delete_p50_ms=float(np.median(delete_ms)),
                view_rebuild_ms_after_grow=steps["push_batch"][
                    "view_access_ms"],
                steps=steps, recall_at_10=recall,
                recall_at_10_oracle=recall_oracle, oracle_queries=N_ORACLE,
                parent_unchanged=True, launches=counts, ops_s=ops_s)


def phase_dynamic_two_level(index, q, zero_counts, read_counts) -> dict:
    """push_batch and a 2048-id delete on the large-kc index (8-row cells,
    no norm stream: grows move rows inside the views), each held to a
    rebuild; then the gathered engine (scan_gather_win=32) beside the
    default per-probe route on the same batch."""
    import torch
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.models.index import _dense_probe
    from ivfadc_tpu_torch.ops import dense_scan
    from ivfadc_tpu_torch.ops.gather_scan import gathered_scan, plan_gather
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered

    dev = q.device
    st = index.store
    check(st.align == 8 and st._device_dense is not None
          and st._device_dense["norms2d"] is None, "large-kc dense view")
    zero_counts()
    new = torch.as_tensor(synthetic_clustered(N_PUSH3, D3, seed=9),
                          device=dev)
    patches0, caps0 = st.grow_patches, st.caps.copy()
    t1 = time.perf_counter()
    index.push_batch(new)
    torch.cuda.synchronize()
    push_s = time.perf_counter() - t1
    grown = int((st.caps != caps0).sum())
    patched = st.grow_patches - patches0
    check(patched > 0, "no grow was patched in place")
    survived = st._device_dense is not None
    steps = {"push_batch": hold_to_rebuild(index, (q,), W3,
                                           "two-level push")}
    rng = np.random.RandomState(13)
    t1 = time.perf_counter()
    index.delete(rng.choice(len(index), 2048, replace=False))
    steps["delete_2048"] = dict(op_ms=1e3 * (time.perf_counter() - t1))
    steps["delete_2048"].update(hold_to_rebuild(index, (q,), W3,
                                                "two-level delete"))
    counts = read_counts("dynamic_two_level", [
        "topk_index", "cell_rank", "grouped_scan_knorm", "topk_payload",
        "probe_scan"])
    # the gathered engine on the same index and batch, at a window limit
    # of 32 rows, or of the p95 cell capacity where 32 leaves the plan off
    caps_p95 = float(np.percentile(st.caps, 95))
    limit = 32 if plan_gather(st.caps, 32)[0] else -(-int(caps_p95) // 8) * 8
    gidx = IVFADCIndex(dataclasses.replace(index.config,
                                           scan_gather_win=limit),
                       index.coarse, index.quantizer, st, index.data_dtype,
                       index.dim)
    win, covers_all = gidx._gather_plan()
    check(win > 0, "gather plan off")
    d_ids, _ = index.search_padded(q, TOPK, w=W3)
    g_ids, g_d = gidx.search_padded(q, TOPK, w=W3)
    check(np.isfinite(g_d).all() and bool((np.diff(g_d, axis=1) >= 0).all()),
          "gathered output")
    overlap = float(np.mean([len(set(a) & set(b)) / TOPK
                             for a, b in zip(g_ids, d_ids)]))
    check(overlap >= 0.99, f"gathered / per-probe overlap {overlap}")
    view = st.device_view_dense(index.quantizer, index.config.scan_chunk)
    cells, v, base, coef = _dense_probe(
        index.coarse, index.quantizer.rotation, q.to(torch.float32), w=W3,
        metric=index.quant_metric, include_base=True, apply_rot=False,
        residual_based=True)
    c64 = cells.to(torch.int64)
    starts, sizes = view["offsets"][c64], view["sizes"][c64]
    small = sizes <= win
    g_sizes, s_sizes = torch.where(small, sizes, 0), torch.where(small, 0,
                                                                 sizes)
    gather_ms = device_ms(lambda: gathered_scan(
        starts, g_sizes, v, base, view["decoded"], view["scale"],
        view["ids"], win=win, norm_coef=coef), calls=5)
    kernel5_ms = device_ms(lambda: dense_scan.dense_scan(
        starts, sizes, v, base, view["decoded"], view["scale"], k_out=TOPK,
        chunk=index._effective_chunk(), norm_coef=coef, nf=128), calls=5)
    kernel5_rest_ms = device_ms(lambda: dense_scan.dense_scan(
        starts, s_sizes, v, base, view["decoded"], view["scale"],
        k_out=TOPK, chunk=index._effective_chunk(), norm_coef=coef, nf=128),
        calls=5)
    search_ms = {}
    for name, x in (("per_probe", index), ("gathered", gidx)):
        x._device_search(q, TOPK, W3)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            x._device_search(q, TOPK, W3)
        torch.cuda.synchronize()
        search_ms[name] = 1e3 * (time.perf_counter() - t1) / 3
    del new
    return dict(push_batch=N_PUSH3, push_batch_s=push_s,
                push_batch_points_per_s=N_PUSH3 / push_s, cells_grown=grown,
                grows_patched_in_place=patched,
                dense_view_survived_push=survived, steps=steps,
                launches=counts, caps_p95=caps_p95, gather_limit=limit,
                gather_win=win, gather_covers_all=covers_all,
                probes_gathered=int(small.sum()), probes=int(small.numel()),
                gathered_top10_overlap=overlap,
                gathered_scan_device_ms=gather_ms,
                kernel5_device_ms_all_probes=kernel5_ms,
                kernel5_device_ms_large_cells=kernel5_rest_ms,
                batch_ms=search_ms)


def phase_opq(base, zero_counts, read_counts) -> dict:
    """An OPQ index (n=200,000 of the SIFT1M data, kc=1024, m=8): its
    rotation orthogonal, a grouped batch through the fused probe with the
    rotation and kernel 3, held to the same index's LUT route and to brute
    force."""
    import torch
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.evaluation import brute_force_topk, recall_at_r

    dev = base.device
    data = base[:N_OPQ]
    t1 = time.perf_counter()
    index = IVFADCIndex.build(data, kc=KC, k=KQ, m=M, seed=0,
                              kmeanspp_sample=65536,
                              quantization_method="opq")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    rot = index.quantizer.rotation.double()
    orth = float((rot @ rot.T - torch.eye(D, dtype=torch.float64,
                                          device=dev)).abs().max())
    check(index.quantizer.method == "opq" and orth <= 1e-4,
          f"OPQ rotation orthogonal to {orth}")
    gq = torch.Generator(device=dev).manual_seed(14)
    nq = 4096
    q = data[torch.randint(0, N_OPQ, (nq,), generator=gq, device=dev)] \
        + 0.05 * torch.randn((nq, D), generator=gq, device=dev)
    check(nq * W >= 4 * KC, "OPQ batch takes the grouped scan")
    zero_counts()
    ids, dists = index.search_padded(q, TOPK, w=W)
    counts = read_counts("opq", ["coarse_probe", "cell_rank", "grouped_scan",
                                 "topk_payload"],
                         idle=["coarse_topw", "probe_scan"])
    check(ids.shape == (nq, TOPK) and np.isfinite(dists).all()
          and (ids >= 0).all() and bool((np.diff(dists, axis=1) >= 0).all()),
          "OPQ search output")
    lut = IVFADCIndex(dataclasses.replace(index.config, scan_mode="lut"),
                      index.coarse, index.quantizer, index.store,
                      index.data_dtype, index.dim)
    l_ids, _ = lut.search_padded(q, TOPK, w=W)
    overlap = float(np.mean([len(set(a) & set(b)) / TOPK
                             for a, b in zip(ids, l_ids)]))
    check(overlap >= 0.95, f"OPQ dense / LUT overlap {overlap}")
    _, gt = brute_force_topk(data, q, TOPK)
    del index, lut
    return dict(n=N_OPQ, kc=KC, m=M, k=KQ, build_s=build_s,
                rotation_orthogonality=orth, queries=nq,
                recall_at_10=recall_at_r(ids, gt, TOPK),
                recall_at_10_lut=recall_at_r(l_ids, gt, TOPK),
                top10_overlap_lut=overlap, launches=counts)


N_SERVE_PUSH, N_SERVE_DEL, SERVE_MUTATIONS = 1000, 1000, 10
SERVE_S = 5.0                        # the serving phase's static window


def write_fvecs(path: str, data: np.ndarray) -> None:
    """The TEXMEX .fvecs layout: per row [int32 d][d x float32]."""
    n, d = data.shape
    rows = np.empty((n, d + 1), np.float32)
    rows[:, 0] = np.frombuffer(np.full(n, d, np.int32).tobytes(), np.float32)
    rows[:, 1:] = data
    rows.tofile(path)


def host_peak_rss_mb() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def phase_streaming(index, data, base, qa, qs, gt, recall_full, zero_counts,
                    read_counts) -> dict:
    """The SIFT1M base points as one .fvecs file, indexed out of core by
    build_from_files: (a) with the in-memory points as train_data, which
    must give the build phase's index bit for bit (store, digest, B=16384
    results); (b) on the default 2^18-point reservoir, whose recall@10
    must be within 0.02 of the full build's."""
    import torch
    from benchmarks.oracle import ReferenceOracle
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.evaluation import recall_at_r
    from ivfadc_tpu_torch.utils.repro import index_digest

    kw = dict(kc=KC, k=KQ, m=M, seed=0, kmeanspp_sample=65536)
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "base.fvecs")
        t1 = time.perf_counter()
        write_fvecs(path, data)
        out["file_bytes"] = os.path.getsize(path)
        out["file_write_s"] = time.perf_counter() - t1
        builds = {}
        for name, extra in (("train_data", dict(train_data=base)),
                            ("reservoir", {})):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            idx = IVFADCIndex.build_from_files(path, chunk_rows=262144,
                                               **extra, **kw)
            torch.cuda.synchronize()
            builds[name] = idx
            out[name] = dict(
                build_s=time.perf_counter() - t1,
                build_timings={k: round(v, 4)
                               for k, v in idx.build_timings.items()},
                device_peak_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
                device_resident_before_mb=resident / 2 ** 20,
                host_peak_rss_mb=host_peak_rss_mb())
    a, b = builds["train_data"], builds["reservoir"]
    for key in ("offsets", "caps", "sizes", "codes", "ids"):
        check(np.array_equal(getattr(a.store, key), getattr(index.store, key)),
              f"streamed build (train_data): store {key} differs from build")
    digest = index_digest(a)
    check(digest == index_digest(index),
          "streamed build (train_data): digest differs from build")
    zero_counts()
    got = a.search_padded(qa, TOPK, w=W)
    want = index.search_padded(qa, TOPK, w=W)
    check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]),
          "streamed build (train_data): B=16384 results differ from build")
    b_ids, _ = b.search_padded(qs, TOPK, w=W)
    counts = read_counts("streaming", ["coarse_probe", "cell_rank",
                                       "grouped_scan", "topk_payload"])
    recall_b = recall_at_r(b_ids, gt, TOPK)
    check(abs(recall_b - recall_full) <= 0.02,
          f"reservoir build recall {recall_b} vs full build {recall_full}")
    oracle = ReferenceOracle(
        b.coarse.centroids.cpu().numpy(), b.quantizer.codebooks.cpu().numpy(),
        *zip(*[b.store.cell_entries(c) for c in range(KC)]))
    o_ids, _ = oracle.search_batch(qs[:N_ORACLE].cpu().numpy(), TOPK, W)
    o_pad = np.full((N_ORACLE, TOPK), -1, np.int64)
    for i, row in enumerate(o_ids):
        o_pad[i, :len(row)] = row
    out.update(n=N, chunk_rows=262144, build_digest_train_data=digest,
               identical_to_build=True, recall_at_10_reservoir=recall_b,
               recall_at_10_reservoir_oracle=recall_at_r(
                   o_pad, gt[:N_ORACLE], TOPK),
               recall_at_10_reservoir_same_queries=recall_at_r(
                   b_ids[:N_ORACLE], gt[:N_ORACLE], TOPK),
               recall_at_10_full_build=recall_full, train_sample=1 << 18,
               launches=counts)
    del a, b, builds, oracle
    torch.cuda.empty_cache()
    return out


EXTRA_PBS = (4, 20, 100, 256)          # scan_pb values autotune does not try


def phase_tune(index, q) -> dict:
    """autotune on a B=16384 batch with the JAX package's default
    candidates (pb 16/32/64/128 x chunk 512/1024/2048): 12 timed rows,
    none an error (pb = 128 runs 64-row tiles, `dense_scan.tile_height`);
    every candidate's ids and distances bit-equal to the default
    config's, and those of EXTRA_PBS too; then memory_stats, its
    scan-cache bytes against the view's own tensors."""
    cfg0 = index.config
    want = index.search_padded(q, TOPK, w=W)
    t1 = time.perf_counter()
    out = index.autotune(q, k=TOPK, w=W)
    tune_s = time.perf_counter() - t1
    try:
        rows = out["results"]
        check(len(rows) == 12, f"autotune tried {len(rows)} candidates")
        for r in rows:
            check("error" not in r, f"autotune row {r} failed")
        best = out["best"]
        check(out["applied"] and best is not None
              and index.config.scan_pb == best["pb"]
              and index.config.scan_chunk == best["chunk"],
              "autotune did not apply its best candidate")
        for r in rows:
            index.config = dataclasses.replace(cfg0, scan_pb=r["pb"],
                                               scan_chunk=r["chunk"])
            index._drop_plans()
            got = index.search_padded(q, TOPK, w=W)
            check(np.array_equal(got[0], want[0])
                  and np.array_equal(got[1], want[1]),
                  f"autotune candidate pb={r['pb']} chunk={r['chunk']}: "
                  f"results differ from the default config's")
        # the other pb values the JAX package takes (C.23)
        for pb in EXTRA_PBS:
            index.config = dataclasses.replace(cfg0, scan_pb=pb)
            got = index.search_padded(q, TOPK, w=W)
            check(np.array_equal(got[0], want[0])
                  and np.array_equal(got[1], want[1]),
                  f"scan_pb={pb}: results differ from the default "
                  f"config's")
    finally:
        index.config = cfg0
        index._drop_plans()
    stats = index.memory_stats()
    view = index.store._device_dense
    scan_bytes = (view["decoded"].numel() * view["decoded"].element_size()
                  + view["ids2d"].numel() * 4)
    check(stats["device_scan_cache_bytes"] == scan_bytes,
          f"memory_stats scan cache {stats['device_scan_cache_bytes']} vs "
          f"the view's {scan_bytes} bytes")
    return dict(batch=q.shape[0], tune_s=tune_s, best=out["best"],
                candidates=[dict(r, ms=1e3 * r["seconds"]) for r in rows],
                results_identical=True, extra_pbs_identical=EXTRA_PBS,
                default_pb=cfg0.scan_pb,
                default_chunk=cfg0.scan_chunk, memory_stats=stats,
                scan_cache_bytes_of_view=scan_bytes)


def fixed_points(index, n: int, seed: int):
    """n points that the index stores exactly: a random cell's centroid
    plus the decoded residual of random codes, kept where the coarse
    search and the encoder give that cell and those codes back. A query
    at such a point scores its own posting at the cache's rounding error,
    far below any other posting's distance, so it is found at rank 0."""
    import torch
    from ivfadc_tpu_torch.ops import pq as pq_ops
    dev = index.device
    g = torch.Generator(device=dev).manual_seed(seed)
    cells = torch.randint(0, KC, (8 * n,), generator=g, device=dev)
    codes = torch.randint(0, KQ, (8 * n, M), generator=g, device=dev)
    cents = index.coarse.centroids
    pts = cents[cells] + pq_ops.decode(index.quantizer, codes)[:, :D]
    got_cells = index.coarse.search(pts, 1)[0][:, 0].to(torch.int64)
    got_codes = pq_ops.encode(index.quantizer, pts - cents[got_cells])
    ok = (got_cells == cells) & (got_codes.to(torch.int64) == codes).all(1)
    check(int(ok.sum()) >= n, f"only {int(ok.sum())} fixed points")
    return pts[ok][:n].cpu().numpy()


def serve_client(c, s, pool, stop, window, logs, errors) -> None:
    """One closed-loop client of a BatchingSearcher `s` until `stop`:
    clients 0-5 send single queries, the others arrays of 256 rows of
    `pool`, each waiting for its answer. Logs (window tag, first row, ndim,
    ids, seconds) per request; an exception goes to `errors`."""
    r = np.random.RandomState(100 + c)
    try:
        while not stop.is_set():
            i = r.randint(len(pool) - 256)
            q = pool[i] if c < 6 else pool[i:i + 256]
            tag = window[0]
            t1 = time.perf_counter()
            ids, _ = s.submit(q, TOPK, w=W).result(timeout=60)
            logs[c].append((tag, i, q.ndim, ids, time.perf_counter() - t1))
    except Exception as e:          # noqa: BLE001 - reported by the phase
        errors.append(repr(e))


def served_overlap(entries, queries, direct):
    """Top-k overlap of served requests (serve_client log entries) with
    `direct(rows)`, a direct search of the same query rows on the same
    index version -> (overlap, rows checked)."""
    import torch
    rows = np.concatenate([np.arange(i, i + (1 if nd == 1 else 256))
                           for _, i, nd, _, _ in entries])
    served = np.concatenate([ids.reshape(-1, TOPK)
                             for _, _, _, ids, _ in entries])
    got = direct(queries[torch.as_tensor(rows, device=queries.device)])
    return float(np.mean((served[:, :, None] == got[:, None, :])
                         .any(2).sum(1) / TOPK)), len(rows)


def phase_serving(index, queries, zero_counts, read_counts) -> dict:
    """A BatchingSearcher(max_batch=1024, max_wait_ms=2, pipeline=2) over
    the SIFT1M index: 16 single queries one at a time, then 8 client
    threads (6 sending single queries, 2 arrays of 256) for SERVE_S
    seconds: the clients' served QPS, request latency, dispatches,
    batch size, every served row held to a direct search of its rows (top-10
    overlap >= 0.99: coalesced batches cross the B*w >= 4*kc route
    boundary, so no bit-equality). Then, with the clients running,
    SERVE_MUTATIONS push_batch and delete mutations through the searcher
    (N_SERVE_PUSH points, N_SERVE_DEL ids): each one's fork time, the
    clients' latency meanwhile, and every pushed point found at rank 0 by
    a query submitted after its mutate returned."""
    import threading

    import torch
    from ivfadc_tpu_torch import BatchingSearcher

    pool = queries.cpu().numpy()
    pushed = fixed_points(index, N_SERVE_PUSH, seed=21)
    fork_ms = []
    live_fork = index.fork

    def timed_fork():
        t1 = time.perf_counter()
        snap = live_fork()
        fork_ms.append(1e3 * (time.perf_counter() - t1))
        return snap

    index.fork = timed_fork                  # what mutate() calls
    stop = threading.Event()
    window = ["static"]
    logs = [[] for _ in range(8)]
    errors = []
    zero_counts()
    s = BatchingSearcher(index, max_batch=1024, max_wait_ms=2, pipeline=2)
    threads = [threading.Thread(target=serve_client, daemon=True, args=(
        c, s, pool, stop, window, logs, errors)) for c in range(8)]
    mutations = []
    try:
        # single queries alone first: batches of one row take the
        # per-probe route (kernels 5, 6), which the clients' mixed load
        # reaches only when no array is pending
        for i in range(16):
            t1 = time.perf_counter()
            ids, _ = s.submit(pool[i], TOPK, w=W).result(timeout=60)
            logs[0].append(("alone", i, 1, ids, time.perf_counter() - t1))
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(SERVE_S)
        static_s = time.perf_counter() - t0
        q0, b0 = s.stats.queries - 16, s.stats.batches - 16
        counts = read_counts("serving", ["coarse_probe", "cell_rank",
                                         "grouped_scan", "topk_payload",
                                         "probe_scan", "topk_index"])
        window[0] = "mutating"
        # the index as the static window served it; static requests still
        # in flight (a few ms) end before the first mutation
        snap = live_fork()
        time.sleep(0.2)
        zero_counts()
        per = N_SERVE_PUSH // SERVE_MUTATIONS
        rng = np.random.RandomState(22)
        t_mut = time.perf_counter()
        for j in range(SERVE_MUTATIONS):
            pts = pushed[j * per:(j + 1) * per]
            n_before = len(index)
            t1 = time.perf_counter()
            s.push_batch(pts)
            push_ms = 1e3 * (time.perf_counter() - t1)
            ids, _ = s.submit(pts, TOPK, w=W).result(timeout=60)
            check(np.array_equal(ids[:, 0], n_before + np.arange(per)),
                  f"mutation {j}: pushed points not at rank 0")
            dels = np.sort(rng.choice(len(index), N_SERVE_DEL //
                                      SERVE_MUTATIONS, replace=False))
            t1 = time.perf_counter()
            s.delete(dels)
            mutations.append(dict(push_ms=push_ms, delete_ms=1e3 * (
                time.perf_counter() - t1)))
        mut_s = time.perf_counter() - t_mut
        # the pushes' cells by kernel 7, the clients' batches by 1-4
        counts_mut = read_counts("serving_mutations", [
            "coarse_topw", "coarse_probe", "cell_rank", "grouped_scan",
            "topk_payload"])
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        s.close()
        del index.fork
    check(not errors, f"serving clients failed: {errors[:3]}")
    check(not any(t.is_alive() for t in threads), "a client hung")
    for m, (f_push, f_del) in zip(mutations, zip(fork_ms[::2],
                                                 fork_ms[1::2])):
        m.update(fork_push_ms=f_push, fork_delete_ms=f_del)
    static = [e for log in logs for e in log if e[0] == "static"]
    during = [e for log in logs for e in log if e[0] == "mutating"]
    checked = static + [e for e in logs[0] if e[0] == "alone"]
    t1 = time.perf_counter()
    overlap, n_rows = served_overlap(checked, queries, lambda q: (
        snap.search_stream(q, TOPK, W, batch=B_SMALL)[0]))
    direct_s = time.perf_counter() - t1
    check(overlap >= 0.99, f"served / direct top-{TOPK} overlap {overlap}")
    lat = 1e3 * np.array([e[4] for e in static])
    lat_mut = 1e3 * np.array([e[4] for e in during])
    del snap
    torch.cuda.empty_cache()
    return dict(
        clients=8, single_clients=6, array_clients=2, array_rows=256,
        max_batch=1024, max_wait_ms=2, pipeline=2, static_s=static_s,
        requests=len(static), query_rows=int(q0),
        served_qps=q0 / static_s, dispatches=int(b0),
        mean_batch=q0 / max(b0, 1),
        latency_p50_ms=float(np.percentile(lat, 50)),
        latency_p99_ms=float(np.percentile(lat, 99)),
        top10_overlap_direct=overlap, direct_rows=n_rows,
        direct_check_s=direct_s, launches=counts,
        mutations=mutations, mutations_s=mut_s,
        fork_ms_p50=float(np.median(fork_ms)),
        fork_ms_max=float(np.max(fork_ms)),
        requests_during_mutations=len(during),
        latency_p50_ms_during_mutations=float(np.percentile(lat_mut, 50)),
        latency_p99_ms_during_mutations=float(np.percentile(lat_mut, 99)),
        launches_during_mutations=counts_mut,
        pushed=N_SERVE_PUSH, deleted=N_SERVE_DEL,
        pushed_found_at_rank_0=True, n_end=len(index))


SHARD_DEVICE = "cuda:0"              # the card the sharded views fill
N_SHARD_PUSH = 65536                 # a sharded push_batch: ~64 points a cell
WIDE_CAP = 1 << 20                   # the lowered device id cap of (d)
SHARD_SERVE_S = 2.0                  # the sharded serving window
N_SHARD_SERVE = 100                  # points a push, ids a delete, there


def batch_ms(fn) -> float:
    """Host ms of fn() between two synchronisations."""
    import torch
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t1)


def tie_slack(ids_a, d_a, ids_b) -> float:
    """The most recall@k two results with bit-equal distances can differ
    by when their ids differ only at ties: a hit can move only among a
    row's entries tied with its last distance."""
    n = sum(int((d == d[-1]).sum()) for ia, d, ib in zip(ids_a, d_a, ids_b)
            if not np.array_equal(ia, ib))
    return n / ids_a.size


def hold_to_fresh(view, batches, mesh, what: str) -> dict:
    """A mutated (refreshed) view against a ShardedIVFADCIndex built
    afresh over the same base: each batch's ids and distances bit-equal.
    Returns the fresh view's build seconds."""
    from ivfadc_tpu_torch import ShardedIVFADCIndex
    t1 = time.perf_counter()
    fresh = ShardedIVFADCIndex(view.index, mesh)
    build_s = time.perf_counter() - t1
    for name, q in batches.items():
        got, ref = view.search_padded(q, TOPK, w=W), \
            fresh.search_padded(q, TOPK, w=W)
        check(np.array_equal(got[0], ref[0]) and np.array_equal(got[1],
                                                                ref[1]),
              f"{what}: {name} results differ from a fresh view's")
    del fresh
    return dict(fresh_view_s=build_s)


def phase_sharded(index, queries, qs, gt, recall, smi, zero_counts,
                  read_counts) -> None:
    """The sharded view over the SIFT1M index (emits one line a part):

      sharded           (a) views of 4 shards on one card and of make_mesh()
                        (one shard): the search phase's 1000 queries, a
                        B=16384 (grouped) and a B=256 (per-probe) batch,
                        distances bit-equal to the single card's, ids but
                        at exact ties, recall@10 equal but at ties, each
                        batch's launches; batch ms beside the single card's
      sharded_mutations (c) a fork of the 4-shard view: push, a 1000-id
                        delete (the rows of the largest cells), push_front,
                        pop (each an incremental refresh), push_batch of
                        65,536 (a full one); each step bit-equal to a fresh
                        view; the parent view unchanged
      sharded_wide      (d) IVFADC_DEVICE_ID_CAP=2^20: a value-mode view
                        crossing it on a 65,536-point push_batch, wide ids
                        equal to an uncapped twin's, distances bit-equal;
                        the capped base's own search raises
      sharded_serving   (e) a BatchingSearcher over a fork of the 4-shard
                        view: 16 single queries, a closed loop of 8
                        clients for SHARD_SERVE_S, then 2 push_batch and 2
                        deletes through it; served top-10 overlap with the
                        view's own search >= 0.995"""
    import threading

    import torch
    from ivfadc_tpu_torch import (BatchingSearcher, ShardedIVFADCIndex,
                                  make_mesh)
    from ivfadc_tpu_torch.parallel.sharded import WIDE_NO_ID
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    from ivfadc_tpu_torch.utils.evaluation import recall_at_r

    # ---- (a) search
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    q16, q256 = queries[:BATCH], queries[BATCH:BATCH + B_SMALL]
    batches = {"queries_1000": qs, "b16384": q16, "b256": q256}
    single = {name: index.search_padded(q, TOPK, w=W)
              for name, q in batches.items()}
    grouped = ["coarse_probe", "cell_rank", "grouped_scan", "topk_payload",
               "topk_index"]
    per_probe = ["coarse_probe", "probe_scan", "topk_index"]
    mesh4 = make_mesh(n_shards=4, devices=[SHARD_DEVICE] * 4)
    views, out = {}, {}
    for S, mesh in ((1, make_mesh()), (4, mesh4)):
        t1 = time.perf_counter()
        view = ShardedIVFADCIndex(index, mesh)
        torch.cuda.synchronize()
        rec = dict(view_build_s=time.perf_counter() - t1, launches={},
                   tie_rows={})
        check(view.n_shards == S and view.wide_ids is False
              and all(v["decoded"].is_cuda for v in view.views),
              f"S={S}: shards not on the card")
        for name, q in batches.items():
            zero_counts()
            si, sd = view.search_padded(q, TOPK, w=W)
            counts = read_counts(
                f"sharded_s{S}_{name}", per_probe if name == "b256"
                else grouped, idle=["coarse_topw", "grouped_scan_knorm"])
            # the shards share the card: one coarse probe a search
            check(counts["coarse_probe"] == 1, f"S={S} {name}: coarse "
                                               f"probe launched "
                                               f"{counts['coarse_probe']}")
            rec["launches"][name] = {k: counts[k] for k in
                                     ("coarse_probe", "cell_rank",
                                      "grouped_scan", "topk_payload",
                                      "probe_scan", "topk_index")}
            rec["tie_rows"][name] = ties_only(si, sd, *single[name])
            if name == "queries_1000":
                rec["recall_at_10"] = recall_at_r(si, gt, TOPK)
                slack = tie_slack(si, sd, single[name][0])
                check(abs(rec["recall_at_10"] - recall) <= slack,
                      f"S={S}: recall {rec['recall_at_10']} vs {recall}")
        out[f"s{S}"] = rec
        views[S] = view
    ms = {"single": [], "s1": [], "s4": []}
    for r in range(11):                        # the first: warm-up
        for key, fn in (
                ("single", lambda: index._device_search(q16, TOPK, W)),
                ("s1", lambda: views[1]._dispatch(q16, TOPK, W, False)),
                ("s4", lambda: views[4]._dispatch(q16, TOPK, W, False))):
            t = batch_ms(fn)
            if r:
                ms[key].append(t)
    del views[1]
    emit("sharded", card=smi, recall_single=recall,
         batch_ms_b16384={k: float(np.median(v)) for k, v in ms.items()},
         device_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         memory_stats_s4={k: v for k, v in views[4].memory_stats().items()
                          if k in ("sharded_device_bytes_total",
                                   "n_shards")},
         **out, seconds=time.perf_counter() - t0)

    # ---- (c) mutations on a fork of the 4-shard view
    t0 = time.perf_counter()
    s4 = views[4]
    probe = {"b16384": q16, "b256": q256}
    before = {name: s4.search_padded(q, TOPK, w=W)
              for name, q in probe.items()}
    t1 = time.perf_counter()
    fork = s4.fork()
    fork_ms = 1e3 * (time.perf_counter() - t1)
    st = fork.index.store
    dels = []
    for c in np.argsort(-st.sizes, kind="stable"):
        dels.extend(st.cell_entries(int(c))[0].tolist())
        if len(dels) >= 1000:
            break
    dels = np.sort(np.asarray(dels[:1000]))
    pts = qs[:2].cpu().numpy()
    steps = {}
    for name, fn in (("push", lambda: fork.push(pts[0])),
                     ("delete_1000", lambda: fork.delete(dels)),
                     ("push_front", lambda: fork.push_front(pts[1])),
                     ("pop", lambda: fork.pop())):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        steps[name] = dict(ms=1e3 * (time.perf_counter() - t1),
                           refresh=fork._last_refresh)
        check(fork._last_refresh == "incremental",
              f"{name}: refresh {fork._last_refresh}")
        steps[name].update(hold_to_fresh(fork, probe, mesh4, name))
    big = synthetic_clustered(N_SHARD_PUSH, D, seed=33)
    caps = fork._h_caps.copy()
    t1 = time.perf_counter()
    fork.push_batch(big)
    torch.cuda.synchronize()
    kc_all = np.arange(KC)
    outgrown = float(np.mean(st.sizes > caps[kc_all % 4, kc_all]))
    steps["push_batch"] = dict(ms=1e3 * (time.perf_counter() - t1),
                               refresh=fork._last_refresh,
                               cells_outgrown=outgrown)
    check(fork._last_refresh == "full", f"push_batch: refresh "
                                        f"{fork._last_refresh}")
    steps["push_batch"].update(hold_to_fresh(fork, probe, mesh4,
                                             "push_batch"))
    for name, q in probe.items():
        got = s4.search_padded(q, TOPK, w=W)
        check(all(np.array_equal(a, b) for a, b in zip(got, before[name])),
              f"the parent view's {name} results changed")
    n_fork = len(fork.index)
    del fork
    emit("sharded_mutations", card=smi, fork_ms=fork_ms, steps=steps,
         n_end=n_fork, parent_unchanged=True,
         seconds=time.perf_counter() - t0)

    # ---- (d) wide ids past a lowered device id cap
    t0 = time.perf_counter()
    big = synthetic_clustered(N_SHARD_PUSH, D, seed=34)
    twin = ShardedIVFADCIndex(index.fork(), mesh4)
    twin.push_batch(big)
    ref_i, ref_d = twin.search_padded(q16, TOPK, w=W)
    del twin
    cap = WIDE_CAP
    with env(IVFADC_DEVICE_ID_CAP=str(cap)):
        capped = ShardedIVFADCIndex(index.fork(), mesh4)
        check(not capped.wide_ids and len(capped.index) < cap,
              "the capped view does not start in value mode")
        t1 = time.perf_counter()
        capped.push_batch(big)
        torch.cuda.synchronize()
        upgrade_ms = 1e3 * (time.perf_counter() - t1)
        check(capped.wide_ids and len(capped.index) > cap, "no wide ids")
        ids, dists = capped.search_padded(q16, TOPK, w=W)
        try:
            capped.index.search_padded(q16, TOPK, w=W)
            raised = False
        except AssertionError:
            raised = True
        check(raised, "the capped base's own search did not raise")
    check(ids.dtype == np.uint64 and not (ids == WIDE_NO_ID).any()
          and np.array_equal(ids, ref_i.astype(np.uint64))
          and np.array_equal(dists, ref_d),
          "wide ids differ from the uncapped twin's")
    n_wide = len(capped.index)
    del capped
    emit("sharded_wide", card=smi, device_id_cap=cap, n=n_wide,
         upgrade_push_batch_ms=upgrade_ms, ids_equal_twin=True,
         base_search_raised=True, seconds=time.perf_counter() - t0)

    # ---- (e) serving over a fork of the 4-shard view
    t0 = time.perf_counter()
    sv = s4.fork()
    pool = queries.cpu().numpy()
    pushed = fixed_points(index, 2 * N_SHARD_SERVE, seed=35)
    stop = threading.Event()
    window = ["static"]
    logs = [[] for _ in range(8)]
    errors = []
    zero_counts()
    s = BatchingSearcher(sv, max_batch=1024, max_wait_ms=2)
    threads = [threading.Thread(target=serve_client, daemon=True, args=(
        c, s, pool, stop, window, logs, errors)) for c in range(8)]
    rng = np.random.RandomState(36)
    try:
        for i in range(16):
            t1 = time.perf_counter()
            ids, _ = s.submit(pool[i], TOPK, w=W).result(timeout=60)
            logs[0].append(("alone", i, 1, ids, time.perf_counter() - t1))
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(SHARD_SERVE_S)
        static_s = time.perf_counter() - t1
        q0, b0 = s.stats.queries - 16, s.stats.batches - 16
        window[0] = "mutating"
        snap = sv.fork()
        counts = read_counts("sharded_serving", grouped + ["probe_scan"])
        for j in range(2):
            p = pushed[j * N_SHARD_SERVE:(j + 1) * N_SHARD_SERVE]
            n_before = len(sv.index)
            s.push_batch(p)
            got, _ = s.submit(p, TOPK, w=W).result(timeout=60)
            check(np.array_equal(got[:, 0], n_before + np.arange(len(p))),
                  f"sharded serving: pushed points not at rank 0 ({j})")
            s.delete(np.sort(rng.choice(len(sv.index), N_SHARD_SERVE,
                                        replace=False)))
        refreshes = sv._last_refresh
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        s.close()
    check(not errors, f"sharded serving clients failed: {errors[:3]}")
    check(not any(t.is_alive() for t in threads), "a client hung")
    static = [e for log in logs for e in log if e[0] == "static"]
    overlap, n_rows = served_overlap(
        static + [e for e in logs[0] if e[0] == "alone"], queries,
        lambda q: np.concatenate([snap.search_padded(
            q[i:i + B_SMALL], TOPK, w=W)[0]
            for i in range(0, q.shape[0], B_SMALL)]))
    check(overlap >= 0.995, f"sharded served / direct top-{TOPK} overlap "
                            f"{overlap}")
    lat = 1e3 * np.array([e[4] for e in static])
    del snap, sv
    emit("sharded_serving", card=smi, clients=8, static_s=static_s,
         requests=len(static), query_rows=int(q0), served_qps=q0 / static_s,
         dispatches=int(b0), mean_batch=q0 / max(b0, 1),
         latency_p50_ms=float(np.percentile(lat, 50)),
         latency_p99_ms=float(np.percentile(lat, 99)),
         top10_overlap_direct=overlap, direct_rows=n_rows, launches=counts,
         mutations=4, last_refresh=refreshes, pushed_found_at_rank_0=True,
         seconds=time.perf_counter() - t0)
    del s4, views
    torch.cuda.empty_cache()


N_DIST_PUSH = 65536                  # the distributed view's push_batch
N_DIST_DEL = 1000                    # its delete
RANK_TIMEOUT_S = 420                 # a spawned rank's limit in (d)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _distributed_rank(rank: int, port: int, out_dir: str, phase: str,
                      device: str, shape: tuple):
    """One rank of phase_distributed's (d): two ranks on `device` (the
    card: gloo, since NCCL refuses two ranks on one card), two shards each
    of a global 1 x 4 mesh. `build` builds from the build phase's points
    (`shape` = (n, d, kc, m, k)) and searches the 1000 queries, then saves
    its own shard files; `load` loads the directory in a fresh group and
    searches again. Writes its results and timings into `out_dir`."""
    sys.path.insert(0, ROOT)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ivfadc_tpu_torch import IVFADCConfig
    from ivfadc_tpu_torch.parallel import (ShardedIVFADCIndex,
                                           initialize_cluster,
                                           load_sharded_index, make_mesh,
                                           process_info, save_sharded_index,
                                           shutdown_cluster)
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    t0 = time.perf_counter()
    ok = initialize_cluster(f"127.0.0.1:{port}", 2, rank, [0, 0])
    info = process_info()
    check(ok and info["process_count"] == 2
          and info["global_device_count"] == 4, f"rank {rank}: {info}")
    mesh = make_mesh(n_shards=4)
    q = np.load(os.path.join(out_dir, "queries.npy"))
    rec = dict(rank=rank, backend=info["backend"],
               init_s=time.perf_counter() - t0)
    path = os.path.join(out_dir, "dir")
    t1 = time.perf_counter()
    if phase == "build":
        n, d, kc, m, k = shape
        data = torch.as_tensor(synthetic_clustered(n, d, seed=0),
                               device=device)
        view = ShardedIVFADCIndex.build(data, mesh, IVFADCConfig(
            kc=kc, k=k, m=m, seed=0))
        del data
    else:
        view = load_sharded_index(path, mesh)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    rec[f"{phase}_s"] = time.perf_counter() - t1
    if phase == "build":
        rec["build_stages_s"] = view.build_timings
    held = [v for v in view.views if v is not None]
    check(len(held) == 2 and all(v["ids"].device.type ==
                                 torch.device(device).type for v in held),
          f"rank {rank}: not 2 shards on {device}")
    ids, dists = view.search_padded(q, TOPK, w=W)
    if phase == "build":
        t1 = time.perf_counter()
        save_sharded_index(path, view)
        rec["save_s"] = time.perf_counter() - t1
    np.savez(os.path.join(out_dir, f"{phase}{rank}.npz"), ids=ids,
             dists=dists)
    with open(os.path.join(out_dir, f"{phase}{rank}.json"), "w") as f:
        json.dump(rec, f)
    shutdown_cluster()


def run_ranks(phase: str, out_dir: str) -> list:
    """Two ranks of `_distributed_rank` by torch.multiprocessing (spawn);
    a rank that raises, or that outlasts RANK_TIMEOUT_S, fails the phase.
    Every process is stopped before this returns. -> the ranks' records."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(
        _distributed_rank, args=(_free_port(), out_dir, phase, SHARD_DEVICE,
                                 (N, D, KC, M, KQ)),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.perf_counter() + RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() < deadline,
                  f"distributed {phase}: a rank outlasted "
                  f"{RANK_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    out = []
    for r in range(2):
        with open(os.path.join(out_dir, f"{phase}{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase_distributed(base, queries, qs, gt, recall, recall_oracle, smi,
                      zero_counts, read_counts) -> float:
    """The distributed build at the SIFT1M width (one line a part; returns
    the 1 x 4 build's recall@10):

      distributed          (a) ShardedIVFADCIndex.build of the build phase's
                           1M points over make_mesh(n_shards=4) on one card
                           (seconds per stage); counts zeroed per batch: the
                           1000 queries and a B=16384 batch (kernel 1 once,
                           2-4 once a shard, 6 once to merge) and a B=256
                           batch (1 once, 5 once a shard, 6 once a shard and
                           once to merge); recall@10 >= the single card's
                           - 0.01; its directory consolidated into an
                           IVFADCIndex on the card: B=16384 and B=256
                           distances bit-equal, ids but at exact ties;
                           batch ms, device peak
      distributed_persist  (b) save_sharded_index, load_sharded_index onto
                           S=4 (results bit-equal) and S=2 (a reshard:
                           distances bit-equal), consolidate_sharded_to_file
                           then IVFADCIndex.load on the card: equal to the
                           in-memory consolidation; bytes and seconds
      distributed_mutations (c) a fork of the view: push_batch of 65,536
                           points (a regrow; kernel 7 gives the cells), a
                           1000-id delete, push_front, pop, pop_front,
                           reconstruct; after each, B=16384 and B=256
                           results equal a fresh view over the consolidated
                           state (distances bit-equal, ids but at ties), ids
                           stay 0..n-1; the parent unchanged; ms of each op
      distributed_ranks    (d) two spawned ranks on the card (gloo), a
                           global 1 x 4 mesh: build, search the 1000
                           queries, save each rank's shard files; a fresh
                           group loads the directory and searches: every
                           rank's ids and distances bit-equal to (a)'s"""
    import shutil

    import torch
    from ivfadc_tpu_torch import (IVFADCConfig, IVFADCIndex,
                                  ShardedIVFADCIndex, make_mesh)
    from ivfadc_tpu_torch.parallel import (consolidate_sharded_index,
                                           consolidate_sharded_to_file,
                                           load_sharded_index,
                                           save_sharded_index)
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    from ivfadc_tpu_torch.utils.evaluation import recall_at_r

    # ---- (a) build and search
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh4 = make_mesh(n_shards=4, devices=[SHARD_DEVICE] * 4)
    t1 = time.perf_counter()
    view = ShardedIVFADCIndex.build(base, mesh4,
                                    IVFADCConfig(kc=KC, k=KQ, m=M, seed=0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    check(view._distributed_build and not view.index.store.has_payload
          and len(view.index) == N
          and all(v["decoded"] is not None and v["decoded"].is_cuda
                  and v["ids"].is_cuda for v in view.views),
          "distributed view not dense on the card")
    q16, q256 = queries[:BATCH], queries[BATCH:BATCH + B_SMALL]
    batches = {"queries_1000": qs, "b16384": q16, "b256": q256}
    grouped = dict(coarse_probe=1, cell_rank=4, grouped_scan=4,
                   topk_payload=4, topk_index=1, probe_scan=0)
    per_probe = dict(coarse_probe=1, cell_rank=0, grouped_scan=0,
                     topk_payload=0, probe_scan=4, topk_index=5)
    res, launch = {}, {}
    for name, q in batches.items():
        want = per_probe if name == "b256" else grouped
        zero_counts()
        res[name] = view.search_padded(q, TOPK, w=W)
        counts = read_counts(f"distributed_{name}",
                             [k for k, v in want.items() if v])
        launch[name] = {k: counts[k] for k in want}
        check(launch[name] == want,
              f"distributed {name}: launches {launch[name]}, want {want}")
    ids, dists = res["queries_1000"]
    check(ids.shape == (N_SEARCH, TOPK) and np.isfinite(dists).all()
          and (ids >= 0).all() and (ids < N).all(), "distributed output")
    rec10 = recall_at_r(ids, gt, TOPK)
    check(rec10 >= recall - 0.01,
          f"distributed recall {rec10} vs the single card's {recall}")
    ms = {"b16384": [], "b256": []}
    for r in range(11):                        # the first: warm-up
        for name in ms:
            t = batch_ms(lambda: view._dispatch(batches[name], TOPK, W,
                                                False))
            if r:
                ms[name].append(t)
    tmp = tempfile.mkdtemp(dir=ROOT)
    try:
        d4 = os.path.join(tmp, "s4")
        t1 = time.perf_counter()
        save_sharded_index(d4, view)
        save_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        plain = consolidate_sharded_index(d4, device="cuda")
        consolidate_s = time.perf_counter() - t1
        check(plain.device.type == "cuda" and len(plain) == N,
              "consolidated index")
        tie_rows = {}
        for name in ("b16384", "b256"):
            tie_rows[name] = ties_only(*res[name], *plain.search_padded(
                batches[name], TOPK, w=W))
        emit("distributed", card=smi, n=N, d=D, kc=KC, m=M, k=KQ,
             n_shards=4, build_s=build_s,
             build_stages_s=view.build_timings, recall_at_10=rec10,
             recall_single_card=recall, recall_oracle=recall_oracle,
             launches=launch,
             batch_ms={k: float(np.median(v)) for k, v in ms.items()},
             consolidated_tie_rows=tie_rows,
             device_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             seconds=time.perf_counter() - t0)

        # ---- (b) the shard directory
        t0 = time.perf_counter()
        dir_bytes = sum(os.path.getsize(os.path.join(d4, f))
                        for f in os.listdir(d4))
        t1 = time.perf_counter()
        v4 = load_sharded_index(d4, mesh4)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        for name in ("b16384", "b256"):
            got = v4.search_padded(batches[name], TOPK, w=W)
            check(all(np.array_equal(a, b) for a, b in zip(got, res[name])),
                  f"load S=4: {name} results differ")
        del v4
        t1 = time.perf_counter()
        v2 = load_sharded_index(d4, make_mesh(n_shards=2,
                                              devices=[SHARD_DEVICE] * 2))
        torch.cuda.synchronize()
        reshard_s = time.perf_counter() - t1
        reshard_ties = {name: ties_only(*res[name], *v2.search_padded(
            batches[name], TOPK, w=W)) for name in ("b16384", "b256")}
        del v2
        flat = os.path.join(tmp, "flat.npz")
        t1 = time.perf_counter()
        consolidate_sharded_to_file(d4, flat)
        to_file_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        loaded = IVFADCIndex.load(flat, device="cuda")
        file_load_s = time.perf_counter() - t1
        for key in ("offsets", "caps", "sizes", "codes", "ids"):
            check(np.array_equal(getattr(loaded.store, key),
                                 getattr(plain.store, key)),
                  f"out-of-core consolidation: {key} differs")
        for name in ("b16384", "b256"):
            got = loaded.search_padded(batches[name], TOPK, w=W)
            ref = plain.search_padded(batches[name], TOPK, w=W)
            check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
                  f"the consolidated file's {name} results differ")
        del loaded, plain
        emit("distributed_persist", card=smi, dir_bytes=dir_bytes,
             save_s=save_s, load_s4_s=load_s, load_s2_reshard_s=reshard_s,
             consolidate_s=consolidate_s, consolidate_to_file_s=to_file_s,
             file_bytes=os.path.getsize(flat), file_load_s=file_load_s,
             reshard_tie_rows=reshard_ties,
             seconds=time.perf_counter() - t0)
        os.remove(flat)

        # ---- (c) native mutations on a fork
        t0 = time.perf_counter()
        probe = {"b16384": q16, "b256": q256}
        fork = view.fork()
        steps = {}

        def hold(step):
            d = os.path.join(tmp, f"c_{step}")
            save_sharded_index(d, fork)
            ref = consolidate_sharded_index(d, device="cuda")
            shutil.rmtree(d)
            live = ref.store.ids[ref.store.ids >= 0]
            check(np.array_equal(np.sort(live), np.arange(len(ref)))
                  and len(ref) == len(fork.index), f"{step}: ids not 0..n-1")
            fresh = ShardedIVFADCIndex(ref, mesh4)
            steps[step]["tie_rows"] = {
                name: ties_only(*fork.search_padded(q, TOPK, w=W),
                                *fresh.search_padded(q, TOPK, w=W))
                for name, q in probe.items()}
            return ref

        def timed(step, fn):
            t1 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            steps[step] = dict(ms=1e3 * (time.perf_counter() - t1))
            return out

        big = synthetic_clustered(N_DIST_PUSH, D, seed=37)
        caps = fork._h_caps.copy()
        zero_counts()
        timed("push_batch", lambda: fork.push_batch(big))
        push_counts = read_counts("distributed_push", ["coarse_topw"])
        check(not np.array_equal(caps, fork._h_caps),
              "push_batch: no regrow")
        steps["push_batch"]["launches"] = {
            k: push_counts[k] for k in ("coarse_topw", "topk_index")}
        hold("push_batch")
        rng = np.random.RandomState(38)
        dels = np.sort(rng.choice(len(fork.index), N_DIST_DEL,
                                  replace=False))
        timed("delete_1000", lambda: fork.delete(dels))
        hold("delete_1000")
        pt = qs[0].cpu().numpy()
        timed("push_front", lambda: fork.push_front(pt))
        hold("push_front")
        timed("pop", fork.pop)
        hold("pop")
        timed("pop_front", fork.pop_front)
        ref = hold("pop_front")
        rec = timed("reconstruct", lambda: fork.reconstruct(123))
        check(np.allclose(rec, ref.reconstruct(123), rtol=1e-6, atol=1e-5),
              "reconstruct differs from the consolidated index's")
        for name, q in probe.items():
            got = view.search_padded(q, TOPK, w=W)
            check(all(np.array_equal(a, b) for a, b in zip(got, res[name])),
                  f"the parent view's {name} results changed")
        n_end = len(fork.index)
        del fork, ref
        emit("distributed_mutations", card=smi, steps=steps, n_end=n_end,
             last_refresh="native", parent_unchanged=True,
             seconds=time.perf_counter() - t0)
        del view
        torch.cuda.empty_cache()

        # ---- (d) two ranks of one process group on the card
        t0 = time.perf_counter()
        ranks_dir = os.path.join(tmp, "ranks")
        os.makedirs(ranks_dir)
        np.save(os.path.join(ranks_dir, "queries.npy"), qs.cpu().numpy())
        build_recs = run_ranks("build", ranks_dir)
        check(sorted(f for f in os.listdir(os.path.join(ranks_dir, "dir"))
                     if f.startswith("shard_")) ==
              [f"shard_{s:05d}.npz" for s in range(4)], "rank shard files")
        load_recs = run_ranks("load", ranks_dir)
        for phase in ("build", "load"):
            for r in range(2):
                z = np.load(os.path.join(ranks_dir, f"{phase}{r}.npz"))
                check(np.array_equal(z["ids"], ids)
                      and np.array_equal(z["dists"], dists),
                      f"rank {r} ({phase}) differs from the single-process "
                      f"view")
        emit("distributed_ranks", card=smi, ranks=2,
             backend=build_recs[0]["backend"], build=build_recs,
             load=load_recs, equal_single_process=True,
             seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec10


N_MC_PUSH = 65536                    # the (2, 4) view's push_batch
N_MC_DEL = 1000                      # its delete
WIDE_CAP_MC = 1 << 19                # the wide-id build's lowered cap (< N)
CODES_DIFF_MAX = 1e-3                # train_step: rows whose codes may differ


def phase_multichip(index, base, queries, qs, gt, recall, recall_1x4, smi,
                    zero_counts, read_counts) -> None:
    """The port's `entry()` and multi-chip dry run (emits one line a
    part); every mesh position repeats the one card, so no number here is
    a scaling across cards:

      multichip_entry  (a) `dryrun.entry()` on the card (the LUT forward,
                       kernel 7 probes): ids equal to the same forward on
                       CPU copies of its arguments, distances within 1e-5
                       relative; then `dryrun_multichip(8)` at its tiny
                       shapes over a (data=2, shard=4) mesh: every step's
                       asserts and its OK line
      multichip        (b) the dry run's sequence at the batch cell's width
                       (the 1M points, its config, seed 0) over a (2, 4)
                       mesh: train_step over the data axis from the single
                       index's centres and codebooks against the one-
                       position train_step (assignments equal, centres to
                       float rounding, C.22; codes equal on all but
                       CODES_DIFF_MAX of the rows); the (2, 4) view of the
                       single index at B=16384 and B=256 against the single
                       card (distances bit-equal, tie rows counted; kernel
                       1 and the merge's 6 once a data group, 2-4 or 5 and
                       6 once a shard a group); ShardedIVFADCIndex.build
                       over (2, 4): seconds by stage, recall@10 within
                       0.01 of the 1 x 4 build's, held to its consolidated
                       twin; on a fork push_batch of 65,536 (a regrow), a
                       1000-id delete and pop, each held to a fresh view
                       over its consolidated state, ids 0..n-1; a save and
                       a load onto (1, 2); build_streaming over (2, 4) from
                       262,144-row chunks, held to its base index, recall
                       within 0.02 of the full build's; a wide-id build
                       under IVFADC_DEVICE_ID_CAP=2^19 < n: uint64 ids and
                       distances equal to the uncapped build's, then a
                       push_batch and a delete. Printed: train_step s, the
                       build's s by stage, batch ms beside the single
                       card's, save / load s, the device peak"""
    import io
    import shutil

    import torch
    from ivfadc_tpu_torch import IVFADCConfig, ShardedIVFADCIndex, make_mesh
    from ivfadc_tpu_torch import dryrun
    from ivfadc_tpu_torch.models.coarse import NaiveCoarseQuantizer
    from ivfadc_tpu_torch.parallel import (consolidate_sharded_index,
                                           load_sharded_index,
                                           save_sharded_index)
    from ivfadc_tpu_torch.parallel.distributed import train_step
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    from ivfadc_tpu_torch.utils.evaluation import recall_at_r

    # ---- (a) the entry point and the tiny dry run
    t0 = time.perf_counter()
    fn, args = dryrun.entry()
    ids_e, dists_e = fn(*args)
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    cpu_args[1] = NaiveCoarseQuantizer(args[1].centroids.cpu(),
                                       args[1].metric)
    ids_c, dists_c = fn(*cpu_args)
    check(torch.equal(ids_e.cpu(), ids_c), "entry: card and CPU ids differ")
    entry_err = float((dists_e.cpu() - dists_c).abs().max())
    check(torch.allclose(dists_e.cpu(), dists_c, rtol=1e-5, atol=1e-5),
          f"entry: distances differ by {entry_err}")
    printed = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        tiny = dryrun.dryrun_multichip(8)
    dry_s = time.perf_counter() - t1
    ok_line = [ln for ln in printed.getvalue().splitlines()
               if ln.startswith("dryrun_multichip OK")]
    check(tiny["mesh"] == {"data": 2, "shard": 4} and len(ok_line) == 1
          and "mesh={'data': 2, 'shard': 4}" in ok_line[0],
          "the tiny dry run's OK line")
    emit("multichip_entry", card=smi, entry_shape=list(ids_e.shape),
         entry_max_abs_err=entry_err, dryrun_s=dry_s,
         dryrun_devices=tiny["devices"], dryrun_ok_line=ok_line[0],
         seconds=time.perf_counter() - t0)

    # ---- (b) the same sequence at full width over a (2, 4) mesh
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(n_shards=4, n_data=2, devices=[SHARD_DEVICE] * 8)
    out = dict(mesh=dict(mesh.shape))
    metric = index.quant_metric
    cents, cbs = index.coarse.centroids, index.quantizer.codebooks
    mask = torch.ones(N, dtype=torch.float32)
    ts = {}
    for key, m_ in (("one", make_mesh(n_shards=1,
                                      devices=[SHARD_DEVICE])),
                    ("2x4", mesh)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ts[key] = train_step(cents, cbs, base, mask, mesh=m_,
                             metric=metric, m=M)
        torch.cuda.synchronize()
        out[f"train_step_s_{key}"] = time.perf_counter() - t1
    (c1, a1, k1), (c2, a2, k2) = ts["one"], ts["2x4"]
    check(torch.equal(a1, a2), "train_step: assignments differ")
    cent_err = float((c1 - c2).abs().max())
    check(torch.allclose(c1, c2, rtol=1e-5, atol=1e-4),
          f"train_step: centres differ by {cent_err}")
    codes_diff = float((k1 != k2).any(dim=1).float().mean())
    check(codes_diff <= CODES_DIFF_MAX,
          f"train_step: {codes_diff} of the rows' codes differ")
    out.update(train_step_centre_max_abs_diff=cent_err,
               train_step_codes_rows_differ=codes_diff)
    del ts, c1, a1, k1, c2, a2, k2

    q16, q256 = queries[:BATCH], queries[BATCH:BATCH + B_SMALL]
    batches = {"b16384": q16, "b256": q256}
    # per data group: one coarse probe, a scan a shard (the grouped route
    # at 8192 queries a group, per probe at 128), one merge (kernel 6);
    # the per-probe route's position top-k is kernel 6 too, once a shard
    want = {"b16384": dict(coarse_probe=2, cell_rank=8, grouped_scan=8,
                           topk_payload=8, topk_index=2, probe_scan=0),
            "b256": dict(coarse_probe=2, cell_rank=0, grouped_scan=0,
                         topk_payload=0, probe_scan=8, topk_index=10)}

    def searched(view, what):
        res, launch = {}, {}
        for name, q in batches.items():
            zero_counts()
            res[name] = view.search_padded(q, TOPK, w=W)
            counts = read_counts(f"multichip_{what}_{name}",
                                 [k for k, v in want[name].items() if v])
            launch[name] = {k: counts[k] for k in want[name]}
            check(launch[name] == want[name],
                  f"{what} {name}: launches {launch[name]}, want "
                  f"{want[name]}")
        return res, launch

    def timed_ms(fn_):
        ms = []
        for r in range(11):                    # the first: warm-up
            t = batch_ms(fn_)
            if r:
                ms.append(t)
        return float(np.median(ms))

    # the (2, 4) view of the single index
    t1 = time.perf_counter()
    view = ShardedIVFADCIndex(index, mesh)
    torch.cuda.synchronize()
    out["view_s"] = time.perf_counter() - t1
    res, out["launches_view"] = searched(view, "view")
    out["view_tie_rows"] = {name: ties_only(*res[name], *index.search_padded(
        q, TOPK, w=W)) for name, q in batches.items()}
    out["batch_ms"] = {name: dict(
        single=timed_ms(lambda: index._device_search(q, TOPK, W)),
        view_2x4=timed_ms(lambda: view._dispatch(q, TOPK, W, False)))
        for name, q in batches.items()}
    del view

    # the distributed build over (2, 4)
    cfg = IVFADCConfig(kc=KC, k=KQ, m=M, seed=0)
    t1 = time.perf_counter()
    dview = ShardedIVFADCIndex.build(base, mesh, cfg)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t1
    out["build_stages_s"] = dview.build_timings
    check(not dview.index.store.has_payload and len(dview.index) == N,
          "the (2, 4) build")
    res, out["launches_build"] = searched(dview, "build")
    rec = recall_at_r(dview.search_padded(qs, TOPK, w=W)[0], gt, TOPK)
    check(abs(rec - recall_1x4) <= 0.01,
          f"(2, 4) build recall {rec} vs the 1 x 4 build's {recall_1x4}")
    out.update(recall_at_10=rec, recall_at_10_1x4=recall_1x4)
    tmp = tempfile.mkdtemp(dir=ROOT)
    try:
        def consolidated(view_, step):
            d = os.path.join(tmp, step)
            save_sharded_index(d, view_)
            ref = consolidate_sharded_index(d, device="cuda")
            shutil.rmtree(d)
            live = ref.store.ids[ref.store.ids >= 0]
            check(np.array_equal(np.sort(live), np.arange(len(ref)))
                  and len(ref) == len(view_.index),
                  f"{step}: ids not 0..n-1")
            return ref

        twin = consolidated(dview, "twin")
        out["consolidated_tie_rows"] = {
            name: ties_only(*res[name], *twin.search_padded(q, TOPK, w=W))
            for name, q in batches.items()}
        del twin

        # native ops on a fork, each held to a fresh view
        fork = dview.fork()
        steps = {}
        big = synthetic_clustered(N_MC_PUSH, D, seed=39)
        dels = np.sort(np.random.RandomState(40).choice(
            N + N_MC_PUSH, N_MC_DEL, replace=False))
        caps = fork._h_caps.copy()
        for step, op in (("push_batch", lambda: fork.push_batch(big)),
                         ("delete_1000", lambda: fork.delete(dels)),
                         ("pop", fork.pop)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            op()
            torch.cuda.synchronize()
            steps[step] = dict(ms=1e3 * (time.perf_counter() - t1))
            if step == "push_batch":
                check(not np.array_equal(caps, fork._h_caps),
                      "push_batch: no regrow")
            ref = consolidated(fork, step)
            fresh = ShardedIVFADCIndex(ref, mesh)
            steps[step]["tie_rows"] = {
                name: ties_only(*fork.search_padded(q, TOPK, w=W),
                                *fresh.search_padded(q, TOPK, w=W))
                for name, q in batches.items()}
            del ref, fresh
        out["native_steps"] = steps
        d = os.path.join(tmp, "fork")
        t1 = time.perf_counter()
        save_sharded_index(d, fork)
        out["save_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        v12 = load_sharded_index(d, make_mesh(n_shards=2,
                                              devices=[SHARD_DEVICE] * 2))
        torch.cuda.synchronize()
        out["load_1x2_s"] = time.perf_counter() - t1
        out["load_1x2_tie_rows"] = {
            name: ties_only(*fork.search_padded(q, TOPK, w=W),
                            *v12.search_padded(q, TOPK, w=W))
            for name, q in batches.items()}
        del v12, fork
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the streamed build over (2, 4)
    chunks = [base[i:i + 262144] for i in range(0, N, 262144)]
    t1 = time.perf_counter()
    sview = ShardedIVFADCIndex.build_streaming(
        chunks, mesh, IVFADCConfig(kc=KC, k=KQ, m=M, seed=0,
                                   kmeanspp_sample=65536))
    torch.cuda.synchronize()
    out["stream_build_s"] = time.perf_counter() - t1
    s_ids, s_d = sview.search_padded(qs, TOPK, w=W)
    out["stream_recall_at_10"] = recall_at_r(s_ids, gt, TOPK)
    check(abs(out["stream_recall_at_10"] - recall) <= 0.02,
          f"(2, 4) streamed build recall {out['stream_recall_at_10']} vs "
          f"{recall}")
    out["stream_tie_rows"] = ties_only(s_ids, s_d, *sview.index.search_padded(
        qs, TOPK, w=W))
    del sview

    # wide ids: the same build under a device id cap below n
    ref_i, ref_d = dview.search_padded(q16, TOPK, w=W)
    del dview
    with env(IVFADC_DEVICE_ID_CAP=str(WIDE_CAP_MC)):
        t1 = time.perf_counter()
        wview = ShardedIVFADCIndex.build(base, mesh, cfg)
        torch.cuda.synchronize()
        out["wide_build_s"] = time.perf_counter() - t1
        check(wview.wide_ids, "the capped build is not in wide-id mode")
        w_ids, w_d = wview.search_padded(q16, TOPK, w=W)
        check(w_ids.dtype == np.uint64
              and np.array_equal(w_ids, ref_i.astype(np.uint64))
              and np.array_equal(w_d, ref_d),
              "wide ids differ from the uncapped build's")
        wview.push_batch(big[:1000])
        wview.delete([1, 7])
        check(len(wview.index) == N + 998, "wide view length")
        del wview
    emit("multichip", card=smi, n=N, d=D, kc=KC, m=M, k=KQ,
         device_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         wide_device_id_cap=WIDE_CAP_MC, **out,
         seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()


def phase_sharded_two_level(index, q, smi, zero_counts, read_counts) -> None:
    """(b) two shards of the large-kc index on one card: a B=4096 batch at
    w=32 with distances bit-equal to the single card's (ids but at exact
    ties), through stage 1 (6), stage 2 (2, 8a, 4), the per-probe posting
    scan (5) and top-k (6); batch ms beside the single card's."""
    import torch
    from ivfadc_tpu_torch import ShardedIVFADCIndex, make_mesh
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    view = ShardedIVFADCIndex(index, make_mesh(n_shards=2,
                                               devices=[SHARD_DEVICE] * 2))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    ref = index.search_padded(q, TOPK, w=W3)
    zero_counts()
    got = view.search_padded(q, TOPK, w=W3)
    counts = read_counts("sharded_two_level", [
        "topk_index", "cell_rank", "grouped_scan_knorm", "topk_payload",
        "probe_scan"], idle=["grouped_scan", "coarse_probe"])
    tie_rows = ties_only(*got, *ref)
    ms = {"single": [], "s2": []}
    for r in range(6):                          # the first: warm-up
        for key, fn in (("single", lambda: index._device_search(q, TOPK,
                                                                  W3)),
                        ("s2", lambda: view._dispatch(q, TOPK, W3, False))):
            t = batch_ms(fn)
            if r:
                ms[key].append(t)
    del view
    torch.cuda.empty_cache()
    emit("sharded_two_level", card=smi, n_shards=2, queries=q.shape[0],
         w=W3, view_build_s=build_s, launches=counts, tie_rows=tie_rows,
         batch_ms={k: float(np.median(v)) for k, v in ms.items()},
         seconds=time.perf_counter() - t0)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ivfadc_tpu_torch import IVFADCIndex, _build
    from ivfadc_tpu_torch.ops import cell_rank, coarse_scan, dense_scan, topk
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    from ivfadc_tpu_torch.utils.evaluation import brute_force_topk, recall_at_r
    from ivfadc_tpu_torch.utils.repro import index_digest
    from benchmarks.oracle import ReferenceOracle

    kernels = {"coarse_probe": coarse_scan.KERNEL,
               "cell_rank": cell_rank.KERNEL,
               "grouped_scan": dense_scan.KERNEL,
               "topk_payload": topk.KERNEL,
               "probe_scan": dense_scan.PROBE_KERNEL,
               "topk_index": topk.INDEX_KERNEL,
               "coarse_topw": coarse_scan.TOPW_KERNEL,
               "grouped_scan_knorm": dense_scan.NORMS_KERNEL,
               "grouped_scan_pos8": dense_scan.GROUPED_KERNELS["pos8", "int8"],
               "grouped_scan_bf16": dense_scan.GROUPED_KERNELS["ids", "bf16"],
               "grouped_scan_knorm_bf16":
                   dense_scan.GROUPED_KERNELS["knorm", "bf16"],
               "probe_scan_bf16": dense_scan.PROBE_KERNELS["fold", "bf16"],
               "grouped_scan_exact":
                   dense_scan.GROUPED_KERNELS["exact", "int8"],
               "probe_scan_exact": dense_scan.PROBE_KERNELS["exact", "int8"],
               "grouped_scan_extract":
                   dense_scan.GROUPED_KERNELS["extract", "int8"],
               "cell_rank_v2": cell_rank.KERNEL_V2,
               "coarse_probe_v2": coarse_scan.V2_KERNEL,
               "grouped_scan_qc": dense_scan.QC_KERNELS["int8"],
               "grouped_scan_qc_bf16": dense_scan.QC_KERNELS["bf16"]}
    # the path whose run gives each kernel its launch count
    path_of = {"coarse_probe": "search", "cell_rank": "search",
               "grouped_scan": "search", "topk_payload": "search",
               "probe_scan": "small_batch", "topk_index": "small_batch",
               "coarse_topw": "lut", "grouped_scan_knorm": "two_level",
               "grouped_scan_pos8": "two_level_grouped",
               "grouped_scan_bf16": "variants_bf16",
               "grouped_scan_knorm_bf16": "variants_bf16",
               "probe_scan_bf16": "variants_bf16",
               "grouped_scan_exact": "variants_exact",
               "probe_scan_exact": "variants_exact",
               "grouped_scan_extract": "variants_extract",
               "cell_rank_v2": "engines_rank_v2",
               "coarse_probe_v2": "engines_coarse_v2",
               "grouped_scan_qc": "engines_qc",
               "grouped_scan_qc_bf16": "engines_qc_bf16"}
    # the TPU kernel table's row of each kernel (PERF.md)
    row_of = {"coarse_probe": "1", "cell_rank": "2", "grouped_scan": "3",
              "topk_payload": "4", "probe_scan": "5", "topk_index": "6",
              "coarse_topw": "7", "grouped_scan_knorm": "8a",
              "grouped_scan_pos8": "8b", "grouped_scan_bf16": "8c",
              "grouped_scan_knorm_bf16": "8c", "probe_scan_bf16": "8c",
              "grouped_scan_exact": "8d", "probe_scan_exact": "8d",
              "grouped_scan_extract": "8e", "cell_rank_v2": "11",
              "coarse_probe_v2": "10", "grouped_scan_qc": "9",
              "grouped_scan_qc_bf16": "9"}
    launches = {}

    def zero_counts():
        for kern in kernels.values():
            kern.launches = 0

    def read_counts(path, launched, idle=()):
        """Counts of the path just driven: `launched` must have run, `idle`
        must not."""
        counts = {name: kern.launches for name, kern in kernels.items()}
        for name in launched:
            check(counts[name] > 0, f"kernel {name} never launched on the "
                                    f"{path} path")
        for name in idle:
            check(counts[name] == 0, f"kernel {name} launched on the "
                                     f"{path} path")
        launches[path] = counts
        return counts

    # ---- setup
    t0 = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_dir()
    emit("setup", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device_count=torch.cuda.device_count(),
         kernel_build_s=_build.build_seconds,
         seconds=time.perf_counter() - t0)

    # ---- build
    t0 = time.perf_counter()
    data = synthetic_clustered(N, D, seed=0)
    gen_s = time.perf_counter() - t0
    base = torch.as_tensor(data, device=dev)
    t1 = time.perf_counter()
    index = IVFADCIndex.build(base, kc=KC, k=KQ, m=M, seed=0,
                              kmeanspp_sample=65536)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    check(len(index) == N and index.device.type == "cuda", "build")
    g = torch.Generator(device=dev).manual_seed(1)
    nq = 4 * BATCH
    qidx = torch.randint(0, N, (nq,), generator=g, device=dev)
    queries = base[qidx] + 0.05 * torch.randn((nq, D), generator=g,
                                              device=dev)
    # digest of the built parameters: two runs of one tree and seed that
    # print the same digest built the same index bit for bit
    emit("build", n=N, d=D, kc=KC, m=M, k=KQ, data_gen_s=gen_s,
         build_s=build_s, build_digest=index_digest(index),
         build_phases={k: round(v, 3) for k, v in
                       index.build_timings.items()},
         seconds=time.perf_counter() - t0)

    # ---- kernels against their plain versions
    t0 = time.perf_counter()
    records = phase_kernels(index, queries)
    emit("kernels", seconds=time.perf_counter() - t0)

    # ---- search: the main path, with every launch count zeroed first
    t0 = time.perf_counter()
    zero_counts()
    qs = queries[:N_SEARCH]
    ids, dists = index.search_padded(qs, TOPK, w=W)
    check(ids.shape == (N_SEARCH, TOPK) and np.isfinite(dists).all()
          and (ids >= 0).all() and (ids < N).all(), "search output")
    check(bool((np.diff(dists, axis=1) >= 0).all()), "distances not sorted")
    _, gt = brute_force_topk(base, qs, TOPK)
    recall = recall_at_r(ids, gt, TOPK)
    oracle = ReferenceOracle(
        index.coarse.centroids.cpu().numpy(),
        index.quantizer.codebooks.cpu().numpy(),
        *zip(*[index.store.cell_entries(c) for c in range(KC)]))
    q_host = qs[:N_ORACLE].cpu().numpy()
    o_ids, o_dists = oracle.search_batch(q_host, TOPK, W)
    o_pad = np.full((N_ORACLE, TOPK), -1, np.int64)
    o_dpad = np.full((N_ORACLE, TOPK), np.inf, np.float32)
    for i, (row_ids, row_d) in enumerate(zip(o_ids, o_dists)):
        o_pad[i, :len(row_ids)] = row_ids
        o_dpad[i, :len(row_ids)] = row_d
    recall_oracle = recall_at_r(o_pad, gt[:N_ORACLE], TOPK)
    recall_port_sub = recall_at_r(ids[:N_ORACLE], gt[:N_ORACLE], TOPK)
    overlap = float(np.mean([len(set(a) & set(b)) / TOPK
                             for a, b in zip(ids[:N_ORACLE], o_pad)]))
    check(abs(recall_port_sub - recall_oracle) <= 0.01,
          f"recall {recall_port_sub} vs oracle {recall_oracle}")

    def wave():
        for s in range(0, nq, BATCH):
            index._device_search(queries[s:s + BATCH], TOPK, W)
        torch.cuda.synchronize()

    wave()                                           # warm-up
    waves = []
    for _ in range(5):
        t1 = time.perf_counter()
        wave()
        waves.append(time.perf_counter() - t1)
    qps = nq / statistics.median(waves)
    singles = []
    for r in range(10):
        t1 = time.perf_counter()
        index._device_search(queries[(r % 4) * BATCH:(r % 4 + 1) * BATCH],
                             TOPK, W)
        torch.cuda.synchronize()
        singles.append(time.perf_counter() - t1)
    counts = read_counts("search", ["coarse_probe", "cell_rank",
                                    "grouped_scan", "topk_payload"],
                         idle=["probe_scan", "topk_index", "coarse_topw",
                               "grouped_scan_knorm"])
    emit("search", recall_at_10=recall, recall_at_10_oracle_queries=recall_port_sub,
         recall_oracle=recall_oracle, oracle_queries=N_ORACLE, top10_overlap_oracle=overlap,
         qps=qps, wave_s=waves, p50_batch_ms=1e3 * float(np.median(singles)),
         batch=BATCH, w=W, launches=counts,
         seconds=time.perf_counter() - t0)

    # ---- small batches: B*w < 4*kc, single queries included
    t0 = time.perf_counter()
    zero_counts()
    one_i, one_d = index.search(qs[0], TOPK, w=W)
    check(one_i.dtype == np.dtype(index.config.index_dtype)
          and one_i.shape == one_d.shape == (TOPK,)
          and bool((np.diff(one_d) >= 0).all()), "single-point search")
    check(np.array_equal(one_i, index.search(qs[0].cpu().numpy(), TOPK,
                                             w=W)[0]),
          "single-point search: tensor and array queries differ")
    small = {}
    for b in (8, 64, B_SMALL):
        bi, bd = index.search_padded(qs[:b], TOPK, w=W)
        check(bi.shape == (b, TOPK) and np.isfinite(bd).all()
              and (bi >= 0).all() and (bi < N).all()
              and bool((np.diff(bd, axis=1) >= 0).all()),
              f"small-batch output at B={b}")
        small[b] = bi
    check(np.array_equal(one_i, small[8][0]), "B=1 and B=8 ids differ")
    s_ids, s_dists = map(np.concatenate, zip(*[
        index.search_padded(qs[s:s + B_SMALL], TOPK, w=W)
        for s in range(0, N_SEARCH, B_SMALL)]))
    recall_small = recall_at_r(s_ids, gt, TOPK)
    overlap_small = float(np.mean([len(set(a) & set(b)) / TOPK
                                   for a, b in zip(s_ids, ids)]))
    check(abs(recall_small - recall) <= 0.01,
          f"small-batch recall {recall_small} vs grouped {recall}")
    check(overlap_small >= 0.95,
          f"small-batch / grouped top-{TOPK} overlap {overlap_small}")
    lat = []
    for r in range(220):                  # first 20: warm-up
        t1 = time.perf_counter()
        index.search(queries[r], TOPK, w=W)    # ends in a device->host copy
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t1))
    lat = lat[20:]
    p50_by_batch = {}
    for b in (8, 64, B_SMALL):
        ts = []
        for r in range(25):
            t1 = time.perf_counter()
            index.search_padded(queries[r * b:(r + 1) * b], TOPK, w=W)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t1))
        p50_by_batch[b] = float(np.median(ts[5:]))
    counts = read_counts("small_batch", ["coarse_probe", "probe_scan",
                                         "topk_index"],
                         idle=["cell_rank", "grouped_scan", "topk_payload",
                               "coarse_topw", "grouped_scan_knorm"])
    prof1 = phase_profile(
        lambda i: index.search(queries[i], TOPK, w=W), 50)
    emit("small_batch", recall_at_10=recall_small, recall_grouped=recall,
         top10_overlap_grouped=overlap_small,
         single_query_p50_ms=float(np.percentile(lat, 50)),
         single_query_p99_ms=float(np.percentile(lat, 99)),
         single_query_calls=len(lat), p50_ms_by_batch=p50_by_batch,
         launches=counts, single_query_profile=prof1,
         seconds=time.perf_counter() - t0)

    # ---- IVFADC_NORMS=off: the posting scan through kernel 8a
    t0 = time.perf_counter()
    zero_counts()
    with norms_off(index):
        n_ids, n_dists = index.search_padded(qs, TOPK, w=W)
    counts = read_counts("norms_off", ["coarse_probe", "cell_rank",
                                       "grouped_scan_knorm", "topk_payload"],
                         idle=["grouped_scan", "probe_scan", "topk_index"])
    # bf16-rounded squares against the cached f32 norms: near-ties may swap
    overlap_norms = float(np.mean([len(set(a) & set(b)) / TOPK
                                   for a, b in zip(n_ids, ids)]))
    check(overlap_norms >= 0.99, f"IVFADC_NORMS=off / cached-norms top-"
                                 f"{TOPK} overlap {overlap_norms}")
    recall_norms = recall_at_r(n_ids, gt, TOPK)
    check(abs(recall_norms - recall) <= 0.01,
          f"IVFADC_NORMS=off recall {recall_norms} vs {recall}")
    emit("norms_off", recall_at_10=recall_norms, recall_cached_norms=recall,
         top10_overlap_cached_norms=overlap_norms, launches=counts,
         seconds=time.perf_counter() - t0)

    # ---- the scan variants: bf16 cache, exact merge, extraction
    t0 = time.perf_counter()
    emit("variants", **phase_variants(
        index, qs, gt, dict(ids=ids, s_ids=s_ids, s_dists=s_dists,
                            n_ids=n_ids,
                            n_dists=n_dists, recall_oracle=recall_oracle,
                            batch=queries[:BATCH]),
        zero_counts, read_counts), seconds=time.perf_counter() - t0)

    # ---- the opt-in engines on B=8192 batches
    t0 = time.perf_counter()
    emit("engines", **phase_engines(
        index, queries, gt, dict(recall_oracle=recall_oracle), zero_counts,
        read_counts), seconds=time.perf_counter() - t0)

    # ---- LUT engine: scan_mode="lut", and k > 128 under the default config
    t0 = time.perf_counter()
    zero_counts()
    lut_index = IVFADCIndex(
        dataclasses.replace(index.config, scan_mode="lut"), index.coarse,
        index.quantizer, index.store, index.data_dtype, index.dim)
    l_ids, l_dists = lut_index.search_padded(qs[:B_SMALL], TOPK, w=W)
    check(bool((np.diff(l_dists, axis=1) >= 0).all()) and (l_ids >= 0).all(),
          "LUT output")
    # both are the exact algorithm in f32, so the sorted distances agree;
    # the oracle (argpartition) and the port (lowest candidate first) may
    # pick different ids among EQUAL scores at the k-th place, which points
    # with the same PQ code in one cell produce. The raw overlap counts
    # those as misses; the tie-aware one accepts a port id whose distance
    # ties the oracle's k-th distance.
    np.testing.assert_allclose(l_dists, o_dpad[:B_SMALL], rtol=1e-4,
                               atol=1e-3)
    overlap_lut, overlap_tie = [], []
    for pi, pdist, oi, odist in zip(l_ids, l_dists, o_pad, o_dpad):
        hit = np.isin(pi, oi)
        tied = ~hit & (np.abs(pdist - odist[-1]) <= 1e-4 * abs(odist[-1]))
        overlap_lut.append(hit.mean())
        overlap_tie.append((hit | tied).mean())
    overlap_lut = float(np.mean(overlap_lut))
    overlap_tie = float(np.mean(overlap_tie))
    check(overlap_tie >= 0.99, f"LUT / oracle overlap {overlap_tie} "
                               f"(raw {overlap_lut})")
    big_k = 200
    w_ids, w_dists = index.search_padded(qs[:64], big_k, w=W)
    check(w_ids.shape == (64, big_k)
          and bool((np.diff(w_dists, axis=1) >= 0).all()), "k=200 output")
    for row in w_ids:
        live = row[row >= 0]
        check(len(set(live.tolist())) == len(live), "k=200: repeated id")
    # the same 64-query batch at k=10 (same shapes, so bit-equal scores):
    # the kernel's tie order and the stable sort's must agree
    check(np.array_equal(w_ids[:, :TOPK],
                         lut_index.search_padded(qs[:64], TOPK, w=W)[0]),
          "k=200: first 10 differ from the k=10 run")
    t1 = time.perf_counter()
    lut_index.search_padded(qs[:B_SMALL], TOPK, w=W)
    torch.cuda.synchronize()
    lut_ms = 1e3 * (time.perf_counter() - t1)
    counts = read_counts("lut", ["coarse_topw", "topk_payload"],
                         idle=["coarse_probe", "cell_rank", "grouped_scan",
                               "probe_scan"])
    emit("lut", top10_overlap_oracle=overlap_lut,
         top10_overlap_oracle_tie_aware=overlap_tie, queries=B_SMALL,
         k200_queries=64, batch_ms_b256_k10=lut_ms,
         recall_at_10=recall_at_r(l_ids, gt[:B_SMALL], TOPK),
         launches=counts, seconds=time.perf_counter() - t0)

    # ---- unfused probe: a second index scored by inner product
    t0 = time.perf_counter()
    index2 = IVFADCIndex.build(base[:N2], kc=KC2, k=KQ, m=M, seed=0,
                               kmeanspp_sample=65536,
                               quantization_metric="inner_product")
    torch.cuda.synchronize()
    build2_s = time.perf_counter() - t0
    nq2 = 4096
    q2 = queries[:nq2]
    gt2 = torch.topk(q2 @ base[:N2].T, TOPK, dim=1)[1].cpu().numpy()
    zero_counts()
    u_small = np.concatenate([index2.search_padded(q2[s:s + 16], TOPK, w=W)[0]
                              for s in range(0, 256, 16)])
    c_small = read_counts("unfused", ["coarse_topw", "probe_scan",
                                      "topk_index"],
                          idle=["coarse_probe", "cell_rank", "grouped_scan",
                                "topk_payload"])
    u_ids, u_dists = index2.search_padded(q2, TOPK, w=W)
    check(bool((np.diff(u_dists, axis=1) >= 0).all()) and (u_ids >= 0).all()
          and (u_ids < N2).all(), "inner-product output")
    # no norm term under inner product: the grouped scan reads no norms
    # stream and runs its in-kernel-norms variant (8a), as in the JAX package
    counts = read_counts("unfused", ["coarse_topw", "probe_scan",
                                     "topk_index", "cell_rank",
                                     "grouped_scan_knorm", "topk_payload"],
                         idle=["coarse_probe", "grouped_scan"])
    lut2 = IVFADCIndex(
        dataclasses.replace(index2.config, scan_mode="lut"), index2.coarse,
        index2.quantizer, index2.store, index2.data_dtype, index2.dim)
    u_lut, _ = lut2.search_padded(q2, TOPK, w=W)
    r_dense = recall_at_r(u_ids, gt2, TOPK)
    r_small = recall_at_r(u_small, gt2[:256], TOPK)
    r_lut = recall_at_r(u_lut, gt2, TOPK)
    r_lut_small = recall_at_r(u_lut[:256], gt2[:256], TOPK)
    check(abs(r_dense - r_lut) <= 0.01,
          f"inner product: grouped recall {r_dense} vs LUT {r_lut}")
    check(abs(r_small - r_lut_small) <= 0.01,
          f"inner product: per-probe recall {r_small} vs LUT {r_lut_small}")
    emit("unfused", n=N2, kc=KC2, metric="inner_product", build_s=build2_s,
         recall_at_10_grouped=r_dense, recall_at_10_lut=r_lut,
         recall_at_10_per_probe=r_small, recall_at_10_lut_same_256=r_lut_small,
         launches_b16=c_small, launches=counts,
         seconds=time.perf_counter() - t0)
    del index2, lut2

    # ---- save / load
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "index.npz")
        index.save(path)
        loaded = IVFADCIndex.load(path, device="cuda")
        ids2, dists2 = loaded.search_padded(qs, TOPK, w=W)
        # the same index on the CPU searches through the kernels' plain
        # versions: the whole path must agree with the card's
        on_cpu = IVFADCIndex.load(path, device="cpu")
        # "auto" resolves to the (unported) LUT scan off the card
        on_cpu.config = dataclasses.replace(on_cpu.config, scan_mode="dense")
        ids3, dists3 = on_cpu.search_padded(qs.cpu(), TOPK, w=W)
    check(np.array_equal(ids, ids2) and np.array_equal(dists, dists2),
          "save/load changed search results")
    same = ids == ids3
    check(same.mean() >= 0.999, f"CPU plain path ids agree {same.mean()}")
    np.testing.assert_allclose(dists[same], dists3[same], rtol=1e-5,
                               atol=1e-3)
    emit("persist", identical=True, cpu_plain_ids_agree=float(same.mean()),
         seconds=time.perf_counter() - t0)

    # ---- where a batch's device time goes
    t0 = time.perf_counter()
    emit("profile", **phase_profile(
        lambda i: index._device_search(queries[i * BATCH:(i + 1) * BATCH],
                                       TOPK, W), 3),
         seconds=time.perf_counter() - t0)

    # ---- dynamic ops on a fork of the SIFT1M index, then an OPQ index
    t0 = time.perf_counter()
    emit("dynamic", card=smi, **phase_dynamic(index, base, queries,
                                              zero_counts, read_counts),
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    emit("opq", card=smi, **phase_opq(base, zero_counts, read_counts),
         seconds=time.perf_counter() - t0)

    # ---- out-of-core build, autotune and memory_stats, the serving front
    # end (its mutations change the SIFT1M index, which no later phase uses)
    t0 = time.perf_counter()
    emit("streaming", card=smi, **phase_streaming(
        index, data, base, queries[:BATCH], qs, gt, recall, zero_counts,
        read_counts), seconds=time.perf_counter() - t0)
    del data
    t0 = time.perf_counter()
    emit("tune", card=smi, **phase_tune(index, queries[:BATCH]),
         seconds=time.perf_counter() - t0)
    phase_sharded(index, queries, qs, gt, recall, smi, zero_counts,
                  read_counts)
    recall_1x4 = phase_distributed(base, queries, qs, gt, recall,
                                   recall_oracle, smi, zero_counts,
                                   read_counts)
    phase_multichip(index, base, queries, qs, gt, recall, recall_1x4, smi,
                    zero_counts, read_counts)
    t0 = time.perf_counter()
    emit("serving", card=smi, **phase_serving(index, queries, zero_counts,
                                              read_counts),
         seconds=time.perf_counter() - t0)

    # ---- the large-kc two-level index
    del index, lut_index, loaded, on_cpu, oracle, base, queries, qs
    torch.cuda.empty_cache()
    posting = records.pop("grouped_scan_knorm@posting")
    pos8_sift = records.pop("grouped_scan_pos8@sift1m_integer")
    tl = phase_two_level(zero_counts, read_counts, posting)
    phase_sharded_two_level(tl["index"], tl["queries"], smi, zero_counts,
                            read_counts)
    t0 = time.perf_counter()
    emit("dynamic_two_level", card=smi, **phase_dynamic_two_level(
        tl.pop("index"), tl.pop("queries"), zero_counts, read_counts),
         seconds=time.perf_counter() - t0)
    records["grouped_scan_knorm"] = tl["grouped_scan_knorm"]
    records["grouped_scan_pos8"] = dict(tl["grouped_scan_pos8"],
                                        sift1m_tiles=pos8_sift)
    records["grouped_scan_extract"]["stage2_shape"] = \
        tl["grouped_scan_extract@stage2"]

    # launches: the count from the run of the kernel's own path
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=rec["source"],
             replaces=rec["replaces"],
             launches=launches[path_of[name]][name],
             max_abs_err=rec["max_abs_err"], ms=rec["ms"],
             plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
             bound_by=rec["bound_by"], library_ms=rec["library_ms"],
             path=path_of[name], table_row=row_of[name],
             launches_by_path={ph: c[name] for ph, c in launches.items()},
             **{k: v for k, v in rec.items()
                if k not in ("source", "replaces", "max_abs_err", "ms",
                             "plain_ms", "bound_ms", "bound_by",
                             "library_ms")})
        for name, rec in records.items()]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
