#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ivfadc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `ivfadc_tpu_torch/csrc/`, then runs in
phases, printing one JSON line per phase; any failure raises (exit != 0):

  setup    card name and power limit, versions, kernel build time
  build    IVFADCIndex.build at the SIFT1M shape (n=1M, d=128, kc=1024,
           m=8, k=256, pq, seed 0, kmeanspp_sample=65536) on cuda
  kernels  each of the seven kernels against its plain PyTorch version on
           its path's own inputs. At B=16384 queries, w=8: coarse probe,
           cell ranks, grouped fold scan (plus an integer-valued case that
           must be bit-exact) and the top-k merge. At B=256, w=8 (2048
           probes): per-probe fold scan (plus a bit-exact integer case),
           top-k with indices on that scan's candidate rows, exact top-w
           probe (also against the fused probe's cells). For each: kernel
           time, plain time, the time of the nearest PyTorch library call
           where there is one, and the card's bound for the same work
  search   with every launch count zeroed: search_padded of 1000 queries,
           recall@10 against brute force and against the NumPy oracle of
           the reference algorithm, QPS over back-to-back B=16384 batches
           and the p50 batch latency; kernels 1-4 must have launched
  small_batch  counts zeroed: single-point search and search_padded at
           B=8/64/256 (B*w < 4*kc: per-probe scan + top-k with indices);
           recall@10 and id overlap against the grouped path on the same
           1000 queries; p50/p99 of 200 synchronised single-query searches,
           p50 per batch size, device idle share of a single-query search
  lut      counts zeroed: scan_mode="lut" at k=10 (256 queries, against the
           oracle) and k=200 through the default configuration (k > 128
           routes to the LUT engine)
  unfused  counts zeroed: a second index (n=200k, kc=256) scored by inner
           product: exact top-w probe, then the per-probe scan (B=16) and
           the grouped scan (B=4096); recall against brute-force inner
           product, dense routes against the LUT route
  persist  save -> load(device="cuda") -> identical search_padded output;
           the same file loaded on the CPU (kernels' plain versions) agrees
  profile  device time per kernel and idle share over three B=16384
           searches (torch.profiler)

The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the repository beside it, the script fails.
"""

from __future__ import annotations

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
N_SEARCH, N_ORACLE = 1000, 500
B_SMALL = 256                       # largest small-batch size: 2048 probes
N2, KC2 = 200_000, 256              # the inner-product index

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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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
        **bound(4 * (BATCH * D + KC * D + KC + D * D)
                + BATCH * W * (12 + 2 * D), 2.0 * BATCH * KC * D, PEAK_F32))

    # 2. cell ranks on the probe's own cells: exact.
    cells = kv[1].reshape(-1)
    kr = cell_rank.cell_ranks(cells, kc=KC)
    pr = cell_rank.cell_ranks_plain(cells, KC)
    check(torch.equal(kr[0], pr[0]) and torch.equal(kr[1], pr[1]),
          "cell ranks differ")
    records["cell_rank"] = dict(
        source="ivfadc_tpu_torch/csrc/cell_rank.cu",
        replaces="ivfadc_tpu/ops/cell_rank.py:54", max_abs_err=0.0,
        ms=cuda_ms(lambda: cell_rank.cell_ranks(cells, kc=KC)),
        plain_ms=cuda_ms(lambda: cell_rank.cell_ranks_plain(cells, KC)),
        library_ms=cuda_ms(lambda: (torch.sort(cells, stable=True),
                                    torch.bincount(cells, minlength=KC))),
        **bound(8 * cells.numel() + 4 * KC, cells.numel(), PEAK_F32))

    # 3. grouped scan on the main path's own tiles
    view = index.store.device_view_dense(index.quantizer,
                                         index.config.scan_chunk)
    pb, nf = index.config.scan_pb, index.config.scan_fold_lanes
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
        **bound(8 * flat_d.numel() + 8 * BATCH * TOPK,
                float(flat_d.numel()) * TOPK, PEAK_F32))
    records.update(phase_kernels_small(index, queries))
    return records


def phase_kernels_small(index, queries):
    """Kernels 5-7 against their plain versions on the small-batch path's
    own inputs at B=256, w=8 (2048 probes)."""
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
        **bound(4 * (B_SMALL * D + KC * D + KC) + 8 * B_SMALL * W,
                2.0 * B_SMALL * KC * D, PEAK_F32))

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
        **bound(4 * flat_d.numel() + 8 * B_SMALL * TOPK,
                float(flat_d.numel()) * TOPK, PEAK_F32))
    return records


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
    from benchmarks.oracle import ReferenceOracle

    kernels = {"coarse_probe": coarse_scan.KERNEL,
               "cell_rank": cell_rank.KERNEL,
               "grouped_scan": dense_scan.KERNEL,
               "topk_payload": topk.KERNEL,
               "probe_scan": dense_scan.PROBE_KERNEL,
               "topk_index": topk.INDEX_KERNEL,
               "coarse_topw": coarse_scan.TOPW_KERNEL}
    # the path whose run gives each kernel its launch count
    path_of = {"coarse_probe": "search", "cell_rank": "search",
               "grouped_scan": "search", "topk_payload": "search",
               "probe_scan": "small_batch", "topk_index": "small_batch",
               "coarse_topw": "lut"}
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
    digest = hashlib.sha1()
    for part in (index.coarse.centroids.cpu().numpy(),
                 index.quantizer.codebooks.cpu().numpy(),
                 index.store.codes, index.store.ids):
        digest.update(np.ascontiguousarray(part).tobytes())
    emit("build", n=N, d=D, kc=KC, m=M, k=KQ, data_gen_s=gen_s,
         build_s=build_s, build_digest=digest.hexdigest()[:12],
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
                         idle=["probe_scan", "topk_index", "coarse_topw"])
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
    s_ids = np.concatenate([index.search_padded(qs[s:s + B_SMALL], TOPK,
                                                w=W)[0]
                            for s in range(0, N_SEARCH, B_SMALL)])
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
                               "coarse_topw"])
    prof1 = phase_profile(
        lambda i: index.search(queries[i], TOPK, w=W), 50)
    emit("small_batch", recall_at_10=recall_small, recall_grouped=recall,
         top10_overlap_grouped=overlap_small,
         single_query_p50_ms=float(np.percentile(lat, 50)),
         single_query_p99_ms=float(np.percentile(lat, 99)),
         single_query_calls=len(lat), p50_ms_by_batch=p50_by_batch,
         launches=counts, single_query_profile=prof1,
         seconds=time.perf_counter() - t0)

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
    counts = read_counts("unfused", ["coarse_topw", "probe_scan",
                                     "topk_index", "cell_rank",
                                     "grouped_scan", "topk_payload"],
                         idle=["coarse_probe"])
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

    # launches: the count from the run of the kernel's own path
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=rec["source"],
             replaces=rec["replaces"],
             launches=launches[path_of[name]][name],
             max_abs_err=rec["max_abs_err"], ms=rec["ms"],
             plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
             bound_by=rec["bound_by"], library_ms=rec["library_ms"],
             path=path_of[name],
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
