#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ivfadc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `ivfadc_tpu_torch/csrc/`, then runs in
phases, printing one JSON line per phase; any failure raises (exit != 0):

  setup    card name and power limit, versions, kernel build time
  build    IVFADCIndex.build at the SIFT1M shape (n=1M, d=128, kc=1024,
           m=8, k=256, pq, seed 0, kmeanspp_sample=65536) on cuda
  kernels  each of the four kernels against its plain PyTorch version on
           the main path's own inputs (B=16384 queries, w=8): coarse probe,
           cell ranks, grouped fold scan (plus an integer-valued case that
           must be bit-exact) and the top-k merge; kernel and plain times
  search   with every launch count zeroed: search_padded of 1000 queries,
           recall@10 against brute force and against the NumPy oracle of
           the reference algorithm, QPS over back-to-back B=16384 batches
           and the p50 batch latency; every kernel must have launched
  persist  save -> load(device="cuda") -> identical search_padded output;
           the same file loaded on the CPU (kernels' plain versions) agrees
  profile  device time per kernel and idle share over three B=16384
           searches (torch.profiler)

The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the repository beside it, the script fails.
"""

from __future__ import annotations

import dataclasses
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of fn() over `reps` runs after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
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
    records["coarse_probe"] = dict(
        source="ivfadc_tpu_torch/csrc/coarse_scan.cu",
        replaces="ivfadc_tpu/ops/coarse_scan.py:95", max_abs_err=err,
        cells_agree=agree,
        ms=cuda_ms(lambda: coarse_scan.coarse_vbase(q, c32, cn, rot, W,
                                                    False)),
        plain_ms=cuda_ms(lambda: coarse_scan.coarse_vbase_plain(
            q, c32, cn, rot, W, False)))

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
        plain_ms=cuda_ms(lambda: cell_rank.cell_ranks_plain(cells, KC)))

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
    records["grouped_scan"] = dict(
        source="ivfadc_tpu_torch/csrc/dense_scan.cu",
        replaces="ivfadc_tpu/ops/pallas_scan.py:171", max_abs_err=err,
        ids_agree=id_agree, integer_case_bit_exact=True,
        tiles=int(tsize.shape[0]), live_tiles=int((tsize > 0).sum().item()),
        ms=cuda_ms(lambda: dense_scan.grouped_scan(*scan_args, **kw)),
        plain_ms=cuda_ms(lambda: dense_scan.grouped_scan_plain(*scan_args,
                                                               **kw), reps=3))

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
            flat_d, flat_p, TOPK)))
    return records


def phase_profile(index, queries) -> dict:
    """Device time per kernel and the device's idle share over three
    back-to-back B=16384 searches, from torch.profiler's CUDA trace
    (profiler overhead included in the wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [queries[s:s + BATCH] for s in range(0, 3 * BATCH, BATCH)]
    index._device_search(batches[0], TOPK, W)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            index._device_search(b, TOPK, W)
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
        wall_ms_per_batch=wall_ms,
        device_busy_ms_per_batch=busy_ms if rows else None,
        device_idle_share=(1.0 - busy_ms / wall_ms) if rows else None,
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
               "topk_payload": topk.KERNEL}

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
    emit("build", n=N, d=D, kc=KC, m=M, k=KQ, data_gen_s=gen_s,
         build_s=build_s,
         build_phases={k: round(v, 3) for k, v in
                       index.build_timings.items()},
         seconds=time.perf_counter() - t0)

    # ---- kernels against their plain versions
    t0 = time.perf_counter()
    records = phase_kernels(index, queries)
    emit("kernels", seconds=time.perf_counter() - t0)

    # ---- search: the main path, with every launch count zeroed first
    t0 = time.perf_counter()
    for k in kernels.values():
        k.launches = 0
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
    o_ids, _ = oracle.search_batch(q_host, TOPK, W)
    o_pad = np.full((N_ORACLE, TOPK), -1, np.int64)
    for i, row_ids in enumerate(o_ids):
        o_pad[i, :len(row_ids)] = row_ids
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
    launches = {name: k.launches for name, k in kernels.items()}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    emit("search", recall_at_10=recall, recall_at_10_oracle_queries=recall_port_sub,
         recall_oracle=recall_oracle, oracle_queries=N_ORACLE, top10_overlap_oracle=overlap,
         qps=qps, wave_s=waves, p50_batch_ms=1e3 * float(np.median(singles)),
         batch=BATCH, w=W, launches=launches,
         seconds=time.perf_counter() - t0)

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
    emit("profile", **phase_profile(index, queries),
         seconds=time.perf_counter() - t0)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=rec["source"],
             replaces=rec["replaces"], launches=launches[name],
             max_abs_err=rec["max_abs_err"], ms=rec["ms"],
             plain_ms=rec["plain_ms"],
             **{k: v for k, v in rec.items()
                if k not in ("source", "replaces", "max_abs_err", "ms",
                             "plain_ms")})
        for name, rec in records.items()]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
