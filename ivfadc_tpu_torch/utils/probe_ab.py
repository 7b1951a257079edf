"""Hold the per-probe scan kernels against an earlier build of their source,
in results and in time, on one card.

    git show <commit>:ivfadc_tpu_torch/csrc/probe_scan.cu > _archive/old.cu
    python -m ivfadc_tpu_torch.utils.probe_ab --old-src _archive/old.cu \
        [--shapes b256,posting,cells1000] [--variants fold/int8,...] \
        [--old-abi wide|narrow] [--cell-order] [--out results.json]

The earlier source is compiled by nvcc into a temporary directory (beside
this tree's `csrc/common.cuh`) and called through its own C signature,
which takes v at the cache's width (the earlier wrapper padded it; the
padding is part of that call); with --old-abi narrow it is a variant of
this tree's source with this tree's signature (a copy with one design
choice flipped, to measure it). Both builds run the four entry points
(fold / exact merge x int8 / bf16 cache) on the same inputs at three
shapes:

  b256     chip_smoke.py's B=256, w=8 probes (2,048) on its SIFT1M-shape
           index (n = 1M, d = 128, kc = 1024; cells of ~1000 rows)
  posting  the large-kc posting shape: 131,072 probes (4,096 queries x
           w = 32) over 2^18 8-row-aligned cells of 1-55 rows, v at
           d = 96 over a 128-wide cache
  cells1000  2,048 probes over 512 cells of 1,000 rows, d = 128

real and integer-valued (every f32 sum exact, so the builds must agree bit
for bit). Prints one JSON line: the card's name and power limit; the
count of bulk-copy (UBLKCP), tensor-core (HMMA), f32 FMA (FFMA) and block
barrier (BAR) instructions in each build's SASS; and per shape and
variant whether the integer case is bit-equal, the real case's max abs
difference and payload agreement (exact merge: of each probe's sorted
top-10), both builds' median milliseconds per call (CUDA events) taken in
turns (old, new, new, old), their kernel device time per call
(torch.profiler), each build's launch shape, and the bound (bytes: rows
of the probed cells, v, base, starts, sizes and the output rows, each
once; 3.35e12 B/s) with the new build's share of it. With --cell-order,
each row also times this tree's scan on the probes taken in cell order
(`cell_order`: a stable sort by cell start, so probes of one cell run
back to back and may find its rows in L2; the sort and the permutations
are part of the call), in turns with the probe-order call, and checks
that both orders give the same output on the integer case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import tempfile

import torch

from ivfadc_tpu_torch import _build
from ivfadc_tpu_torch.ops import dense_scan
from ivfadc_tpu_torch.utils.coarse_ab import build_old, cuda_ms, kernel_ms
from ivfadc_tpu_torch.utils.scan_ab import TOPK, compare, sass_counts

PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12
SASS_OPS = ("UBLKCP", "HMMA", "FFMA", "BAR")
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_ARGS = [P_] * 6 + [I_] * 4 + [F_] + [P_] * 3


def _caches(decoded, scale):
    """{"int8": (decoded, scale), "bf16": (rows as the kernels see them,
    None)}."""
    sc = scale.to(torch.bfloat16).to(torch.float32)
    return {"int8": (decoded, scale),
            "bf16": ((decoded.float() * sc).to(torch.bfloat16), None)}


def b256_inputs():
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.ops import coarse_scan
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    dev = torch.device("cuda")
    n, d, kc, w, B = 1_000_000, 128, 1024, 8, 256
    base = torch.as_tensor(synthetic_clustered(n, d, seed=0), device=dev)
    index = IVFADCIndex.build(base, kc=kc, k=256, m=8, seed=0,
                              kmeanspp_sample=65536)
    g = torch.Generator(device=dev).manual_seed(1)
    q = base[torch.randint(0, n, (B,), generator=g, device=dev)] \
        + 0.05 * torch.randn((B, d), generator=g, device=dev)
    del base
    view = index.store.device_view_dense(index.quantizer,
                                         index.config.scan_chunk)
    cells, _, v, bq = coarse_scan.coarse_probe_vbase(
        q, index.coarse.centroids, w, torch.eye(d, device=dev), False, True)
    c64 = cells.to(torch.int64)
    probes = (view["offsets"][c64], view["sizes"][c64], v, bq)
    return probes, _caches(view["decoded"], view["scale"])


def synthetic_inputs(kc: int, sizes, B: int, w: int, d: int, dv: int,
                     seed: int):
    """B*w probes over kc 8-row-aligned cells of the given sizes, random
    int8 rows and scales, v (B, w, dv), bases near 10."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    sizes = sizes.to(torch.int32)
    caps = (sizes + 7) // 8 * 8
    offsets = (torch.cumsum(caps, 0) - caps).to(torch.int32)
    rows = int(caps.sum().item())
    decoded = torch.randint(-127, 128, (rows, d), generator=g, device=dev,
                            dtype=torch.int8)
    scale = 0.01 + 0.02 * torch.rand(d, generator=g, device=dev)
    cells = torch.randint(0, kc, (B, w), generator=g, device=dev)
    v = torch.randn((B, w, dv), generator=g, device=dev).to(torch.bfloat16)
    bq = 10 + torch.rand((B, w), generator=g, device=dev)
    probes = (offsets[cells], sizes[cells], v, bq)
    return probes, _caches(decoded, scale)


def shape_inputs(name: str):
    dev = torch.device("cuda")
    if name == "b256":
        return b256_inputs()
    g = torch.Generator(device=dev).manual_seed(5)
    if name == "posting":
        kc = 1 << 18
        sizes = torch.randint(1, 56, (kc,), generator=g, device=dev)
        return synthetic_inputs(kc, sizes, 4096, 32, 128, 96, 3)
    sizes = torch.full((512,), 1000, device=dev)
    return synthetic_inputs(512, sizes, 256, 8, 128, 128, 4)


def integer_twin(probes, caches, seed: int):
    """The same probes with integer-valued v, rows and finite bases; scale
    ones: every f32 sum exact."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    starts, sizes, v, bq = probes
    vi = torch.randint(-4, 5, v.shape, generator=g, device=dev) \
        .to(torch.bfloat16)
    bi = torch.where(torch.isfinite(bq), torch.randint(
        0, 100, bq.shape, generator=g, device=dev).float(), float("inf"))
    dec = caches["int8"][0]
    deci = torch.randint(-3, 4, dec.shape, generator=g, device=dev,
                         dtype=torch.int8)
    ones = torch.ones(dec.shape[1], device=dev)
    return (starts, sizes, vi, bi), _caches(deci, ones)


def runners(old_lib, merge, elem, probes, caches, abi: str = "wide"):
    """(old, new): no-argument calls returning (out_d, out_p) of (P, nf).
    abi "wide": the earlier build takes v at the cache's width; "narrow":
    it has this tree's signature (v at its own width)."""
    starts, sizes, v, bq = probes
    dec, scale = caches[elem]
    nf = 128
    d = dec.shape[1]
    P = starts.numel()
    fn = getattr(old_lib, dense_scan.PROBE_KERNELS[merge, elem].fn)
    fn.argtypes = OLD_ARGS if abi == "wide" else dense_scan._PROBE_ARGS
    fn.restype = ctypes.c_int
    st, sz = starts.reshape(P).int(), sizes.reshape(P).int()
    bs = bq.reshape(P).float()
    sc = None if scale is None else scale.to(torch.bfloat16).float()
    kw = dict(k_out=TOPK, chunk=512, norm_coef=1.0, merge=merge, nf=nf)

    def old():
        wide = abi == "wide"
        vp = (torch.nn.functional.pad(v, (0, d - v.shape[-1])) if wide
              else v).reshape(P, -1).to(torch.bfloat16)
        out_d = torch.empty((P, nf), device=v.device)
        out_p = torch.empty((P, nf), dtype=torch.int32, device=v.device)
        dims = (P, d, nf) if wide else (P, d, vp.shape[1], nf)
        err = fn(st.data_ptr(), sz.data_ptr(), bs.data_ptr(), vp.data_ptr(),
                 dec.data_ptr(), None if sc is None else sc.data_ptr(), *dims,
                 TOPK, 1.0, out_d.data_ptr(), out_p.data_ptr(),
                 _build.stream_ptr(v.device))
        if err:
            raise RuntimeError(f"old {fn.__name__} failed: error {err}")
        return out_d, out_p

    def new():
        out_d, out_p = dense_scan.dense_scan(starts, sizes, v, bq, dec,
                                             scale, **kw)
        return out_d.reshape(P, nf), out_p.reshape(P, nf)
    return old, new


def cell_ordered(merge, elem, probes, caches):
    """A no-argument call of this tree's scan on the probes sorted by cell
    start (stable), its (P, nf) outputs put back in probe order."""
    starts, sizes, v, bq = probes
    dec, scale = caches[elem]
    P, nf = starts.numel(), 128
    kw = dict(k_out=TOPK, chunk=512, norm_coef=1.0, merge=merge, nf=nf)

    def run():
        order = torch.sort(starts.reshape(P), stable=True)[1]
        out_d, out_p = dense_scan.dense_scan(
            starts.reshape(P)[order][:, None],
            sizes.reshape(P)[order][:, None],
            v.reshape(P, -1)[order][:, None], bq.reshape(P)[order][:, None],
            dec, scale, **kw)
        rd = torch.empty((P, nf), device=v.device)
        rp = torch.empty((P, nf), dtype=torch.int32, device=v.device)
        rd[order] = out_d.reshape(P, nf)
        rp[order] = out_p.reshape(P, nf)
        return rd, rp
    return run


def bound(probes, elem: str, d: int) -> dict:
    """Bytes: each probed cell's rows once, v / base / start / size per
    probe, every output row (nf = 128) written; operations: dot and norm
    products of each probe with its cell's rows at the bf16 rate."""
    starts, sizes, v, _ = probes
    P = starts.numel()
    es = 1 if elem == "int8" else 2
    # cells are told apart by their start
    uniq = torch.unique(starts.reshape(-1), return_inverse=True)[1]
    first = torch.zeros(int(uniq.max().item()) + 1, dtype=torch.int64,
                        device=starts.device)
    first.scatter_reduce_(0, uniq, sizes.reshape(-1).to(torch.int64),
                          reduce="amax")
    rows = int(first.sum().item())
    probe_rows = int(sizes.to(torch.int64).sum().item())
    nbytes = rows * d * es + P * (2 * v.shape[-1] + 12) + P * 128 * 8
    t_b = 1e3 * nbytes / PEAK_BYTES
    t_o = 1e3 * 4.0 * d * probe_rows / PEAK_BF16
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                probes=P, mean_probe_rows=probe_rows / P)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shapes", default="b256,posting,cells1000")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--old-abi", choices=("wide", "narrow"), default="wide",
                    help="the earlier source's C signature: v at the "
                         "cache's width (the design before this one) or "
                         "at its own width (a variant of this design)")
    ap.add_argument("--cell-order", action="store_true",
                    help="also time this tree's scan on the probes "
                         "sorted by cell")
    ap.add_argument("--variants", default="fold/int8,exact/int8,fold/bf16,"
                                          "exact/bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        old_path = build_old(args.old_src, tmp, "probe_scan_old")
        sass = dict(old=sass_counts(old_path, SASS_OPS), new=sass_counts(
            os.path.join(_build.build_dir(), "libprobe_scan.so"), SASS_OPS))
        old_lib = ctypes.CDLL(old_path)
        for name in [s for s in args.shapes.split(",") if s]:
            probes, caches = shape_inputs(name)
            iprobes, icaches = integer_twin(probes, caches, 7)
            d = caches["int8"][0].shape[1]
            for merge, elem in (tuple(x.split("/"))
                                for x in args.variants.split(",") if x):
                row = dict(merge=merge, cache=elem, d=d,
                           dv=probes[2].shape[-1],
                           **bound(probes, elem, d))
                for integer in (True, False):
                    pr, ca = (iprobes, icaches) if integer else \
                        (probes, caches)
                    old, new = runners(old_lib, merge, elem, pr, ca,
                                       args.old_abi)
                    row["integer" if integer else "real"] = compare(
                        old(), new(), merge == "exact")
                t_old, t_new = [], []
                for first, second in ((old, new), (new, old)):
                    for fn in (first, second):
                        (t_old if fn is old else t_new).extend(
                            cuda_ms(fn, args.reps))
                kern = dense_scan.PROBE_KERNELS[merge, elem]
                row.update(
                    old_ms=statistics.median(t_old),
                    new_ms=statistics.median(t_new),
                    old_device_ms=kernel_ms(old, match="probe_scan"),
                    new_device_ms=kernel_ms(new, match="probe_scan"),
                    old_launch=dict(grid=probes[0].numel(), threads=128),
                    new_launch=dense_scan.probe_fit(kern.fn, d, 128, TOPK))
                row["new_share_of_bound"] = row["bound_ms"] / \
                    row["new_device_ms"]
                if args.cell_order:
                    srt = cell_ordered(merge, elem, probes, caches)
                    _, inew = runners(old_lib, merge, elem, iprobes, icaches,
                                      args.old_abi)
                    t_srt, t_new = [], []
                    for first, second in ((new, srt), (srt, new)):
                        for fn in (first, second):
                            (t_srt if fn is srt else t_new).extend(
                                cuda_ms(fn, args.reps))
                    row["cell_order"] = dict(
                        integer_bit_equal=compare(inew(), cell_ordered(
                            merge, elem, iprobes, icaches)(),
                            merge == "exact")["bit_equal"],
                        distinct_cells=int(torch.unique(
                            probes[0]).numel()),
                        ms=statistics.median(t_srt),
                        probe_order_ms=statistics.median(t_new),
                        device_ms=kernel_ms(srt, match="probe_scan"))
                res[f"{name}/{merge}/{elem}"] = row
                print(json.dumps({f"{name}/{merge}/{elem}": row}),
                      flush=True)
            del probes, caches, iprobes, icaches
            torch.cuda.empty_cache()
    line = json.dumps({"card": card, "sass": sass, "shapes": res})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
