"""Hold the grouped scan kernels against an earlier build of their source,
in results and in time, on one card.

    git show <commit>:ivfadc_tpu_torch/csrc/dense_scan.cu > _archive/old.cu
    python -m ivfadc_tpu_torch.utils.scan_ab --old-src _archive/old.cu

The earlier source is compiled by nvcc into a temporary directory (beside
this tree's `csrc/common.cuh`) and bound under the same C entry points,
which the wrappers then call in place of this tree's build, so both builds
see the same inputs through the same wrapper. Inputs: a SIFT1M-shape
index (n = 1M, d = 128, kc = 1024, int8 and bf16 caches) and its tiles at
B = 16384, w = 8 (kernel 3, 8a-8e) and B = 8192 (kernel 9, the qc route),
real and integer-valued (every f32 sum exact, so both builds must agree
bit for bit), and one synthetic large-kc batch of pos8 tiles (kc = 2^18
cells of ~8 rows, 2^20 probes: 8b's shape). Prints
one JSON line: the card's name and power limit; the count of tensor-core
(HMMA / HGMMA) and CUDA-core FMA (FFMA) instructions in each build's SASS;
and per shape the max abs difference of the finite scores, the share of
agreeing payloads (exact merge: of each probe's sorted top-k), whether
the integer case is bit-equal, both builds' median milliseconds per
wrapper call (CUDA events) taken in turns (old, new, new, old), their
kernel device time per call (torch.profiler) and the new build's launch
shape (blocks per SM from the occupancy API, shared bytes, staged tiles,
fold buffer, registers, spills).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import tempfile

import torch

from ivfadc_tpu_torch import _build
from ivfadc_tpu_torch.ops import coarse_scan, dense_scan
from ivfadc_tpu_torch.utils.coarse_ab import build_old, cuda_ms, kernel_ms

N, D, KC, M, KQ, W = 1_000_000, 128, 1024, 8, 256, 8
BATCH, BATCH_QC, TOPK = 16384, 8192, 10
KC_BIG, P_BIG, LIVE_BIG = 1 << 18, 1 << 20, 107_600

# name -> (variant, cache, tiles): kernel 3 and its variants, 9 and 8b
SHAPES = {"k3": ("ids", "int8", "b16384"),
          "8a": ("knorm", "int8", "b16384"),
          "8b": ("pos8", "int8", "b16384"),
          "8c": ("ids", "bf16", "b16384"),
          "8c_knorm": ("knorm", "bf16", "b16384"),
          "8d": ("exact", "int8", "b16384"),
          "8e": ("extract", "int8", "b16384"),
          "9": ("qc", "int8", "b8192"),
          "9_bf16": ("qc", "bf16", "b8192"),
          "8b_large_kc": ("pos8", "int8", "large_kc")}


def sass_counts(lib: str, ops=("HMMA", "HGMMA", "FFMA")) -> dict:
    """Counts of the named instructions (tensor-core and f32 FMA by
    default) in a library's SASS."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    return {op.lower(): len(re.findall(rf"\b{op}\b", sass)) for op in ops}


def old_kernels(lib_path: str) -> dict:
    """Kernel objects bound to the earlier build's entry points."""
    lib = ctypes.CDLL(lib_path)
    lib.ivfadc_error_string.argtypes = [ctypes.c_int]
    lib.ivfadc_error_string.restype = ctypes.c_char_p
    out = {}
    for table in (dense_scan.GROUPED_KERNELS, dense_scan.QC_KERNELS):
        for key, k in table.items():
            o = _build.Kernel("dense_scan", k.fn, k.argtypes)
            cfn = getattr(lib, k.fn)
            cfn.argtypes = k.argtypes
            cfn.restype = ctypes.c_int
            o._cfn = (lib, cfn)
            out[id(table), key] = o
    return out


@contextlib.contextmanager
def build(old: dict | None):
    """The wrappers call the earlier build's kernels inside the block."""
    tables = (dense_scan.GROUPED_KERNELS, dense_scan.QC_KERNELS)
    saved = [dict(t) for t in tables]
    try:
        if old is not None:
            for t in tables:
                for key in t:
                    t[key] = old[id(t), key]
        yield
    finally:
        for t, s in zip(tables, saved):
            t.update(s)


def sift_inputs():
    """The SIFT1M-shape index (seed 0) and its tiles for queries near its
    points: (views, B=16384 placement args, B=8192 qc args per cache)."""
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    dev = torch.device("cuda")
    base = torch.as_tensor(synthetic_clustered(N, D, seed=0), device=dev)
    index = IVFADCIndex.build(base, kc=KC, k=KQ, m=M, seed=0,
                              kmeanspp_sample=65536)
    g = torch.Generator(device=dev).manual_seed(1)
    qidx = torch.randint(0, N, (4 * BATCH,), generator=g, device=dev)
    queries = base[qidx] + 0.05 * torch.randn((4 * BATCH, D), generator=g,
                                              device=dev)
    del base
    views = {"int8": index.store.device_view_dense(
        index.quantizer, index.config.scan_chunk)}
    views["bf16"] = index.store.device_view_dense(
        index.quantizer, index.config.scan_chunk, cache="bf16")
    c32 = index.coarse.centroids
    eye = torch.eye(D, device=dev)
    pb, nf = index.config.scan_pb, index.config.scan_fold_lanes
    cells, _, v, bq = coarse_scan.coarse_probe_vbase(queries[:BATCH], c32, W,
                                                     eye, False, True)
    tiles = dense_scan.place_tiles(cells, views["int8"]["offsets"],
                                   views["int8"]["sizes"], v, bq, kc=KC,
                                   pb=pb)[:4]
    cells8 = coarse_scan.coarse_probe_vbase(queries[:BATCH_QC], c32, W, eye,
                                            False, True)[0]
    qc = {elem: dense_scan.qc_tile_inputs(
        cells8, vw["offsets"], vw["sizes"], queries[:BATCH_QC], c32, None, D,
        kc=KC, pb=pb)[:7] for elem, vw in views.items()}
    return views, tiles, qc, pb, nf


def large_kc_inputs(pb: int, nf: int):
    """A synthetic batch at 8b's shape (a B=32768, w=32 batch at the
    Deep1B-shard shape, n = 2M, d = 96): 2^18 cells of ~8 rows (8-row
    aligned), 2^20 probes spread over LIVE_BIG of them (that batch's count
    of live tiles), random int8 rows."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    sizes = torch.randint(1, 16, (KC_BIG,), generator=g, device=dev) \
        .to(torch.int32)
    caps = (sizes + 7) // 8 * 8
    offsets = (torch.cumsum(caps, 0) - caps).to(torch.int32)
    rows = int(caps.sum().item()) + 128
    decoded = torch.randint(-127, 128, (rows, D), generator=g, device=dev,
                            dtype=torch.int8)
    scale = 0.01 + 0.02 * torch.rand(D, generator=g, device=dev)
    pool = torch.randperm(KC_BIG, generator=g, device=dev)[:LIVE_BIG]
    cells = pool[torch.randint(0, LIVE_BIG, (P_BIG // 32, 32), generator=g,
                               device=dev)].to(torch.int32)
    v = torch.randn((P_BIG // 32, 32, D), generator=g, device=dev) \
        .to(torch.bfloat16)
    bq = 10 + torch.rand((P_BIG // 32, 32), generator=g, device=dev)
    tiles = dense_scan.place_tiles(cells, offsets, sizes, v, bq, kc=KC_BIG,
                                   pb=pb)[:4]
    return tiles, decoded, scale


def integer_twin(args, qc: bool, seed: int):
    """The same tiles with integer-valued rows, v / queries and centroids,
    finite bases and norms: every f32 sum exact."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(t, lo, hi, dtype):
        return torch.randint(lo, hi, t.shape, generator=g, device=dev,
                             dtype=torch.int8).to(dtype)
    a = list(args)
    if qc:      # (tstart, tsize, c_t, qidx, q, c, rot, dec, scale, ids2d)
        a[4] = ints(a[4], -4, 5, torch.float32)
        a[5] = ints(a[5], -4, 5, torch.float32)
        a[7] = ints(a[7], -3, 4, a[7].dtype)
        a[8] = None if a[8] is None else torch.ones_like(a[8])
        return a
    # (tstart, tsize, v, base, dec, scale, ids2d, norms2d)
    a[2] = ints(a[2], -4, 5, torch.bfloat16)
    a[3] = torch.where(torch.isfinite(a[3]), ints(a[3], 0, 100, torch.float32),
                       float("inf"))
    a[4] = ints(a[4], -3, 4, a[4].dtype)
    a[5] = None if a[5] is None else torch.ones_like(a[5])
    a[7] = None if a[7] is None else ints(a[7], 0, 50, torch.float32)
    return a


def compare(a, b, exact: bool) -> dict:
    """Max abs difference of the finite scores, payload agreement and
    whether the outputs are bit-equal."""
    ad, ap = a
    bd, bp = b
    equal = torch.equal(ad, bd) and torch.equal(ap, bp)
    if exact:          # each probe's buffer as a sorted list
        ad, ai = torch.sort(ad, dim=1)
        bd, bi = torch.sort(bd, dim=1)
        ad, bd = ad[:, :TOPK], bd[:, :TOPK]
        ap = torch.gather(ap, 1, ai[:, :TOPK])
        bp = torch.gather(bp, 1, bi[:, :TOPK])
    fin = torch.isfinite(ad) & torch.isfinite(bd)
    return dict(bit_equal=equal,
                inf_pattern_equal=torch.equal(torch.isfinite(ad),
                                              torch.isfinite(bd)),
                max_abs_diff=(ad[fin] - bd[fin]).abs().max().item()
                if fin.any() else 0.0,
                payloads_agree=(ap == bp).float().mean().item())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    wanted = [s for s in args.shapes.split(",") if s]
    views, tiles, qc, pb, nf = sift_inputs()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        old_lib = build_old(args.old_src, tmp, "dense_scan_old")
        sass = dict(old=sass_counts(old_lib), new=sass_counts(
            os.path.join(_build.build_dir(), "libdense_scan.so")))
        old = old_kernels(old_lib)
        for name in wanted:
            variant, elem, where = SHAPES[name]
            vw = views[elem]
            kw = dict(pb=pb, nf=nf, norm_coef=1.0)
            if where == "large_kc":
                big, dec, sc = large_kc_inputs(pb, nf)
                call_args = list(big) + [dec, sc, None, None]
            elif variant == "qc":
                call_args = list(qc[elem]) + [vw["decoded"], vw["scale"],
                                              vw["ids2d"]]
                kw.update(base_mult=2.0, apply_rot=False)
            else:
                call_args = list(tiles) + [vw["decoded"], vw["scale"],
                                           vw["ids2d"], vw["norms2d"]]
            if variant in ("pos8", "exact"):
                call_args[6] = call_args[7] = None
            if variant in ("knorm", "extract"):
                call_args[7] = None
            if variant == "pos8":
                kw["pos8"] = True
            if variant == "exact":
                kw.update(merge="exact", k_out=TOPK)
            if variant == "extract":
                kw["extract_k"] = TOPK
            scan = dense_scan.grouped_scan_qc if variant == "qc" \
                else dense_scan.grouped_scan
            row = dict(variant=variant, cache=elem, tiles=where)
            for integer in (False, True):
                a = integer_twin(call_args, variant == "qc", 7) \
                    if integer else call_args
                with build(old):
                    out_old = scan(*a, **kw)
                out_new = scan(*a, **kw)
                cmp = compare(out_old, out_new, variant == "exact")
                row["integer" if integer else "real"] = cmp
                del out_old, out_new, a
            t_old, t_new = [], []

            def run_old():
                with build(old):
                    return scan(*call_args, **kw)

            def run_new():
                return scan(*call_args, **kw)
            for first, second in ((run_old, run_new), (run_new, run_old)):
                for fn in (first, second):
                    (t_old if fn is run_old else t_new).extend(
                        cuda_ms(fn, args.reps))
            kern = (dense_scan.QC_KERNELS[elem] if variant == "qc"
                    else dense_scan.GROUPED_KERNELS[variant, elem])
            row.update(old_ms=statistics.median(t_old),
                       new_ms=statistics.median(t_new),
                       old_device_ms=kernel_ms(run_old, match="grouped_scan"),
                       new_device_ms=kernel_ms(run_new, match="grouped_scan"),
                       launch_shape=dense_scan.scan_fit(
                           kern.fn, D, pb, nf if variant != "exact" else 128,
                           TOPK if variant in ("exact", "extract") else 0),
                       tiles_count=int(call_args[0].numel()),
                       live_tiles=int((call_args[1] > 0).sum().item()))
            res[name] = row
            print(json.dumps({name: row}), flush=True)
            del call_args
            torch.cuda.empty_cache()
    line = json.dumps({"card": card, "sass": sass, "pb": pb, "nf": nf,
                       "shapes": res})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
