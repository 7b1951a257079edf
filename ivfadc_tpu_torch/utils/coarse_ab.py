"""Hold the coarse kernels against an earlier build of their source, bit for
bit and in time, on one card.

    git show <commit>:ivfadc_tpu_torch/csrc/coarse_scan.cu > _archive/old.cu
    python -m ivfadc_tpu_torch.utils.coarse_ab --old-src _archive/old.cu \
        [--shapes vbase_gist,...]

The earlier source is compiled by nvcc into a temporary directory (beside
this tree's `csrc/common.cuh`) and bound with the C signatures that take
a launch plan (query tile tq, table splits, the splits' lists and
tickets), those of this tree and of every source since the plan was added.
The earlier build runs the plan of the rule its source had: a `coarse_fit`
that reports 7 ints or more (the cost model's sources) takes this tree's
`choose` over its own fits, which plans a fit that reports no large-w
selection as those sources did; a 4-int `coarse_fit` the rule before the
cost model (tq = 4 where the 64-query grid fills every SM, else 1; the
most splits whose blocks all fit the resident slots at once). At each
shape the kernel (top-w, v/base or v2) runs on the same inputs through both builds: random-float queries near random centroids
from a seed, and integer-valued ones (entries in -2..2, so most scores tie
exactly). Prints one JSON line: the card's name and power limit, and per
shape whether every output (vals, cells, v, rn) is bit-equal, the median
milliseconds of each build's call (CUDA events, wrapper included), taken
in turns (old, new, new, old) in this one process, each build's kernel
device time per call (torch.profiler), the old plan and this tree's.
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
from ivfadc_tpu_torch.ops import coarse_scan as cs

# (name, kernel, B, kc, d, w, rotation): the SIFT1M shape's small batch
# (B = 256) and grouped batch (B = 16384), the Deep1B-shard shape's naive
# probe over kc = 2^18 (B = 4096, d = 96, w = 32), then the benchmark
# cells' (gist1m.batch, sift1m.batch, sift1m.batch64k, sift1m.ivf8192), and
# beside the last its top-w kernel and its shape at w = 8: top-w at w = 64
# less at w = 8 is what w costs the selection, v/base less top-w the
# epilogue
SHAPES = [("topw_b256", "topw", 256, 1024, 128, 8, False),
          ("vbase_b16384", "vbase", 16384, 1024, 128, 8, False),
          ("vbase_b16384_rot", "vbase", 16384, 1024, 128, 8, True),
          ("v2_b16384", "vbase_v2", 16384, 1024, 128, 8, False),
          ("v2_b16384_rot", "vbase_v2", 16384, 1024, 128, 8, True),
          ("topw_large_kc", "topw", 4096, 1 << 18, 96, 32, False),
          ("vbase_large_kc", "vbase", 4096, 1 << 18, 96, 32, False),
          ("vbase_gist", "vbase", 10240, 1024, 960, 8, False),
          ("vbase_sift", "vbase", 10240, 1024, 128, 8, False),
          ("vbase_b65536", "vbase", 65536, 1024, 128, 8, False),
          ("vbase_sift8k", "vbase", 10240, 8192, 128, 64, False),
          ("topw_sift8k", "topw", 10240, 8192, 128, 64, False),
          ("vbase_sift8k_w8", "vbase", 10240, 8192, 128, 8, False)]

P, I = ctypes.c_void_p, ctypes.c_int
OLD_ARGS = {"vbase": [P] * 4 + [I] * 7 + [P] * 7,      # the stream last
            "vbase_v2": [P] * 6 + [I] * 7 + [P] * 6,
            "topw": [P] * 3 + [I] * 6 + [P] * 5}
OLD_FN = {"vbase": "coarse_vbase", "vbase_v2": "coarse_vbase_v2",
          "topw": "coarse_topw"}


def build_old(src: str, out_dir: str, name: str = "coarse_old") -> str:
    """nvcc builds an earlier source beside this tree's headers; returns
    the library's path."""
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", lib, src], check=True)
    return lib


def old_plan(lib, B, d, kc, w, kind):
    """(tq, splits, fit of the plan's tile) of an earlier source by its own
    rule: this tree's `choose` over the fits of a `coarse_fit` of 7 ints or
    more; over a 4-int one, 64-query tiles where their grid fills every SM,
    else 16, and the most splits whose blocks all fit the card's resident
    slots at once."""
    fit = lib.coarse_fit
    fit.argtypes = [I, I, I, I, P]
    fit.restype = I
    sms = cs._sms(torch.cuda.current_device())
    fits, plans = {}, []
    for tq in cs.TQS:
        out = (ctypes.c_int * 16)(*[-1] * 16)   # -1: a place not written
        if fit(d, w, cs._KINDS[kind], tq, ctypes.addressof(out)):
            raise RuntimeError("old coarse_fit failed")
        bq, bc, smem, per_sm = out[:4]
        if per_sm == 0:
            continue
        if out[4] != -1:
            fits[tq] = dict(bq=bq, bc=bc, smem_bytes=smem,
                            blocks_per_sm=per_sm, registers=out[4],
                            local_bytes=out[5], resident=bool(out[6]),
                            wide=out[7] == 1, cap=max(out[8], 0))
            continue
        tiles, qtiles = -(-kc // bc), -(-B // bq)
        s = min(tiles, max(1, sms * per_sm // max(qtiles, 1)))
        s = -(-tiles // -(-tiles // s))
        plans.append((tq, s, qtiles * s, dict(bq=bq, smem_bytes=smem,
                                               blocks_per_sm=per_sm)))
    if fits:
        p = cs.choose(B, d, kc, w, sms, fits)
        return p["tq"], p["splits"], fits[p["tq"]]
    tq, s, _, f = plans[0] if plans[0][2] >= sms else plans[-1]
    return tq, s, f


def inputs(B, kc, d, rotation, integer, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if integer:
        c = torch.randint(-2, 3, (kc, d), generator=g, device="cuda").float()
        q = torch.randint(-2, 3, (B, d), generator=g, device="cuda").float()
    else:
        c = torch.randn((kc, d), generator=g, device="cuda")
        pick = torch.randint(0, kc, (B,), generator=g, device="cuda")
        q = c[pick] + 0.3 * torch.randn((B, d), generator=g, device="cuda")
    rot = torch.linalg.qr(torch.randn((d, d), generator=g, device="cuda"))[0] \
        .contiguous() if rotation else torch.eye(d, device="cuda")
    return q.contiguous(), c.contiguous(), torch.sum(c * c, dim=1), rot


def runners(lib, kind, q, c, cn, rot, w, rotation):
    """(old, new, old plan): each runner a no-argument call returning the
    kernel's outputs."""
    B, d = q.shape
    kc = c.shape[0]
    fn = getattr(lib, OLD_FN[kind])
    fn.argtypes = OLD_ARGS[kind]
    fn.restype = ctypes.c_int
    hi, lo = cs.hi_lo_split(c, rot, rotation)
    tq, splits, ofit = old_plan(lib, B, d, kc, w, kind)
    part = torch.empty((B, splits, w, 2), dtype=torch.int32,
                       device="cuda") if splits > 1 else None
    tickets = torch.zeros(-(-B // (16 * tq)), dtype=torch.int32,
                          device="cuda") if splits > 1 else None
    plan = [tq, splits, cs._ptr(part), cs._ptr(tickets)]

    def outs():
        o = [torch.empty((B, w), device="cuda"),
             torch.empty((B, w), dtype=torch.int32, device="cuda")]
        if kind != "topw":
            o.append(torch.empty((B, w, d), dtype=torch.bfloat16,
                                 device="cuda"))
        if kind == "vbase":
            o.append(torch.empty((B, w), device="cuda"))
        return o

    def old():
        o = outs()
        if tickets is not None:
            tickets.zero_()
        stream = _build.stream_ptr(q.device)
        ptrs = [t.data_ptr() for t in o]
        if kind == "topw":
            err = fn(q.data_ptr(), c.data_ptr(), cn.data_ptr(), B, d, kc, w,
                     *plan, *ptrs, stream)
        elif kind == "vbase":
            err = fn(q.data_ptr(), c.data_ptr(), cn.data_ptr(),
                     rot.data_ptr(), B, d, kc, w, int(rotation), *plan,
                     *ptrs, stream)
        else:
            err = fn(q.data_ptr(), c.data_ptr(), cn.data_ptr(),
                     rot.data_ptr(), hi.data_ptr(), lo.data_ptr(), B, d, kc,
                     w, int(rotation), *plan, *ptrs, stream)
        if err:
            raise RuntimeError(f"old {OLD_FN[kind]} failed: error {err}")
        return o

    def new():
        if kind == "topw":
            # the wrapper's own outputs, before it adds ||q||^2 back
            vals = torch.empty((B, w), device="cuda")
            cells = torch.empty((B, w), dtype=torch.int32, device="cuda")
            tq, splits, part, tickets = cs._launch_args(
                B, d, kc, w, "topw", q.device)
            cs.TOPW_KERNEL(q.data_ptr(), c.data_ptr(), cn.data_ptr(), B, d,
                           kc, w, tq, splits, cs._ptr(part),
                           cs._ptr(tickets), vals.data_ptr(),
                           cells.data_ptr(), _build.stream_ptr(q.device))
            return [vals, cells]
        if kind == "vbase":
            return list(cs.coarse_vbase(q, c, cn, rot, w, rotation))
        return list(cs.coarse_vbase_v2(q, c, cn, rot, hi, lo, w, rotation))

    return old, new, plan[:2] + [ofit]


def cuda_ms(fn, reps: int) -> list:
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
    return times


def kernel_ms(fn, calls: int = 5, match: str = "coarse") -> float:
    """Device time of the kernels whose name holds `match` per call of fn
    (torch.profiler's CUDA trace), without the wrapper's host time and
    other operations."""
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
        if getattr(e, "device_type", None) == DeviceType.CUDA \
                and match in e.key:
            t = getattr(e, "self_device_time_total", None)
            us += t if t is not None else getattr(e, "self_cuda_time_total", 0)
    return us / 1e3 / calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shapes", default=",".join(s[0] for s in SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("coarse_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    wanted = set(args.shapes.split(","))
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = ctypes.CDLL(build_old(args.old_src, tmp))
        for name, kind, B, kc, d, w, rotation in SHAPES:
            if name not in wanted:
                continue
            row = {}
            for integer in (True, False):      # time on the random floats
                q, c, cn, rot = inputs(B, kc, d, rotation, integer,
                                       seed=B + kc + d)
                old, new, oplan = runners(lib, kind, q, c, cn, rot, w,
                                          rotation)
                a, b = old(), new()
                row["integer_equal" if integer else "equal"] = all(
                    torch.equal(x, y) for x, y in zip(a, b))
                del a, b
            t_old, t_new = [], []
            for first, second in ((old, new), (new, old)):
                for fn in (first, second):
                    (t_old if fn is old else t_new).extend(
                        cuda_ms(fn, args.reps))
            row.update(old_ms=statistics.median(t_old),
                       new_ms=statistics.median(t_new),
                       old_kernel_ms=kernel_ms(old),
                       new_kernel_ms=kernel_ms(new), B=B, kc=kc, d=d,
                       w=w, rotation=rotation, old_plan=oplan,
                       plan=cs.plan(B, d, kc, w, kind, q.device))
            res[name] = row
            del q, c, cn, rot
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "shapes": res}), flush=True)


if __name__ == "__main__":
    main()
