"""Hold the cell-rank kernel and the tile prep it carries against an earlier
build of `csrc/cell_rank.cu` and the torch prep of that time, in results
and in time, on one card.

    git show 96fdf83:ivfadc_tpu_torch/csrc/cell_rank.cu > _archive/rank_old.cu
    python -m ivfadc_tpu_torch.utils.rank_ab --old-src _archive/rank_old.cu \
        [--shapes sift1m,stage2,...] [--out results.json]

The earlier source (three launches a call behind the C signature
`cell_ranks(cells, P, kc, ranks, counts, scratch, stream)`, `cell_ranks_v2`
alike) is compiled by nvcc into a temporary directory beside this tree's
`csrc/common.cuh`; with `--old-abi fused` the other source is a variant of
this tree's (same C interface, a design choice flipped, to measure it). At each shape of `SHAPES` (skewed cells: 30 % in five
hot cells, cell 1 empty; both engines) two pairs run on the same inputs:

  ranks   the earlier kernel's call (its wrapper's allocations included)
          against `cell_rank.cell_ranks`: ranks and counts
  prep    the earlier kernel plus the earlier torch tile map and `row` /
          `inv_row` lines (int64), as `ops/dense_scan.py::_tile_slots` ran
          them, against the fused `cell_rank.tile_slots`: counts, c_t,
          tile_start, tile_size, row and inv_row

Each pair is run twice; the line says whether both builds' outputs are
bit-equal to each other and from call to call. Times: median
milliseconds per call by CUDA events (host time included), taken in turns
(old, new, new, old); the device time per call of every operation the call
launches and their count (torch.profiler); and the device time of the
rank kernels alone. Prints one JSON line per pair and a last line with the
card's name and power limit and every pair.
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
from ivfadc_tpu_torch.ops import cell_rank
from ivfadc_tpu_torch.utils.coarse_ab import build_old, cuda_ms

PEAK_BYTES = 3.35e12
# name: (P probes, kc cells, pb slots a tile)
SHAPES = {"sift1m": (131072, 1024, 16),       # B = 16384, w = 8
          "stage2": (131072, 512, 64),        # large-kc stage 2, g = 512
          "kc4096": (5000, 4096, 64),
          "kc1": (3000, 1, 8),
          "p1m": (1048576, 4096, 64)}         # B = 32768, w = 32
_OLD_BLK = 1024


def inputs(P: int, kc: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    hot = torch.randint(0, min(kc, 5), (P,), generator=g, device="cuda")
    cells = torch.where(torch.rand(P, generator=g, device="cuda") < 0.3, hot,
                        torch.randint(0, kc, (P,), generator=g,
                                      device="cuda"))
    if kc > 1:
        cells[cells == 1] = 0
    sizes = torch.randint(0, 400, (kc,), generator=g, device="cuda")
    offsets = torch.cumsum(sizes + 7, 0) - sizes - 7
    return (cells.to(torch.int32), offsets.to(torch.int32),
            sizes.to(torch.int32))


def fused_runners(lib, engine: str, cells, offsets, sizes, kc: int,
                  pb: int):
    """(ranks, prep) of another build of this tree's C interface (a
    variant of `csrc/cell_rank.cu`), with its own launch shape and
    scratch."""
    kern = cell_rank.KERNELS[engine]
    fn = getattr(lib, kern.fn)
    fn.argtypes = kern.argtypes
    fn.restype = ctypes.c_int
    fit_fn = lib.cell_rank_fit
    fit_fn.argtypes = cell_rank.FIT.argtypes
    fit_fn.restype = ctypes.c_int
    dev, P = cells.device, cells.numel()
    T_max = cell_rank.t_max(P, kc, pb)
    plans = {}
    for tiles in (False, True):
        out = (ctypes.c_int * 6)()
        if fit_fn(kc, int(tiles), out):
            raise RuntimeError("old cell_rank_fit failed")
        plans[tiles] = (out[2], torch.zeros(4 + out[2] * kc,
                                            dtype=torch.int32, device=dev))

    def call(tiles: bool):
        i32 = dict(dtype=torch.int32, device=dev)
        counts = torch.empty(kc, **i32)
        max_grid, scratch = plans[tiles]
        if not tiles:
            ranks = torch.empty(P, **i32)
            err = fn(cells.data_ptr(), P, kc, ranks.data_ptr(),
                     counts.data_ptr(), None, None, 0, 0, None, None, None,
                     None, None, scratch.data_ptr(), max_grid,
                     _build.stream_ptr(dev))
            outs = (ranks, counts)
        else:
            i64 = dict(dtype=torch.int64, device=dev)
            outs = (counts, torch.empty(T_max, **i32),
                    torch.empty(T_max, **i32), torch.empty(T_max, **i32),
                    torch.empty(P, **i64), torch.empty(T_max * pb, **i64))
            err = fn(cells.data_ptr(), P, kc, None, counts.data_ptr(),
                     offsets.data_ptr(), sizes.data_ptr(), pb, T_max,
                     *(o.data_ptr() for o in outs[1:]), scratch.data_ptr(),
                     max_grid, _build.stream_ptr(dev))
        if err:
            raise RuntimeError(f"old {kern.fn} failed: error {err}")
        return outs
    return (lambda: call(False)), (lambda: call(True))


def old_runners(lib, engine: str, cells, offsets, sizes, kc: int, pb: int):
    """(ranks, prep): the earlier kernel's wrapper and the earlier prep."""
    fn = getattr(lib, cell_rank.KERNELS[engine].fn)
    fn.argtypes = [_build.P, _build.I, _build.I] + [_build.P] * 4
    fn.restype = ctypes.c_int

    def ranks():
        c = cells.to(torch.int32).contiguous()
        P, dev = c.shape[0], c.device
        r = torch.empty(P, dtype=torch.int32, device=dev)
        n = torch.empty(kc, dtype=torch.int32, device=dev)
        scratch = torch.empty(max(1, -(-P // _OLD_BLK)) * kc,
                              dtype=torch.int32, device=dev)
        err = fn(c.data_ptr(), P, kc, r.data_ptr(), n.data_ptr(),
                 scratch.data_ptr(), _build.stream_ptr(dev))
        if err:
            raise RuntimeError(f"old {fn.__name__} failed: error {err}")
        return r, n

    def prep():
        P = cells.numel()
        T_max = P // pb + min(kc, P) + 1
        dev = cells.device
        cells_flat = cells.reshape(-1).to(torch.int32)
        r, counts = ranks()
        nt = (counts.to(torch.int64) + pb - 1) // pb
        tile_base = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                               torch.cumsum(nt, 0)[:-1]])
        trange = torch.arange(T_max, dtype=torch.int64, device=dev)
        c_t = torch.clamp(
            torch.searchsorted(tile_base, trange, right=True) - 1, 0, kc - 1)
        tile_valid = trange < torch.sum(nt)
        tile_start = torch.where(tile_valid, offsets.to(torch.int64)[c_t], 0)
        tile_size = torch.where(tile_valid, sizes.to(torch.int64)[c_t], 0)
        r = r.to(torch.int64)
        row = (tile_base[cells_flat.to(torch.int64)] + r // pb) * pb \
            + r % pb
        inv_row = torch.full((T_max * pb,), P, dtype=torch.int64, device=dev)
        inv_row[row] = torch.arange(P, dtype=torch.int64, device=dev)
        return (counts, c_t.to(torch.int32), tile_start.to(torch.int32),
                tile_size.to(torch.int32), row, inv_row)
    return ranks, prep


def profile_call(fn, calls: int = 10) -> dict:
    """Device time per call of all operations fn launches, of the rank
    kernels alone, and the operations' count per call (torch.profiler).
    The trace at times drops kernel events, so it is taken up to five
    times, until the operations it holds are a whole number per call."""
    for _ in range(5):
        res = _profile_once(fn, calls)
        if res["device_ops"] >= 1 and res["device_ops"] == int(
                res["device_ops"]):
            break
    return res


def _profile_once(fn, calls: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = rank_us = 0.0
    ops = 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = t if t is not None else getattr(e, "self_cuda_time_total", 0.0)
        us += t
        ops += e.count
        if "rank" in e.key:
            rank_us += t
    return dict(device_ms=us / 1e3 / calls, rank_kernel_ms=rank_us / 1e3 /
                calls, device_ops=ops / calls)


def same(a, b) -> bool:
    return all(torch.equal(x.to(torch.int64), y.to(torch.int64))
               for x, y in zip(a, b))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", required=True)
    ap.add_argument("--old-abi", choices=("three-launch", "fused"),
                    default="three-launch",
                    help="three-launch: the earlier kernel and the torch prep "
                         "(96fdf83); fused: a variant of this tree's source")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rank_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        old_lib = ctypes.CDLL(build_old(args.old_src, tmp, "cell_rank_old"))
        for name in [s for s in args.shapes.split(",") if s]:
            P, kc, pb = SHAPES[name]
            cells, offsets, sizes = inputs(P, kc, seed=P + kc + pb)
            for engine in ("v1", "v2"):
                runners = (old_runners if args.old_abi == "three-launch"
                           else fused_runners)
                o_ranks, o_prep = runners(old_lib, engine, cells, offsets,
                                          sizes, kc, pb)
                pairs = {
                    "ranks": (o_ranks, lambda: cell_rank.cell_ranks(
                        cells, kc=kc, engine=engine)),
                    "prep": (o_prep, lambda: cell_rank.tile_slots(
                        cells, offsets, sizes, kc=kc, pb=pb,
                        engine=engine))}
                for mode, (old, new) in pairs.items():
                    o1, n1, n2, o2 = old(), new(), new(), old()
                    # ranks: cells in, ranks and counts out; prep: also
                    # offsets and sizes in, the tile arrays and the int64
                    # row / inv_row out
                    T = cell_rank.t_max(P, kc, pb)
                    nbytes = 4 * P + 4 * kc + (
                        4 * P if mode == "ranks" else
                        8 * kc + 12 * T + 8 * P + 8 * T * pb)
                    row = dict(P=P, kc=kc, pb=pb, engine=engine, mode=mode,
                               bit_equal=same(o1, n1) and same(n1, n2)
                               and same(o1, o2),
                               bound_ms=1e3 * nbytes / PEAK_BYTES,
                               bound_by="bytes")
                    t_old, t_new = [], []
                    for first, second in ((old, new), (new, old)):
                        for fn in (first, second):
                            (t_old if fn is old else t_new).extend(
                                cuda_ms(fn, args.reps))
                    row.update(old_ms=statistics.median(t_old),
                               new_ms=statistics.median(t_new))
                    for b, fn in (("old", old), ("new", new)):
                        for k, v in profile_call(fn).items():
                            row[f"{b}_{k}"] = v
                    row["new_launch"] = cell_rank.rank_fit(
                        cells.device, kc, mode == "prep")
                    key = f"{name}/{engine}/{mode}"
                    res[key] = row
                    print(json.dumps({key: row}), flush=True)
            del cells, offsets, sizes
            torch.cuda.empty_cache()
    line = json.dumps({"card": card, "shapes": res})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
