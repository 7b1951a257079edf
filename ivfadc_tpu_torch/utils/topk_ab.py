"""Hold the top-k kernels against an earlier build of their source, in
results and in time, on one card.

    git show <commit>:ivfadc_tpu_torch/csrc/topk.cu > _archive/topk_old.cu
    python -m ivfadc_tpu_torch.utils.topk_ab --old-src _archive/topk_old.cu \
        [--shapes sift1m_merge,stage2_merge,...] [--out results.json]

The earlier source is compiled by nvcc into a temporary directory (beside
this tree's `csrc/common.cuh`) and called through the same C signatures
(`topk_payload`, `topk_index`). Both builds run on the same inputs at the
five shapes the search paths give the kernels (`SHAPES`), each in three
row sets:

  real        rows shaped like w probes' fold buffers, in ascending probe
              order (probe u's 128 lanes hold u + uniform(0, 1), 5 % of the
              lanes empty: +inf); stage 1 (group distances) uniform(0, 1)
  integer     integers 0..49 with zeros of both signs: ties everywhere, and
              the winners' sign bits must agree
  descending  every row in descending order, the worst case of a running
              threshold: every element enters the candidate buffer

Prints one JSON line: the card's name and power limit; the count of
16-byte global loads (LDG.E.128), all global loads (LDG), shared loads
and stores (LDS, STS), shuffles (SHFL), votes (VOTE) and block barriers
(BAR) in each build's SASS; and per shape
and row set whether the outputs are bit-equal (values as int32 bits,
indices or payloads), both builds' median milliseconds per call (CUDA
events, wrapper included) taken in turns (old, new, new, old), their
kernel device time per call (torch.profiler), the new build's launch shape
(`ops.topk.topk_fit`), and the bound (bytes: the values once, the k
winners' payloads, the (B, k) outputs; 3.35e12 B/s) with each build's
share of it.
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
from ivfadc_tpu_torch.ops import topk
from ivfadc_tpu_torch.utils.coarse_ab import build_old, cuda_ms, kernel_ms
from ivfadc_tpu_torch.utils.scan_ab import sass_counts

PEAK_BYTES = 3.35e12
SASS_OPS = ("LDG.E.128", "LDG", "LDS", "STS", "SHFL", "VOTE", "BAR")
# name: (payload kernel (4) or index kernel (6), B, N, k)
SHAPES = {"sift1m_merge": (True, 16384, 1024, 10),
          "stage2_merge": (True, 4096, 4096, 32),
          "final_merge": (False, 4096, 4096, 10),
          "stage1": (False, 4096, 512, 32),
          "b256": (False, 256, 1024, 10)}
ROW_SETS = ("real", "integer", "descending")


def inputs(name: str, rows: str, seed: int):
    """(x (B, N) f32, payload (B, N) i32) of one shape and row set."""
    _, B, N, _ = SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    if rows == "real":
        x = torch.rand((B, N), generator=g, device="cuda")
        if name != "stage1":
            x += torch.arange(N, device="cuda") // 128
            x[torch.rand((B, N), generator=g, device="cuda") < 0.05] = \
                float("inf")
    elif rows == "integer":
        x = torch.randint(0, 50, (B, N), generator=g, device="cuda").float()
        x[(x == 0) & (torch.rand((B, N), generator=g, device="cuda") < 0.5)] \
            = -0.0
    else:
        x = torch.arange(N, 0, -1, device="cuda").float().expand(B, N) \
            + torch.randint(0, 4, (B, 1), generator=g, device="cuda")
    p = torch.randint(0, 1 << 30, (B, N), generator=g, device="cuda",
                      dtype=torch.int32)
    return x.contiguous(), p


def runners(old_lib, payload: bool, x, p, k: int):
    """(old, new): no-argument calls returning (vals, idx or payloads)."""
    B, N = x.shape
    kern = topk.KERNEL if payload else topk.INDEX_KERNEL
    fn = getattr(old_lib, kern.fn)
    fn.argtypes = kern.argtypes
    fn.restype = ctypes.c_int

    def old():
        vals = torch.empty((B, k), device=x.device)
        out = torch.empty((B, k), dtype=torch.int32, device=x.device)
        ptrs = ((x.data_ptr(), p.data_ptr()) if payload else
                (x.data_ptr(),))
        err = fn(*ptrs, vals.data_ptr(), out.data_ptr(), B, N, k,
                 _build.stream_ptr(x.device))
        if err:
            raise RuntimeError(f"old {kern.fn} failed: error {err}")
        return vals, out

    def new():
        if payload:
            return topk.topk_lastdim_payload(x, p, k)
        return topk.topk_lastdim(x, k)
    return old, new


def bound(B: int, N: int, k: int, payload: bool) -> dict:
    nbytes = 4 * B * N + (4 * B * k if payload else 0) + 8 * B * k
    return dict(bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes",
                bound_bytes=nbytes)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("topk_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        old_path = build_old(args.old_src, tmp, "topk_old")
        sass = dict(old=sass_counts(old_path, SASS_OPS), new=sass_counts(
            os.path.join(_build.build_dir(), "libtopk.so"), SASS_OPS))
        old_lib = ctypes.CDLL(old_path)
        for name in [s for s in args.shapes.split(",") if s]:
            payload, B, N, k = SHAPES[name]
            for rows in ROW_SETS:
                x, p = inputs(name, rows, seed=B + N + k)
                old, new = runners(old_lib, payload, x, p, k)
                (ov, oo), (nv, no) = old(), new()
                row = dict(kernel=4 if payload else 6, B=B, N=N, k=k,
                           rows=rows,
                           bit_equal=torch.equal(ov.view(torch.int32),
                                                 nv.view(torch.int32))
                           and torch.equal(oo, no),
                           **bound(B, N, k, payload))
                t_old, t_new = [], []
                for first, second in ((old, new), (new, old)):
                    for fn in (first, second):
                        (t_old if fn is old else t_new).extend(
                            cuda_ms(fn, args.reps))
                row.update(old_ms=statistics.median(t_old),
                           new_ms=statistics.median(t_new),
                           old_device_ms=kernel_ms(old, match="topk"),
                           new_device_ms=kernel_ms(new, match="topk"),
                           new_launch=topk.topk_fit(B, N, k, payload))
                for b in ("old", "new"):
                    dms = row[f"{b}_device_ms"]
                    row[f"{b}_share_of_bound"] = \
                        row["bound_ms"] / dms if dms else None
                res[f"{name}/{rows}"] = row
                print(json.dumps({f"{name}/{rows}": row}), flush=True)
                del x, p, ov, oo, nv, no
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
