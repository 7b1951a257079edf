"""Time Lloyd's assignment pass against the one-hot formulation it replaced.

    python -m ivfadc_tpu_torch.utils.lloyd_timing [--n 1000000] [--reps 5]

`ops.kmeans._assign_pass` folds `||c||^2` into the distance matmul and takes
the per-cell sums by a sorted segment sum. The JAX package's formulation,
kept here as `one_hot_pass` for the comparison only, is the full
`||x||^2 + ||c||^2 - 2 x c^T` matrix per block and a (block, k) one-hot
matmul. Both run at the two k-means shapes of a SIFT1M-shape build: the
coarse quantizer (one problem, d=128, k=1024) and PQ training (m=8
problems, d=16, k=256). Prints one JSON line: the card's name and power
limit, the median milliseconds of a pass either way, and how many points
the two passes put into different cells (a lower bound, from the cells'
sizes).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from ivfadc_tpu_torch.ops import kmeans as km
from ivfadc_tpu_torch.ops.metrics import SQEUCLIDEAN

SHAPES = {"coarse": (1, 128, 1024), "pq": (8, 16, 256)}


def one_hot_pass(x_blocks, mask, centers):
    """Sums and counts of one assignment pass, one-hot matmul per block."""
    m, nb, _, d = x_blocks.shape
    k = centers.shape[1]
    sums = torch.zeros((m, k, d), device=centers.device)
    counts = torch.zeros((m, k), device=centers.device)
    for b in range(nb):
        xb = x_blocks[:, b]
        a = torch.argmin(km._pairwise(SQEUCLIDEAN, xb, centers), dim=2)
        onehot = torch.nn.functional.one_hot(a, k).to(torch.float32) \
            * mask[b][None, :, None]
        sums = sums + torch.bmm(onehot.transpose(1, 2), xb)
        counts = counts + torch.sum(onehot, dim=1)
    return sums, counts


def median_ms(fn, reps: int, cuda: bool) -> float:
    times = []
    for _ in range(reps + 1):                  # first: warm-up
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    card = None
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    out = dict(card=card, n=args.n, reps=args.reps)
    for name, (m, d, k) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((m, args.n, d), generator=g, device=dev)
        centers = x[:, :k].clone()
        x_blocks, mask = km._pad_blocks(x, 16384)
        # the two distance formulations round differently: points within
        # an ulp of two centers may change cell, so compare the cell sizes
        seg = km._assign_pass(x_blocks, mask, centers, SQEUCLIDEAN)
        hot = one_hot_pass(x_blocks, mask, centers)
        out[f"{name}_points_in_other_cells"] = \
            0.5 * (seg[3] - hot[1]).abs().sum().item()
        out[f"{name}_segment_ms"] = median_ms(
            lambda: km._assign_pass(x_blocks, mask, centers, SQEUCLIDEAN),
            args.reps, cuda)
        out[f"{name}_one_hot_ms"] = median_ms(
            lambda: one_hot_pass(x_blocks, mask, centers), args.reps, cuda)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
