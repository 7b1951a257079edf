"""Closed loop of back-to-back batches through `search_padded`.

Traffic keys: `batch` (queries a call), `pool` (= batch: the query set),
`k`, `w`, `keep_per_search` (answers a call kept for the comparison,
rows drawn from the seed). Every call ends in the numpy results, so the
device-to-host copy is inside the window.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from annbench.datagen import STREAM_SAMPLE, sub_seed
from annbench.window import Window


def _queries(ctx):
    return ctx.queries[:ctx.traffic["batch"]]


def warm(ctx) -> None:
    t = ctx.traffic
    for _ in range(3):
        ctx.index.search_padded(_queries(ctx), t["k"], t["w"])


def run(ctx, seconds: float, span=contextlib.nullcontext) -> Window:
    t = ctx.traffic
    q, k, w, B = _queries(ctx), t["k"], t["w"], t["batch"]
    rng = np.random.default_rng(sub_seed(ctx.seed, STREAM_SAMPLE))
    plan = rng.integers(0, B, size=(4096, t["keep_per_search"]))
    answers = []
    n = 0
    t0 = time.perf_counter()
    while True:
        with span():
            ids, dists = ctx.index.search_padded(q, k, w)
        for r in plan[n % len(plan)]:
            answers.append((int(r), ids[r].copy(), dists[r].copy()))
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    return Window(attempted=n * B, failed=0, completed=n * B,
                  elapsed_s=elapsed, searches=n, answers=answers,
                  sent=[(np.arange(B), n)])
