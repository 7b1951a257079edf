"""Closed loop of back-to-back batches through `search_padded`, with the
index mutated between searches.

Traffic keys: the batch driver's (`batch`, `pool`, `k`, `w`,
`keep_per_search`), and `push` (points a `push_batch`), `delete` (ids a
`delete`) and `every_s` (the period, in window seconds). Whenever a
period has passed since the window began, one `push_batch` and then one
`delete` go between two searches; a period that passed during a search
is not made up. Pair j pushes points j*push .. of the run's pushed stream
(`datagen.pushed`, made before the window and handed over from the
host, as a user's new vectors come) and deletes `delete` ids drawn from
(seed, j), uniformly over the index's live positions. Each call returns
before the next search is sent, so its time lies inside the window, and
`qps` counts the queries answered over all of it. Every mutation goes
into `ctx.mutations` (the warm-up's pair first) and the window's log.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np

from annbench import datagen, trace
from annbench.drivers import batch
from annbench.window import Window


def _points(ctx, j: int) -> np.ndarray:
    """Pair j's pushed points, on the host."""
    p = ctx.traffic["push"]
    return datagen.pushed(ctx.data, ctx.seed, j * p, p,
                          ctx.queries.device).cpu().numpy()


def _pair(ctx, points: np.ndarray, span) -> None:
    """One push_batch, then one delete, each logged once it returns."""
    t = ctx.traffic
    j = sum(m[0] == "push" for m in ctx.mutations)
    with span(trace.MUTATE_SPAN):
        ctx.index.push_batch(points)
    ctx.mutations.append(("push", j * t["push"], len(points)))
    rng = np.random.default_rng(
        datagen.sub_seed(ctx.seed, datagen.STREAM_DELETE, j))
    ids = rng.choice(len(ctx.index), t["delete"], replace=False)
    with span(trace.MUTATE_SPAN):
        ctx.index.delete(ids)
    ctx.mutations.append(("delete", ids))


def warm(ctx) -> None:
    """The batch driver's searches, one pair, and those searches again:
    the searches after a mutation (view patches, a graph captured again)
    run once before the window."""
    batch.warm(ctx)
    _pair(ctx, _points(ctx, 0), contextlib.nullcontext)
    batch.warm(ctx)


def run(ctx, seconds: float, span=contextlib.nullcontext) -> Window:
    t = ctx.traffic
    q, k, w, B = batch._queries(ctx), t["k"], t["w"], t["batch"]
    every = t["every_s"]
    rng = np.random.default_rng(
        datagen.sub_seed(ctx.seed, datagen.STREAM_SAMPLE))
    plan = rng.integers(0, B, size=(4096, t["keep_per_search"]))
    # at most one pair a period, the first a period in, and none once a
    # search has ended past `seconds`: ceil(seconds / every) + 1 pairs
    # bound them
    j0 = sum(m[0] == "push" for m in ctx.mutations)
    ready = [_points(ctx, j0 + i)
             for i in range(math.ceil(seconds / every) + 1)]
    answers, sent = [], []
    n = pairs = 0
    due = every
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= due:
            _pair(ctx, ready[pairs], span)
            pairs += 1
            due = (math.floor(now / every) + 1) * every
        version = len(ctx.mutations)
        with span():
            ids, dists = ctx.index.search_padded(q, k, w)
        for r in plan[n % len(plan)]:
            answers.append((int(r), ids[r].copy(), dists[r].copy(),
                            version))
        if sent and sent[-1][2] == version:
            sent[-1] = (sent[-1][0], sent[-1][1] + 1, version)
        else:
            sent.append((np.arange(B), 1, version))
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    return Window(attempted=n * B, failed=0, completed=n * B,
                  elapsed_s=elapsed, searches=n, answers=answers,
                  sent=sent, mutations=list(ctx.mutations))
