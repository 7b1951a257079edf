"""Batched k-means (port of `ivfadc_tpu/ops/kmeans.py`).

Plain tensor code, as in the JAX package (no kernel there either):
  * assignment = one distance matmul + argmin per block of points, so the
    (n, k) distance matrix is never materialized; under the euclidean
    metrics the block's matrix is `||c||^2 - 2 x c^T` straight out of the
    matmul and `||x||^2` joins the winners only;
  * centroid update = a segment sum over the points sorted by cell (stable
    sort, sums taken in sorted order), where the JAX package multiplies by
    a (block, k) one-hot: the one-hot costs as many operations again as
    the distances and, at k = 2^18, 1 GB a block, and is about half as fast
    on the card already at k = 1024 (`utils/lloyd_timing.py` times both). No
    scatter-add of floats (`index_add_`), which on a GPU sums in an order
    that changes from run to run;
  * k-means++ seeding = a loop of rank-1 distance updates + D^2 sampling;
    beyond `_PP_MAX_K` centers k-means|| (a few rounds, each drawing a
    batch of seeds at once);
  * D^2 sampling is Gumbel-max, `argmax(log w + gumbel)`: exact sampling
    proportional to w without a prefix sum (a float `cumsum` on a GPU is
    not reproducible from run to run);
  * empty clusters are re-seeded each iteration at far-away points.

Every function takes a leading subspace axis internally, so PQ training
runs its m subspace k-means as one batched program (the JAX package's
`vmap`); the 2-D entry points are the m = 1 case. Randomness comes from
explicit `torch.Generator`s — one per subspace, so the batched and the
sequential PQ layouts draw identical streams.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from ivfadc_tpu_torch.ops.metrics import Metric, SQEUCLIDEAN


class KMeansResult(NamedTuple):
    centers: torch.Tensor       # (k, d) float32
    assignments: torch.Tensor   # (n,) int32


# beyond this k, "k-means++" seeding runs as k-means|| (_kmeans_parallel)
_PP_MAX_K = 4096


def make_generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one named random stream of a build: distinct streams
    of one seed never share state."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) * 0x9E3779B1 + int(stream)) % (1 << 63))
    return g


def _pairwise(metric: Metric, x, y):
    """metric.pairwise over a leading batch axis: x (m, n, d), y (m, c, d)."""
    if metric.name in ("sqeuclidean", "euclidean"):
        xn = torch.sum(x * x, dim=-1, keepdim=True)
        yn = torch.sum(y * y, dim=-1)[:, None, :]
        return torch.clamp_min(xn + yn - 2.0 * torch.bmm(x, y.transpose(1, 2)),
                               0.0)
    return torch.stack([metric.pairwise(a, b) for a, b in zip(x, y)])


def _pad_blocks(x, block: int):
    """Zero-pad points (m, n, d) to a multiple of `block`; returns
    (blocks (m, nb, block, d), mask (nb, block))."""
    m, n, d = x.shape
    nb = -(-n // block)
    pad = nb * block - n
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    mask = torch.nn.functional.pad(
        torch.ones(n, dtype=torch.float32, device=x.device), (0, pad))
    return xp.reshape(m, nb, block, d), mask.reshape(nb, block)


def _d2_weights(mind):
    """D^2 sampling weights from min-distances (..., n), shifted by the
    (non-positive) minimum first so that metrics with negative "distances"
    keep their ordering."""
    return torch.clamp_min(
        mind - torch.clamp_max(mind.min(dim=-1, keepdim=True).values, 0.0),
        0.0)


def _gumbel_keys(gens: Sequence[torch.Generator], w):
    """Keys whose argmax (top-j) is a draw (j draws without replacement)
    proportional to the weights w (m, n): log w + Gumbel noise, one noise
    stream per subspace; zero-weight points get -inf."""
    u = torch.stack([torch.rand(w.shape[1], generator=g, device=w.device)
                     for g in gens])
    keys = torch.log(torch.clamp_min(w, 1e-30)) - torch.log(-torch.log(u))
    return torch.where(w > 0, keys, -float("inf"))


def _kmeans_plus_plus(gens: Sequence[torch.Generator], x, k: int,
                      metric: Metric):
    """k-means++ seeding of each subspace: x (m, n, d) -> (m, k, d)."""
    m, n, d = x.shape
    dev = x.device
    rows = torch.arange(m, device=dev)

    def uniform_idx():
        return torch.stack([torch.randint(0, n, (), generator=g, device=dev)
                            for g in gens])

    first = x[rows, uniform_idx()]                         # (m, d)
    centers = torch.zeros((m, k, d), dtype=torch.float32, device=dev)
    centers[:, 0] = first
    mind = _pairwise(metric, x, first[:, None, :])[:, :, 0]
    for j in range(1, k):
        w = _d2_weights(mind)
        idx = torch.argmax(_gumbel_keys(gens, w), dim=1)
        # degenerate guard: no residual mass left -> uniform pick
        idx = torch.where(torch.any(w > 0, dim=1), idx, uniform_idx())
        c = x[rows, idx]
        centers[:, j] = c
        mind = torch.minimum(mind, _pairwise(metric, x, c[:, None, :])[:, :, 0])
    return centers


def kmeans_plus_plus(gen: torch.Generator, x, k: int,
                     metric: Metric = SQEUCLIDEAN):
    """k-means++ seeding: (n, d) -> (k, d) float32 initial centers."""
    return _kmeans_plus_plus([gen], x.to(torch.float32)[None], k, metric)[0]


def _nearest(metric: Metric, xb, centers):
    """Nearest center of each point: xb (m, b, d), centers (m, k, d) ->
    (argmin (m, b) i64, first minimum; min distance (m, b) f32). Under the
    euclidean metrics the (b, k) matrix is written once, as ||c||^2 - 2 x.c
    out of the matmul, and ||x||^2 joins the winners only: the distances of
    `_pairwise` up to f32 rounding, for a fraction of the memory traffic."""
    if metric.name not in ("sqeuclidean", "euclidean"):
        dist = _pairwise(metric, xb, centers)               # (m, b, k)
        a = torch.argmin(dist, dim=2)
        return a, torch.gather(dist, 2, a[:, :, None])[:, :, 0]
    cn = torch.sum(centers * centers, dim=-1)[:, None, :]
    part = torch.baddbmm(cn, xb, centers.transpose(1, 2), alpha=-2.0)
    a = torch.argmin(part, dim=2)
    md = torch.gather(part, 2, a[:, :, None])[:, :, 0]
    return a, torch.clamp_min(md + torch.sum(xb * xb, dim=-1), 0.0)


def _kmeans_parallel(gen: torch.Generator, x, k: int, rounds: int, m_r: int,
                     block: int, metric: Metric):
    """k-means||-style seeding (after Bahmani et al., VLDB'12): `rounds`
    rounds each draw `m_r` seeds by D^2-weighted sampling WITHOUT
    replacement (Gumbel-top-m_r: one top-k per round, no sequential
    draws), and the running min-distance updates against each round's
    whole batch in blocked matmul passes. The k seeds are the pooled draws
    themselves. Already-chosen points have distance 0 => weight 0 => are
    never redrawn. x (n, d) f32 -> (k, d)."""
    n, d = x.shape
    dev = x.device
    first = x[torch.randint(0, n, (), generator=gen, device=dev)]
    mind = _pairwise(metric, x[None], first[None, None, :])[0, :, 0]
    cand = torch.zeros((1 + rounds * m_r, d), dtype=torch.float32, device=dev)
    cand[0] = first
    for j in range(rounds):
        keys = _gumbel_keys([gen], _d2_weights(mind)[None])[0]
        new_c = x[torch.topk(keys, m_r).indices]
        cand[1 + j * m_r:1 + (j + 1) * m_r] = new_c
        dmin = torch.cat([
            _nearest(metric, x[None, s:s + block], new_c[None])[1][0]
            for s in range(0, n, block)])
        mind = torch.minimum(mind, dmin)
    return cand[:k]


def kmeans_parallel(gen: torch.Generator, x, k: int,
                    metric: Metric = SQEUCLIDEAN, *, rounds: int = 16,
                    block: int = 16384):
    """k-means|| seeding: (n, d) -> (k, d) float32 seeds, each a data
    point. Cost: `rounds` blocked (n x k/rounds) matmul passes and one
    n-wide top-k per round."""
    n = x.shape[0]
    if n < k:
        raise AssertionError(
            f"k-means|| needs at least k={k} points to seed from, got {n}")
    rounds = max(1, min(rounds, k))
    m_r = min(-(-k // rounds), n)      # pool 1 + rounds*m_r >= k
    block = max(256, min(block, (1 << 28) // max(m_r, 1)))
    return _kmeans_parallel(gen, x.to(torch.float32), k, rounds, m_r, block,
                            metric)


def _segment_sums(x, assignments, k: int):
    """Per-cell sums of x (n, d) under assignments (n,) i64 -> (sums (k, d),
    counts (k,) f32): a stable sort by cell, then each cell's rows summed
    in sorted (= original) order. No float atomics, so the same inputs give
    the same bits in every run."""
    order = torch.argsort(assignments, stable=True)
    counts = torch.bincount(assignments, minlength=k)
    sums = torch.segment_reduce(x[order], "sum", lengths=counts, axis=0,
                                unsafe=True)
    return sums, counts.to(torch.float32)


def _assign_pass(x_blocks, mask, centers, metric: Metric,
                 with_sums: bool = True):
    """One streamed pass over (m, nb, block, d) points: per-point argmin/min
    plus the per-cell sums -> (assignments (m, nb, block) i64, mindists
    (m, nb, block) f32, sums (m, k, d) f32, counts (m, k) f32; sums and
    counts are None without `with_sums`). The sums are one sorted segment
    sum per subspace after the pass."""
    m, nb, block, d = x_blocks.shape
    k = centers.shape[1]
    assigns, mindists = [], []
    for b in range(nb):
        a, md = _nearest(metric, x_blocks[:, b], centers)
        # padded points are never picked as re-seed targets
        mindists.append(torch.where(mask[b][None, :] > 0, md, -float("inf")))
        assigns.append(a)
    assigns = torch.stack(assigns, 1)
    if not with_sums:
        return assigns, torch.stack(mindists, 1), None, None
    n = int(mask.sum().item())             # the padding follows the points
    flat_x, flat_a = x_blocks.reshape(m, -1, d), assigns.reshape(m, -1)
    per = [_segment_sums(flat_x[i, :n], flat_a[i, :n], k) for i in range(m)]
    return (assigns, torch.stack(mindists, 1),
            torch.stack([p[0] for p in per]),
            torch.stack([p[1] for p in per]))


def _lloyd_update(x_blocks, mask, flat_x, centers, metric: Metric):
    """One Lloyd iteration: assignment pass + mean update + empty reseed
    (each empty cluster takes a farthest point of some block, farthest
    blocks first)."""
    _, mindists, sums, counts = _assign_pass(x_blocks, mask, centers, metric)
    new_centers = sums / torch.clamp_min(counts[:, :, None], 1.0)
    empty = counts < 0.5                                    # (m, k)
    barg = torch.argmax(mindists, dim=2)                    # (m, nb)
    bfar = torch.gather(mindists, 2, barg[:, :, None])[:, :, 0]
    nb, block = mindists.shape[1], mindists.shape[2]
    order = torch.argsort(-bfar, dim=1, stable=True)        # farthest first
    cand_idx = torch.gather(barg, 1, order) + order * block
    slot = torch.cumsum(empty.to(torch.int64), dim=1) - 1   # rank among empties
    pick = torch.gather(cand_idx, 1, torch.clamp(slot, 0, nb - 1))
    reseed = flat_x[torch.arange(flat_x.shape[0],
                                 device=flat_x.device)[:, None], pick]
    new_centers = torch.where(empty[:, :, None], reseed, new_centers)
    # keep the old center when a cluster is empty AND there is no mass to
    # re-seed from (degenerate tiny inputs)
    any_mass = torch.isfinite(bfar.max(dim=1).values)[:, None, None]
    return torch.where(any_mass | ~empty[:, :, None], new_centers, centers)


def _lloyd(x, init_centers, maxiter: int, block: int, metric: Metric):
    """Deterministic Lloyd iterations over (m, n, d) points; all randomness
    lives in seeding. Returns (centers (m, k, d), assignments (m, n))."""
    m, n, d = x.shape
    x_blocks, mask = _pad_blocks(x, block)
    flat_x = x_blocks.reshape(m, -1, d)
    centers = init_centers
    for _ in range(maxiter):
        centers = _lloyd_update(x_blocks, mask, flat_x, centers, metric)
    assigns = _assign_pass(x_blocks, mask, centers, metric,
                           with_sums=False)[0]
    return centers, assigns.reshape(m, -1)[:, :n].to(torch.int32)


def kmeans(gen: torch.Generator, x, k: int, *, maxiter: int = 25,
           metric: Metric = SQEUCLIDEAN, block: int = 16384,
           pp_sample: int = 0) -> KMeansResult:
    """Lloyd k-means. `x` is (n, d); returns float32 centers + int32
    assignments. `pp_sample > 0` runs the k-means++ seeding on a uniform
    subsample of at most that many points (0 = all points); beyond
    _PP_MAX_K centers the seeding is k-means|| on at least min(n, 2k)
    points."""
    n, d = x.shape
    if k > n:
        raise AssertionError(f"k={k} must be <= number of points {n}")
    if not metric.trainable:
        raise ValueError(
            f"metric {metric.name!r} does not support k-means training")
    x = x.to(torch.float32)
    block = min(block, max(256, n))
    # the assignment step materializes (block, k) distances — cap their
    # footprint (~1 GB f32) for huge-k builds
    block = max(256, min(block, (1 << 28) // max(k, 1)))
    # k-means++ is a k-step sequential loop: fine to a few thousand centers;
    # past the cutoff seeding switches to k-means||, the same D^2-weighted
    # spread as a handful of batched rounds
    parallel = k > _PP_MAX_K
    xs = x
    if pp_sample and pp_sample < n:
        # k-means|| draws k DISTINCT seeds: the sample must hold
        # comfortably more than k points
        eff_sample = max(pp_sample, min(n, 2 * k)) if parallel else pp_sample
        if eff_sample < n:
            sel = torch.randperm(n, generator=gen,
                                 device=x.device)[:eff_sample]
            xs = x[sel]
    if parallel:
        init_centers = kmeans_parallel(gen, xs, k, metric, block=block)
    else:
        init_centers = kmeans_plus_plus(gen, xs, k, metric)
    centers, assigns = _lloyd(x[None], init_centers[None], maxiter, block,
                              metric)
    return KMeansResult(centers[0], assigns[0])


def kmeans_batched(gens: List[torch.Generator], x, k: int, *, maxiter: int,
                   metric: Metric, block: int):
    """k-means++ seeded Lloyd on each of the m subspaces of x (m, n, d) ->
    centers (m, k, d). The JAX package's vmapped `_kmeans_impl`."""
    init_centers = _kmeans_plus_plus(gens, x, k, metric)
    return _lloyd(x, init_centers, maxiter, block, metric)[0]


def assign(x, centers, *, metric: Metric = SQEUCLIDEAN,
           block: int = 16384) -> torch.Tensor:
    """Nearest-center assignment only -> (n,) int32."""
    k = centers.shape[0]
    block = max(256, min(block, (1 << 28) // max(k, 1)))
    out = []
    for s in range(0, x.shape[0], block):
        dist = _pairwise(metric, x[None, s:s + block].to(torch.float32),
                         centers[None].to(torch.float32))[0]
        out.append(torch.argmin(dist, dim=1).to(torch.int32))
    return torch.cat(out) if out else torch.empty(0, dtype=torch.int32,
                                                   device=x.device)
