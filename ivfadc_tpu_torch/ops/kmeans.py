"""Batched k-means (port of `ivfadc_tpu/ops/kmeans.py`).

Plain tensor code, as in the JAX package (no kernel there either):
  * assignment = one `||x||^2 + ||c||^2 - 2 x c^T` matmul + argmin per block
    of points, so the (n, k) distance matrix is never materialized;
  * centroid update = one-hot matmul (block, k)^T @ (block, d) — on a GPU
    this also keeps builds deterministic, where a scatter-add of floats
    (`index_add_`) would sum in an order that changes from run to run;
  * k-means++ seeding = a loop of rank-1 distance updates + D^2 sampling;
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


# beyond this k, the JAX package seeds with k-means|| (not ported yet)
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


def _kmeans_plus_plus(gens: Sequence[torch.Generator], x, k: int,
                      metric: Metric):
    """k-means++ seeding of each subspace: x (m, n, d) -> (m, k, d)."""
    m, n, d = x.shape
    dev = x.device
    rows = torch.arange(m, device=dev)

    def uniform_idx():
        return torch.stack([torch.randint(0, n, (), generator=g, device=dev)
                            for g in gens])

    def uniform():
        return torch.stack([torch.rand((), generator=g, device=dev)
                            for g in gens])

    first = x[rows, uniform_idx()]                         # (m, d)
    centers = torch.zeros((m, k, d), dtype=torch.float32, device=dev)
    centers[:, 0] = first
    mind = _pairwise(metric, x, first[:, None, :])[:, :, 0]
    for j in range(1, k):
        # D^2 weights, shifted by the (non-positive) minimum first so that
        # metrics with negative "distances" keep their ordering
        w = torch.clamp_min(
            mind - torch.clamp_max(mind.min(dim=1, keepdim=True).values, 0.0),
            0.0)
        cum = torch.cumsum(w, dim=1)
        total = cum[:, -1]
        u = uniform() * torch.clamp_min(total, 1e-30)
        idx = torch.searchsorted(cum, u[:, None]).reshape(m)
        idx = torch.clamp(idx, 0, n - 1)
        # degenerate guard: no residual mass left -> uniform pick
        idx = torch.where(total > 0, idx, uniform_idx())
        c = x[rows, idx]
        centers[:, j] = c
        mind = torch.minimum(mind, _pairwise(metric, x, c[:, None, :])[:, :, 0])
    return centers


def kmeans_plus_plus(gen: torch.Generator, x, k: int,
                     metric: Metric = SQEUCLIDEAN):
    """k-means++ seeding: (n, d) -> (k, d) float32 initial centers."""
    return _kmeans_plus_plus([gen], x.to(torch.float32)[None], k, metric)[0]


def _assign_pass(x_blocks, mask, centers, metric: Metric):
    """One streamed pass over (m, nb, block, d) points: per-point argmin/min
    plus accumulated one-hot sums -> (assignments (m, nb, block) i64,
    mindists (m, nb, block) f32, sums (m, k, d) f32, counts (m, k) f32)."""
    m, nb, block, d = x_blocks.shape
    k = centers.shape[1]
    sums = torch.zeros((m, k, d), dtype=torch.float32, device=centers.device)
    counts = torch.zeros((m, k), dtype=torch.float32, device=centers.device)
    assigns, mindists = [], []
    for b in range(nb):
        xb = x_blocks[:, b]
        dist = _pairwise(metric, xb, centers)               # (m, block, k)
        a = torch.argmin(dist, dim=2)                       # first minimum
        md = torch.gather(dist, 2, a[:, :, None])[:, :, 0]
        onehot = torch.nn.functional.one_hot(a, k).to(torch.float32) \
            * mask[b][None, :, None]
        sums = sums + torch.bmm(onehot.transpose(1, 2), xb)
        counts = counts + torch.sum(onehot, dim=1)
        # padded points are never picked as re-seed targets
        mindists.append(torch.where(mask[b][None, :] > 0, md, -float("inf")))
        assigns.append(a)
    return torch.stack(assigns, 1), torch.stack(mindists, 1), sums, counts


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
    assigns, _, _, _ = _assign_pass(x_blocks, mask, centers, metric)
    return centers, assigns.reshape(m, -1)[:, :n].to(torch.int32)


def kmeans(gen: torch.Generator, x, k: int, *, maxiter: int = 25,
           metric: Metric = SQEUCLIDEAN, block: int = 16384,
           pp_sample: int = 0) -> KMeansResult:
    """Lloyd k-means. `x` is (n, d); returns float32 centers + int32
    assignments. `pp_sample > 0` runs the k-means++ seeding on a uniform
    subsample of at most that many points (0 = all points)."""
    n, d = x.shape
    if k > n:
        raise AssertionError(f"k={k} must be <= number of points {n}")
    if not metric.trainable:
        raise ValueError(
            f"metric {metric.name!r} does not support k-means training")
    x = x.to(torch.float32)
    block = min(block, max(256, n))
    # the assignment step materializes (block, k) distances and a (block, k)
    # one-hot — cap their footprint (~1 GB f32) for huge-k builds
    block = max(256, min(block, (1 << 28) // max(k, 1)))
    if k > _PP_MAX_K:
        raise NotImplementedError(
            f"k={k} > {_PP_MAX_K} seeds with k-means||, which is not "
            f"ported yet (ROADMAP A.7)")
    xs = x
    if pp_sample and pp_sample < n:
        sel = torch.randperm(n, generator=gen, device=x.device)[:pp_sample]
        xs = x[sel]
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
