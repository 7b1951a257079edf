"""The reference's own training, and the quality of trained tables.

Plain k-means in float64: k-means++ seeding on a uniform sample drawn by
the reference's own generator, then Lloyd iterations over every point,
an empty cluster keeping its center. It trains the coarse centroids on
the base points and the PQ codebooks on each subspace of the residuals
to them, at the iteration counts and the seeding sample the
configuration states. It imports nothing of the program and takes
nothing it made: it is the yardstick of the one stage the rest of the
reference follows from the program's tables (`compare.train_numbers`).
"""

from __future__ import annotations

from typing import Dict

import torch

from annbench.reference.ivfadc import Trained


def _block(m: int, k: int) -> int:
    """Points a distance block, (m, block, k) float64 at most ~1 GB."""
    return max(1024, (1 << 27) // max(1, m * k))


def nearest(x: torch.Tensor, c: torch.Tensor):
    """x (m, n, d), c (m, k, d) float64 -> (index (m, n) int64, squared
    distance (m, n) float64) of each point's nearest center."""
    m, n, _ = x.shape
    cn = (c * c).sum(2)
    idx = torch.empty((m, n), dtype=torch.int64, device=x.device)
    dist = torch.empty((m, n), dtype=torch.float64, device=x.device)
    step = _block(m, c.shape[1])
    for s in range(0, n, step):
        xb = x[:, s:s + step]
        dd = ((xb * xb).sum(2)[:, :, None] - 2.0 * torch.bmm(
            xb, c.transpose(1, 2)) + cn[:, None, :]).clamp_min(0)
        dist[:, s:s + step], idx[:, s:s + step] = dd.min(2)
    return idx, dist


def means(x: torch.Tensor, idx: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """Lloyd's update: each center the mean of its points; an empty
    cluster keeps its center."""
    m, k, d = c.shape
    flat = (idx + k * torch.arange(m, device=x.device)[:, None]).reshape(-1)
    sums = torch.zeros((m * k, d), dtype=torch.float64, device=x.device)
    sums.index_add_(0, flat, x.reshape(-1, d))
    counts = torch.bincount(flat, minlength=m * k).to(torch.float64)
    new = (sums / counts.clamp_min(1)[:, None]).reshape(m, k, d)
    return torch.where((counts > 0).reshape(m, k, 1), new, c)


def seed_pp(x: torch.Tensor, k: int, sample: int,
            gen: torch.Generator) -> torch.Tensor:
    """k-means++ seeds (m, k, d) of each of x's m point sets, drawn from a
    uniform sample of at most `sample` points (0: every point)."""
    m, n, d = x.shape
    if sample and sample < n:
        pick = torch.randperm(n, generator=gen, device=x.device)[:sample]
        x = x[:, pick]
        n = sample
    rows = torch.arange(m, device=x.device)
    first = torch.randint(0, n, (m,), generator=gen, device=x.device)
    c = torch.empty((m, k, d), dtype=torch.float64, device=x.device)
    c[:, 0] = x[rows, first]
    mind = ((x - c[:, :1]) ** 2).sum(2)
    for j in range(1, k):
        nxt = torch.multinomial(mind + 1e-300, 1, generator=gen)[:, 0]
        c[:, j] = x[rows, nxt]
        mind = torch.minimum(mind, ((x - c[:, j:j + 1]) ** 2).sum(2))
    return c


def kmeans(x: torch.Tensor, k: int, iters: int, sample: int,
           gen: torch.Generator) -> torch.Tensor:
    """Centers (m, k, d) of `iters` Lloyd iterations from k-means++
    seeds."""
    c = seed_pp(x, k, sample, gen)
    for _ in range(iters):
        c = means(x, nearest(x, c)[0], c)
    return c


def subspaces(r: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) -> (m, n, dsub), zero-padding d up to a multiple of m."""
    n, d = r.shape
    dsub = -(-d // m)
    if dsub * m != d:
        r = torch.nn.functional.pad(r, (0, dsub * m - d))
    return r.reshape(n, m, dsub).permute(1, 0, 2).contiguous()


def train(x: torch.Tensor, index: dict, gen: torch.Generator,
          coarse_iters: int = None, pq_iters: int = None) -> Trained:
    """The reference's centroids and codebooks for base points x (n, d)
    under the configuration's index settings (`kc`, `m`, `k`,
    `coarse_maxiter`, `quantization_maxiter`, `kmeanspp_sample`); the
    iteration counts can be overridden (the training faults)."""
    x64 = x.double()[None]
    ci = index["coarse_maxiter"] if coarse_iters is None else coarse_iters
    qi = index["quantization_maxiter"] if pq_iters is None else pq_iters
    sample = index.get("kmeanspp_sample", 0)
    cen = kmeans(x64, index["kc"], ci, sample, gen)
    a = nearest(x64, cen)[0][0]
    r = subspaces(x64[0] - cen[0][a], index["m"])
    del x64
    cb = kmeans(r, index["k"], qi, sample, gen)
    return Trained(cen[0].float(), cb.float())


def quality(x: torch.Tensor, trained: Trained) -> Dict[str, float]:
    """Float64 sums over every point of tables' errors: `J`, the squared
    distance to the nearest centroid (the k-means objective); `E`, the
    squared error of the residual to it coded by the nearest codewords
    (the PQ distortion); `J1` and `E1`, the same after one more Lloyd
    update of the centroids and of the codebooks."""
    x64 = x.double()[None]
    cen = trained.centroids.double()[None]
    a, dist = nearest(x64, cen)
    J = float(dist.sum())
    J1 = float(nearest(x64, means(x64, a, cen))[1].sum())
    cb = trained.codebooks.double()
    r = subspaces(x64[0] - cen[0][a[0]], cb.shape[0])
    del x64, a, dist
    codes, err = nearest(r, cb)
    E = float(err.sum())
    E1 = float(nearest(r, means(r, codes, cb))[1].sum())
    return dict(J=J, J1=J1, E=E, E1=E1)
