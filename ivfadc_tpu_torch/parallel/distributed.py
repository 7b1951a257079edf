"""Distributed index training: data-parallel k-means and the train step
(port of `ivfadc_tpu/parallel/distributed.py`).

Plain tensor code, as the JAX package's are XLA programs:

  * the Lloyd statistics run data-parallel: each position scans its slice
    of the points in blocks (the (block, k) distances, never the (n, k)
    ones), and sums its points per cluster; the per-position sums and
    counts are summed over the positions in position order
    (parallel/collectives.py): an exact Lloyd update whose bits do not
    depend on how the positions are spread over processes;
  * an empty cluster keeps its old centre (no re-seed, unlike the
    single-card `_lloyd_update`), as in the JAX package;
  * the seeding (k-means++, k-means|| past `_PP_MAX_K`) runs once, on
    position 0's device in the rank that owns it, on the port's own
    generator, and its centres are broadcast: every rank starts from the
    same centres whatever the world size.

Inputs are either a full (n, d) array (host or tensor; every rank of a
group passes the same one), which is padded to a multiple of the positions
and split over them, or a list of per-position tensors with their masks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ivfadc_tpu_torch.ops.kmeans import (_PP_MAX_K, _segment_sums,
                                         kmeans_parallel, kmeans_plus_plus,
                                         make_generator)
from ivfadc_tpu_torch.ops.metrics import Metric, SQEUCLIDEAN
from ivfadc_tpu_torch.parallel.collectives import Collectives
from ivfadc_tpu_torch.parallel.mesh import DATA_AXIS

# the random stream of the coarse seeding (models/index.py's
# _STREAM_COARSE): a distributed build seeds from the stream a single-card
# build of the same seed uses
_STREAM_COARSE = 0


def _argmin_blocks(x, centers, metric: Metric, block: int) -> torch.Tensor:
    """Nearest centre of each row (metric.pairwise + argmin), in row blocks
    so only a (block, k) distance matrix is ever live -> (n,) i64."""
    n = x.shape[0]
    block = max(1, min(block, n))
    outs = [torch.argmin(metric.pairwise(x[s:s + block], centers), dim=1)
            for s in range(0, n, block)]
    return torch.cat(outs) if outs else torch.zeros(
        0, dtype=torch.int64, device=x.device)


def _local_stats(x_local, mask_local, centers, metric: Metric,
                 block: int = 16384):
    """One position's Lloyd statistics: (assignments (nl,) i32, sums (k, d)
    f32, counts (k,) f32) over its rows with mask > 0. The distances run in
    blocks of `block` rows; the sums are a stable segment sum by cluster."""
    k = centers.shape[0]
    a = _argmin_blocks(x_local, centers, metric, block)
    valid = mask_local > 0
    sums, counts = _segment_sums(x_local[valid], a[valid], k)
    return a.to(torch.int32), sums, counts


def _split(col: Collectives, x, mask):
    """(parts, masks, rows a position, n) of a full input (padded to a
    multiple of the positions) or of given per-position parts."""
    if isinstance(x, (list, tuple)):
        nl = next(p for p in x if p is not None).shape[0]
        return list(x), list(mask), nl, None
    n = x.shape[0]
    nl = -(-n // len(col))
    pad = nl * len(col) - n
    xt = torch.as_tensor(np.asarray(x, np.float32)) \
        if isinstance(x, np.ndarray) else torch.as_tensor(x).to(torch.float32)
    xt = torch.nn.functional.pad(xt, (0, 0, 0, pad)) if pad else xt
    m = torch.ones(n, dtype=torch.float32) if mask is None else \
        torch.as_tensor(mask).to(torch.float32).cpu()
    m = torch.nn.functional.pad(m, (0, pad)) if pad else m
    return col.split(xt, nl), col.split(m, nl), nl, n


def _lloyd_step(col: Collectives, centers, parts, masks, metric: Metric):
    """One summed Lloyd step over the positions -> (centres on `home`,
    per-position assignments)."""
    stats = [None] * len(col)
    for i in col.local:
        stats[i] = _local_stats(parts[i], masks[i],
                                centers.to(col.devices[i]), metric)
    sums = col.sum([None if s is None else s[1] for s in stats])
    counts = col.sum([None if s is None else s[2] for s in stats])
    new = sums / torch.clamp_min(counts[:, None], 1.0)
    new = torch.where(counts[:, None] > 0.5, new, centers.to(col.home))
    return new, [None if s is None else s[0] for s in stats]


def distributed_kmeans_step(centers, x, mask=None, *, mesh, metric: Metric,
                            axes=(DATA_AXIS,)):
    """One exact Lloyd iteration with the points split over `axes`.
    Returns (new centres (k, d) on this process's first mesh device,
    assignments): the assignments (n,) i32 of a full input, or one tensor
    a position (None where not local) for per-position parts."""
    col = Collectives(mesh, axes)
    parts, masks, nl, n = _split(col, x, mask)
    centers = torch.as_tensor(centers).to(torch.float32)
    new, assigns = _lloyd_step(col, centers, parts, masks, metric)
    if n is None:
        return new, assigns
    return new, torch.cat(col.gather(assigns))[:n]


def distributed_kmeans(seed: int, x, k: int, mesh, *, maxiter: int = 25,
                       metric: Metric = SQEUCLIDEAN, mask=None,
                       n_valid: int = 0, axes=(DATA_AXIS,)
                       ) -> Tuple[torch.Tensor, list]:
    """Data-parallel Lloyd k-means over the mesh axes `axes`. `x` is a full
    (n, d) array (padded and split here) or per-position parts (pass their
    `mask` list and the true point count `n_valid`). Seeds on
    `sample_indices(0, n, max(16 k, 1024))`'s rows, then runs `maxiter`
    exact distributed iterations. Returns (centres (k, d) on this
    process's first mesh device, per-position assignments)."""
    from ivfadc_tpu_torch.utils.datasets import sample_indices
    col = Collectives(mesh, axes)
    parts, masks, nl, n = _split(col, x, mask)
    n = n if n is not None else (n_valid or nl * len(col))
    n_samp = min(n, max(k * 16, 1024))
    sel = sample_indices(0, n, n_samp)
    if isinstance(x, (list, tuple)):
        sample = col.take_rows(parts, sel, nl)
    else:
        sample = torch.as_tensor(np.asarray(x, np.float32)[sel]) \
            if isinstance(x, np.ndarray) else \
            torch.as_tensor(x)[torch.as_tensor(sel)].to(torch.float32)
    dev0 = col.devices[0]
    centers = None
    if 0 in col.local:
        sample = sample.to(dev0)
        gen = make_generator(seed, _STREAM_COARSE, dev0)
        if k > _PP_MAX_K:
            centers = kmeans_parallel(gen, sample, k, metric)
        else:
            centers = kmeans_plus_plus(gen, sample, k, metric)
    centers = col.broadcast(centers, 0)
    assigns = None
    for _ in range(maxiter):
        centers, assigns = _lloyd_step(col, centers, parts, masks, metric)
    return centers, assigns


def train_step(centers, codebooks, x, mask=None, *, mesh, metric: Metric,
               m: int):
    """One full distributed training step (the multi-chip dry run's):
    a summed Lloyd iteration over the data axis, the residuals against the
    new centres, and their PQ codes against the codebooks (m, k, dsub).
    Returns (new centres, assignments (n,) i32, codes (n, m) i32) for a
    full input, per-position lists for parts."""
    col = Collectives(mesh, (DATA_AXIS,))
    parts, masks, nl, n = _split(col, x, mask)
    centers = torch.as_tensor(centers).to(torch.float32)
    codebooks = torch.as_tensor(codebooks).to(torch.float32)
    new, assigns = _lloyd_step(col, centers, parts, masks, metric)
    codes = [None] * len(col)
    for i in col.local:
        dev = col.devices[i]
        c = new.to(dev)
        resid = parts[i] - c[assigns[i].to(torch.int64)]
        nl_i, d = resid.shape
        sub = resid.reshape(nl_i, m, d // m).permute(1, 0, 2)
        cb = codebooks.to(dev)
        codes[i] = torch.stack([
            torch.argmin(metric.pairwise(sub[j], cb[j]), dim=1)
            for j in range(m)], dim=1).to(torch.int32)
    if n is None:
        return new, assigns, codes
    return (new, torch.cat(col.gather(assigns))[:n],
            torch.cat(col.gather(codes))[:n])
