"""The plain reference of an IVFADC index: assignment, encoding, probe,
scan and merge in plain PyTorch.

It follows the published algorithm (Jegou, Douze and Schmid, TPAMI 2011)
with the IVFADC.jl estimator the configurations state: a posting x in
cell c scores ||q - c||^2 + sum_j ||(q - c)_j - codebook_j[code_j(x)]||^2.
It imports nothing of the program. It follows the program step by step
from the program's trained tables (`Trained`: k-means centroids and PQ
codebooks), and works out again everything the program derives from
them: each point's cell, its codes, the posting lists, the probe, the
scores and the top-k. The stage this skips, training, is checked by
itself against the reference's own training (`train.py`).

Every function takes a `prec`: "exact" computes in float32 with TF32 off
(and the compared quantities in float64), "control" one step below what
the configurations state: bfloat16 products where they state float32,
an int4 decoded-residual table where the program keeps an int8 one. The
control stands in the program's place to show that the comparison
fails it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

EXACT, CONTROL = "exact", "control"


@dataclass
class Trained:
    """Trained tables: centroids (kc, d), codebooks (m, ks, dsub)."""
    centroids: torch.Tensor
    codebooks: torch.Tensor


@dataclass
class Stored:
    """A build's result, as the search reads it: each point's cell (n,)
    and codes (n, m), both int64."""
    assign: torch.Tensor
    codes: torch.Tensor


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    """Inputs of a product at the precision's storage type."""
    return x.to(torch.bfloat16).to(torch.float32) if prec == CONTROL else x


def _quantize(table: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-column symmetric quantization to +-levels (int8: 127, int4:
    7), returned dequantized."""
    scale = torch.clamp_min(table.abs().amax(dim=0) / levels, 1e-12)
    return torch.clamp(torch.round(table / scale), -levels, levels) * scale


def sqdist(x: torch.Tensor, y: torch.Tensor, prec: str) -> torch.Tensor:
    """(a, d) x (b, d) -> (a, b) squared distances, ||x||^2 - 2 x.y +
    ||y||^2 in float32 (TF32 off) or over bfloat16-rounded inputs."""
    x, y = _round(x.float(), prec), _round(y.float(), prec)
    return ((x * x).sum(1)[:, None] - 2.0 * (x @ y.T)
            + (y * y).sum(1)[None, :])


def nearest(x: torch.Tensor, table: torch.Tensor, prec: str,
            block: int) -> torch.Tensor:
    """Row of `table` nearest to each row of x -> (n,) int64."""
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], block):
        out[s:s + block] = sqdist(x[s:s + block], table, prec).argmin(1)
    return out


def assign(x: torch.Tensor, trained: Trained, prec: str) -> torch.Tensor:
    """Each point's coarse cell: its nearest centroid."""
    kc = trained.centroids.shape[0]
    block = max(256, min(65536, (1 << 30) // (4 * kc)))
    return nearest(x, trained.centroids, prec, block)


def _subspaces(r: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) -> (m, n, dsub), zero-padding d up to a multiple of m."""
    n, d = r.shape
    dsub = -(-d // m)
    if dsub * m != d:
        r = torch.nn.functional.pad(r, (0, dsub * m - d))
    return r.reshape(n, m, dsub).permute(1, 0, 2)


def encode(x: torch.Tensor, cells: torch.Tensor, trained: Trained,
           prec: str, block: int = 65536) -> torch.Tensor:
    """PQ codes (n, m) of the residuals x - centroid[cell]: per subspace
    the nearest codeword."""
    cb = trained.codebooks
    m = cb.shape[0]
    out = torch.empty((x.shape[0], m), dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], block):
        r = x[s:s + block].float() - trained.centroids[cells[s:s + block]]
        sub = _subspaces(r, m)
        for j in range(m):
            out[s:s + block, j] = sqdist(sub[j], cb[j], prec).argmin(1)
    return out


def decode(codes: torch.Tensor, codebooks: torch.Tensor, d: int
           ) -> torch.Tensor:
    """(n, m) codes -> (n, d) decoded residuals (float64)."""
    m, _, dsub = codebooks.shape
    sub = torch.arange(m, device=codes.device)[None, :]
    rows = codebooks.double()[sub, codes].reshape(codes.shape[0], m * dsub)
    return rows[:, :d]


def build(x: torch.Tensor, trained: Trained, prec: str) -> Stored:
    """The reference's own build from the trained tables."""
    cells = assign(x, trained, prec)
    return Stored(cells, encode(x, cells, trained, prec))


# ------------------------------------------------------------------ probe
def probe(q: torch.Tensor, trained: Trained, w: int, prec: str):
    """The w cells each query scans, its w nearest centroids -> (cells
    (B, w) int64, coarse distances (B, w)). Exact distances are float64,
    the control's over bfloat16 inputs."""
    c = trained.centroids
    dist = _sqdist64(q, c) if prec == EXACT else sqdist(q, c, prec)
    top = torch.topk(dist, w, dim=1, largest=False)
    return top.indices, top.values


def brute_force_nn(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Each query's exact nearest point (float32 search, TF32 off)."""
    return nearest(q, x, EXACT, max(1, (1 << 28) // (4 * x.shape[0])))


def _sqdist64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(a, b) float64 squared distances."""
    x, y = x.double(), y.double()
    return ((x * x).sum(1)[:, None] - 2.0 * (x @ y.T)
            + (y * y).sum(1)[None, :]).clamp_min(0)


# ------------------------------------------------------------------ lists
class Lists:
    """Posting lists of a build: the points of each cell."""

    def __init__(self, stored: Stored, kc: int):
        a = stored.assign.cpu().numpy()
        self.order = np.argsort(a, kind="stable")
        sizes = np.bincount(a, minlength=kc)
        self.sizes = sizes
        self.starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])

    def rows(self, cells) -> np.ndarray:
        return np.concatenate([self.order[self.starts[c]:
                                          self.starts[c] + self.sizes[c]]
                               for c in cells])


# ------------------------------------------------------------------- scan
def score(q: torch.Tensor, rows: torch.Tensor, stored: Stored,
          trained: Trained) -> torch.Tensor:
    """Exact float64 estimator of query q (d,) against points `rows`:
    ||q - c||^2 + ||(q - c) - decoded||^2 with each point's stored cell
    c and codes."""
    d = q.shape[0]
    cen = trained.centroids.double()[stored.assign[rows]]
    r = q.double()[None, :] - cen
    xh = decode(stored.codes[rows], trained.codebooks, d)
    return (r * r).sum(1) + ((r - xh) ** 2).sum(1)


def search(q: torch.Tensor, cells: torch.Tensor, cdist: torch.Tensor,
           stored: Stored, lists: Lists, trained: Trained, k: int,
           prec: str):
    """Scan the probed cells and keep the k best -> (ids (B, k) int64, -1
    padded; scores (B, k), +inf padded). Exact: float64 scores, ties by
    id. Control: int4 decoded residuals, bfloat16 query residuals, the
    probe's own coarse distances."""
    B, d = q.shape
    ids = np.full((B, k), -1, np.int64)
    out = np.full((B, k), np.inf)
    cells_h = cells.cpu().numpy()
    if prec == CONTROL:
        m, _, dsub = trained.codebooks.shape
        cb4 = _quantize(trained.codebooks.permute(1, 0, 2)
                        .reshape(-1, m * dsub), 7)
        cb4 = cb4.reshape(-1, m, dsub).permute(1, 0, 2)
    for i in range(B):
        rows_h = lists.rows(cells_h[i])
        if rows_h.size == 0:
            continue
        rows = torch.as_tensor(rows_h, device=q.device)
        if prec == EXACT:
            s = score(q[i], rows, stored, trained)
        else:
            cell_of = stored.assign[rows]
            pos = (cells[i][None, :] == cell_of[:, None]).float().argmax(1)
            base = cdist[i].float()[pos]
            r = _round(q[i].float()[None, :]
                       - trained.centroids[cell_of], prec)
            xh = decode(stored.codes[rows], cb4, d).float()
            s = base + ((r - _round(xh, prec)) ** 2).sum(1)
        order = np.lexsort((rows_h, s.cpu().numpy()))[:k]
        ids[i, :order.size] = rows_h[order]
        out[i, :order.size] = s.cpu().numpy()[order]
    return ids, out
