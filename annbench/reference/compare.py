"""The comparison that decides `correct`.

Inputs: the base points (made again from the seed), the program's
trained tables, the reference's own (`train.py`), the build under test
(each point's cell and codes, read from the index's store), and a sample
of answered requests (query, ids, distances) that the timed path
produced. The training is held by itself, as sums over every point
(float64):

- `kmeans_gap`: the program's k-means objective (each point's squared
  distance to its nearest centroid, summed) over the reference's own,
  less 1.
- `pq_gap`: the same of the PQ distortion (the residual to the nearest
  centroid against its nearest codewords' decoding).
- `kmeans_lloyd_gain`, `pq_lloyd_gain`: the share of the program's
  objective, or distortion, that one more Lloyd update of its tables
  would remove: near 0 once training has converged.

What the tables derive is then held step by step, each number a widest
gap over what it covers, or an exact count:

- `lost_rows`: points the build holds not exactly once (exact, 0).
- `assign_gap`: over every point, how far the cell it was given lies
  beyond its nearest centroid: (|x - c_given|^2 - |x - c_best|^2) /
  |x - c_best|^2 (float64).
- `code_gap`: over every point, how far its codes' residual error lies
  beyond the nearest codewords' (same form), for the residual to the
  cell it was given.
- `probe_gap`: over every returned id, how far its cell lies beyond the
  w-th cell the reference probes, as a share of that cell's distance
  (0 for a cell the reference probes too).
- `dist_err`: over every returned id, |returned distance - reference
  estimator of that id| over the reference's k-th best distance.
- `rank_gap`: over every answer, how far its j-th best id's reference
  score lies beyond the reference's j-th best, over the k-th best.
- `miss_share`: over every answer, the share of its ids whose reference
  score lies above the reference's k-th best (ties with it count as
  hits), averaged over the answers.
- `bad_answers`: returned ids that are -1, out of range or repeated while
  the reference has k candidates (exact, 0).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from annbench.reference import ivfadc as ref
from annbench.reference import train

TRAINING = ("kmeans_gap", "pq_gap", "kmeans_lloyd_gain", "pq_lloyd_gain")
NAMES = ("kmeans_gap", "pq_gap", "kmeans_lloyd_gain", "pq_lloyd_gain",
         "lost_rows", "assign_gap", "code_gap", "probe_gap", "dist_err",
         "rank_gap", "miss_share", "bad_answers")


def _rel_gap(worse: torch.Tensor, best: torch.Tensor) -> float:
    gap = (worse - best).clamp_min(0) / best.clamp_min(1e-12)
    return float(gap.max()) if gap.numel() else 0.0


def train_numbers(x: torch.Tensor, trained: ref.Trained,
                  mine: ref.Trained) -> Dict[str, float]:
    """kmeans_gap, pq_gap and the Lloyd gains of the program's tables
    (`trained`) against the reference's own (`mine`) on base points x."""
    p, r = train.quality(x, trained), train.quality(x, mine)
    return dict(kmeans_gap=p["J"] / r["J"] - 1.0,
                pq_gap=p["E"] / r["E"] - 1.0,
                kmeans_lloyd_gain=(p["J"] - p["J1"]) / p["J"],
                pq_lloyd_gain=(p["E"] - p["E1"]) / p["E"])


def build_numbers(x: torch.Tensor, trained: ref.Trained,
                  given: ref.Stored, own: ref.Stored) -> Dict[str, float]:
    """assign_gap and code_gap of the build under test (`given`) against
    the reference's own build (`own`), over every point, in blocks."""
    a_gap = c_gap = 0.0
    cen = trained.centroids.double()
    d = x.shape[1]
    for s in range(0, x.shape[0], 65536):
        xb = x[s:s + 65536].double()
        ag, ao = given.assign[s:s + 65536], own.assign[s:s + 65536]
        dg = ((xb - cen[ag]) ** 2).sum(1)
        do = ((xb - cen[ao]) ** 2).sum(1)
        a_gap = max(a_gap, _rel_gap(dg, do))
        # the codes the reference gives the residual to the GIVEN cell
        r = xb - cen[ag]
        best = ref.encode(x[s:s + 65536], ag, trained, ref.EXACT)
        eg = ((r - ref.decode(given.codes[s:s + 65536],
                              trained.codebooks, d)) ** 2).sum(1)
        eb = ((r - ref.decode(best, trained.codebooks, d)) ** 2).sum(1)
        c_gap = max(c_gap, _rel_gap(eg, eb))
    return dict(assign_gap=a_gap, code_gap=c_gap)


def answer_numbers(q: torch.Tensor, ids: np.ndarray, dists: np.ndarray,
                   trained: ref.Trained, given: ref.Stored,
                   own: ref.Stored, lists: ref.Lists, k: int, w: int
                   ) -> Dict[str, float]:
    """probe_gap, dist_err, rank_gap and bad_answers of answers (ids,
    dists) (S, k) to queries q (S, d)."""
    n = given.assign.shape[0]
    cells, cdist = ref.probe(q, trained, w, ref.EXACT)
    best_ids, best = ref.search(q, cells, cdist, own, lists, trained, k,
                                ref.EXACT)
    cells_h = cells.cpu().numpy()
    dw = cdist[:, -1].cpu().numpy()
    probe_gap = dist_err = rank_gap = 0.0
    bad = misses = 0
    cen = trained.centroids.double()
    for i in range(q.shape[0]):
        row = ids[i]
        ok = (row >= 0) & (row < n)
        _, first = np.unique(row, return_index=True)
        dup = np.ones(k, bool)
        dup[first] = False
        full = np.isfinite(best[i]).all()
        if full:
            bad += int((~ok).sum() + (dup & ok).sum())
        kth = max(best[i][np.isfinite(best[i])].max(initial=0.0), 1e-12)
        got = row[ok]
        if got.size == 0:
            continue
        rows = torch.as_tensor(got, device=q.device)
        s = ref.score(q[i], rows, given, trained).cpu().numpy()
        dist_err = max(dist_err, float(
            np.abs(dists[i][ok].astype(np.float64) - s).max() / kth))
        # a returned id misses when its exact score lies beyond the k-th
        # best by more than float64 rounding
        misses += int((s > kth * (1 + 1e-9)).sum()) + (k - got.size)
        gs = np.sort(s)
        bi = best[i][:gs.size]
        fin = np.isfinite(bi)
        if fin.any():
            rank_gap = max(rank_gap, float(
                np.clip(gs[fin] - bi[fin], 0, None).max() / kth))
        gcell = given.assign[rows]
        outside = ~np.isin(gcell.cpu().numpy(), cells_h[i])
        if outside.any():
            dc = ((q[i].double()[None, :] - cen[gcell[torch.as_tensor(
                outside, device=q.device)]]) ** 2).sum(1).cpu().numpy()
            probe_gap = max(probe_gap, float(
                np.clip(dc - dw[i], 0, None).max() / max(dw[i], 1e-12)))
    return dict(probe_gap=probe_gap, dist_err=dist_err, rank_gap=rank_gap,
                miss_share=misses / max(1, k * q.shape[0]),
                bad_answers=float(bad))


def lost_rows(given: ref.Stored, held_ids: np.ndarray, n: int) -> float:
    """Points 0..n-1 not held exactly once, plus ids held that are no
    point: `held_ids` lists every id the store holds."""
    counts = np.bincount(held_ids[(held_ids >= 0) & (held_ids < n)],
                         minlength=n)
    extra = int(((held_ids < 0) | (held_ids >= n)).sum())
    return float((counts != 1).sum() + extra)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number within its limit (NaN fails)."""
    return all(numbers.get(name, float("inf")) <= limits[name]
               for name in limits)
