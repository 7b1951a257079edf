"""Peaks of the card and the work of each layer, counted from the
problem, not from the implementation, so that any design of a layer is
held to the same least time and none can read above 100 %.

- queries read once, 4 bytes a dimension;
- the centroids read once;
- each probed posting read once a batch in the index's stored form: its
  m code bytes and its id;
- the results written once, an id and a distance each;
- 2·d operations per (query, centroid) pair the probe has to score and
  per (query, posting) pair the scan scores.

The least time is the larger of bytes over the memory rate and
operations over the highest dense peak an implementation that passes the
comparison could use: the metric's file names it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BYTES_S = 3.35e12
PEAKS = {"bf16": 989e12, "int8": 1979e12}


def least_s(nbytes: float, ops: float, peak: str) -> float:
    return max(nbytes / PEAK_BYTES_S, ops / PEAKS[peak])


def share(nbytes: float, ops: float, peak: str, seconds: float):
    """Percent of the roofline, or None where the layer took no time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_s(nbytes, ops, peak) / seconds


def layer_share(run, layer: str, peak: str):
    """A traced run's percent of `layer`'s roofline, from the work the
    harness counted (`run.work`) and the layer's device time."""
    t = run.trace
    if t is None or layer not in run.work:
        return None
    nbytes, ops = run.work[layer]
    return share(nbytes, ops, peak, t.layer_s.get(layer, 0.0))


def probe_work(n_queries: int, d: int, pairs: int, centroid_rows: int):
    """(bytes, ops) of a probe: queries and the centroids it needs read
    once, the probe's `pairs` (query, centroid) distances."""
    return 4.0 * d * (n_queries + centroid_rows), 2.0 * d * pairs


def scan_work(d: int, m: int, id_bytes: int, pairs: int, postings: int):
    """(bytes, ops) of a scan: each probed posting once in stored form,
    2·d operations a (query, posting) pair."""
    return float(postings * (m + id_bytes)), 2.0 * d * pairs


def merge_work(n_queries: int, k: int):
    """(bytes, ops) of a merge: its results written once."""
    return 8.0 * n_queries * k, 0.0
