"""Synthetic data (port of `ivfadc_tpu/utils/datasets.py::synthetic_clustered`).

NumPy, not torch: the same seed gives the same points in both packages.
"""

from __future__ import annotations

import numpy as np


def synthetic_clustered(n: int, d: int, n_clusters: int = 256,
                        noise: float = 0.15, seed: int = 0,
                        dtype=np.float32) -> np.ndarray:
    """Gaussian-mixture data with SIFT-like cluster structure, generated in
    blocks to bound memory."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, d).astype(np.float32)
    out = np.empty((n, d), dtype)
    block = 1 << 16
    for start in range(0, n, block):
        b = min(block, n - start)
        which = rng.randint(0, n_clusters, b)
        out[start:start + b] = (centers[which] +
                                noise * rng.randn(b, d)).astype(dtype)
    return out
