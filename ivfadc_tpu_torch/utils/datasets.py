"""Dataset readers and synthetic data (port of `ivfadc_tpu/utils/datasets.py`).

fvecs/bvecs/ivecs are the TEXMEX formats SIFT1M/GIST1M ship in. Everything
but `synthetic_clustered_device` is NumPy, not torch: the same files and the
same seed give the same arrays, bit for bit, in both packages.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def read_fvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """TEXMEX .fvecs: each row is [int32 d][d x float32]."""
    with open(path, "rb") as f:
        head = np.fromfile(f, np.int32, 1)
        if head.size == 0:
            return np.empty((0, 0), np.float32)
        d = int(head[0])
    row_bytes = 4 * (d + 1)
    count = -1 if max_rows is None else max_rows
    raw = np.fromfile(path, np.uint8, count * row_bytes if count > 0 else -1)
    raw = raw[:len(raw) - len(raw) % row_bytes].reshape(-1, row_bytes)
    return raw[:, 4:].copy().view(np.float32).reshape(-1, d)


def read_bvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """TEXMEX .bvecs: each row is [int32 d][d x uint8]."""
    with open(path, "rb") as f:
        d = int(np.fromfile(f, np.int32, 1)[0])
    row_bytes = 4 + d
    count = -1 if max_rows is None else max_rows
    raw = np.fromfile(path, np.uint8, count * row_bytes if count > 0 else -1)
    raw = raw[:len(raw) - len(raw) % row_bytes].reshape(-1, row_bytes)
    return raw[:, 4:].astype(np.float32)


def read_ivecs(path: str) -> np.ndarray:
    """TEXMEX .ivecs (ground-truth id lists)."""
    raw = np.fromfile(path, np.int32)
    d = int(raw[0])
    return raw.reshape(-1, d + 1)[:, 1:].copy()


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


def synthetic_clustered_device(n: int, d: int, n_clusters: int = 256,
                               noise: float = 0.15, seed: int = 0,
                               device="cuda"):
    """`synthetic_clustered`'s mixture family (centers + Gaussian noise)
    drawn on `device` by a `torch.Generator` seeded with `seed`: no host
    array and no host-to-device copy. Deterministic per (seed, device),
    but not the bits of `synthetic_clustered`, nor of the JAX package's
    `jax.random` version: the generators differ."""
    import torch
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    centers = torch.randn((n_clusters, d), generator=g, device=dev)
    which = torch.randint(0, n_clusters, (n,), generator=g, device=dev)
    return centers[which] + noise * torch.randn((n, d), generator=g,
                                                device=dev)


def load_or_synthesize(name: str, n: int, d: int, seed: int = 0,
                       data_dir: Optional[str] = None) -> np.ndarray:
    """Load a real TEXMEX base file if IVFADC_DATA_DIR provides one, else
    synthesize a clustered stand-in with the same shape."""
    data_dir = data_dir or os.environ.get("IVFADC_DATA_DIR", "")
    if data_dir:
        for ext, reader in ((".fvecs", read_fvecs), (".bvecs", read_bvecs)):
            p = os.path.join(data_dir, name + ext)
            if os.path.exists(p):
                return reader(p, max_rows=n)
    return synthetic_clustered(n, d, seed=seed)


def sample_indices(seed: int, n: int, size: int) -> np.ndarray:
    """`size` distinct sorted indices in [0, n) in O(size) host memory:
    rejection-sampled unique draws (expected < 2 rounds while size << n),
    a permutation only when size is a large fraction of n."""
    if size >= n:
        return np.arange(n, dtype=np.int64)
    rng = np.random.RandomState(seed)
    if size > n // 2:
        return np.sort(rng.permutation(n)[:size].astype(np.int64))
    out = np.unique(rng.randint(0, n, int(size * 1.2) + 16))
    while out.size < size:
        out = np.unique(np.concatenate(
            [out, rng.randint(0, n, int(size * 0.5) + 16)]))
    return np.sort(rng.permutation(out)[:size]).astype(np.int64)


def _vecs_meta(path: str, fmt: str):
    """(dim, row_bytes, n_rows) of a TEXMEX vector file."""
    with open(path, "rb") as f:
        head = np.fromfile(f, np.int32, 1)
    if head.size == 0:
        return 0, 0, 0
    d = int(head[0])
    row_bytes = 4 + d * (4 if fmt == "fvecs" else 1)
    return d, row_bytes, os.path.getsize(path) // row_bytes


def _read_vec_rows(path: str, fmt: str, start_row: int, n_rows: int,
                   d: int, row_bytes: int) -> np.ndarray:
    """Read rows [start_row, start_row + n_rows) as (n_rows, d) float32."""
    raw = np.fromfile(path, np.uint8, count=n_rows * row_bytes,
                      offset=start_row * row_bytes)
    raw = raw[:len(raw) - len(raw) % row_bytes].reshape(-1, row_bytes)
    if fmt == "fvecs":
        return raw[:, 4:].copy().view(np.float32).reshape(-1, d)
    return raw[:, 4:].astype(np.float32)


class VecsChunks:
    """Re-iterable chunked reader over TEXMEX .fvecs/.bvecs files, the
    out-of-core source of `IVFADCIndex.build_streaming` /
    `build_from_files`. Iterating yields (<= chunk_rows, d) float32 arrays;
    one chunk is resident at a time. Multiple files concatenate in order
    (Deep1B ships as numbered .bvecs parts)."""

    def __init__(self, paths, chunk_rows: int = 262144,
                 max_rows: Optional[int] = None):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        paths = list(paths)          # generators of paths must hit the
        if not paths:                # emptiness check
            raise ValueError("no input files")
        if chunk_rows < 1:
            raise ValueError("chunk_rows must be >= 1")
        self.paths = [os.fspath(p) for p in paths]
        self.chunk_rows = int(chunk_rows)
        self.max_rows = max_rows
        self._meta = []
        dim = None
        for p in self.paths:
            fmt = "fvecs" if p.endswith(".fvecs") else \
                  "bvecs" if p.endswith(".bvecs") else None
            if fmt is None:
                raise ValueError(f"{p}: expected a .fvecs or .bvecs file")
            d, row_bytes, n = _vecs_meta(p, fmt)
            if n == 0:
                continue
            if dim is None:
                dim = d
            elif d != dim:
                raise ValueError(
                    f"{p} holds {d}-dim vectors, expected {dim}")
            self._meta.append((p, fmt, d, row_bytes, n))
        self.dim = dim or 0
        total = sum(n for *_, n in self._meta)
        self.n_rows = total if max_rows is None else min(total, max_rows)

    def __len__(self) -> int:
        return self.n_rows

    def __iter__(self):
        remaining = self.n_rows
        for p, fmt, d, row_bytes, n in self._meta:
            take = min(n, remaining)
            for start in range(0, take, self.chunk_rows):
                rows = min(self.chunk_rows, take - start)
                yield _read_vec_rows(p, fmt, start, rows, d, row_bytes)
            remaining -= take
            if remaining <= 0:
                return
