"""Build-phase timing, a profiler trace and search counters (port of
`ivfadc_tpu/utils/profiling.py`).

Phase timings end at a device sync, so the numbers cover the device work
the phase queued, not only its launches.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import numpy as np
import torch


class BuildTimer:
    """Wall time per named phase, summed over repeated phases. On a CUDA
    `device` each phase starts and ends at a sync of that device."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.timings: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (host and, where there is a card,
    device activity); writes a Chrome trace, `trace.json`, into
    `log_dir`."""
    import os
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class SearchStats:
    """Counters a serving layer aggregates; `record` takes a lock, since
    dispatch threads record concurrently (serving.py)."""

    def __init__(self):
        self.queries = 0
        self.batches = 0
        self.seconds = 0.0
        self._lock = threading.Lock()

    def record(self, batch: int, seconds: float) -> None:
        with self._lock:
            self.queries += batch
            self.batches += 1
            self.seconds += seconds

    @property
    def qps(self) -> float:
        return self.queries / self.seconds if self.seconds else 0.0


def probe_stats(index, queries, w: int) -> Dict[str, float]:
    """Per-query work counters at probe width w: the postings the scan
    touches, the slots it spans (padding included), the share of the
    database scanned and the largest probed cell."""
    q = torch.as_tensor(np.asarray(queries, np.float32), device=index.device)
    w_eff = min(w, index.config.kc)
    cells, _ = index.coarse.search(q, w_eff)
    cells_h = cells.cpu().numpy()
    sizes = np.asarray(index.store.sizes)[cells_h]          # (B, w)
    caps = np.asarray(index.store.caps)[cells_h]
    n = max(1, len(index))
    return {
        "nprobe": float(w_eff),
        "scanned_postings_per_query": float(sizes.sum(1).mean()),
        "scanned_slots_per_query": float(caps.sum(1).mean()),
        "scan_selectivity": float(sizes.sum(1).mean() / n),
        "max_cell_in_probe": float(sizes.max(initial=0)),
    }
