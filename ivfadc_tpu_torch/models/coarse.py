"""Coarse quantizers (port of `ivfadc_tpu/models/coarse.py`).

Only the brute-force `NaiveCoarseQuantizer` is ported. The dense search
path never calls its `search`: the fused coarse probe kernel
(`ops/coarse_scan.py`) emits the probed cells together with the scan
inputs. `search` itself needs the top-w kernels that are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ivfadc_tpu_torch.ops.metrics import Metric


@dataclasses.dataclass(frozen=True)
class NaiveCoarseQuantizer:
    """Brute-force coarse scan over all kc centroids."""

    centroids: torch.Tensor     # (kc, d) float32
    metric: Metric

    kind = "naive"

    @property
    def kc(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    def search(self, queries: torch.Tensor, w: int):
        """(B, d) queries -> (cells (B, w) int32, dists (B, w) f32)."""
        raise NotImplementedError(
            "NaiveCoarseQuantizer.search needs the coarse top-w and top-k "
            "kernels, not ported yet (ROADMAP B.6, B.7)")


def make_coarse_quantizer(kind: str, centroids: torch.Tensor,
                          metric: Metric) -> NaiveCoarseQuantizer:
    if kind == "naive":
        return NaiveCoarseQuantizer(centroids, metric)
    raise NotImplementedError(
        f"coarse quantizer {kind!r} (two-level) is not ported yet "
        f"(ROADMAP A.10)")
