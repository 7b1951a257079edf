"""Coarse quantizers (port of `ivfadc_tpu/models/coarse.py`).

Only the brute-force `NaiveCoarseQuantizer` is ported. The default dense
search never calls its `search`: the fused coarse probe kernel
(`ops/coarse_scan.py::coarse_probe_vbase`) emits the probed cells together
with the scan inputs. `search` serves the LUT engine and the unfused dense
probe (inner-product scores, non-euclidean coarse metrics).
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
        """(B, d) queries -> (cells (B, w) int32, dists (B, w) f32
        ascending; squared distances under both euclidean metrics)."""
        from ivfadc_tpu_torch.ops.topk import topk_lastdim
        if (self.metric.name in ("sqeuclidean", "euclidean")
                and w <= min(self.kc, 128)):
            # fused distances + top-w kernel: the (B, kc) matrix never
            # reaches device memory
            from ivfadc_tpu_torch.ops.coarse_scan import coarse_topw
            return coarse_topw(queries, self.centroids, w)
        dist = self.metric.pairwise(queries.to(torch.float32),
                                    self.centroids)             # (B, kc)
        dists, cells = topk_lastdim(dist, w)
        return cells, dists


def make_coarse_quantizer(kind: str, centroids: torch.Tensor,
                          metric: Metric) -> NaiveCoarseQuantizer:
    if kind == "naive":
        return NaiveCoarseQuantizer(centroids, metric)
    raise NotImplementedError(
        f"coarse quantizer {kind!r} (two-level) is not ported yet "
        f"(ROADMAP A.10)")
