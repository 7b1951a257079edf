"""Coarse quantizers (port of `ivfadc_tpu/models/coarse.py`).

  * `NaiveCoarseQuantizer` — brute-force scan over all kc centroids. The
    default dense search never calls its `search`: the fused coarse probe
    kernel (`ops/coarse_scan.py::coarse_probe_vbase`) emits the probed
    cells together with the scan inputs. `search` serves the LUT engine and
    the unfused dense probe (inner-product scores, non-euclidean coarse
    metrics).
  * `TwoLevelCoarseQuantizer` — the ":hnsw" option for huge kc (~2^18):
    the kc centroids are clustered into g groups, a query probes its gp
    nearest groups and scans only their member centroids. Sublinear in kc,
    approximate like a graph search: the probed cells are the best within
    the gp nearest groups.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ivfadc_tpu_torch.ops.metrics import Metric


def pairwise_rows(metric: Metric, queries, rows):
    """metric.pairwise of each query against its own c rows: queries (B, d),
    rows (B, c, d) -> (B, c)."""
    return torch.vmap(metric.pairwise)(queries[:, None, :], rows)[:, 0, :]


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

    def __repr__(self) -> str:
        return (f"NaiveCoarseQuantizer({self.metric.name}), "
                f"{self.dim}×{self.kc} cluster centres")

    def search(self, queries: torch.Tensor, w: int):
        """(B, d) queries -> (cells (B, w) int32, dists (B, w) f32
        ascending; squared distances under both euclidean metrics)."""
        from ivfadc_tpu_torch.ops.coarse_scan import coarse_topw
        from ivfadc_tpu_torch.ops.topk import topk_lastdim
        if (self.metric.name in ("sqeuclidean", "euclidean")
                and w <= min(self.kc, 128)):
            # fused distances + top-w kernel: the (B, kc) matrix never
            # reaches device memory
            return coarse_topw(queries, self.centroids, w)
        queries = queries.to(torch.float32)
        # query blocks bound the (block, kc) distance matrix (~1 GB f32)
        block = max(1, (1 << 28) // self.kc)
        outs = [topk_lastdim(self.metric.pairwise(queries[s:s + block],
                                                  self.centroids), w)
                for s in range(0, max(1, queries.shape[0]), block)]
        return (torch.cat([o[1] for o in outs]),
                torch.cat([o[0] for o in outs]))


@dataclasses.dataclass(frozen=True)
class TwoLevelCoarseQuantizer:
    """Two-level coarse scan: stage 1 ranks the g group centers, stage 2
    scores the member centroids of the gp nearest groups.

    Two stage-2 engines, picked by kc:
      * small kc (<= _GATHER_MAX), or a non-euclidean metric: gather the
        candidate centroid vectors and score them exactly in f32;
      * large kc: the gather would materialize a (B, gp*gmax, d) tensor;
        instead the group-major int8 centroid table is scanned by the
        grouped scan kernel (groups play "cells", centroids play
        "postings"; bf16 products, row norms computed in the kernel), which
        emits cell ids from the `perm2d` stream.
    """

    centroids: torch.Tensor        # (kc, d) float32 — the actual cells
    group_centers: torch.Tensor    # (g, d) float32
    members: torch.Tensor          # (g, gmax) int32, padded with -1
    csr_offsets: torch.Tensor      # (g,) int32 — 128-aligned slot starts
    csr_sizes: torch.Tensor        # (g,) int32 — live centroids per group
    cent_scan: torch.Tensor        # (slots_pad, d_pad) int8 group-major
    cent_scale: torch.Tensor       # (d_pad,) f32 per-column dequant scales
    perm2d: torch.Tensor           # (slots_pad/128, 128) i32 cell-id stream
    metric: Metric
    n_probe_groups: int

    kind = "two_level"
    _GATHER_MAX = 4096

    @classmethod
    def create(cls, centroids, group_centers, members, metric: Metric,
               n_probe_groups: int, device=None) -> "TwoLevelCoarseQuantizer":
        """Derive the CSR and scan arrays from (centroids, members), the
        only arrays a file holds. The derivation runs in numpy, operation
        for operation as in the JAX package, so both hold the same bytes.
        `device` defaults to the device of `centroids`."""
        if device is None:
            device = centroids.device if isinstance(centroids, torch.Tensor) \
                else "cpu"
        dev = torch.device(device)

        def host(a, dtype):
            if isinstance(a, torch.Tensor):
                a = a.cpu().numpy()
            return np.array(a, dtype)      # a writable copy of its own

        cent_h = host(centroids, np.float32)
        members_h = host(members, np.int32)
        g = members_h.shape[0]
        counts = (members_h >= 0).sum(axis=1).astype(np.int64)
        # 128-aligned group starts: the grouped scan kernel streams the
        # cell-id rows (perm2d) and emits cell ids directly
        caps = np.maximum(128, ((counts + 127) // 128) * 128)
        offsets = np.zeros(g, np.int64)
        np.cumsum(caps[:-1], out=offsets[1:])
        d = cent_h.shape[1]
        d_pad = ((d + 127) // 128) * 128
        guard = 1024 + 128
        total = int(offsets[-1] + caps[-1]) + guard
        total = ((total + 127) // 128) * 128
        perm = np.full(total, -1, np.int32)
        # member j of group gi lands at offsets[gi] + its rank among the
        # group's live members (rows may hold -1 gaps anywhere)
        live_r, live_c = np.nonzero(members_h >= 0)
        rank = (np.cumsum(members_h >= 0, axis=1) - 1)[live_r, live_c]
        perm[offsets[live_r] + rank] = members_h[live_r, live_c]
        cent = np.zeros((total, d_pad), np.float32)
        live = perm >= 0
        cent[live, :d] = cent_h[perm[live]]
        # int8 table + per-column scales, the posting cache's scheme
        scale = np.maximum(np.abs(cent).max(axis=0) / 127.0, 1e-12) \
            .astype(np.float32)
        cent_q = np.clip(np.round(cent / scale[None, :]), -127, 127) \
            .astype(np.int8)

        def t(a):
            return torch.as_tensor(a, device=dev)

        return cls(t(cent_h), t(host(group_centers, np.float32)),
                   t(members_h), t(offsets.astype(np.int32)),
                   t(counts.astype(np.int32)), t(cent_q), t(scale),
                   t(perm.reshape(-1, 128)), metric, int(n_probe_groups))

    @property
    def kc(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    def __repr__(self) -> str:
        return (f"TwoLevelCoarseQuantizer({self.metric.name}), "
                f"{self.dim}×{self.kc} cluster centres in "
                f"{self.group_centers.shape[0]} groups "
                f"(gp={self.n_probe_groups})")

    def search(self, queries: torch.Tensor, w: int):
        """(B, d) queries -> (cells (B, w) int32, dists (B, w) f32
        ascending). Fewer candidates than w: the tail is cell 0 at +inf."""
        from ivfadc_tpu_torch.ops.topk import topk_lastdim
        queries = queries.to(torch.float32)
        gp = min(self.n_probe_groups, self.group_centers.shape[0])
        gdist = self.metric.pairwise(queries, self.group_centers)   # (B, g)
        _, gids = topk_lastdim(gdist, gp)                           # (B, gp)
        # the stage-2 scan scores by |q|^2 - 2 q.c + |c|^2, valid only for
        # the (sq)euclidean pairwise; other metrics stay on the exact gather
        scan_ok = self.metric.name in ("sqeuclidean", "euclidean")
        if self.kc > self._GATHER_MAX and scan_ok:
            return self._scan_stage2(queries, gids, gp, w)
        cand = self.members[gids.to(torch.int64)] \
            .reshape(queries.shape[0], -1)
        valid = cand >= 0
        cvecs = self.centroids[torch.where(valid, cand, 0).to(torch.int64)]
        cdist = pairwise_rows(self.metric, queries, cvecs)          # (B, C)
        cdist = torch.where(valid, cdist, float("inf"))
        w_eff = min(w, cand.shape[1])
        dists, pos = topk_lastdim(cdist, w_eff)
        cells = torch.gather(cand, 1, pos.to(torch.int64))
        return _pad_cells(torch.where(torch.isfinite(dists), cells, 0),
                          dists, w)

    def _scan_stage2(self, queries, gids, gp: int, w: int):
        """Stage 2 through the grouped scan (|q-c|^2 = |q|^2 - 2 q.c +
        |c|^2 with bf16 products, f32 accumulation)."""
        from ivfadc_tpu_torch.ops.dense_scan import grouped_dense_scan
        from ivfadc_tpu_torch.ops.topk import topk_lastdim_payload
        B, d = queries.shape
        v = (-2.0 * queries)[:, None, :].expand(B, gp, d)
        base = torch.sum(queries * queries, dim=1)[:, None].expand(B, gp)
        out_d, out_p = grouped_dense_scan(
            gids, self.csr_offsets, self.csr_sizes, v, base, self.cent_scan,
            self.cent_scale, self.perm2d, None,
            kc=self.group_centers.shape[0], k_out=min(w, 128), chunk=512,
            norm_coef=1.0, pb=64, merge="fold", nf=128)
        nf = out_d.shape[-1]
        flat_d = out_d.reshape(B, gp * nf)
        flat_p = out_p.reshape(B, gp * nf)       # emitted CELL ids
        w_eff = min(w, gp * nf)
        dists, cells = topk_lastdim_payload(flat_d, flat_p, w_eff)
        cells = torch.where(torch.isfinite(dists) & (cells >= 0), cells, 0)
        return _pad_cells(cells, dists, w)


def _pad_cells(cells, dists, w: int):
    """Pad (B, w_eff) probe lists to w with cell 0 at +inf."""
    pad = w - cells.shape[1]
    if pad > 0:
        cells = torch.nn.functional.pad(cells, (0, pad))
        dists = torch.nn.functional.pad(dists, (0, pad), value=float("inf"))
    return cells.to(torch.int32), dists


def build_two_level(gen: torch.Generator, centroids: torch.Tensor,
                    metric: Metric, n_groups: int = 0,
                    n_probe_groups: int = 0,
                    maxiter: int = 16) -> TwoLevelCoarseQuantizer:
    """Cluster the kc centroids into ~sqrt(kc) groups."""
    from ivfadc_tpu_torch.ops.kmeans import kmeans

    kc = centroids.shape[0]
    g = n_groups or max(1, int(math.ceil(math.sqrt(kc))))
    g = min(g, kc)
    if g <= 1:
        return TwoLevelCoarseQuantizer.create(
            centroids, torch.mean(centroids, dim=0, keepdim=True),
            np.arange(kc, dtype=np.int32)[None, :], metric, 1)
    res = kmeans(gen, centroids, g, maxiter=maxiter, metric=metric)
    assign = res.assignments.cpu().numpy()
    counts = np.bincount(assign, minlength=g)
    gmax = max(1, int(counts.max()))
    members = np.full((g, gmax), -1, np.int32)
    order = np.argsort(assign, kind="stable")
    within = np.arange(kc, dtype=np.int64) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]])[assign[order]]
    members[assign[order], within] = order
    # default dial: a quarter of the groups at small g, where the candidate
    # pool gp*(kc/g) is thin, tapering to g/16 (but at least 32) at large g;
    # never fewer than 8 groups
    gp = n_probe_groups or max(min(g, 8),
                               min(-(-g // 4), max(32, -(-g // 16))))
    return TwoLevelCoarseQuantizer.create(centroids, res.centers, members,
                                          metric, gp)


def make_coarse_quantizer(kind: str, centroids: torch.Tensor, metric: Metric,
                          generator: torch.Generator = None,
                          n_groups: int = 0, n_probe_groups: int = 0):
    """"naive", or "hnsw" / "two_level" (which clusters the centroids with
    `generator`'s random stream)."""
    if kind == "naive":
        return NaiveCoarseQuantizer(centroids, metric)
    if kind in ("hnsw", "two_level"):
        return build_two_level(generator, centroids.to(torch.float32), metric,
                               n_groups=n_groups,
                               n_probe_groups=n_probe_groups)
    raise ValueError(f"unknown coarse quantizer kind {kind!r}")
