"""IVFADCIndex — the top-level index (port of `ivfadc_tpu/models/index.py`).

This slice ports the build and the batched dense search:

  build:  coarse k-means -> residuals -> PQ training -> encode -> padded CSR
  search: fused coarse probe (kernel 1) -> cell ranks (kernel 2) -> tile
          placement -> grouped fold scan (kernel 3) -> top-k merge (kernel 4)

Routes that are not ported yet raise NotImplementedError naming their
ROADMAP item instead of silently taking another route: the small-batch
path (B*w < 4*kc, which includes single-point search at realistic kc),
k > 128, the LUT scan and metrics without a dot-product decomposition,
the two-level coarse quantizer, and the JAX package's opt-in engines.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ivfadc_tpu_torch.config import IVFADCConfig, device_id_cap
from ivfadc_tpu_torch.models.coarse import (NaiveCoarseQuantizer,
                                            make_coarse_quantizer)
from ivfadc_tpu_torch.models.inverted import PostingStore
from ivfadc_tpu_torch.ops import pq as pq_ops
from ivfadc_tpu_torch.ops.metrics import Metric, get_metric

# auto-cap for PQ codebook training when quantization_sample is unset (0)
_PQ_TRAIN_AUTOCAP = 1 << 20

# random streams of a build (ops.kmeans.make_generator)
_STREAM_COARSE = 0
_STREAM_PQ_SAMPLE = 1

# The JAX package's opt-in engines, selected there by environment variables;
# none is ported, so asking for one fails instead of running the default.
_UNPORTED_ENGINES = {
    "IVFADC_VBASE": ("place", "qc: in-kernel v/base grouped scan, ROADMAP B.9"),
    "IVFADC_EXTRACT": ("0", "in-kernel extraction variant, ROADMAP B.8"),
    "IVFADC_COARSE_ENGINE": ("v1", "v2 coarse probe, ROADMAP B.10"),
    "IVFADC_RANK_ENGINE": ("v1", "v2 cell ranks, ROADMAP B.11"),
    "IVFADC_MERGE_TOPK": ("pallas", "approximate merge top-k"),
    "IVFADC_NORMS": ("cache", "in-kernel row norms, ROADMAP B.8"),
}


def _check_engines() -> None:
    for var, (default, what) in _UNPORTED_ENGINES.items():
        val = os.environ.get(var, default)
        if val not in (default, ""):
            raise NotImplementedError(f"{var}={val} selects an engine that "
                                      f"is not ported yet ({what})")


class _PhaseTimer:
    """Wall time per build phase, ending each phase at a device sync."""

    def __init__(self, device: torch.device):
        self.device = device
        self.timings = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[name] = time.perf_counter() - t0


def _train_components(xd: torch.Tensor, config: IVFADCConfig,
                      cmetric: Metric, qmetric: Metric, timer: _PhaseTimer):
    """Coarse k-means + residual-quantizer training on device data `xd`.
    Returns (kmeans result, residuals (n, d), quantizer)."""
    from ivfadc_tpu_torch.ops.kmeans import kmeans, make_generator

    n = xd.shape[0]
    if config.kc > n:
        raise AssertionError(
            f"kc={config.kc} coarse cells need at least that many training "
            f"points, got {n}")
    with timer.phase("coarse_kmeans"):
        cres = kmeans(make_generator(config.seed, _STREAM_COARSE, xd.device),
                      xd, config.kc, maxiter=config.coarse_maxiter,
                      metric=cmetric, block=config.kmeans_block,
                      pp_sample=config.kmeanspp_sample)
    with timer.phase("residuals"):
        residuals = xd - cres.centers[cres.assignments.to(torch.int64)]
    with timer.phase("train_quantizer"):
        train_res = residuals
        qs = config.quantization_sample
        if qs == 0 and n > _PQ_TRAIN_AUTOCAP:
            qs = _PQ_TRAIN_AUTOCAP
        if qs and qs < n:
            g = make_generator(config.seed, _STREAM_PQ_SAMPLE, xd.device)
            sel = torch.randperm(n, generator=g, device=xd.device)[:qs]
            train_res = residuals[sel]
        quantizer = pq_ops.train_quantizer(
            config.seed, train_res, m=config.m, k=config.k,
            method=config.quantization_method,
            maxiter=config.quantization_maxiter, metric=qmetric,
            block=config.kmeans_block)
        del train_res
    return cres, residuals, quantizer


def _dense_probe(cq, rotation, queries, *, w: int, metric: Metric,
                 include_base: bool, apply_rot: bool, residual_based: bool):
    """Coarse probe + scan-vector prep -> (cells (B,w), v (B,w,dq),
    base (B,w), norm_coef). Only the fused branch is ported."""
    if not (residual_based and metric.name in ("sqeuclidean", "euclidean")
            and isinstance(cq, NaiveCoarseQuantizer)
            and cq.metric.name in ("sqeuclidean", "euclidean")):
        raise NotImplementedError(
            f"dense search with quantization metric {metric.name!r} and "
            f"coarse metric {cq.metric.name!r} needs the unfused coarse "
            f"probe (ROADMAP B.7)")
    from ivfadc_tpu_torch.ops.coarse_scan import coarse_probe_vbase
    cells, _, v, base = coarse_probe_vbase(
        queries.to(torch.float32), cq.centroids, w, rotation, apply_rot,
        include_base)
    return cells, v, base, 1.0


def _pad_to_k(out_ids, out_dists, k):
    k_eff = out_dists.shape[1]
    if k_eff < k:
        pad = k - k_eff
        out_ids = torch.nn.functional.pad(out_ids, (0, pad), value=-1)
        out_dists = torch.nn.functional.pad(out_dists, (0, pad),
                                            value=float("inf"))
    return out_ids, out_dists


def _topk_ids(flat_d, flat_i, k):
    """Top-k over id-payload candidate rows -> ((B, k) ids, (B, k) dists),
    inf-padded past the per-query candidate supply."""
    from ivfadc_tpu_torch.ops.topk import topk_lastdim_payload
    k_eff = min(k, flat_d.shape[1])
    if flat_d.shape[1] % 128 != 0:
        pad = 128 - flat_d.shape[1] % 128
        flat_d = torch.nn.functional.pad(flat_d, (0, pad), value=float("inf"))
        flat_i = torch.nn.functional.pad(flat_i, (0, pad), value=-1)
    out_dists, out_ids = topk_lastdim_payload(flat_d, flat_i, k_eff)
    out_ids = torch.where(torch.isfinite(out_dists), out_ids, -1)
    return _pad_to_k(out_ids, out_dists, k)


def _dense_finish(cells, v, base, dev, *, k, w, chunk, pb, nf, norm_coef):
    """Grouped scan + merge: returns raw (ids, dists); the caller applies
    `metric.finalize`. Only the grouped branch is ported."""
    from ivfadc_tpu_torch.ops.dense_scan import grouped_dense_scan
    B = cells.shape[0]
    kc_ = dev["offsets"].shape[0]
    if B * w < 4 * kc_:
        raise NotImplementedError(
            f"B*w = {B * w} < 4*kc = {4 * kc_} takes the small-batch "
            f"per-probe scan, not ported yet (ROADMAP A.5, B.5, B.6)")
    if dev["ids2d"] is None:
        raise NotImplementedError(
            "stores without 128-row cell alignment need the position-payload "
            "scan variant (ROADMAP B.8)")
    out_d, out_p = grouped_dense_scan(
        cells, dev["offsets"], dev["sizes"], v, base, dev["decoded"],
        dev["scale"], dev["ids2d"], dev["norms2d"], kc=kc_,
        k_out=min(k, 128), chunk=chunk, norm_coef=norm_coef, pb=pb,
        merge="fold", nf=nf)
    n_cand = out_d.shape[-1]
    return _topk_ids(out_d.reshape(B, w * n_cand),
                     out_p.reshape(B, w * n_cand), k)


def _bucket_batch(b: int) -> int:
    """Batch sizes padded to a small set of buckets (the JAX package's
    policy, kept so both packages see the same padded batches)."""
    if b <= 8:
        return 8
    p = 8
    while p < b and p < 1024:
        p *= 2
    if p >= b:
        return p
    return ((b + 1023) // 1024) * 1024


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    try:
        return np.dtype(str(dtype).replace("torch.", ""))
    except TypeError:                    # bfloat16 etc.
        return np.dtype(np.float32)


class IVFADCIndex:
    """Two-level IVFADC ANN index (coarse k-means cells + PQ-coded
    residuals) on one torch device."""

    def __init__(self, config: IVFADCConfig, coarse, quantizer, store,
                 data_dtype, dim: int):
        self.config = config
        self.coarse = coarse                  # NaiveCoarseQuantizer
        self.quantizer = quantizer            # ProductQuantizer
        self.store = store                    # PostingStore
        self.data_dtype = np.dtype(data_dtype)
        self.dim = dim
        self.coarse_metric = get_metric(config.coarse_metric)
        self.quant_metric = get_metric(config.quantization_metric)
        if not self.quant_metric.additive:
            raise ValueError(
                f"quantization metric {self.quant_metric.name!r} is not "
                "additive over subspaces — ADC search would be meaningless")
        if config.scan_mode == "dense":
            self._resolve_scan_mode()         # fail fast on bad metrics

    @property
    def device(self) -> torch.device:
        return self.store.device

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, data, config: Optional[IVFADCConfig] = None, *,
              device=None, **kwargs) -> "IVFADCIndex":
        """Build the index from (n, d) row-major points (numpy array or
        tensor) on `device`: by default the tensor's device, else "cuda"."""
        if config is None:
            config = IVFADCConfig(**kwargs)
        elif kwargs:
            raise TypeError("pass either a config or kwargs, not both")
        if isinstance(data, torch.Tensor):
            dev = torch.device(device) if device is not None else data.device
            data_dtype = _np_dtype(data.dtype)
        else:
            data = np.ascontiguousarray(data)
            dev = torch.device(device if device is not None else "cuda")
            data_dtype = data.dtype
        if data.ndim != 2:
            raise AssertionError("data must be a 2-D (n, d) array")
        n, d = data.shape
        config.validate_for_data(n, d)
        if config.coarse_quantizer != "naive":
            raise NotImplementedError(
                f"coarse quantizer {config.coarse_quantizer!r} (two-level) "
                f"is not ported yet (ROADMAP A.10)")
        if config.quantization_method != "pq":
            raise NotImplementedError(
                "OPQ training is not ported yet (ROADMAP A.7)")
        cmetric = get_metric(config.coarse_metric)
        qmetric = get_metric(config.quantization_metric)
        timer = _PhaseTimer(dev)
        xd = torch.as_tensor(data, device=dev).to(torch.float32)
        cres, residuals, quantizer = _train_components(
            xd, config, cmetric, qmetric, timer)
        with timer.phase("encode"):
            codes = pq_ops.encode(quantizer, residuals, metric=qmetric)
            del residuals, xd
        with timer.phase("build_lists"):
            # 128-row cell alignment lets the grouped scan read posting ids
            # in (rows/128, 128) layout and emit external ids
            align = config.cell_align or (128 if config.kc <= 16384 else 8)
            store = PostingStore.build_device(cres.assignments, codes,
                                              config.kc,
                                              slack=config.cell_slack,
                                              align=align)
        coarse = make_coarse_quantizer(config.coarse_quantizer, cres.centers,
                                       cmetric)
        idx = cls(config, coarse, quantizer, store, data_dtype, d)
        idx.build_timings = timer.timings
        return idx

    # ----------------------------------------------------------------- search
    def _device_search(self, queries, k: int, w: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded fixed-shape search on the index device. queries (B, d)
        numpy array or tensor -> (ids (B, k) i32, dists (B, k) f32)."""
        if k < 1:
            raise AssertionError("k has to be >= 1")
        if w < 1:
            raise AssertionError("w has to be >= 1")
        if len(self) > device_id_cap():
            raise AssertionError(
                f"{len(self)} vectors exceed the device int32 id cap "
                f"({device_id_cap()})")
        _check_engines()
        w = min(w, self.config.kc)
        dev = self.device
        q = torch.as_tensor(queries, device=dev).to(torch.float32)
        B = q.shape[0]
        Bp = _bucket_batch(B)
        if Bp != B:
            q = torch.nn.functional.pad(q, (0, 0, 0, Bp - B))
        include_base = (self.config.score_mode == "reference"
                        or not self.quant_metric.residual_based)
        mode = self._resolve_scan_mode()
        if mode != "dense":
            raise NotImplementedError(
                "the LUT scan is not ported yet (ROADMAP A.6); build with "
                "scan_mode='dense' or search on a CUDA device")
        if k > 128:
            raise NotImplementedError(
                f"k={k} > 128 routes to the exact LUT scan, not ported yet "
                f"(ROADMAP A.6)")
        if self._resolve_merge_mode() != "fold":
            raise NotImplementedError(
                "scan_merge='exact' is a grouped-scan variant not ported yet "
                "(ROADMAP B.8)")
        if self._resolve_cache() != "int8":
            raise NotImplementedError(
                "scan_cache='bf16' is a grouped-scan variant not ported yet "
                "(ROADMAP B.8)")
        if self.config.scan_gather_win:
            raise NotImplementedError(
                "the gathered tiny-cell engine is not ported yet "
                "(ROADMAP A.10)")
        view = self.store.device_view_dense(self.quantizer,
                                            self.config.scan_chunk,
                                            cache=self._resolve_cache())
        cells, v, base, norm_coef = _dense_probe(
            self.coarse, self.quantizer.rotation, q, w=w,
            metric=self.quant_metric, include_base=include_base,
            apply_rot=self.quantizer.method == "opq",
            residual_based=self.quant_metric.residual_based)
        out_ids, out_dists = _dense_finish(
            cells, v, base, view, k=k, w=w, chunk=self._effective_chunk(),
            pb=self.config.scan_pb, nf=self.config.scan_fold_lanes,
            norm_coef=norm_coef)
        out_dists = self.quant_metric.finalize(out_dists)
        if Bp == B:
            return out_ids, out_dists
        return out_ids[:B], out_dists[:B]

    def _effective_chunk(self) -> int:
        """Scan chunk adapted to the cell-size distribution: the p95 cell
        capacity rounded up to a scan_fold_lanes multiple, capped at
        scan_chunk. The CUDA kernel walks 128-row groups, so the chunk
        changes no result; it is kept for parity of the configuration."""
        caps = self.store.caps
        if len(caps) == 0:
            return self.config.scan_chunk
        nf = self.config.scan_fold_lanes
        p95 = int(np.percentile(caps, 95))
        return max(nf, min(self.config.scan_chunk,
                           ((p95 + nf - 1) // nf) * nf))

    def _resolve_cache(self) -> str:
        cache = self.config.scan_cache
        return "int8" if cache == "auto" else cache

    def _resolve_merge_mode(self) -> str:
        mode = self.config.scan_merge
        return "fold" if mode == "auto" else mode

    def _resolve_scan_mode(self) -> str:
        """"auto" resolves to dense on a CUDA device (as the JAX package
        resolves it on the TPU) when the metric has a dot-product form."""
        mode = self.config.scan_mode
        dense_ok = self.quant_metric.name in ("sqeuclidean", "euclidean",
                                              "inner_product")
        if mode == "dense":
            if not dense_ok:
                raise ValueError(
                    f"scan_mode='dense' does not support metric "
                    f"{self.quant_metric.name!r} (needs a dot-product "
                    f"decomposition); use 'lut'")
            return "dense"
        if mode == "auto":
            return "dense" if (dense_ok and self.device.type == "cuda") \
                else "lut"
        return "lut"

    def search(self, points, k: int, w: int = 1):
        """Single point (d,) -> (ids, dists) trimmed to the valid (<= k)
        results. Batch (B, d) -> (list_of_ids, list_of_dists). Ids are
        0-based, dtype = config.index_dtype."""
        pts = points.cpu().numpy() if isinstance(points, torch.Tensor) \
            else np.asarray(points)
        single = pts.ndim == 1
        if single:
            pts = pts[None, :]
        if pts.shape[1] != self.dim:
            raise AssertionError(
                f"query dimension {pts.shape[1]} != index dimension {self.dim}")
        out_dtype = pts.dtype if np.issubdtype(pts.dtype, np.floating) \
            else np.float32
        ids, dists = self._device_search(pts, k, w)
        ids = ids.cpu().numpy()
        dists = dists.cpu().numpy()
        id_dtype = np.dtype(self.config.index_dtype)
        if single:
            m = ids[0] >= 0
            return ids[0][m].astype(id_dtype), dists[0][m].astype(out_dtype)
        out_i, out_d = [], []
        for row_i, row_d in zip(ids, dists):
            m = row_i >= 0
            out_i.append(row_i[m].astype(id_dtype))
            out_d.append(row_d[m].astype(out_dtype))
        return out_i, out_d

    def search_padded(self, points, k: int, w: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch search with fixed (B, k) numpy outputs, -1 / +inf padding."""
        ids, dists = self._device_search(points, k, w)
        return ids.cpu().numpy(), dists.cpu().numpy()

    # ------------------------------------------------------------- inspection
    def __len__(self) -> int:
        return self.store.n

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.dim, len(self))

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        from ivfadc_tpu_torch.utils.persistence import save_index
        save_index(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "IVFADCIndex":
        """Load a format-v1 index file (written by either package) onto
        `device` (default "cuda")."""
        from ivfadc_tpu_torch.utils.persistence import load_index
        return load_index(path, device=device)
