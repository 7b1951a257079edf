"""IVFADCIndex — the top-level index (port of `ivfadc_tpu/models/index.py`).

Ported so far: the build and every search route of a static index, with
the naive or the two-level coarse quantizer.

  build:  coarse k-means (k-means|| seeding past 4096 cells) -> residuals
          -> PQ training -> encode -> padded CSR -> coarse quantizer
  dense search, B*w >= 4*kc: fused coarse probe -> cell ranks -> tile
          placement -> grouped fold scan -> top-k merge over id payloads
  dense search, B*w < 4*kc (single queries included): fused coarse probe ->
          per-probe fold scan -> top-k with indices -> slot positions -> ids
  unfused probe (inner-product scores, non-euclidean coarse metrics, the
          two-level coarse quantizer): the quantizer's own top-w search,
          then v / base in tensor code, then either scan
  LUT search (scan_mode="lut", k > 128, "auto" off the GPU): coarse search
          -> ADC tables -> window gather + table lookups -> k smallest

Routes that are not ported yet raise NotImplementedError naming their
ROADMAP item instead of silently taking another route: OPQ training, the
gathered tiny-cell engine, the exact merge, the bf16 decoded cache, stores
without 128-row cells on the grouped scan (which large-kc indexes reach
only at B*w >= 4*kc), and the JAX package's opt-in engines other than
IVFADC_NORMS.
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
                                            make_coarse_quantizer,
                                            pairwise_rows)
from ivfadc_tpu_torch.models.inverted import PostingStore
from ivfadc_tpu_torch.ops import pq as pq_ops
from ivfadc_tpu_torch.ops.coarse_scan import coarse_probe_vbase
from ivfadc_tpu_torch.ops.kmeans import kmeans, make_generator
from ivfadc_tpu_torch.ops.metrics import Metric, get_metric

# auto-cap for PQ codebook training when quantization_sample is unset (0)
_PQ_TRAIN_AUTOCAP = 1 << 20

# random streams of a build (ops.kmeans.make_generator)
_STREAM_COARSE = 0
_STREAM_PQ_SAMPLE = 1
_STREAM_COARSE_GROUPS = 2

# elements of one (queries, w, window) temporary of the LUT scan; larger
# batches are scanned in query blocks of this size (results do not change:
# queries are independent)
_LUT_BLOCK_ELEMS = 1 << 24

# The JAX package's opt-in engines, selected there by environment variables.
# These are not ported, so asking for one fails instead of running the
# default. (IVFADC_NORMS is honoured: `PostingStore.device_view_dense`.)
_UNPORTED_ENGINES = {
    "IVFADC_VBASE": ("place", "qc: in-kernel v/base grouped scan, ROADMAP B.9"),
    "IVFADC_EXTRACT": ("0", "in-kernel extraction variant, ROADMAP B.8"),
    "IVFADC_COARSE_ENGINE": ("v1", "v2 coarse probe, ROADMAP B.10"),
    "IVFADC_RANK_ENGINE": ("v1", "v2 cell ranks, ROADMAP B.11"),
    "IVFADC_MERGE_TOPK": ("pallas", "approximate merge top-k"),
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
    base (B,w), norm_coef)."""
    queries = queries.to(torch.float32)
    B, d = queries.shape
    dq = rotation.shape[0]                                # quantizer dim
    if (residual_based and metric.name in ("sqeuclidean", "euclidean")
            and isinstance(cq, NaiveCoarseQuantizer)
            and cq.metric.name in ("sqeuclidean", "euclidean")
            and w <= 128 and dq == d):
        # fully fused coarse probe: cells / v / base from one kernel
        cells, _, v, base = coarse_probe_vbase(
            queries, cq.centroids, w, rotation, apply_rot, include_base)
        return cells, v, base, 1.0
    cells, cdists = cq.search(queries, w)
    cent = cq.centroids[cells.to(torch.int64)]            # (B, w, d)
    if residual_based:
        r = queries[:, None, :] - cent
        if d != dq:                     # ragged-subspace zero padding
            r = torch.nn.functional.pad(r, (0, dq - d))
        if apply_rot:
            r = r @ rotation
        v = -2.0 * r
        base = torch.sum(r * r, dim=-1)
        if include_base:
            base = base + cdists
        norm_coef = 1.0
    else:
        # inner-product family: q.x_hat = q.c + q.decode, so the scan
        # vector is the query itself and the coarse term (under the QUANT
        # metric) is the base; no norm term
        qv = queries
        if d != dq:
            qv = torch.nn.functional.pad(qv, (0, dq - d))
        q = qv @ rotation if apply_rot else qv
        v = (-q)[:, None, :].expand(B, w, dq)
        base = pairwise_rows(metric, queries, cent)
        norm_coef = 0.0
    # a quantizer may PAD probes past its candidate supply (cell 0 with an
    # infinite distance): a finite recomputed base would re-scan cell 0 and
    # duplicate its neighbours in the final top-k
    base = torch.where(torch.isfinite(cdists), base, float("inf"))
    return cells, v, base, norm_coef


def _lut_search(cq, codebooks, rotation, view, queries, *, k: int, w: int,
                window: int, metric: Metric, include_base: bool,
                apply_rot: bool, residual_based: bool):
    """LUT search: coarse probe -> ADC tables -> posting scan -> k smallest,
    in query blocks that bound the scan's (queries, w, window) temporaries.
    Returns raw (ids, dists); the caller applies `metric.finalize`."""
    from ivfadc_tpu_torch.ops.adc import build_adc_tables, scan_postings
    queries = queries.to(torch.float32)
    d = queries.shape[1]
    dq = rotation.shape[0]
    block = max(1, _LUT_BLOCK_ELEMS // (w * window))
    outs = []
    for s in range(0, queries.shape[0], block):
        q = queries[s:s + block]
        cells, cdists = cq.search(q, w)                       # (b, w)
        cent = cq.centroids[cells.to(torch.int64)]            # (b, w, d)
        if residual_based:
            vecs = q[:, None, :] - cent
            base = cdists if include_base else torch.zeros_like(cdists)
        else:
            vecs = q[:, None, :].expand(q.shape[0], w, d)
            base = pairwise_rows(metric, q, cent)
        base = torch.where(torch.isfinite(cdists), base, float("inf"))
        if d != dq:                     # ragged-subspace zero padding
            vecs = torch.nn.functional.pad(vecs, (0, dq - d))
        if apply_rot:
            vecs = vecs @ rotation
        tables = build_adc_tables(metric, vecs, codebooks)    # (b, w, m, kq)
        outs.append(scan_postings(
            tables, base, cells, view["offsets"], view["sizes"],
            view["codes"], view["ids"], k=k, window=window))
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


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


def _topk_positions(flat_d, flat_p, k, cells, offsets, n_cand, ids):
    """Top-k over fold candidate rows whose payloads are cell-relative
    128-row block indices, resolving the winners to slot positions and
    external ids -> ((B, k) ids, (B, k) dists)."""
    from ivfadc_tpu_torch.ops.topk import topk_lastdim
    k_eff = min(k, flat_d.shape[1])
    out_dists, which = topk_lastdim(flat_d, k_eff)
    which = which.to(torch.int64)
    blk = torch.gather(flat_p, 1, which).to(torch.int64)
    # re-attach the winning probe's cell offset (k values per query); the
    # lane within its bank is the row within the block
    probe = which // n_cand                                   # (B, k_eff)
    start = torch.gather(offsets.to(torch.int64)[cells.to(torch.int64)], 1,
                         probe)
    pos = torch.where(blk >= 0, start + blk * 128 + which % 128, -1)
    out_ids = torch.where(pos >= 0, ids[torch.clamp_min(pos, 0)], -1)
    out_ids = torch.where(torch.isfinite(out_dists), out_ids, -1) \
        .to(torch.int32)
    return _pad_to_k(out_ids, out_dists, k)


def _dense_finish(cells, v, base, dev, *, k, w, chunk, pb, nf, norm_coef):
    """Scan + merge: returns raw (ids, dists); the caller applies
    `metric.finalize`. Batches whose probes share cells (B*w >= 4*kc) take
    the cell-grouped scan, smaller ones the per-probe scan."""
    B = cells.shape[0]
    kc_ = dev["offsets"].shape[0]
    k_out = min(k, 128)
    if B * w >= 4 * kc_:
        from ivfadc_tpu_torch.ops.dense_scan import grouped_dense_scan
        if dev["ids2d"] is None:
            raise NotImplementedError(
                "stores without 128-row cell alignment need the grouped "
                "scan's position-payload variant (ROADMAP B.8)")
        out_d, out_p = grouped_dense_scan(
            cells, dev["offsets"], dev["sizes"], v, base, dev["decoded"],
            dev["scale"], dev["ids2d"], dev["norms2d"], kc=kc_,
            k_out=k_out, chunk=chunk, norm_coef=norm_coef, pb=pb,
            merge="fold", nf=nf)
        n_cand = out_d.shape[-1]
        return _topk_ids(out_d.reshape(B, w * n_cand),
                         out_p.reshape(B, w * n_cand), k)
    # mostly-distinct cells: grouping would emit about one tile per probe
    from ivfadc_tpu_torch.ops.dense_scan import dense_scan
    cells64 = cells.to(torch.int64)
    out_d, out_p = dense_scan(
        dev["offsets"][cells64], dev["sizes"][cells64], v, base,
        dev["decoded"], dev["scale"], k_out=k_out, chunk=chunk,
        norm_coef=norm_coef, merge="fold", nf=nf)
    n_cand = out_d.shape[-1]
    return _topk_positions(out_d.reshape(B, w * n_cand),
                           out_p.reshape(B, w * n_cand), k, cells,
                           dev["offsets"], n_cand, dev["ids"])


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
        self.coarse = coarse                  # Naive- / TwoLevelCoarseQuantizer
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
        tensor) on `device`. The default is "cuda"; a tensor that already
        lives on a CUDA device keeps that device. Pass device="cpu" to
        build on the CPU."""
        if config is None:
            config = IVFADCConfig(**kwargs)
        elif kwargs:
            raise TypeError("pass either a config or kwargs, not both")
        if isinstance(data, torch.Tensor):
            data_dtype = _np_dtype(data.dtype)
            if device is None and data.device.type == "cuda":
                device = data.device
        else:
            data = np.ascontiguousarray(data)
            data_dtype = data.dtype
        dev = torch.device(device if device is not None else "cuda")
        if data.ndim != 2:
            raise AssertionError("data must be a 2-D (n, d) array")
        n, d = data.shape
        config.validate_for_data(n, d)
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
            # in (rows/128, 128) layout and emit external ids; huge-kc
            # indexes serve the per-probe scan and keep the tight 8 rows
            align = config.cell_align or (128 if config.kc <= 16384 else 8)
            store = PostingStore.build_device(cres.assignments, codes,
                                              config.kc,
                                              slack=config.cell_slack,
                                              align=align)
        with timer.phase("coarse_quantizer"):
            coarse = make_coarse_quantizer(
                config.coarse_quantizer, cres.centers, cmetric,
                generator=make_generator(config.seed, _STREAM_COARSE_GROUPS,
                                         dev),
                n_groups=config.coarse_n_groups,
                n_probe_groups=config.coarse_probe_groups)
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
        if mode == "dense" and k > 128:
            # the dense kernels keep at most 128 candidates per probe lane
            # set; the LUT engine scores every probed posting, so any k is
            # exact there
            mode = "lut"
        if mode == "dense":
            out_ids, out_dists = self._dense_search(q, k, w, include_base)
        else:
            out_ids, out_dists = _lut_search(
                self.coarse, self.quantizer.codebooks,
                self.quantizer.rotation, self.store.device_view(), q, k=k,
                w=w, window=self.store.window, metric=self.quant_metric,
                include_base=include_base,
                apply_rot=self.quantizer.method == "opq",
                residual_based=self.quant_metric.residual_based)
        out_dists = self.quant_metric.finalize(out_dists)
        if Bp == B:
            return out_ids, out_dists
        return out_ids[:B], out_dists[:B]

    def _dense_search(self, q, k: int, w: int, include_base: bool):
        if self._resolve_merge_mode() != "fold":
            raise NotImplementedError(
                "scan_merge='exact' is a scan-kernel variant not ported yet "
                "(ROADMAP B.8)")
        if self._resolve_cache() != "int8":
            raise NotImplementedError(
                "scan_cache='bf16' is a scan-kernel variant not ported yet "
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
        return _dense_finish(
            cells, v, base, view, k=k, w=w, chunk=self._effective_chunk(),
            pb=self.config.scan_pb, nf=self.config.scan_fold_lanes,
            norm_coef=norm_coef)

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
        if isinstance(points, torch.Tensor):    # stays on its device
            pts = points
            out_dtype = _np_dtype(pts.dtype) if pts.dtype.is_floating_point \
                else np.dtype(np.float32)
        else:
            pts = np.asarray(points)
            out_dtype = pts.dtype if np.issubdtype(pts.dtype, np.floating) \
                else np.float32
        single = pts.ndim == 1
        if single:
            pts = pts[None, :]
        if pts.shape[1] != self.dim:
            raise AssertionError(
                f"query dimension {pts.shape[1]} != index dimension {self.dim}")
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
