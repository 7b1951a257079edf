"""IVFADCIndex — the top-level index (port of `ivfadc_tpu/models/index.py`).

Ported: the build (PQ or OPQ, in memory or out of core), every search
route with the naive or the two-level coarse quantizer, the dynamic ops,
autotune and memory_stats.

  build:  coarse k-means (k-means|| seeding past 4096 cells) -> residuals
          -> PQ training (OPQ: alternated with the rotation's Procrustes
          solve) -> encode -> padded CSR -> coarse quantizer
  build_streaming / build_from_files: reservoir sample of the chunk
          stream -> the same training -> each chunk assigned (k-means'
          final-pass arithmetic) and encoded on the device -> the same
          padded CSR and coarse quantizer
  dense search, B*w >= 4*kc: fused coarse probe -> cell ranks (counting
          kernel up to 4096 cells, one sort beyond) -> tile placement ->
          grouped scan -> top-k merge: over id payloads (128-row cells,
          fold; IVFADC_EXTRACT=1: over each probe's extracted top-k), or
          over block indices / slots resolved to ids (8-row cells; the
          exact merge); IVFADC_VBASE=qc on the sqeuclidean naive-coarse
          fold: fused probe (cells only) -> cell ranks -> grouped scan
          deriving v / base in the kernel -> top-k merge
  dense search, B*w < 4*kc (single queries included): fused coarse probe ->
          per-probe scan -> top-k with indices -> slot positions -> ids;
          with scan_gather_win set, cells within the gather window are
          scored by the gathered engine (ops/gather_scan.py) and merged
          with the scan's candidates of larger cells
  both scans take the int8 or the bf16 decoded cache (scan_cache) and the
          fold or the exact merge (scan_merge)
  unfused probe (inner-product scores, non-euclidean coarse metrics, the
          two-level coarse quantizer): the quantizer's own top-w search,
          then v / base in tensor code, then either scan
  LUT search (scan_mode="lut", k > 128, "auto" off the GPU): coarse search
          -> ADC tables -> window gather + table lookups -> k smallest
  dynamic ops: push / push_batch / push_front (cell by the coarse search at
          w = 1, codes by the PQ encoder), pop / pop_front / delete with
          positional ids, reconstruct, fork (copy-on-write views); the
          store patches the cached device views in place
          (models/inverted.py)

The JAX package's opt-in engines are read per search, as it reads them:
IVFADC_VBASE (place | qc), IVFADC_COARSE_ENGINE and IVFADC_RANK_ENGINE
(v1 | v2), IVFADC_MERGE_TOPK (pallas | approx, served by the exact payload
top-k, which is what the JAX package's approx_min_k computes off the TPU),
IVFADC_EXTRACT; IVFADC_NORMS when the dense view is built. An unknown value
raises ValueError.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ivfadc_tpu_torch.config import DTYPE_TO_BITS, IVFADCConfig, device_id_cap
from ivfadc_tpu_torch.models import graphs
from ivfadc_tpu_torch.models.coarse import (NaiveCoarseQuantizer,
                                            make_coarse_quantizer,
                                            pairwise_rows)
from ivfadc_tpu_torch.models.inverted import PostingStore
from ivfadc_tpu_torch.ops import pq as pq_ops
from ivfadc_tpu_torch.ops.coarse_scan import coarse_probe_vbase
from ivfadc_tpu_torch.ops.kmeans import (assign_blocks, kmeans, kmeans_block,
                                         make_generator)
from ivfadc_tpu_torch.ops.metrics import Metric, get_metric
from ivfadc_tpu_torch.utils.profiling import BuildTimer, count, span, tally

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

# the qc route's bounds on the resident queries and centroids (the JAX
# package's VMEM gates, kept so both packages take the same route)
_QC_MAX_QUERY_BYTES = 6 << 20
_QC_MAX_CENT_BYTES = 4 << 20


def _env_extract() -> bool:
    """IVFADC_EXTRACT=1 selects the grouped scan's in-kernel extraction,
    unless IVFADC_NO_EXTRACT is set to anything but "0" or "" (read as the
    JAX package reads them)."""
    return (os.environ.get("IVFADC_EXTRACT", "0") == "1"
            and os.environ.get("IVFADC_NO_EXTRACT", "0") in ("", "0"))


def _env_rank_engine() -> str:
    """IVFADC_RANK_ENGINE: "v1" (default) or "v2" cell-rank kernel."""
    return os.environ.get("IVFADC_RANK_ENGINE", "v1")


def _env_vbase() -> str:
    """IVFADC_VBASE: "place" (default: placed v/base tiles) or "qc" (v and
    base derived in the scan kernel, where the qc gate admits the batch)."""
    vbase = os.environ.get("IVFADC_VBASE", "place")
    if vbase not in ("place", "qc"):
        raise ValueError(f"IVFADC_VBASE must be 'place' or 'qc', got "
                         f"{vbase!r}")
    return vbase


def _env_coarse_engine() -> str:
    """IVFADC_COARSE_ENGINE: "v1" (default) or "v2" fused coarse probe."""
    return os.environ.get("IVFADC_COARSE_ENGINE", "v1")


def _env_merge_topk() -> str:
    """IVFADC_MERGE_TOPK: "pallas" (default) or "approx", the latter with
    its recall target folded in ("approx:0.95", IVFADC_MERGE_RECALL), as
    the JAX package spells it."""
    eng = os.environ.get("IVFADC_MERGE_TOPK", "pallas")
    if eng == "approx":
        return f"approx:{float(os.environ.get('IVFADC_MERGE_RECALL', '0.95'))}"
    return eng


def _train_components(xd: torch.Tensor, config: IVFADCConfig,
                      cmetric: Metric, qmetric: Metric, timer: BuildTimer):
    """Coarse k-means + residual-quantizer training on device data `xd`,
    shared by `build` and `build_streaming`. Returns (kmeans result,
    residuals (n, d), quantizer)."""
    n = xd.shape[0]
    if config.kc > n:
        raise AssertionError(
            f"kc={config.kc} coarse cells need at least that many training "
            f"points, got {n} (streamed builds: raise train_sample above "
            f"kc)")
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
            opq_iters=config.opq_iters, block=config.kmeans_block)
        del train_res
    return cres, residuals, quantizer


def _fused_probe_ok(cq, rotation, queries, w: int, metric: Metric,
                    residual_based: bool) -> bool:
    """Whether the fused coarse probe serves this search: a residual
    (sq)euclidean quantizer over a naive (sq)euclidean coarse quantizer,
    w <= 128 and no ragged-subspace padding."""
    return (residual_based and metric.name in ("sqeuclidean", "euclidean")
            and isinstance(cq, NaiveCoarseQuantizer)
            and cq.metric.name in ("sqeuclidean", "euclidean")
            and w <= 128 and rotation.shape[0] == queries.shape[1])


def _dense_probe(cq, rotation, queries, *, w: int, metric: Metric,
                 include_base: bool, apply_rot: bool, residual_based: bool,
                 extract: bool = False, coarse_engine: str | None = None,
                 rank_engine: str | None = None):
    """Coarse probe + scan-vector prep -> (cells (B,w), v (B,w,dq),
    base (B,w), norm_coef)."""
    with span("ivfadc.probe"):
        queries = queries.to(torch.float32)
        B, d = queries.shape
        dq = rotation.shape[0]                                # quantizer dim
        if _fused_probe_ok(cq, rotation, queries, w, metric, residual_based):
            # fully fused coarse probe: cells / v / base from one kernel; the
            # rotation is the PQ identity or OPQ's orthogonal Procrustes
            # solution, so the v2 engine's score-derived base holds
            cells, _, v, base = coarse_probe_vbase(
                queries, cq.centroids, w, rotation, apply_rot, include_base,
                engine=coarse_engine, rot_orthogonal=True)
            return cells, v, base, 1.0
        cells, cdists = cq.search(queries, w, extract=extract,
                                  rank_engine=rank_engine)
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
                apply_rot: bool, residual_based: bool, extract: bool = False,
                rank_engine: str | None = None, rows: int | None = None):
    """LUT search: coarse probe -> ADC tables -> posting scan -> k smallest,
    in query blocks that bound the scan's (queries, w, window) temporaries.
    Returns raw (ids, dists); the caller applies `metric.finalize`. `rows`:
    the leading query rows that are not padding, for `counting()` (None:
    all)."""
    from ivfadc_tpu_torch.ops.adc import build_adc_tables, scan_postings
    queries = queries.to(torch.float32)
    d = queries.shape[1]
    dq = rotation.shape[0]
    block = max(1, _LUT_BLOCK_ELEMS // (w * window))
    outs = []
    for s in range(0, queries.shape[0], block):
        q = queries[s:s + block]
        with span("ivfadc.probe"):
            cells, cdists = cq.search(q, w, extract=extract,
                                      rank_engine=rank_engine)  # (b, w)
            cent = cq.centroids[cells.to(torch.int64)]          # (b, w, d)
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
            tables = build_adc_tables(metric, vecs, codebooks)  # (b,w,m,kq)
        t = tally()
        if t is not None:
            t.probed(cells, view["sizes"],
                     None if rows is None else max(0, rows - s))
            t.scanned(q.shape[0] * w * window)
        outs.append(scan_postings(
            tables, base, cells, view["offsets"], view["sizes"],
            view["codes"], view["ids"], k=k, window=window))
    if len(outs) == 1:
        return outs[0]
    with span("ivfadc.merge"):
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))


def _pad_to_k(out_ids, out_dists, k):
    k_eff = out_dists.shape[1]
    if k_eff < k:
        pad = k - k_eff
        out_ids = torch.nn.functional.pad(out_ids, (0, pad), value=-1)
        out_dists = torch.nn.functional.pad(out_dists, (0, pad),
                                            value=float("inf"))
    return out_ids, out_dists


def _topk_ids(flat_d, flat_i, k, engine: str = "pallas"):
    """Top-k over id-payload candidate rows -> ((B, k) ids, (B, k) dists),
    inf-padded past the per-query candidate supply. `engine` is
    IVFADC_MERGE_TOPK: "approx[:<recall>]" selects the JAX package's
    lax.approx_min_k, which is exact off the TPU (a full sort); the port
    serves it with the exact payload top-k kernel, as "pallas"."""
    from ivfadc_tpu_torch.ops.topk import topk_lastdim_payload
    if engine != "pallas" and not engine.startswith("approx"):
        raise ValueError(f"IVFADC_MERGE_TOPK must be 'pallas' or 'approx', "
                         f"got {engine!r}")
    k_eff = min(k, flat_d.shape[1])
    if flat_d.shape[1] % 128 != 0:
        pad = 128 - flat_d.shape[1] % 128
        flat_d = torch.nn.functional.pad(flat_d, (0, pad), value=float("inf"))
        flat_i = torch.nn.functional.pad(flat_i, (0, pad), value=-1)
    out_dists, out_ids = topk_lastdim_payload(flat_d, flat_i, k_eff)
    out_ids = torch.where(torch.isfinite(out_dists), out_ids, -1)
    return _pad_to_k(out_ids, out_dists, k)


def _topk_positions(flat_d, flat_p, k, cells, offsets, n_cand, ids,
                    merge: str = "fold"):
    """Top-k over position-payload candidate rows, resolving the winners to
    slot positions and external ids -> ((B, k) ids, (B, k) dists). Fold
    payloads are cell-relative 128-row block indices; exact-merge payloads
    are absolute slots."""
    from ivfadc_tpu_torch.ops.topk import topk_lastdim
    k_eff = min(k, flat_d.shape[1])
    out_dists, which = topk_lastdim(flat_d, k_eff)
    which = which.to(torch.int64)
    sel = torch.gather(flat_p, 1, which).to(torch.int64)
    if merge == "fold":
        # re-attach the winning probe's cell offset (k values per query);
        # the lane within its bank is the row within the block
        probe = which // n_cand                               # (B, k_eff)
        start = torch.gather(offsets.to(torch.int64)[cells.to(torch.int64)],
                             1, probe)
        pos = torch.where(sel >= 0, start + sel * 128 + which % 128, -1)
    else:
        pos = sel
    out_ids = torch.where(pos >= 0, ids[torch.clamp_min(pos, 0)], -1)
    out_ids = torch.where(torch.isfinite(out_dists), out_ids, -1) \
        .to(torch.int32)
    return _pad_to_k(out_ids, out_dists, k)


def _dense_finish(cells, v, base, dev, *, k, w, chunk, pb, nf, norm_coef,
                  merge: str = "fold", pos8: bool = False,
                  extract: bool = False, rank_engine: str | None = None,
                  merge_topk: str = "pallas", gather_win: int = 0,
                  gather_all: bool = False, rows: int | None = None):
    """Scan + merge (the JAX `_dense_finish`): returns raw (ids, dists);
    the caller applies `metric.finalize`. Batches whose probes share cells
    (B*w >= 4*kc) take the cell-grouped scan, smaller ones the per-probe
    scan; with a gather window (`_gather_plan`) the cells within it go to
    the gathered engine instead, all of them when `gather_all`. `rows`:
    the leading query rows that are not padding, for `counting()` (None:
    all)."""
    B = cells.shape[0]
    kc_ = dev["offsets"].shape[0]
    k_out = min(k, 128)
    n_lanes = nf if merge == "fold" else 128
    t = tally()
    if t is not None:
        _count_dense(t, cells, dev, w=w, pb=pb, gather_win=gather_win,
                     gather_all=gather_all, rows=rows)
    if B * w >= 4 * kc_:
        from ivfadc_tpu_torch.ops.dense_scan import grouped_dense_scan
        # id emission needs the fold and 128-row cells; extraction needs id
        # emission, and runs with the row norms computed in the kernel; a
        # score without a norm term (inner product) reads no norms stream
        emit_ids = merge == "fold" and dev["ids2d"] is not None
        extract_k = k_out if (emit_ids and 2 * k_out <= 128
                              and extract) else 0
        use_norms = (dev["norms2d"] is not None and emit_ids
                     and not extract_k and norm_coef != 0.0)
        out_d, out_p = grouped_dense_scan(
            cells, dev["offsets"], dev["sizes"], v, base, dev["decoded"],
            dev["scale"], dev["ids2d"] if emit_ids else None,
            dev["norms2d"] if use_norms else None, kc=kc_, k_out=k_out,
            chunk=chunk, norm_coef=norm_coef, pb=pb, merge=merge, nf=n_lanes,
            pos8=pos8, extract_k=extract_k, rank_engine=rank_engine)
        with span("ivfadc.merge"):
            n_cand = out_d.shape[-1]
            flat_d = out_d.reshape(B, w * n_cand)
            flat_p = out_p.reshape(B, w * n_cand)
            if emit_ids:
                return _topk_ids(flat_d, flat_p, k, merge_topk)
            return _topk_positions(flat_d, flat_p, k, cells, dev["offsets"],
                                   n_cand, dev["ids"], merge)
    # mostly-distinct cells: grouping would emit about one tile per probe
    from ivfadc_tpu_torch.ops.dense_scan import dense_scan
    with span("ivfadc.tileprep"):
        cells64 = cells.to(torch.int64)
        starts_p = dev["offsets"][cells64]
        sizes_p = dev["sizes"][cells64]
    g_res = None
    if gather_win:
        # tiny cells: gather exactly the probed rows and score them as one
        # batched contraction; larger cells stay on the scan kernel
        from ivfadc_tpu_torch.ops.gather_scan import gathered_scan
        with span("ivfadc.tileprep"):
            small = sizes_p <= gather_win
            g_sizes = torch.where(small, sizes_p, 0)
        gd, gi = gathered_scan(starts_p, g_sizes, v, base, dev["decoded"],
                               dev["scale"], dev["ids"], win=gather_win,
                               norm_coef=norm_coef)
        with span("ivfadc.merge"):
            g_res = _topk_ids(gd.reshape(B, w * gather_win),
                              gi.reshape(B, w * gather_win), k)
        if gather_all:
            return g_res
        with span("ivfadc.tileprep"):
            sizes_p = torch.where(small, 0, sizes_p)
    out_d, out_p = dense_scan(
        starts_p, sizes_p, v, base, dev["decoded"], dev["scale"],
        k_out=k_out, chunk=chunk, norm_coef=norm_coef, merge=merge,
        nf=n_lanes)
    with span("ivfadc.merge"):
        n_cand = out_d.shape[-1]
        s_res = _topk_positions(out_d.reshape(B, w * n_cand),
                                out_p.reshape(B, w * n_cand), k, cells,
                                dev["offsets"], n_cand, dev["ids"], merge)
        if g_res is None:
            return s_res
        # hybrid merge: every global winner is in one side's top-k
        return _topk_ids(torch.cat([g_res[1], s_res[1]], dim=1),
                         torch.cat([g_res[0], s_res[0]], dim=1), k)


def _count_dense(t, cells, view, *, w: int, pb: int, gather_win: int = 0,
                 gather_all: bool = False, rows: int | None = None) -> None:
    """A dense search's device counts (`profiling.counting`) from its probed
    cells (B, w) and its dense view: the postings the first `rows` query
    rows probe, and by the route's loop bounds the pairs its scan scores
    and the cache rows it streams, at the view's row bytes (grouped or
    qc: `grouped_rows` rows, tile_height(pb) pairs a row; per probe: the
    probed cells' sizes, less those the gathered engine takes at
    `gather_win` rows a probe, one pair a row)."""
    sizes = view["sizes"]
    row_bytes = view["decoded"].shape[1] * view["decoded"].element_size()
    t.probed(cells, sizes, rows)
    if cells.shape[0] * w >= 4 * sizes.shape[0]:
        from ivfadc_tpu_torch.ops.dense_scan import grouped_rows, tile_height
        n = grouped_rows(cells, sizes, kc=sizes.shape[0], pb=pb)
        t.scanned(n * tile_height(pb))
        t.streamed(n * row_bytes)
        return
    sizes_p = sizes[cells.to(torch.int64)]
    if gather_win:
        t.scanned(cells.numel() * gather_win)
        t.streamed(cells.numel() * gather_win * row_bytes)
        if gather_all:
            return
        sizes_p = torch.where(sizes_p <= gather_win, 0, sizes_p)
    n = sizes_p.sum()
    t.scanned(n)
    t.streamed(n * row_bytes)


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


def _pad_rows(q: torch.Tensor, rows: int) -> torch.Tensor:
    """q (B, d) with zero rows appended up to `rows`."""
    if q.shape[0] == rows:
        return q
    return torch.nn.functional.pad(q, (0, 0, 0, rows - q.shape[0]))


def _to_host(ids: torch.Tensor, dists: torch.Tensor
             ) -> Tuple[np.ndarray, np.ndarray]:
    """One search's results as host arrays. From a card they land in
    page-locked buffers (`graphs.stage_host`), which the arrays hold until
    they are freed."""
    if not ids.is_cuda:
        return ids.cpu().numpy(), dists.cpu().numpy()
    (ids, dists), done = graphs.stage_host((ids, dists))
    done.synchronize()
    return ids.numpy(), dists.numpy()


def _host_rows(chunk) -> np.ndarray:
    """A chunk of the stream as a host array (tensors are copied over)."""
    if isinstance(chunk, torch.Tensor):
        return chunk.cpu().numpy()
    return np.asarray(chunk)


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
        cmetric = get_metric(config.coarse_metric)
        qmetric = get_metric(config.quantization_metric)
        timer = BuildTimer(dev)
        xd = torch.as_tensor(data, device=dev).to(torch.float32)
        cres, residuals, quantizer = _train_components(
            xd, config, cmetric, qmetric, timer)
        with timer.phase("encode"):
            codes = pq_ops.encode(quantizer, residuals, metric=qmetric)
            del residuals, xd
        # the cells are k-means' final assignment pass (`assign_blocks`'s
        # arithmetic), as build_streaming's pass 2 assigns its chunks
        return cls._finish_build(config, cres.assignments, codes,
                                 cres.centers, quantizer, cmetric, data_dtype,
                                 d, timer)

    @classmethod
    def _finish_build(cls, config, assignments, codes, centers, quantizer,
                      cmetric, data_dtype, d, timer) -> "IVFADCIndex":
        """Padded CSR from (assignments, codes) on the device, then the
        coarse quantizer: the last steps of both builds."""
        with timer.phase("build_lists"):
            # 128-row cell alignment lets the grouped scan read posting ids
            # in (rows/128, 128) layout and emit external ids; huge-kc
            # indexes serve the per-probe scan and keep the tight 8 rows
            align = config.cell_align or (128 if config.kc <= 16384 else 8)
            store = PostingStore.build_device(assignments, codes, config.kc,
                                              slack=config.cell_slack,
                                              align=align)
        with timer.phase("coarse_quantizer"):
            coarse = make_coarse_quantizer(
                config.coarse_quantizer, centers, cmetric,
                generator=make_generator(config.seed, _STREAM_COARSE_GROUPS,
                                         codes.device),
                n_groups=config.coarse_n_groups,
                n_probe_groups=config.coarse_probe_groups)
        idx = cls(config, coarse, quantizer, store, data_dtype, d)
        idx.build_timings = timer.timings
        return idx

    @classmethod
    def build_streaming(cls, chunks, config: Optional[IVFADCConfig] = None,
                        *, train_data=None, train_sample: int = 1 << 18,
                        device=None, _sharded: bool = False,
                        **kwargs) -> "IVFADCIndex":
        """Out-of-core build: index data that never fits in memory at once.

        `chunks` is a RE-ITERABLE of (b, d) float arrays (or tensors), e.g.
        a `utils.datasets.VecsChunks` over TEXMEX files or a list of
        arrays; a one-shot generator is rejected (two passes are needed).

        Pass 1 reservoir-samples up to `train_sample` points, uniformly
        over the whole stream (Algorithm R on NumPy's RandomState seeded by
        `config.seed`, so the sample equals the JAX package's bit for
        bit), and trains the coarse k-means and the PQ/OPQ codebooks on it
        on `device` (default "cuda"; a CUDA `train_data` keeps its
        device). With `train_data` given, pass 1 is skipped and training
        runs on it. Pass 2 re-streams the chunks: each is copied to the
        device, assigned by k-means' own final-pass arithmetic
        (`ops.kmeans.assign_blocks`, in blocks of the training's block
        size) and PQ-encoded there; the (assignment, code) pairs, n * (4 +
        m) bytes, stay on the device until the one CSR layout pass. Host
        memory holds one chunk of floats at a time, and the host reads
        chunk i + 1 while the device works on chunk i.

        With `train_data` equal to the concatenated stream the result is
        `build(train_data)` bit for bit: the same training, the same cell
        arithmetic, row-independent encoding and the same CSR builder.

        `_sharded=True` (set by `ShardedIVFADCIndex.build_streaming`) lets
        the stream cross the device int32 id cap: the sharded view's
        wide-id mode serves such an index.
        """
        if config is None:
            config = IVFADCConfig(**kwargs)
        elif kwargs:
            raise TypeError("pass either a config or kwargs, not both")
        if device is None and isinstance(train_data, torch.Tensor) \
                and train_data.device.type == "cuda":
            device = train_data.device
        dev = torch.device(device if device is not None else "cuda")
        cmetric = get_metric(config.coarse_metric)
        qmetric = get_metric(config.quantization_metric)
        timer = BuildTimer(dev)

        # --- pass 1: reservoir sample for training (Algorithm R, vectorized
        # per chunk: item t >= S replaces slot r ~ U[0, t] iff r < S; the
        # chunk's independent draws replay the sequential algorithm) ---
        d = None
        if train_data is None:
            rng = np.random.RandomState(config.seed)
            sample = None
            seen = 0
            with timer.phase("sample"):
                for chunk in chunks:
                    chunk = _host_rows(chunk)
                    if chunk.ndim != 2:
                        raise AssertionError(
                            "chunks must be 2-D (b, d) arrays")
                    if d is None:
                        d = chunk.shape[1]
                        sample = np.empty((train_sample, d), np.float32)
                    elif chunk.shape[1] != d:
                        raise AssertionError(
                            f"chunk dim {chunk.shape[1]} != {d}")
                    b = chunk.shape[0]
                    fill = min(b, max(0, train_sample - seen))
                    if fill:
                        sample[seen:seen + fill] = chunk[:fill]
                    if b > fill:
                        draws = rng.randint(
                            0, seen + fill + np.arange(b - fill) + 1)
                        hit = draws < train_sample
                        sample[draws[hit]] = chunk[fill:][hit]
                    seen += b
            if seen == 0:
                raise AssertionError("empty chunk stream")
            train = sample[:min(seen, train_sample)]
            # every validate_for_data check is decidable now: fail before
            # the training and encode passes, not after them
            config.validate_for_data(seen, d, _sharded)
        else:
            train = train_data if isinstance(train_data, torch.Tensor) \
                else np.asarray(train_data, np.float32)
            if train.ndim != 2:
                raise AssertionError("train_data must be 2-D (n, d)")
            d = train.shape[1]
            # sized sources (VecsChunks) give the stream length: fail fast
            # here too; the exact n is validated again after pass 2
            n_hint = getattr(chunks, "n_rows", None)
            if n_hint:
                config.validate_for_data(int(n_hint), d, _sharded)
        if config.k > train.shape[0]:
            raise AssertionError(
                f"training sample ({train.shape[0]}) must hold at least "
                f"k={config.k} points (streamed builds: raise train_sample)")

        xt = torch.as_tensor(train, device=dev).to(torch.float32)
        cres, residuals, quantizer = _train_components(
            xt, config, cmetric, qmetric, timer)
        block = kmeans_block(xt.shape[0], config.kc, config.kmeans_block)
        del residuals, xt                # pass 2 encodes every point anew
        centers = cres.centers

        # --- pass 2: stream the chunks through assign + encode ---
        all_assign, all_codes = [], []
        n = 0
        data_dtype = None
        with timer.phase("encode"):
            for chunk in chunks:
                if not isinstance(chunk, torch.Tensor):
                    chunk = np.asarray(chunk)
                if chunk.ndim != 2:
                    raise AssertionError("chunks must be 2-D (b, d) arrays")
                if chunk.shape[0] == 0:
                    continue
                if data_dtype is None:
                    data_dtype = _np_dtype(chunk.dtype) \
                        if isinstance(chunk, torch.Tensor) else chunk.dtype
                    if not np.issubdtype(data_dtype, np.floating):
                        data_dtype = np.dtype(np.float32)
                if chunk.shape[1] != d:
                    raise AssertionError(f"chunk dim {chunk.shape[1]} != {d}")
                x = torch.as_tensor(chunk, device=dev).to(torch.float32)
                a = assign_blocks(x, centers, metric=cmetric, block=block)
                all_assign.append(a)
                all_codes.append(pq_ops.encode(
                    quantizer, x - centers[a.to(torch.int64)],
                    metric=qmetric))
                n += chunk.shape[0]
        if train_data is None and n != seen:
            raise AssertionError(
                f"chunk stream yielded {seen} rows on pass 1 but {n} on "
                f"pass 2: build_streaming needs a re-iterable source, not "
                f"a one-shot generator")
        if n == 0:
            raise AssertionError("empty chunk stream")
        config.validate_for_data(n, d, _sharded)
        return cls._finish_build(config, torch.cat(all_assign),
                                 torch.cat(all_codes), centers, quantizer,
                                 cmetric, data_dtype, d, timer)

    @classmethod
    def build_from_files(cls, paths, config: Optional[IVFADCConfig] = None,
                         *, chunk_rows: int = 262144,
                         max_rows: Optional[int] = None,
                         train_sample: int = 1 << 18,
                         **kwargs) -> "IVFADCIndex":
        """`build_streaming` over TEXMEX .fvecs/.bvecs files (multiple
        files concatenate in order, as Deep1B's numbered parts do), read
        `chunk_rows` rows at a time; the float data is never resident as
        a whole. Other keywords (`device`, `train_data`, the config's
        fields) pass through."""
        from ivfadc_tpu_torch.utils.datasets import VecsChunks
        return cls.build_streaming(
            VecsChunks(paths, chunk_rows=chunk_rows, max_rows=max_rows),
            config, train_sample=train_sample, **kwargs)

    # ----------------------------------------------------------------- search
    def _device_search(self, queries, k: int, w: int, host: bool = False):
        """Padded fixed-shape search on the index device. queries (B, d)
        numpy array or tensor -> (ids (B, k) i32, dists (B, k) f32), on the
        device or (host) as numpy arrays."""
        with span("ivfadc.setup"):
            if k < 1:
                raise AssertionError("k has to be >= 1")
            if w < 1:
                raise AssertionError("w has to be >= 1")
            if len(self) > device_id_cap():
                raise AssertionError(
                    f"{len(self)} vectors exceed the device int32 id cap "
                    f"({device_id_cap()})")
            extract = _env_extract()
            w = min(w, self.config.kc)
            dev = self.device
            q = torch.as_tensor(queries, device=dev).to(torch.float32)
            B = q.shape[0]
            Bp = _bucket_batch(B)
            include_base = (self.config.score_mode == "reference"
                            or not self.quant_metric.residual_based)
            mode = self._resolve_scan_mode()
            if mode == "dense" and k > 128:
                # the dense kernels keep at most 128 candidates per probe
                # lane set; the LUT engine scores every probed posting, so
                # any k is exact there
                mode = "lut"
            key = None
            if mode == "dense":
                plan = self._dense_plan(Bp, w, extract)
                key = self._graph_key(plan, q, Bp, k, w, include_base,
                                      extract)
            else:
                view = self.store.device_view()
            if key is None:
                q = _pad_rows(q, Bp)
        t = tally()
        if t is not None:
            t.search(B, Bp, w)
        if key is not None:
            with span("ivfadc.graph"):
                out = self._graph_search(key, q, Bp, k, w, include_base,
                                         extract, plan, t, host)
            if out is not None:
                return out
            with span("ivfadc.setup"):          # the key's first call
                q = _pad_rows(q, Bp)
        if mode == "dense":
            out_ids, out_dists, _ = self._dense_search(
                q, k, w, include_base, extract, plan, rows=B)
        else:
            out_ids, out_dists = _lut_search(
                self.coarse, self.quantizer.codebooks,
                self.quantizer.rotation, view, q, k=k, w=w,
                window=self.store.window, metric=self.quant_metric,
                include_base=include_base,
                apply_rot=self.quantizer.method == "opq",
                residual_based=self.quant_metric.residual_based,
                extract=extract, rank_engine=_env_rank_engine(), rows=B)
        with span("ivfadc.merge"):
            out_dists = self.quant_metric.finalize(out_dists)
            if Bp != B:
                out_ids, out_dists = out_ids[:B], out_dists[:B]
        if not host:
            return out_ids, out_dists
        with span("ivfadc.to_host"):
            return _to_host(out_ids, out_dists)

    def _graph_key(self, plan: dict, q, Bp: int, k: int, w: int,
                   include_base: bool, extract: bool) -> Optional[tuple]:
        """The shape key of this dense search's CUDA graph
        (models/graphs.py): everything the captured work depends on. None
        where the search runs eager: off the current CUDA device, or while
        the current stream is capturing already."""
        where = graphs.stream_key(q.device)
        if where is None:
            return None
        p, cfg = plan, self.config
        return (Bp, q.shape[1], k, w, include_base, extract, cfg.scan_pb,
                cfg.scan_fold_lanes, p["engines"]["coarse_engine"],
                p["engines"]["rank_engine"], p["merge_topk"], p["merge"],
                p["apply_rot"], p["qc"], p["gather_win"], p["gather_all"],
                p["chunk"], p["pos8"], id(p["view"]), id(self.coarse),
                id(self.quantizer), where)

    def _graph_search(self, key: tuple, q, Bp: int, k: int, w: int,
                      include_base: bool, extract: bool, plan: dict, t,
                      host: bool):
        """The dense search from the store's graph of `key` -> (ids, dists)
        of q's rows (numpy arrays where `host`), or None where this call
        runs eager (the key's first calls).
        The graph holds the padded batch's route up to `finalize`; the
        counts of an open `counting()` block are summed from its probed
        cells after each replay."""
        def body(static_q):
            ids, dists, cells = self._dense_search(
                static_q, k, w, include_base, extract, plan)
            with span("ivfadc.merge"):
                return ids, self.quant_metric.finalize(dists), cells

        after = None
        if t is not None:
            def after(outs):
                _count_dense(t, outs[2], plan["view"], w=w,
                             pb=self.config.scan_pb,
                             gather_win=plan["gather_win"],
                             gather_all=plan["gather_all"], rows=q.shape[0])
        return self.store.graphs.run(
            key, q, Bp, body, pin=(plan["view"], self.coarse, self.quantizer),
            after=after, host=host)

    def _dense_plan(self, Bp: int, w: int, extract: bool) -> dict:
        """The dense route's host-side choices for a search of Bp padded
        rows: the engines, the dense view, the merge, the scan chunk, the
        gather plan, the pos8 gate and whether the qc route serves the
        batch."""
        gather_win, gather_all = self._gather_plan()
        engines = dict(coarse_engine=_env_coarse_engine(),
                       rank_engine=_env_rank_engine())
        merge_topk, vbase = _env_merge_topk(), _env_vbase()
        view = self.store.device_view_dense(self.quantizer,
                                            self.config.scan_chunk,
                                            cache=self._resolve_cache())
        merge = self._resolve_merge_mode()
        qc = vbase == "qc" and not gather_win and \
            self._qc_ok(Bp, w, view, merge, extract)
        return dict(
            engines=engines, merge_topk=merge_topk, view=view, merge=merge,
            apply_rot=self.quantizer.method == "opq", qc=qc,
            gather_win=gather_win, gather_all=gather_all,
            chunk=self._effective_chunk(),
            # int8 block indices while every cell holds at most 127 blocks
            pos8=bool(int(self.store.caps.max(initial=0)) <= 127 * 128))

    def _dense_search(self, q, k: int, w: int, include_base: bool,
                      extract: bool, plan: dict, rows: int | None = None):
        """The dense route over the padded batch q -> raw (ids, dists) and
        the probed cells (B, w)."""
        engines = plan["engines"]
        if plan["qc"]:
            return self._qc_search(q, k, w, include_base, plan["view"],
                                   plan["apply_rot"], plan["merge_topk"],
                                   chunk=plan["chunk"], rows=rows, **engines)
        cells, v, base, norm_coef = _dense_probe(
            self.coarse, self.quantizer.rotation, q, w=w,
            metric=self.quant_metric, include_base=include_base,
            apply_rot=plan["apply_rot"],
            residual_based=self.quant_metric.residual_based, extract=extract,
            **engines)
        return *_dense_finish(
            cells, v, base, plan["view"], k=k, w=w, chunk=plan["chunk"],
            pb=self.config.scan_pb, nf=self.config.scan_fold_lanes,
            norm_coef=norm_coef, merge=plan["merge"], pos8=plan["pos8"],
            extract=extract, rank_engine=engines["rank_engine"],
            merge_topk=plan["merge_topk"], gather_win=plan["gather_win"],
            gather_all=plan["gather_all"], rows=rows), cells

    def _qc_ok(self, B: int, w: int, view, merge: str, extract: bool) -> bool:
        """The JAX package's gate of the qc route, letter for letter: the
        residual sqeuclidean quantizer over the naive sqeuclidean coarse
        quantizer, emitted ids, the fold, no extraction, a grouped batch
        of B padded rows (B*w >= 4*kc) of the counting prep (kc <= 4096),
        and the resident queries (<= 6 MiB) and centroids (<= 4 MiB) in f32
        at d_dec features. (The gate's last term, no gather window, is the
        caller's.)"""
        from ivfadc_tpu_torch.ops.cell_rank import MAX_KC
        kc = view["offsets"].shape[0]
        d_dec = view["decoded"].shape[-1]
        cq = self.coarse
        return (self.quant_metric.residual_based
                and self.quant_metric.name == "sqeuclidean"
                and isinstance(cq, NaiveCoarseQuantizer)
                and cq.metric.name == "sqeuclidean"
                and view["ids2d"] is not None and merge == "fold"
                and not extract and B * w >= 4 * kc and kc <= MAX_KC
                and B * d_dec * 4 <= _QC_MAX_QUERY_BYTES
                and kc * d_dec * 4 <= _QC_MAX_CENT_BYTES)

    def _qc_search(self, q, k: int, w: int, include_base: bool, view,
                   apply_rot: bool, merge_topk: str, *, chunk: int,
                   coarse_engine: str, rank_engine: str,
                   rows: int | None = None):
        """The qc route: cells from the fused probe (its v / base are not
        used) or the quantizer's search, then the grouped scan that derives
        v and base in its kernel, then the id top-k. Raw (ids, dists) and
        the probed cells."""
        from ivfadc_tpu_torch.ops.dense_scan import grouped_dense_scan_qc
        cq, rot = self.coarse, self.quantizer.rotation
        B = q.shape[0]
        kc = view["offsets"].shape[0]
        with span("ivfadc.probe"):
            if _fused_probe_ok(cq, rot, q, w, self.quant_metric, True):
                cells = coarse_probe_vbase(
                    q, cq.centroids, w, rot, apply_rot, include_base,
                    engine=coarse_engine, rot_orthogonal=True)[0]
            else:
                cells, _ = cq.search(q, w, rank_engine=rank_engine)
        t = tally()
        if t is not None:
            _count_dense(t, cells, view, w=w, pb=self.config.scan_pb,
                         rows=rows)
        out_d, out_p = grouped_dense_scan_qc(
            cells, view["offsets"], view["sizes"], q, cq.centroids,
            rot if apply_rot else None, view["decoded"], view["scale"],
            view["ids2d"], kc=kc, chunk=chunk, norm_coef=1.0,
            pb=self.config.scan_pb, nf=self.config.scan_fold_lanes,
            apply_rot=apply_rot, base_mult=2.0 if include_base else 1.0,
            rank_engine=rank_engine)
        with span("ivfadc.merge"):
            n_cand = out_d.shape[-1]
            return _topk_ids(out_d.reshape(B, w * n_cand),
                             out_p.reshape(B, w * n_cand), k,
                             merge_topk) + (cells,)

    def _effective_chunk(self) -> int:
        """Scan chunk adapted to the cell-size distribution: the p95 cell
        capacity rounded up to a scan_fold_lanes multiple, capped at
        scan_chunk. The CUDA kernel walks 128-row groups, so the chunk
        changes no result; it is kept for parity of the configuration.
        Cached on the store per (caps array identity, caps max), as the
        JAX package caches it: caps may grow in place, and the store's
        `_invalidate()` drops the value."""
        store = self.store
        caps = store.caps
        if len(caps) == 0:
            return self.config.scan_chunk
        max_cap = int(caps.max())
        nf, chunk = self.config.scan_fold_lanes, self.config.scan_chunk
        key = (max_cap, nf, chunk)
        cache = store._chunk_cache
        if cache is not None and cache[0] is caps and cache[1] == key:
            return cache[2]
        p95 = int(np.percentile(caps, 95))
        eff = max(nf, min(chunk, ((p95 + nf - 1) // nf) * nf))
        store._chunk_cache = (caps, key, eff)
        return eff

    def _gather_plan(self) -> Tuple[int, bool]:
        """The gathered engine's plan (ops/gather_scan.py::plan_gather):
        (window rows, covers_all). Cached on the store per (caps array
        identity, caps max, scan_gather_win), as the JAX package keys it:
        a cell grown in place past a covers_all window must not keep that
        window, or its postings would drop out of the search."""
        from ivfadc_tpu_torch.ops.gather_scan import plan_gather
        store = self.store
        limit, caps = self.config.scan_gather_win, store.caps
        if not limit or len(caps) == 0:
            return 0, False
        key = (int(caps.max()), limit)
        cache = store._gather_cache
        if cache is not None and cache[0] is caps and cache[1] == key:
            return cache[2]
        plan = plan_gather(caps, limit, max_cap=key[0])
        store._gather_cache = (caps, key, plan)
        return plan

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

    def autotune(self, queries, k: int = 10, w: int = 8, *,
                 pbs: Sequence[int] = (16, 32, 64, 128),
                 chunks: Sequence[int] = (512, 1024, 2048),
                 merges: Sequence[str] = ("fold",),
                 gather_wins: Sequence[Optional[int]] = (None,),
                 reps: int = 5, apply: bool = True) -> dict:
        """Time the dense search of this index under candidate kernel
        parameters (scan_pb x scan_chunk x scan_merge x scan_gather_win)
        on a representative query batch, and apply the fastest to
        `self.config` (which `save()` persists); the config is restored
        between candidates and on exit. Times are `utils.timing.true_time`
        (CUDA events on the card). A candidate that raises is recorded
        with its error and skipped. The grouped kernels run at
        `ops.dense_scan.tile_height(pb)` (pb = 64 and 128 launch the same
        tiles), and the CUDA scans walk 128-row groups whatever the
        chunk, so on the card neither axis changes a result; both are
        swept for parity of the configuration. Returns {"best": row or
        None, "results": [rows], "applied": bool} (and "reason" when the
        dense path is inactive)."""
        import dataclasses
        from ivfadc_tpu_torch.utils.timing import true_time
        if self._resolve_scan_mode() != "dense":
            return {"best": None, "results": [],
                    "applied": False, "reason": "dense scan path inactive"}
        q = queries if isinstance(queries, torch.Tensor) \
            else torch.as_tensor(np.asarray(queries, np.float32))
        q = q.to(self.device, torch.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise AssertionError(
                f"autotune expects (B, {self.dim}) queries, "
                f"got {tuple(q.shape)}")
        orig = self.config
        nf = orig.scan_fold_lanes
        # one dense-view build whose guard rows cover the largest chunk
        max_chunk = max(list(chunks) + [orig.scan_chunk])
        self.store.device_view_dense(self.quantizer, max_chunk,
                                     cache=self._resolve_cache())
        results = []
        try:
            for gw in gather_wins:
                gw_eff = orig.scan_gather_win if gw is None else int(gw)
                for merge in merges:
                    for pb in pbs:
                        for chunk in chunks:
                            if chunk % nf:
                                continue    # the kernels need nf | chunk
                            self.config = dataclasses.replace(
                                orig, scan_pb=pb, scan_chunk=chunk,
                                scan_merge=merge, scan_gather_win=gw_eff)
                            self._drop_plans()
                            row = {"pb": pb, "chunk": chunk, "merge": merge,
                                   "gather_win": gw_eff}
                            try:
                                # two warm calls: the eager one, then the
                                # CUDA graph's capture
                                row["seconds"] = float(true_time(
                                    lambda: self._device_search(q, k, w),
                                    reps=reps, warm=2))
                            except (ValueError, RuntimeError) as e:
                                row["error"] = \
                                    f"{type(e).__name__}: {e}"[:200]
                            results.append(row)
        finally:
            self.config = orig
            self._drop_plans()
        ok = [r for r in results if "seconds" in r]
        best = min(ok, key=lambda r: r["seconds"]) if ok else None
        if best is not None and apply:
            self.config = dataclasses.replace(
                orig, scan_pb=best["pb"], scan_chunk=best["chunk"],
                scan_merge=best["merge"], scan_gather_win=best["gather_win"])
        return {"best": best, "results": results,
                "applied": best is not None and apply}

    def _drop_plans(self) -> None:
        """Drop the scan chunk, gather plan and search graphs cached on the
        store: they are keyed on the caps, not on the config autotune
        swaps."""
        self.store._chunk_cache = None
        self.store._gather_cache = None
        self.store.graphs.clear()

    def search(self, points, k: int, w: int = 1):
        """Single point (d,) -> (ids, dists) trimmed to the valid (<= k)
        results. Batch (B, d) -> (list_of_ids, list_of_dists). Ids are
        0-based, dtype = config.index_dtype."""
        with span("ivfadc.search"):
            if isinstance(points, torch.Tensor):    # stays on its device
                pts = points
                out_dtype = _np_dtype(pts.dtype) \
                    if pts.dtype.is_floating_point else np.dtype(np.float32)
            else:
                pts = np.asarray(points)
                out_dtype = pts.dtype \
                    if np.issubdtype(pts.dtype, np.floating) else np.float32
            single = pts.ndim == 1
            if single:
                pts = pts[None, :]
            if pts.shape[1] != self.dim:
                raise AssertionError(
                    f"query dimension {pts.shape[1]} != index dimension "
                    f"{self.dim}")
            ids, dists = self._device_search(pts, k, w, host=True)
            with span("ivfadc.to_host"):
                id_dtype = np.dtype(self.config.index_dtype)
                if single:
                    m = ids[0] >= 0
                    return (ids[0][m].astype(id_dtype),
                            dists[0][m].astype(out_dtype))
                out_i, out_d = [], []
                for row_i, row_d in zip(ids, dists):
                    m = row_i >= 0
                    out_i.append(row_i[m].astype(id_dtype))
                    out_d.append(row_d[m].astype(out_dtype))
                return out_i, out_d

    def search_padded(self, points, k: int, w: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch search with fixed (B, k) numpy outputs, -1 / +inf padding."""
        with span("ivfadc.search"):
            return self._device_search(points, k, w, host=True)

    def search_stream(self, points, k: int, w: int = 1, *,
                      batch: int = 16384, stats=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Search a large query set in fixed-size batches, queued back to
        back (the host reads nothing until the end), and return the stacked
        padded (N, k) results. `stats`, if given, is a
        `utils.profiling.SearchStats` (any object with `record(n_queries,
        seconds)` will do)."""
        if not isinstance(points, torch.Tensor):
            points = np.asarray(points)
        n = points.shape[0]
        if n == 0:
            return (np.empty((0, k), np.int32), np.empty((0, k), np.float32))
        t0 = time.perf_counter()
        with span("ivfadc.search"):
            outs = [self._device_search(points[s:s + batch], k, w)
                    for s in range(0, n, batch)]
            with span("ivfadc.merge"):
                ids = torch.cat([i for i, _ in outs])
                dists = torch.cat([d for _, d in outs])
            with span("ivfadc.to_host"):
                # pageable: page-locked staging would hold the whole
                # stream's results in torch's host cache for the process
                ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
        if stats is not None:
            stats.record(n, time.perf_counter() - t0)
        return ids, dists

    # ------------------------------------------------------------ dynamic ops
    def _encode_point(self, point: np.ndarray) -> Tuple[int, np.ndarray]:
        """Nearest cell (the coarse search at w = 1) and PQ codes."""
        q = torch.as_tensor(np.asarray(point, np.float32),
                            device=self.device)[None, :]
        cells, _ = self.coarse.search(q, 1)
        cell = int(cells[0, 0])
        residual = q - self.coarse.centroids[cell][None, :]
        codes = pq_ops.encode(self.quantizer, residual,
                              metric=self.quant_metric)
        return cell, codes.cpu().numpy().astype(self.store.code_dtype)[0]

    def _capacity(self) -> int:
        """The id dtype's capacity (the reference's capacity law; host ids
        are int64, so pushes past the device int32 cap succeed and the
        device search raises)."""
        return 1 << DTYPE_TO_BITS[self.config.index_dtype]

    def _check_push(self, point) -> None:
        point = np.asarray(point)
        if point.shape != (self.dim,):
            raise AssertionError(
                f"Wrong point dimension {point.shape}, expected ({self.dim},)")
        if len(self) >= self._capacity():
            raise AssertionError(
                f"Index is full for dtype {self.config.index_dtype} "
                f"({self._capacity()} vectors)")

    def push(self, point) -> None:
        """Append `point` with id n."""
        with span("ivfadc.push"):
            self._check_push(point)
            cell, codes = self._encode_point(point)
            self.store.append(cell, codes, len(self))
            count("pushed_rows")

    def push_batch(self, points) -> None:
        """Append B points at once, ids n..n+B-1: the same index as B
        pushes, from one batched coarse search and one batched encode."""
        with span("ivfadc.push"):
            points = points.to(self.device, torch.float32) \
                if isinstance(points, torch.Tensor) \
                else torch.as_tensor(np.asarray(points, np.float32),
                                     device=self.device)
            if points.ndim != 2 or points.shape[1] != self.dim:
                raise AssertionError(
                    f"push_batch expects (B, {self.dim}) points, got "
                    f"{tuple(points.shape)}")
            if len(self) + len(points) > self._capacity():
                raise AssertionError(
                    f"Index would exceed capacity for dtype "
                    f"{self.config.index_dtype} ({self._capacity()} vectors)")
            if len(points) == 0:
                return
            cells, _ = self.coarse.search(points, 1)
            cells = cells[:, 0].to(torch.int64)
            residuals = points - self.coarse.centroids[cells]
            codes = pq_ops.encode(self.quantizer, residuals,
                                  metric=self.quant_metric)
            self.store.append_batch(cells.cpu().numpy(),
                                    codes.cpu().numpy().astype(
                                        self.store.code_dtype), len(self))
            count("pushed_rows", len(points))

    def push_front(self, point) -> None:
        """Insert `point` with id 0; every live id moves up by one."""
        with span("ivfadc.push"):
            self._check_push(point)
            cell, codes = self._encode_point(point)
            self.store.shift_ids(-1, +1)
            self.store.append(cell, codes, 0)
            count("pushed_rows")

    def _reconstruct_from(self, cell: int, codes: np.ndarray) -> np.ndarray:
        centroid = self.coarse.centroids[cell].cpu().numpy()
        rows = torch.as_tensor(codes[None, :].astype(np.int64),
                               device=self.device)
        resid = pq_ops.decode(self.quantizer, rows)[0].cpu().numpy()
        return (centroid + resid[:self.dim]).astype(self.data_dtype)

    def pop(self) -> np.ndarray:
        """Remove the point with id n-1 and return its reconstruction."""
        n = len(self)
        if n == 0:
            raise IndexError("pop from empty index")
        with span("ivfadc.delete"):
            cell, slot = self.store.find(n - 1)
            codes = self.store.remove_slot(cell, slot)
            count("deleted_rows")
        return self._reconstruct_from(cell, codes)

    def pop_front(self) -> np.ndarray:
        """Remove the point with id 0 and return its reconstruction; every
        other id moves down by one."""
        if len(self) == 0:
            raise IndexError("pop from empty index")
        with span("ivfadc.delete"):
            cell, slot = self.store.find(0)
            codes = self.store.remove_slot(cell, slot)
            self.store.shift_ids(0, -1)
            count("deleted_rows")
        return self._reconstruct_from(cell, codes)

    def delete(self, ids) -> None:
        """Delete by 0-based ids; surviving ids shift down to stay the
        contiguous range 0..n'-1. One id swap-removes and shifts, up to
        2048 take the incremental path (views patched), more the bulk path
        (views rebuilt)."""
        with span("ivfadc.delete"):
            id_list = np.unique(np.asarray(list(ids), np.int64))
            if id_list.size == 1:
                target = int(id_list[0])
                cell, slot = self.store.find(target)
                self.store.remove_slot(cell, slot)
                self.store.shift_ids(target, -1)
            elif id_list.size <= 2048:
                self.store.delete_ids_incremental(id_list)
            else:
                self.store.delete_ids(id_list)
            count("deleted_rows", id_list.size)

    def reconstruct(self, ext_id: int) -> np.ndarray:
        """The stored approximation of a point, from one code row (a single
        device gather while the codes are not on the host)."""
        cell, slot = self.store.find(int(ext_id))
        row = self.store._code_rows(np.asarray([slot]))[0]
        return self._reconstruct_from(cell, row.copy())

    def fork(self) -> "IVFADCIndex":
        """Consistent-snapshot clone: shares the trained components and
        clones the posting store copy-on-write (`PostingStore.fork`), so
        mutations on either side never reach the other's searches."""
        new = IVFADCIndex(self.config, self.coarse, self.quantizer,
                          self.store.fork(), self.data_dtype, self.dim)
        if hasattr(self, "build_timings"):
            new.build_timings = self.build_timings
        return new

    # ------------------------------------------------------------- inspection
    def __len__(self) -> int:
        return self.store.n

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.dim, len(self))

    def bytes_per_vector(self) -> int:
        """Id bytes plus code bytes of one stored vector."""
        id_bytes = DTYPE_TO_BITS[self.config.index_dtype] // 8
        return id_bytes + self.store.code_dtype.itemsize * self.config.m

    def __repr__(self) -> str:
        cq = type(self.coarse).__name__
        return (f"IVFADCIndex ({cq}, {self.config.quantization_method}), "
                f"dim={self.dim}, kc={self.config.kc}, m={self.config.m}, "
                f"k={self.config.k}, {self.bytes_per_vector()}-byte encoding, "
                f"{len(self)} vectors")

    def memory_stats(self) -> dict:
        """Sizes for an operator, with the JAX package's keys and
        accounting: the encoded payload, the CSR capacity and its fill,
        the cell-size distribution, the coarse tables (the two-level
        quantizer's scan table, group centers and members included), the
        codebooks, and, for each device view that exists, its bytes:
        `device_scan_cache_bytes` (the decoded cache plus 4 bytes a row of
        ids2d) and `device_lut_bytes` (codes plus ids). Sizes are read off
        the tensors (`numel() * element_size()`): nothing is copied to the
        host and no view is built."""
        def nbytes(t) -> int:
            return int(t.numel() * t.element_size())

        st = self.store
        sizes = np.asarray(st.sizes)
        live = sizes[sizes > 0]
        id_bytes = DTYPE_TO_BITS[self.config.index_dtype] // 8
        code_bytes = st.code_dtype.itemsize * self.config.m
        out = {
            "n": int(len(self)),
            "bytes_per_vector": self.bytes_per_vector(),
            "encoded_bytes": int(len(self)) * self.bytes_per_vector(),
            "capacity_slots": int(st.total_cap),
            "capacity_bytes": int(st.total_cap) * (id_bytes + code_bytes),
            "fill_ratio": float(len(self) / max(st.total_cap, 1)),
            "cells": {
                "kc": int(self.config.kc),
                "live": int((sizes > 0).sum()),
                "p50": int(np.percentile(live, 50)) if live.size else 0,
                "p95": int(np.percentile(live, 95)) if live.size else 0,
                "max": int(sizes.max(initial=0)),
            },
            "coarse_bytes": nbytes(self.coarse.centroids),
            "codebook_bytes": nbytes(self.quantizer.codebooks),
        }
        if getattr(self.coarse, "kind", "") == "two_level":
            out["coarse_bytes"] += (nbytes(self.coarse.cent_scan)
                                    + nbytes(self.coarse.group_centers)
                                    + nbytes(self.coarse.members))
        dense = st._device_dense
        if dense is not None:
            dec = dense.get("decoded")
            out["device_scan_cache_bytes"] = \
                nbytes(dec) if dec is not None else 0
            ids2d = dense.get("ids2d")
            if ids2d is not None:
                out["device_scan_cache_bytes"] += int(ids2d.numel()) * 4
        if st._device is not None:
            out["device_lut_bytes"] = sum(
                nbytes(a) for key in ("codes", "ids")
                if (a := st._device.get(key)) is not None)
        return out

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
