"""Asymmetric-distance computation (ADC): table build + posting scan, the
exact LUT engine (port of `ivfadc_tpu/ops/adc.py`).

  * tables are one dense (B, w, m, k) array built by a batched pairwise;
  * the scan gathers a static-width window of each probed cell's slots from
    the flat CSR arrays, does m table lookups, masks the padding with +inf
    and keeps the k best.

Plain tensor code, as in the JAX package (which runs this engine outside
any Pallas kernel), except for the final k-smallest: `torch.topk` promises
no order among equal scores, and two points of one cell with the same PQ
code score bit-equal, so k <= 128 goes through the port's own top-k kernel
and larger k (or candidate rows too long for it) through a stable sort. Both return the lower candidate index
first, as `lax.top_k` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ivfadc_tpu_torch.ops.kmeans import _pairwise
from ivfadc_tpu_torch.ops.metrics import Metric
from ivfadc_tpu_torch.ops.topk import MAX_N, topk_lastdim_payload
from ivfadc_tpu_torch.utils.profiling import span


def build_adc_tables(metric: Metric, residuals: torch.Tensor,
                     codebooks: torch.Tensor) -> torch.Tensor:
    """residuals (..., d) x codebooks (m, k, dsub) -> tables (..., m, k)."""
    m, k, dsub = codebooks.shape
    lead = residuals.shape[:-1]
    r = residuals.reshape(-1, m, dsub).permute(1, 0, 2)    # (m, L, dsub)
    t = _pairwise(metric, r, codebooks)                    # (m, L, k)
    return t.permute(1, 0, 2).reshape(*lead, m, k)


def scan_postings(tables, base, cells, offsets, sizes, codes, ids, *, k: int,
                  window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score every posting in the probed cells and return the k best.

    tables  (B, w, m, kq) f32: ADC lookup tables per query x probe
    base    (B, w) f32: additive per-probe base
    cells   (B, w) i32: probed cell ids
    offsets / sizes (kc,) i32: CSR arrays
    codes   (total_cap, m): flat code storage
    ids     (total_cap,) i32: flat external ids (-1 in padding slots)
    window: gather width, at least every cell's size

    Returns (ids (B, k) i32 with -1 padding, dists (B, k) f32 with +inf
    padding), ascending by distance, equal distances in candidate order."""
    B, w, m, kq = tables.shape
    dev = tables.device
    with span("ivfadc.scan"):
        cells = cells.to(torch.int64)
        starts = offsets.to(torch.int64)[cells]                # (B, w)
        lanes = torch.arange(window, dtype=torch.int64, device=dev)
        valid = lanes[None, None, :] \
            < sizes.to(torch.int64)[cells][..., None]
        pos = torch.where(valid, starts[..., None] + lanes[None, None, :], 0)

        cand_ids = ids[pos].to(torch.int32)                    # (B, w, window)
        acc = base.to(torch.float32)[..., None].expand(B, w, window)
        for j in range(m):
            cj = codes[pos, j].to(torch.int64)                 # (B, w, window)
            acc = acc + torch.gather(tables[:, :, j, :], 2, cj)
        scores = torch.where(valid, acc, float("inf")).reshape(B, w * window)
        cand_ids = cand_ids.reshape(B, w * window)
    with span("ivfadc.merge"):
        k_eff = min(k, w * window)
        if k_eff <= 128 and w * window <= MAX_N:
            out_dists, out_ids = topk_lastdim_payload(scores, cand_ids, k_eff)
        else:
            out_dists, which = torch.sort(scores, dim=1, stable=True)
            out_dists = out_dists[:, :k_eff]
            out_ids = torch.gather(cand_ids, 1, which[:, :k_eff])
        out_ids = torch.where(torch.isfinite(out_dists), out_ids, -1)
        if k_eff < k:
            pad = k - k_eff
            out_ids = torch.nn.functional.pad(out_ids, (0, pad), value=-1)
            out_dists = torch.nn.functional.pad(out_dists, (0, pad),
                                                value=float("inf"))
        return out_ids, out_dists
