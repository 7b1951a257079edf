"""Gathered dense scan for tiny cells (port of `ivfadc_tpu/ops/gather_scan.py`).

At huge kc (~2^18) cells hold a handful of postings, and the per-probe scan
kernel walks each probed cell in whole 128-row groups. When every probed
cell fits a small window, the probed rows are gathered instead and scored
as one batched contraction:

    rows   = decoded[start_p + j]            (P, win, d)   one gather
    scores = rows . v_p + coef * ||rows||^2 + base_p       one batched matmul

The score formula is the scan kernels' (bf16 rows and scan vectors, f32
sums; the row norms square in bf16 as the JAX engine's `jnp.sum(rows *
rows)` does). Cells larger than the window are the caller's
(`models/index.py::_dense_finish`): their probes are skipped here and
scanned by the per-probe kernel, and the two candidate lists merge exactly.
The JAX engine has no `pallas_call`; this one is plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ivfadc_tpu_torch.utils.profiling import span

# elements of one block's (probes, win, d) row gather; larger probe sets
# are scored in blocks of probes (results do not change: probes are
# independent)
_BLOCK_ELEMS = 1 << 26


def gathered_scan(starts, sizes, v, base, decoded,
                  scale: Optional[torch.Tensor] = None,
                  ids: Optional[torch.Tensor] = None, *, win: int,
                  norm_coef: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score up to `win` postings of each probed cell.

    starts/sizes (B, w) int — slot ranges of the probed cells (a size of 0
                               skips the probe; callers zero sizes > win)
    v            (B, w, d)  — score vectors (e.g. -2 * rotated residual)
    base         (B, w) f32 — per-probe additive constants
    decoded      (rows, d_pad) bf16 or int8 — resident decoded residuals
    scale        (d_pad,) f32 — int8 dequantization scales (int8 cache only)
    ids          (rows,) i32 — external ids per slot (None: slot indices)

    Returns (dists (B, w, win) f32, ids (B, w, win) i32) with +inf / -1 in
    lanes past each cell's size."""
    with span("ivfadc.scan"):
        if v.shape[-1] != decoded.shape[-1]:    # decoded is lane-padded
            v = torch.nn.functional.pad(
                v, (0, decoded.shape[-1] - v.shape[-1]))
        B, w, d = v.shape
        P = B * w
        j = torch.arange(win, dtype=torch.int64, device=v.device)[None, :]
        valid = j < sizes.reshape(P, 1).to(torch.int64)          # (P, win)
        idx = torch.where(valid, starts.reshape(P, 1).to(torch.int64) + j, 0)
        idx = torch.clamp_max(idx, decoded.shape[0] - 1)
        vb = v.reshape(P, d).to(torch.bfloat16)
        sc = None if scale is None else scale.to(torch.bfloat16)
        base = base.reshape(P, 1).to(torch.float32)
        block = max(1, _BLOCK_ELEMS // max(1, win * d))
        outs = []
        for s in range(0, P, block):
            rows = decoded[idx[s:s + block]].to(torch.bfloat16)  # (p,win,d)
            if sc is not None:
                rows = rows * sc
            # bf16 values multiply exactly in f32, which sums them
            scores = torch.bmm(
                rows.to(torch.float32),
                vb[s:s + block, :, None].to(torch.float32))[..., 0]
            if norm_coef != 0.0:
                scores = scores + norm_coef * (rows * rows).to(
                    torch.float32).sum(-1)
            outs.append(scores + base[s:s + block])
        scores = torch.cat(outs) if outs else base.new_empty((0, win))
        scores = torch.where(valid, scores, float("inf"))
        payload = ids[idx].to(torch.int64) if ids is not None else idx
        out_ids = torch.where(valid, payload, -1).to(torch.int32)
        return scores.reshape(B, w, win), out_ids.reshape(B, w, win)


def plan_gather(caps, limit: int, max_cap=None) -> Tuple[int, bool]:
    """The gather engine's plan: (window rows, covers_all).

    caps: cell capacities (zeros ignored). max_cap overrides the max used
    for the covers_all decision. covers_all=True promises the window bounds
    every cell capacity (sizes never exceed caps), so the scan kernel is
    skipped entirely; otherwise the window is the p95 capacity and larger
    cells fall back to the scan kernel at search time."""
    caps = np.asarray(caps)
    caps = caps[caps > 0]
    if not limit or caps.size == 0:
        return 0, False

    def up8(x):
        return ((max(int(x), 1) + 7) // 8) * 8

    mc = int(max_cap) if max_cap is not None else int(caps.max())
    win_max = up8(mc)
    if win_max <= limit:
        return win_max, True
    win95 = up8(np.percentile(caps, 95))
    return (win95, False) if win95 <= limit else (0, False)
