"""Recall evaluation (port of `ivfadc_tpu/utils/evaluation.py`): exact
brute-force ground truth, blocked over the base set, plus recall@R."""

from __future__ import annotations

import numpy as np
import torch


def brute_force_topk(base, queries, k: int, block: int = 65536):
    """Exact squared-euclidean top-k neighbors -> (dists, ids) numpy arrays.
    Runs on the device of `queries` when it is a tensor, else on the device
    of `base`; `base` blocks are moved there one at a time."""
    if isinstance(queries, torch.Tensor):
        dev = queries.device
    elif isinstance(base, torch.Tensor):
        dev = base.device
    else:
        dev = torch.device("cpu")
    q = torch.as_tensor(queries, device=dev).to(torch.float32)
    qn = torch.sum(q * q, dim=1, keepdim=True)
    run_d = torch.full((q.shape[0], k), float("inf"), device=dev)
    run_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=dev)
    for start in range(0, base.shape[0], block):
        blk = torch.as_tensor(base[start:start + block],
                              device=dev).to(torch.float32)
        d = qn + torch.sum(blk * blk, dim=1)[None, :] - 2.0 * (q @ blk.T)
        bd, bi = torch.topk(d, min(k, blk.shape[0]), dim=1, largest=False)
        cand_d = torch.cat([run_d, bd], dim=1)
        cand_i = torch.cat([run_i, bi + start], dim=1)
        run_d, which = torch.topk(cand_d, k, dim=1, largest=False)
        run_i = torch.gather(cand_i, 1, which)
    return run_d.cpu().numpy(), run_i.cpu().numpy()


def recall_at_r(found_ids: np.ndarray, gt_ids: np.ndarray, r: int) -> float:
    """Mean |found[:r] ∩ gt[:r]| / r over queries; found may contain -1
    pads, and a repeated id in a found row counts once."""
    f = np.asarray(found_ids)[:, :r]
    g = np.asarray(gt_ids)[:, :r]
    block = max(1, (1 << 26) // max(r * r, 1))
    hits = 0
    for s in range(0, f.shape[0], block):
        fb, gb = f[s:s + block], g[s:s + block]
        first = (fb[:, :, None] == fb[:, None, :]).argmax(axis=2) \
            == np.arange(fb.shape[1])[None, :]
        eq = fb[:, :, None] == gb[:, None, :]
        hits += int((eq.any(axis=2) & (fb >= 0) & first).sum())
    return float(hits) / (f.shape[0] * r)
