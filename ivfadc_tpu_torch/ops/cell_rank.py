"""Stable rank of each probe within its cell, plus the per-cell histogram.

Port of `ivfadc_tpu/ops/cell_rank.py::cell_ranks` (the v1 engine). The
CUDA kernel is `csrc/cell_rank.cu` (block histograms, a per-cell scan over
blocks, then in-block ranks: deterministic, no order-dependent atomics);
`cell_ranks_plain` computes the same function with a stable sort.

    rank[p] = #{p' < p : cells[p'] == cells[p]}

The sorted position of probe p is then cell_first[cells[p]] + rank[p].
"""

from __future__ import annotations

import torch

from ivfadc_tpu_torch import _build

MAX_KC = 4096        # the JAX kernel's bound; larger kc uses a sort-based prep
_BLK = 1024          # probes per block of the CUDA kernel

KERNEL = _build.Kernel("cell_rank", "cell_ranks",
                       [_build.P, _build.I, _build.I, _build.P, _build.P,
                        _build.P, _build.P])


def cell_ranks_plain(cells_flat: torch.Tensor, kc: int):
    """Plain version: stable sort by cell, rank = position in the run."""
    c = cells_flat.to(torch.int64)
    P = c.shape[0]
    order = torch.argsort(c, stable=True)
    sorted_c = c[order]
    first = torch.searchsorted(sorted_c, sorted_c)      # run start per entry
    ranks = torch.empty(P, dtype=torch.int32, device=c.device)
    ranks[order] = (torch.arange(P, device=c.device) - first).to(torch.int32)
    valid = (c >= 0) & (c < kc)
    counts = torch.bincount(c[valid], minlength=kc).to(torch.int32)
    return ranks, counts


def cell_ranks(cells_flat: torch.Tensor, *, kc: int):
    """cells_flat (P,) i32 in [0, kc) -> (rank (P,) i32, counts (kc,) i32).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if kc > MAX_KC:
        raise ValueError(f"cell_ranks needs kc <= {MAX_KC}, got {kc}")
    if cells_flat.device.type == "cpu":
        return cell_ranks_plain(cells_flat, kc)
    cells = cells_flat.to(torch.int32).contiguous()
    P = cells.shape[0]
    dev = cells.device
    ranks = torch.empty(P, dtype=torch.int32, device=dev)
    counts = torch.empty(kc, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(1, -(-P // _BLK)) * kc, dtype=torch.int32,
                          device=dev)
    KERNEL(cells.data_ptr(), P, kc, ranks.data_ptr(), counts.data_ptr(),
           scratch.data_ptr(), _build.stream_ptr(dev))
    return ranks, counts
