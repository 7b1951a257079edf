"""Stable rank of each probe within its cell, the per-cell histogram and the
grouped scan's tile layout.

Port of `ivfadc_tpu/ops/cell_rank.py::cell_ranks`, both engines, fused with
the tile bookkeeping that follows it in the JAX package's grouped scan
(`ops/pallas_scan.py:631-653`: `_tile_map` and the `row` / `inv_row`
lines). The CUDA kernel is `csrc/cell_rank.cu`: one cooperative launch
whose persistent blocks count their probes' cells, scan the counts over the
blocks behind a grid barrier, then rank their probes (warp match masks and
a warp-ordered walk over shared per-cell counters) and, in tile mode, lay
out the tiles. Its entry points `cell_ranks` (kernel `_rank_kernel`, "v1")
and `cell_ranks_v2` (`_rank_kernel_v2`) run one design and keep their own
launch counters. The results are deterministic (no order-dependent
atomics) and equal, bit for bit, the plain versions:

    rank[p] = #{p' < p : cells[p'] == cells[p]}            (a stable sort)

and, in tile mode (`tile_slots`), cell c owning ceil(counts[c] / pb) tiles
from tile_base[c] (the exclusive scan of those), probe p in slot
row[p] = tile_base[c] * pb + rank[p], inv_row the inverse (P on an empty
slot).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ivfadc_tpu_torch import _build

MAX_KC = 4096        # the JAX kernel's bound; larger kc uses a sort-based prep

# Fallback engine when a caller omits `engine`, read once at import as the
# JAX package reads it; the index's dispatch sites read IVFADC_RANK_ENGINE
# per search and pass it explicitly.
_DEFAULT_ENGINE = os.environ.get("IVFADC_RANK_ENGINE", "v1")

_P, _I = _build.P, _build.I
# cells, P, kc, ranks, counts, offsets, sizes, pb, T_max, c_t, tile_start,
# tile_size, row, inv_row, scratch, max_grid, stream
_ARGS = [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P]
KERNEL = _build.Kernel("cell_rank", "cell_ranks", _ARGS)
KERNEL_V2 = _build.Kernel("cell_rank", "cell_ranks_v2", _ARGS)
KERNELS = {"v1": KERNEL, "v2": KERNEL_V2}
FIT = _build.HostFn("cell_rank", "cell_rank_fit",
                    [_I, _I, ctypes.POINTER(ctypes.c_int)])

_FIT_KEYS = ("blocks_per_sm", "sms", "max_grid", "smem_bytes", "registers",
             "spill_bytes")
_plans: dict = {}
_plans_lock = threading.Lock()


def rank_fit(dev, kc: int, tiles: bool) -> dict:
    """The kernel's launch shape for kc on device `dev`: resident blocks
    per SM, SMs, the largest (cooperative) grid, shared bytes, registers
    and spilled bytes a thread."""
    return _plan(dev, kc, tiles)[0]


def _plan(dev, kc: int, tiles: bool):
    """(launch shape, scratch) per (device, kc, mode), made once under a
    lock, so threads share one scratch: it holds the grid barrier's two
    words, zero between calls (the kernel resets them), and the (grid, kc)
    block-count table. Calls on one device share it, so they must come in
    order (one stream: threads that set no stream of their own all launch
    on the device's default stream)."""
    key = (dev.index, kc, tiles)
    plan = _plans.get(key)
    if plan is None:
        with _plans_lock:
            plan = _plans.get(key)
            if plan is None:
                out = (ctypes.c_int * 6)()
                with torch.cuda.device(dev):
                    FIT(kc, int(tiles), out)
                fit = dict(zip(_FIT_KEYS, out))
                scratch = torch.zeros(4 + fit["max_grid"] * kc,
                                      dtype=torch.int32, device=dev)
                plan = _plans[key] = (fit, scratch)
    return plan


def _engine(engine: str | None) -> str:
    if engine is None:
        engine = _DEFAULT_ENGINE
    if engine not in KERNELS:
        raise ValueError(f"rank engine must be 'v1' or 'v2', got {engine!r}")
    return engine


def t_max(P: int, kc: int, pb: int) -> int:
    """An upper bound on the tiles P probes over kc cells need."""
    return P // pb + min(kc, P) + 1


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


def tile_layout(ranks, counts, cells_flat, offsets, sizes, *, kc: int,
                pb: int):
    """The tile bookkeeping of the JAX `grouped_dense_scan` as tensor code
    (`_tile_map` and the `row` / `inv_row` lines): cell c owns
    ceil(counts[c]/pb) consecutive tiles from tile_base[c]. Returns (c_t,
    tile_start, tile_size (T_max,) i32: each tile's cell (clamped to kc - 1
    past the last tile needed) and cell row range (zero past the last
    tile); row (P,) each probe's slot; inv_row (T_max*pb,) each slot's
    probe, P on an empty slot; both int64, torch's index type, so the
    gathers they drive convert nothing). The plain half of `tile_slots`,
    and the layout of the sort-based prep (kc > MAX_KC)."""
    dev = counts.device
    P = cells_flat.shape[0]
    T_max = t_max(P, kc, pb)
    nt = (counts.to(torch.int64) + pb - 1) // pb          # tiles per cell
    tile_base = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           torch.cumsum(nt, 0)[:-1]])
    trange = torch.arange(T_max, dtype=torch.int64, device=dev)
    c_t = torch.clamp(torch.searchsorted(tile_base, trange, right=True) - 1,
                      0, kc - 1)
    tile_valid = trange < torch.sum(nt)
    tile_start = torch.where(tile_valid, offsets.to(torch.int64)[c_t], 0)
    tile_size = torch.where(tile_valid, sizes.to(torch.int64)[c_t], 0)
    ranks = ranks.to(torch.int64)
    row = (tile_base[cells_flat.to(torch.int64)] + ranks // pb) * pb \
        + ranks % pb
    # invert `row` (slot -> probe; unwritten slots point at P)
    inv_row = torch.full((T_max * pb,), P, dtype=torch.int64, device=dev)
    inv_row[row] = torch.arange(P, dtype=torch.int64, device=dev)
    return (c_t.to(torch.int32), tile_start.to(torch.int32),
            tile_size.to(torch.int32), row, inv_row)


def tile_slots_plain(cells_flat, offsets, sizes, *, kc: int, pb: int):
    """Plain version of the fused call: `cell_ranks_plain`, then
    `tile_layout`. Returns (counts, c_t, tile_start, tile_size, row,
    inv_row) as `tile_slots` does."""
    ranks, counts = cell_ranks_plain(cells_flat, kc)
    return (counts,) + tile_layout(ranks, counts, cells_flat, offsets, sizes,
                                   kc=kc, pb=pb)


def _launch(engine, cells, kc: int, ranks, counts, offsets=None,
            sizes=None, pb: int = 0, T_max: int = 0, tiles=()) -> None:
    """One launch of `engine`'s entry point; `tiles` the five tile-mode
    outputs (c_t, tile_start, tile_size, row, inv_row), or none."""
    dev = cells.device
    fit, scratch = _plan(dev, kc, offsets is not None)
    ptr = [None] * 5 if not tiles else [t.data_ptr() for t in tiles]
    KERNELS[engine](
        cells.data_ptr(), cells.shape[0], kc,
        None if ranks is None else ranks.data_ptr(), counts.data_ptr(),
        None if offsets is None else offsets.data_ptr(),
        None if sizes is None else sizes.data_ptr(), pb, T_max, *ptr,
        scratch.data_ptr(), fit["max_grid"], _build.stream_ptr(dev))


def _cells_i32(cells_flat, kc: int):
    if kc > MAX_KC or kc < 1:
        raise ValueError(f"the counting ranks need 1 <= kc <= {MAX_KC}, "
                         f"got {kc}")
    return cells_flat.reshape(-1).to(torch.int32).contiguous()


def cell_ranks(cells_flat: torch.Tensor, *, kc: int,
               engine: str | None = None):
    """cells_flat (P,) i32 in [0, kc) -> (rank (P,) i32, counts (kc,) i32).

    `engine` "v1" or "v2" picks the CUDA entry point (default:
    IVFADC_RANK_ENGINE at import). CPU tensors run the plain version; CUDA
    tensors launch the kernel once. A cell outside [0, kc) is counted
    nowhere; on the card its rank is the number of earlier equal cells in
    its 32-aligned warp of probes, in both engines."""
    engine = _engine(engine)
    cells = _cells_i32(cells_flat, kc)
    if cells.device.type == "cpu":
        return cell_ranks_plain(cells, kc)
    P = cells.shape[0]
    ranks = torch.empty(P, dtype=torch.int32, device=cells.device)
    counts = torch.empty(kc, dtype=torch.int32, device=cells.device)
    _launch(engine, cells, kc, ranks, counts)
    return ranks, counts


def tile_slots(cells_flat, offsets, sizes, *, kc: int, pb: int,
               engine: str | None = None):
    """The grouped scan's tile prep in one call: cells_flat (P,) in
    [0, kc), offsets / sizes (kc,) the cells' slot ranges -> (counts (kc,),
    c_t, tile_start, tile_size (T_max,) i32, row (P,), inv_row (T_max*pb,)
    int64), T_max = `t_max(P, kc, pb)`; see `tile_layout`. CPU tensors
    run the plain version (`tile_slots_plain`); CUDA tensors launch the
    kernel of `engine` once, with nothing read back to the host."""
    engine = _engine(engine)
    cells = _cells_i32(cells_flat, kc)
    if cells.device.type == "cpu":
        return tile_slots_plain(cells, offsets, sizes, kc=kc, pb=pb)
    dev = cells.device
    P = cells.shape[0]
    T_max = t_max(P, kc, pb)
    offsets = offsets.to(torch.int32).contiguous()
    sizes = sizes.to(torch.int32).contiguous()
    for name, t in (("offsets", offsets), ("sizes", sizes)):
        if t.device != dev or t.shape != (kc,):
            raise ValueError(f"{name} must be ({kc},) on {dev}")
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    counts = torch.empty(kc, **i32)
    # one allocation each: the grouped scan wants its inputs 16-byte aligned
    tiles = (torch.empty(T_max, **i32), torch.empty(T_max, **i32),
             torch.empty(T_max, **i32), torch.empty(P, **i64),
             torch.empty(T_max * pb, **i64))
    _launch(engine, cells, kc, None, counts, offsets, sizes, pb, T_max,
            tiles)
    return (counts,) + tiles
