"""Dense posting scans (port of `ivfadc_tpu/ops/pallas_scan.py`): the
cell-grouped scan of large batches and the per-probe scan of small ones.

The B*w probes of a search batch are grouped by probed cell into tiles of
pb probes of ONE cell, so each cell's decoded rows are read once per tile
and score all of the tile's probes:

  score(q, x) = base' + v . r_hat + ||r_hat||^2,   v = -2 r,  base' = |r|^2
                                                   (+ coarse distance)

`grouped_dense_scan` holds every variant of the JAX package's grouped scan
that the JAX package reaches, one CUDA kernel template each
(`csrc/dense_scan.cu`, table `GROUPED_KERNELS`):

  "ids"      fold, emitted external ids (ids2d), cached row norms (norms2d):
             the posting scan's default
  "knorm"    fold, emitted ids, row norms computed in the kernel: the
             two-level coarse quantizer's stage 2, and IVFADC_NORMS=off
  "pos8"     fold, cell-relative block-index payloads in int8, in-kernel
  "pos"      norms (int32 below 32-row tiles or past 127 blocks a cell):
             stores without 128-row cells (no ids2d)
  "exact"    merge="exact": a 128-lane buffer that holds each probe's true
             top-k_out distances, absolute slot payloads, in-kernel norms
  "extract"  fold + emitted ids + in-kernel norms, finished in the kernel
             with extract_k min-extract passes (IVFADC_EXTRACT=1)

each over the int8 decoded cache (per-column scale) or the bf16 one (rows
read as they are). The tile prep (`_tile_slots`) lays out the tiles in
one launch of the counting kernel (`cell_rank.tile_slots`, kc <= MAX_KC,
engine v1 or v2: ranks, counts, tile map, `row`, `inv_row`) or by one
sort and `cell_rank.tile_layout` (kc > MAX_KC); `place_tiles` adds the
`inv_row` placement with its zero v-row and +inf base-row. The kernels
write each live slot's row to its probe's index by the same `inv_row`
(the slot map), so the output is in probe order and needs no gather;
`tile_order` is the identity map, which keeps the tile order.

`grouped_dense_scan_qc` (IVFADC_VBASE=qc) is the "knorm" variant without
the placement: each slot carries only its query's index, and the kernel
(`QC_KERNELS`) derives v and base from the queries and the tile's centroid.

`dense_scan` is the per-probe scan of batches too small to share cells
(B*w < 4*kc, single queries included): one kernel launch over all probes
(`csrc/probe_scan.cu`, `PROBE_KERNELS`: persistent blocks whose warps
share out the probes' groups, launch shape in `probe_fit`), fold merge with cell-relative
block-index payloads or the exact merge with absolute slots, row norms
computed in the kernel, int8 or bf16 cache.

`grouped_scan_plain` and `probe_scan_plain` are the same functions as plain
tensor code: the CPU runs them, the card only compares against them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ivfadc_tpu_torch import _build
from ivfadc_tpu_torch.ops.cell_rank import (MAX_KC, tile_layout,
                                            tile_slots)
from ivfadc_tpu_torch.utils.profiling import planned, plans_counted, span

_CAND = 128          # lanes per fold bank (rows per group)
MAX_PB = 64          # the grouped kernels' tallest tile (csrc/dense_scan.cu)
_ELEMS = {torch.int8: "int8", torch.bfloat16: "bf16"}

_GROUPED_ARGS = [_build.P] * 9 + [_build.I] * 6 + [_build.F] + [_build.P] * 3
_PROBE_ARGS = [_build.P] * 6 + [_build.I] * 5 + [_build.F] + [_build.P] * 3


def _entry(prefix: str, variant: str, elem: str) -> str:
    return (prefix + ("" if variant in ("ids", "fold") else f"_{variant}")
            + ("" if elem == "int8" else "_bf16"))


GROUPED_KERNELS = {
    (var, elem): _build.Kernel("dense_scan",
                               _entry("grouped_scan", var, elem),
                               _GROUPED_ARGS)
    for var in ("ids", "knorm", "pos8", "pos", "exact", "extract")
    for elem in ("int8", "bf16")}
PROBE_KERNELS = {
    (merge, elem): _build.Kernel("probe_scan", _entry("probe_scan", merge,
                                                      elem), _PROBE_ARGS)
    for merge in ("fold", "exact") for elem in ("int8", "bf16")}
QC_KERNELS = {
    elem: _build.Kernel("dense_scan", _entry("grouped_scan", "qc", elem),
                        [_build.P] * 11 + [_build.I] * 5 + [_build.F] * 2
                        + [_build.I] + [_build.P] * 3)
    for elem in ("int8", "bf16")}
KERNEL = GROUPED_KERNELS["ids", "int8"]
NORMS_KERNEL = GROUPED_KERNELS["knorm", "int8"]
PROBE_KERNEL = PROBE_KERNELS["fold", "int8"]


@functools.lru_cache(maxsize=None)
def scan_fit(entry: str, d: int, pb: int, nf: int, k_out: int = 0,
             device_index: int = 0) -> dict:
    """The launch shape of a grouped-scan C entry point (`Kernel.fn` of
    GROUPED_KERNELS or QC_KERNELS) at (d, pb, nf, k_out) on a CUDA device:
    resident blocks per SM (the occupancy API), shared bytes a block, bf16
    tiles in turn (int8: 2 converted tiles, or 1 where shared memory holds
    one; bf16: 3 ring slots, or 2), the bf16 tiles the products read from
    (`tiles`: 2, or 1), where the fold buffer lives, registers a thread
    and local (spilled) bytes a thread."""
    out = (ctypes.c_int * 6)()
    fit = _build.HostFn("dense_scan", entry + "_fit",
                        [_build.I] * 4 + [_build.P])
    with torch.cuda.device(device_index):
        fit(d, pb, nf, k_out, ctypes.addressof(out))
    return dict(blocks_per_sm=out[0], smem_bytes=out[1], tile_stages=out[2],
                tiles=out[2] - entry.endswith("_bf16"),
                fold="registers" if out[3] else "shared",
                registers=out[4], local_bytes=out[5])


def _count_plans(kern, d: int, pb: int, nf: int, k_out: int, dev,
                 probe_order: bool) -> None:
    """The launch plans (`profiling.counting`) of one launch of a grouped
    kernel: `scan_single_tile_launches` where it is planned with a single
    staged bf16 tile, `scan_probe_order_launches` where its slot map
    writes probe-order rows."""
    if not plans_counted():
        return
    if scan_fit(kern.fn, d, pb, nf, k_out, dev.index)["tiles"] == 1:
        planned("scan_single_tile_launches")
    if probe_order:
        planned("scan_probe_order_launches")


@functools.lru_cache(maxsize=None)
def probe_fit(entry: str, d: int, nf: int, k_out: int = 0,
              device_index: int = 0) -> dict:
    """The launch shape of a per-probe scan C entry point (`Kernel.fn` of
    PROBE_KERNELS) at (d, nf, k_out) on a CUDA device: resident blocks
    per SM from the occupancy API, the grid of a large batch (that times
    the SM count; smaller batches launch one block per probe), shared
    bytes a block, ring stages and rows per stage of each warp, threads a
    block, registers and local (spilled) bytes a thread."""
    out = (ctypes.c_int * 8)()
    fit = _build.HostFn("probe_scan", entry + "_fit",
                        [_build.I] * 3 + [_build.P])
    with torch.cuda.device(device_index):
        fit(d, nf, k_out, ctypes.addressof(out))
    return dict(blocks_per_sm=out[0], grid=out[0] * out[7],
                smem_bytes=out[1], ring_stages=out[2], stage_rows=out[3],
                threads=out[4], registers=out[5], local_bytes=out[6],
                sms=out[7])


def _elem(decoded, scale) -> str:
    """The decoded cache's kind: "int8" (needs a scale) or "bf16"."""
    elem = _ELEMS.get(decoded.dtype)
    if elem is None:
        raise ValueError(f"decoded cache must be int8 or bf16, got "
                         f"{decoded.dtype}")
    if elem == "int8" and scale is None:
        raise ValueError("int8 decoded cache requires a scale vector")
    return elem


def _rows_f32(decoded, scale, rowidx):
    """The rows the kernels see, in f32: bf16(int8 * bf16(scale)) for the
    int8 cache, the bf16 rows as they are otherwise."""
    rows = decoded[rowidx].to(torch.float32)
    if decoded.dtype == torch.bfloat16:
        return rows
    sc = scale.to(torch.bfloat16).to(torch.float32)
    return (rows * sc).to(torch.bfloat16).to(torch.float32)


def _exact_merge(buf_d, buf_p, s, pay, k_out: int):
    """The kernels' exact-merge passes over one 128-row group: buffers and
    candidates (R, 128). Each pass moves the candidates' minimum (first
    index) into the buffer's maximum lane (first index) when strictly
    smaller, then masks it. A pass that moves nothing leaves every later
    pass nothing to move, which is where the kernels stop."""
    s = s.clone()
    r = torch.arange(s.shape[0], device=s.device)
    for _ in range(k_out):
        cpos = torch.argmin(s, dim=1)
        cmin = s[r, cpos]
        rpos = torch.argmax(buf_d, dim=1)
        rmax = buf_d[r, rpos]
        hit = cmin < rmax
        buf_d[r, rpos] = torch.where(hit, cmin, rmax)
        buf_p[r, rpos] = torch.where(hit, pay[r, cpos], buf_p[r, rpos])
        s[r, cpos] = float("inf")
    return buf_d, buf_p


def _extract_plain(out_d, out_p, extract_k: int):
    """extract_k min-extract passes over (R, nf) fold buffers -> (dists,
    ids (R, extract_k)), id -1 where the distance is +inf."""
    from ivfadc_tpu_torch.ops.topk import topk_lastdim_payload_plain
    vals, pays = topk_lastdim_payload_plain(out_d, out_p, extract_k)
    return vals, torch.where(torch.isinf(vals), -1, pays)


def _grouped_variant(ids2d, norms2d, merge: str, nf: int, pos8: bool,
                     extract_k: int) -> str:
    """The grouped-scan variant an argument set selects (see the module
    docstring); raises on combinations the JAX package refuses."""
    if merge not in ("fold", "exact"):
        raise ValueError(f"merge must be 'fold' or 'exact', got {merge!r}")
    if extract_k:
        if (ids2d is None or norms2d is not None or merge != "fold"
                or not 1 <= 2 * extract_k <= _CAND):
            raise ValueError("extraction needs the fold merge, emitted ids, "
                             "in-kernel norms and 2 * extract_k <= 128")
        return "extract"
    if merge == "exact":
        if ids2d is not None or norms2d is not None or nf != _CAND:
            raise ValueError("the exact merge keeps one 128-lane buffer of "
                             "slots: no ids2d, no norms2d, nf == 128")
        return "exact"
    if ids2d is not None:
        return "ids" if norms2d is not None else "knorm"
    if norms2d is not None:
        raise ValueError("cached norms ride with the id stream (ids2d)")
    return "pos8" if pos8 else "pos"


def tile_order(T: int, pb: int, device) -> dict:
    """The identity slot map as `grouped_scan` / `grouped_scan_qc` keyword
    arguments: every slot writes its own row, so the output holds all
    T*pb slots in tile order (tests and the A/B tool)."""
    return dict(slot_row=torch.arange(T * pb, device=device), n_rows=T * pb)


def _place_rows(out, slot_row, n_rows: int):
    """Slot s's row of `out` (T*pb, width) at row slot_row[s] of an
    (n_rows, width) output; slots mapped to n_rows or past it are dropped.
    Rows no slot maps to are left as allocated, as the kernels leave them."""
    live = slot_row < n_rows
    placed = out.new_empty((n_rows, out.shape[1]))
    placed[slot_row[live]] = out[live]
    return placed


def grouped_scan_plain(tile_start, tile_size, v_tiles, base_tiles, decoded,
                       scale, ids2d, norms2d, *, slot_row, n_rows: int,
                       pb: int, nf: int, norm_coef: float,
                       merge: str = "fold", pos8: bool = False,
                       extract_k: int = 0, k_out: int = 0):
    """Plain version of the scan kernels -> (out_d (n_rows, nf) f32, out_p
    (n_rows, nf) payloads; extraction: (n_rows, extract_k) each), slot s's
    row at row slot_row[s] (T*pb,) and none where that is n_rows or more.
    Walks every tile's cell in 128-row groups with the kernels' arithmetic
    order (see csrc/dense_scan.cu): cached norms join after the size mask;
    with `norms2d=None` the norms are f32 sums of the rows' bf16-rounded
    squares and join before the base."""
    variant = _grouped_variant(ids2d, norms2d, merge, nf, pos8, extract_k)
    dev = v_tiles.device
    T = tile_start.shape[0]
    d = v_tiles.shape[1]
    nbank = nf // _CAND
    vt = v_tiles.to(torch.bfloat16).to(torch.float32).reshape(T, pb, d)
    bt = base_tiles.to(torch.float32).reshape(T, pb, 1)
    ids = None if ids2d is None else ids2d.reshape(-1)
    nrm = None if norms2d is None else norms2d.reshape(-1)
    starts = tile_start.to(torch.int64)
    sizes = tile_size.to(torch.int64)
    out_d = torch.full((T, pb, nf), float("inf"), dtype=torch.float32,
                       device=dev)
    out_p = torch.full((T, pb, nf), -1, dtype=torch.int32, device=dev)
    ngroups = (sizes + _CAND - 1) // _CAND
    lane = torch.arange(_CAND, device=dev)
    for G in range(int(ngroups.max()) if T else 0):
        act = torch.nonzero(ngroups > G).reshape(-1)
        pos = G * _CAND + lane
        valid = pos[None, :] < sizes[act, None]                 # (A, 128)
        rowidx = torch.where(valid, starts[act, None] + pos[None, :], 0)
        rows = _rows_f32(decoded, scale, rowidx)                # (A, 128, d)
        s = torch.bmm(vt[act], rows.transpose(1, 2))            # (A, pb, 128)
        if nrm is None and norm_coef != 0.0:
            sq = (rows * rows).to(torch.bfloat16).to(torch.float32)
            s = s + norm_coef * torch.sum(sq, dim=-1)[:, None, :]
        s = s + bt[act]
        s = torch.where(valid[:, None, :], s, float("inf"))
        if nrm is not None:
            s = s + norm_coef * torch.where(valid, nrm[rowidx],
                                            0.0)[:, None, :]
        if variant == "exact":
            A = act.shape[0]
            slot = (starts[act, None] + pos[None, :]).to(torch.int32)
            bd, bp = _exact_merge(
                out_d[act].reshape(A * pb, _CAND),
                out_p[act].reshape(A * pb, _CAND), s.reshape(A * pb, _CAND),
                slot[:, None, :].expand(A, pb, _CAND).reshape(A * pb, _CAND),
                k_out)
            out_d[act] = bd.reshape(A, pb, _CAND)
            out_p[act] = bp.reshape(A, pb, _CAND)
            continue
        if ids is not None:
            pay = torch.where(valid, ids[rowidx], -1).to(torch.int32)
        else:
            pay = torch.full_like(rowidx, G, dtype=torch.int32)
        b = slice((G % nbank) * _CAND, (G % nbank + 1) * _CAND)
        cur_d = out_d[act, :, b]
        cur_p = out_p[act, :, b]
        upd = s < cur_d
        out_d[act, :, b] = torch.where(upd, s, cur_d)
        out_p[act, :, b] = torch.where(upd, pay[:, None, :].expand_as(cur_p),
                                       cur_p)
    out_d, out_p = out_d.reshape(T * pb, nf), out_p.reshape(T * pb, nf)
    if variant == "extract":
        out_d, out_p = _extract_plain(out_d, out_p, extract_k)
    if variant == "pos8":
        out_p = out_p.to(torch.int8)
    slot_row = slot_row.to(torch.int64)
    return (_place_rows(out_d, slot_row, n_rows),
            _place_rows(out_p, slot_row, n_rows))


def tile_height(pb: int) -> int:
    """The tile height the tile prep and the grouped kernels run at for a
    configured `scan_pb`: min(round_up(pb, 8), MAX_PB). The JAX package
    tiles at any pb >= 1; the kernels step tiles by 8 rows and hold at
    most MAX_PB probes' fold buffers. A probe's fold buffer does not
    depend on which probes share its tile, so every pb gives the results
    of the configured one (the config keeps its value)."""
    if pb < 1:
        raise ValueError(f"scan_pb must be >= 1, got {pb}")
    return min(-(-pb // 8) * 8, MAX_PB)


def _check_slot_map(slot_row, n_rows: int, T: int, pb: int) -> None:
    if tuple(slot_row.shape) != (T * pb,) or not 0 <= n_rows < 2 ** 31:
        raise ValueError(f"the slot map must hold one row per slot, "
                         f"({T * pb},), and n_rows fit int32, got "
                         f"{tuple(slot_row.shape)}, {n_rows}")


def grouped_scan(tile_start, tile_size, v_tiles, base_tiles, decoded, scale,
                 ids2d, norms2d, *, slot_row, n_rows: int, pb: int, nf: int,
                 norm_coef: float, merge: str = "fold", pos8: bool = False,
                 extract_k: int = 0, k_out: int = 0):
    """The scan kernels' wrapper. tile_start/tile_size (T,) i32 (cell row
    range per tile, 8-row aligned starts; 128-row with ids2d / norms2d),
    v_tiles (T*pb, d) bf16, base_tiles (T*pb, 1) f32, decoded (rows, d)
    int8 with scale (d,) f32, or bf16 with scale None; ids2d / norms2d
    (rows/128, 128) i32 / f32 or None. The arguments select the variant
    (module docstring); `k_out` is the exact merge's pass count. slot_row
    (T*pb,) int64 maps each slot to its output row, n_rows or more for none
    (the tile prep's `inv_row` with n_rows = P: probe order; `tile_order`:
    tile order). Returns (out_d (n_rows, nf) f32, out_p (n_rows, nf) i32 or
    int8 for pos8), or with extract_k (dists (n_rows, extract_k) f32, ids
    i32); a row no slot maps to is left unwritten. CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    variant = _grouped_variant(ids2d, norms2d, merge, nf, pos8, extract_k)
    elem = _elem(decoded, scale)
    if nf % _CAND or pb % 8 or not 8 <= pb <= MAX_PB:
        raise ValueError(f"grouped scan needs nf % 128 == 0 and pb in "
                         f"{{8, 16, ..., 64}}, got nf={nf}, pb={pb}")
    if variant == "exact" and not 1 <= k_out <= _CAND:
        raise ValueError(f"the exact merge needs 1 <= k_out <= 128, got "
                         f"{k_out}")
    T = tile_start.shape[0]
    _check_slot_map(slot_row, n_rows, T, pb)
    kw = dict(slot_row=slot_row, n_rows=n_rows, pb=pb, nf=nf,
              norm_coef=norm_coef, merge=merge, pos8=pos8,
              extract_k=extract_k, k_out=k_out)
    if v_tiles.device.type == "cpu":
        with span("ivfadc.scan"):
            return grouped_scan_plain(tile_start, tile_size, v_tiles,
                                      base_tiles, decoded, scale, ids2d,
                                      norms2d, **kw)
    d = v_tiles.shape[1]
    dev = v_tiles.device
    if d % 128 or decoded.shape[1] != d:
        raise ValueError(f"feature dim must be a 128-multiple shared by v "
                         f"and the decoded cache, got {d} / "
                         f"{decoded.shape[1]}")
    with span("ivfadc.tileprep"):
        args = [tile_start.to(torch.int32), tile_size.to(torch.int32),
                v_tiles.to(torch.bfloat16), base_tiles.to(torch.float32),
                decoded,
                None if elem == "bf16"
                else scale.to(torch.bfloat16).to(torch.float32),
                None if ids2d is None else ids2d.to(torch.int32),
                None if norms2d is None else norms2d.to(torch.float32),
                slot_row.to(torch.int64)]
        args = [None if a is None else a.contiguous() for a in args]
        for a in args:
            if a is None:
                continue
            if a.device != dev:
                raise ValueError("grouped scan inputs must be on one device")
            if a.data_ptr() % 16:
                raise ValueError(
                    "grouped scan inputs must be 16-byte aligned")
        width = extract_k or nf
        out_d = torch.empty((n_rows, width), dtype=torch.float32, device=dev)
        out_p = torch.empty((n_rows, width), dtype=torch.int8
                            if variant == "pos8" else torch.int32, device=dev)
    kern = GROUPED_KERNELS[variant, elem]
    with span("ivfadc.scan"):
        kern(*(None if a is None else a.data_ptr() for a in args), T, d, pb,
             nf, extract_k or k_out, n_rows, float(norm_coef),
             out_d.data_ptr(), out_p.data_ptr(), _build.stream_ptr(dev))
    _count_plans(kern, d, pb, nf, extract_k or k_out, dev,
                 n_rows < T * pb)
    return out_d, out_p


def grouped_dense_scan(cells, offsets, sizes, v, base, decoded, scale=None,
                       ids2d=None, norms2d=None, *, kc: int, k_out: int,
                       chunk: int, norm_coef: float = 1.0, pb: int = 16,
                       merge: str = "fold", nf: int = _CAND,
                       pos8: bool = False, extract_k: int = 0,
                       rank_engine: str | None = None):
    """Cell-major grouped scan (the JAX `grouped_dense_scan`).

    cells (B, w) i32; offsets/sizes (kc,) i32; v (B, w, d) bf16; base (B, w)
    f32; decoded (rows, d_pad) int8 with scale (d_pad,) f32, or bf16 rows
    with scale None; d_pad a 128-multiple >= d (v is zero-padded up to it
    here). ids2d / norms2d: the posting ids and cached ||r_hat||^2 in
    (rows/128, 128) layout (cells 128-row aligned), or None. Returns
    (cand_d (B, w, nf) f32, cand_p (B, w, nf)) in the original probe order:
    with ids2d EXTERNAL ids; without, under the fold, the 128-row block
    index within the cell (int8 when pos8 and the tile height is >= 32,
    the caller vouching that every cell holds at most 127 blocks); under
    merge="exact"
    (nf = 128) absolute slots. extract_k > 0 (ids2d, fold, no norms2d,
    2 * extract_k <= 128): (dists, ids (B, w, extract_k)), each probe's
    extract_k best. `chunk` is kept for the JAX signature: the CUDA kernels
    walk 128-row groups, and nf | chunk makes the fold's result independent
    of it. `rank_engine` picks the counting kernel's engine (kc <= MAX_KC).
    `pb` is the configured scan_pb; the tiles are `tile_height(pb)` tall.
    """
    if nf % _CAND or chunk % nf:
        raise ValueError(f"nf must be a 128-multiple dividing chunk, "
                         f"got nf={nf}, chunk={chunk}")
    pb = tile_height(pb)
    # the JAX package writes int8 payloads only from pb = 32 (Mosaic's int8
    # tile is (32, 128)); the gate is a property of the tile the kernel
    # writes, so it is decided on the height the kernel runs at. The
    # payload width changes no result.
    pos8 = pos8 and pb >= 32
    d_dec = decoded.shape[-1]
    with span("ivfadc.tileprep"):
        if v.shape[-1] != d_dec:
            v = torch.nn.functional.pad(v, (0, d_dec - v.shape[-1]))
        B, w, _ = v.shape
        tile_start, tile_size, v_tiles, base_tiles, inv_row = place_tiles(
            cells, offsets, sizes, v, base, kc=kc, pb=pb,
            rank_engine=rank_engine)
    out_d, out_p = grouped_scan(tile_start, tile_size, v_tiles, base_tiles,
                                decoded, scale, ids2d, norms2d,
                                slot_row=inv_row, n_rows=B * w, pb=pb, nf=nf,
                                norm_coef=norm_coef, merge=merge, pos8=pos8,
                                extract_k=extract_k, k_out=k_out)
    width = out_d.shape[1]
    return out_d.reshape(B, w, width), out_p.reshape(B, w, width)


def grouped_rows(cells, sizes, *, kc: int, pb: int):
    """The cache rows the grouped scan streams for the probes `cells`
    (B, w) over cells of `sizes` (kc,): cell c's n_c probes fill
    ceil(n_c / h) tiles of h = tile_height(pb) slots, and each tile reads
    the cell's sizes[c] rows once, so sum_c ceil(n_c / h) * sizes[c], the
    sum over the tiles of tile_size. Each slot, empty ones included, meets
    every row of its tile: the scan scores h times as many (probe slot,
    row) pairs. An int64 device scalar (`profiling.counting`)."""
    h = tile_height(pb)
    n = torch.bincount(cells.reshape(-1).to(torch.int64), minlength=kc)
    return ((n + h - 1) // h * sizes.to(torch.int64)).sum()


def sort_ranks(cells_flat, kc: int):
    """The sort-based rank source (the JAX prep's `lax.sort` branch for
    kc > MAX_KC, `ops/pallas_scan.py:668-683`): one sort of the unique
    key cell << 32 | probe, which orders the probes by cell and keeps the
    probe order within a cell; cell_first / cell_last by searchsorted.
    Returns (rank (P,) i32, counts (kc,) i32) as `cell_ranks` does, for any
    kc. Deterministic: no atomics."""
    c = cells_flat.to(torch.int64)
    P = c.shape[0]
    dev = c.device
    pidx = torch.arange(P, dtype=torch.int64, device=dev)
    key = torch.sort((c << 32) | pidx).values
    order = key & 0xFFFFFFFF
    sorted_cells = key >> 32
    crange = torch.arange(kc, dtype=torch.int64, device=dev)
    cell_first = torch.searchsorted(sorted_cells, crange)
    counts = torch.searchsorted(sorted_cells, crange, right=True) - cell_first
    ranks = torch.empty(P, dtype=torch.int32, device=dev)
    ranks[order] = (pidx - cell_first[sorted_cells]).to(torch.int32)
    return ranks, counts.to(torch.int32)


def _tile_slots(cells, offsets, sizes, *, kc: int, pb: int,
                rank_engine: str | None):
    """The placement both tile preps share: for kc <= MAX_KC the fused
    counting call (`tile_slots`, engine `rank_engine`: one kernel launch
    on the card), above it one sort (`sort_ranks`) and `tile_layout`,
    inside the span `ivfadc.tileprep.sort`, each such prep one
    `tileprep_sort_launches` (`profiling.counting`).
    Returns (c_t, tile_start, tile_size (T_max,) i32, row (P,) each
    probe's row in the tile output, inv_row (T_max*pb,) each slot's probe
    or P for an empty slot, both int64), T_max = P // pb + min(kc, P) + 1
    (an upper bound on the tiles needed)."""
    cells_flat = cells.reshape(-1).to(torch.int32)
    if kc <= MAX_KC:
        return tile_slots(cells_flat, offsets, sizes, kc=kc, pb=pb,
                          engine=rank_engine)[1:]
    planned("tileprep_sort_launches")
    with span("ivfadc.tileprep.sort"):
        ranks, counts = sort_ranks(cells_flat, kc)
        return tile_layout(ranks, counts, cells_flat, offsets, sizes, kc=kc,
                           pb=pb)


def place_tiles(cells, offsets, sizes, v, base, *, kc: int, pb: int,
                rank_engine: str | None = None):
    """The tile prep: group the B*w probes by cell into tiles of pb probes
    of one cell, probes of a cell in probe order (`_tile_slots`), and place
    their v and base rows by a gather. Returns the scan kernel's tile
    inputs (tile_start, tile_size (T_max,) i32, v_tiles (T_max*pb, d) bf16,
    base_tiles (T_max*pb, 1) f32) and `inv_row` (T_max*pb,) int64, each
    slot's probe (P for an empty slot): the scan's slot map."""
    B, w, d = v.shape
    P = B * w
    dev = v.device
    _, tile_start, tile_size, _, inv_row = _tile_slots(
        cells, offsets, sizes, kc=kc, pb=pb, rank_engine=rank_engine)
    # empty slots point at the padding row P, whose v is zero and whose
    # base is +inf, so they never score
    v_pad = torch.cat([v.reshape(P, d).to(torch.bfloat16),
                       torch.zeros((1, d), dtype=torch.bfloat16, device=dev)])
    base_pad = torch.cat([base.reshape(P, 1).to(torch.float32),
                          torch.full((1, 1), float("inf"), device=dev)])
    return tile_start, tile_size, v_pad[inv_row], base_pad[inv_row], inv_row


def probe_scan_plain(starts, sizes, base, v, decoded, scale, *, nf: int,
                     norm_coef: float, merge: str = "fold", k_out: int = 0):
    """Plain version of the per-probe scan kernels -> (out_d (P, nf) f32,
    out_p (P, nf) i32: cell-relative 128-row block indices under the fold,
    absolute slots under the exact merge). starts / sizes / base (P,), v
    (P, d) bf16, decoded (rows, d) int8 with scale (d,), or bf16 with scale
    None. Walks every probe's cell in 128-row groups with the kernel's
    arithmetic order (see csrc/probe_scan.cu)."""
    dev = v.device
    P = starts.shape[0]
    nbank = nf // _CAND
    vf = v.to(torch.bfloat16).to(torch.float32)
    bf = base.to(torch.float32)
    starts = starts.to(torch.int64)
    sizes = sizes.to(torch.int64)
    out_d = torch.full((P, nf), float("inf"), dtype=torch.float32, device=dev)
    out_p = torch.full((P, nf), -1, dtype=torch.int32, device=dev)
    ngroups = (sizes + _CAND - 1) // _CAND
    lane = torch.arange(_CAND, device=dev)
    for G in range(int(ngroups.max()) if P else 0):
        act = torch.nonzero(ngroups > G).reshape(-1)
        pos = G * _CAND + lane
        valid = pos[None, :] < sizes[act, None]                 # (A, 128)
        rowidx = torch.where(valid, starts[act, None] + pos[None, :], 0)
        rows = _rows_f32(decoded, scale, rowidx)                # (A, 128, d)
        s = torch.bmm(rows, vf[act, :, None])[:, :, 0]          # (A, 128)
        if norm_coef != 0.0:
            sq = (rows * rows).to(torch.bfloat16).to(torch.float32)
            s = s + norm_coef * torch.sum(sq, dim=-1)
        s = s + bf[act, None]
        s = torch.where(valid, s, float("inf"))
        if merge == "exact":
            slot = (starts[act, None] + pos[None, :]).to(torch.int32)
            out_d[act], out_p[act] = _exact_merge(out_d[act], out_p[act], s,
                                                  slot, k_out)
            continue
        b = slice((G % nbank) * _CAND, (G % nbank + 1) * _CAND)
        cur_d = out_d[act, b]
        upd = s < cur_d
        out_d[act, b] = torch.where(upd, s, cur_d)
        out_p[act, b] = torch.where(upd, G, out_p[act, b])
    return out_d, out_p


def dense_scan(starts, sizes, v, base, decoded, scale=None, *, k_out: int,
               chunk: int, norm_coef: float = 1.0, merge: str = "fold",
               nf: int = _CAND):
    """Scan the probed cells one probe at a time (the JAX `dense_scan`).

    starts / sizes (B, w) i32 slot ranges of the probed cells; v (B, w, d);
    base (B, w) f32; decoded (rows, d_pad) int8 with scale (d_pad,) f32, or
    bf16 with scale None; d_pad a 128-multiple >= d (the kernel reads v at
    its own width and takes the missing features as 0; the plain version
    pads v). Returns (dists (B, w, nf) f32 with +inf padding, positions
    (B, w, nf) i32, -1 padding): under the fold the cell-relative 128-row
    block index of each lane's best row; under merge="exact" (nf = 128,
    k_out passes) absolute slots, the buffer holding each probe's true
    top-k_out distances. `chunk` is kept for the JAX signature: fold
    results do not depend on it (nf | chunk). CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if merge not in ("fold", "exact"):
        raise ValueError(f"merge must be 'fold' or 'exact', got {merge!r}")
    if merge == "exact" and (nf != _CAND or not 1 <= k_out <= _CAND):
        raise ValueError(f"the exact merge keeps one 128-lane buffer: nf == "
                         f"128 and 1 <= k_out <= 128, got nf={nf}, "
                         f"k_out={k_out}")
    if nf % _CAND or chunk % nf:
        raise ValueError(f"nf must be a 128-multiple dividing chunk, "
                         f"got nf={nf}, chunk={chunk}")
    elem = _elem(decoded, scale)
    d_dec = decoded.shape[-1]
    dev = v.device
    if v.shape[-1] > d_dec:
        raise ValueError(f"v is wider ({v.shape[-1]}) than the decoded "
                         f"cache ({d_dec})")
    # the plain version needs v at the cache's width, the kernel at a
    # multiple of 8 features (16-byte rows for its bulk copies)
    pad_to = d_dec if dev.type == "cpu" else -(-v.shape[-1] // 8) * 8
    if v.shape[-1] != pad_to:
        v = torch.nn.functional.pad(v, (0, pad_to - v.shape[-1]))
    B, w, dv = v.shape
    P = B * w
    with span("ivfadc.tileprep"):
        args = [starts.reshape(P).to(torch.int32),
                sizes.reshape(P).to(torch.int32),
                base.reshape(P).to(torch.float32),
                v.reshape(P, dv).to(torch.bfloat16), decoded,
                None if elem == "bf16"
                else scale.to(torch.bfloat16).to(torch.float32)]
    if dev.type == "cpu":
        with span("ivfadc.scan"):
            out_d, out_p = probe_scan_plain(*args, nf=nf,
                                            norm_coef=norm_coef, merge=merge,
                                            k_out=k_out)
        return out_d.reshape(B, w, nf), out_p.reshape(B, w, nf)
    if d_dec % 128:
        raise ValueError(f"the decoded cache's feature dim must be a "
                         f"128-multiple, got {d_dec}")
    with span("ivfadc.tileprep"):
        args = [None if a is None else a.contiguous() for a in args]
        for a in args:
            if a is None:
                continue
            if a.device != dev:
                raise ValueError("dense scan inputs must be on one device")
            if a.data_ptr() % 16:
                raise ValueError("dense scan inputs must be 16-byte aligned")
        out_d = torch.empty((P, nf), dtype=torch.float32, device=dev)
        out_p = torch.empty((P, nf), dtype=torch.int32, device=dev)
    with span("ivfadc.scan"):
        PROBE_KERNELS[merge, elem](
            *(None if a is None else a.data_ptr() for a in args), P, d_dec,
            dv, nf, k_out, float(norm_coef), out_d.data_ptr(),
            out_p.data_ptr(), _build.stream_ptr(dev))
    return out_d.reshape(B, w, nf), out_p.reshape(B, w, nf)


def _qc_tiles(c_t, qidx, q_pad, c_pad, rot_pad, *, pb: int, apply_rot: bool,
              base_mult: float):
    """The qc kernel's prologue as tensor code: per slot r = q[qidx] -
    c[tile cell] (under a rotation bf16(r) @ bf16(R), f32 products),
    base = base_mult * ||r||^2 (+inf for an empty slot), v = bf16(-2 r).
    Returns (v_tiles (T*pb, d) bf16, base_tiles (T*pb, 1) f32)."""
    ok = qidx >= 0
    r = q_pad[torch.clamp_min(qidx.to(torch.int64), 0)] \
        - c_pad[c_t.to(torch.int64)].repeat_interleave(pb, dim=0)
    if apply_rot:
        r = r.to(torch.bfloat16).to(torch.float32) \
            @ rot_pad.to(torch.float32)
    base = torch.where(ok, base_mult * torch.sum(r * r, dim=1),
                       float("inf"))
    return (-2.0 * r).to(torch.bfloat16), base[:, None]


def grouped_scan_qc_plain(tile_start, tile_size, c_t, qidx, q_pad, c_pad,
                          rot_pad, decoded, scale, ids2d, *, slot_row,
                          n_rows: int, pb: int, nf: int, norm_coef: float,
                          base_mult: float, apply_rot: bool):
    """Plain version of the qc kernel: the prologue in tensor code
    (`_qc_tiles`), then the in-kernel-norms scan's plain version."""
    v_tiles, base_tiles = _qc_tiles(c_t, qidx, q_pad, c_pad, rot_pad, pb=pb,
                                    apply_rot=apply_rot, base_mult=base_mult)
    return grouped_scan_plain(tile_start, tile_size, v_tiles, base_tiles,
                              decoded, scale, ids2d, None, slot_row=slot_row,
                              n_rows=n_rows, pb=pb, nf=nf,
                              norm_coef=norm_coef)


def grouped_scan_qc(tile_start, tile_size, c_t, qidx, q_pad, c_pad, rot_pad,
                    decoded, scale, ids2d, *, slot_row, n_rows: int, pb: int,
                    nf: int, norm_coef: float, base_mult: float,
                    apply_rot: bool):
    """The qc kernel's wrapper. tile_start / tile_size / c_t (T,) i32, qidx
    (T*pb,) i32 (-1: empty slot), q_pad (B', d) and c_pad (kc', d) f32,
    rot_pad (d, d) bf16, decoded (rows, d) int8 with scale (d,) f32 or bf16
    with scale None, ids2d (rows/128, 128) i32; d a 128-multiple; the slot
    map as `grouped_scan`'s. Returns (out_d (n_rows, nf) f32, out_p
    (n_rows, nf) i32 external ids). CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    elem = _elem(decoded, scale)
    if nf % _CAND or pb % 8 or not 8 <= pb <= MAX_PB:
        raise ValueError(f"grouped scan needs nf % 128 == 0 and pb in "
                         f"{{8, 16, ..., 64}}, got nf={nf}, pb={pb}")
    T = tile_start.shape[0]
    _check_slot_map(slot_row, n_rows, T, pb)
    kw = dict(slot_row=slot_row, n_rows=n_rows, pb=pb, nf=nf,
              norm_coef=norm_coef, base_mult=base_mult, apply_rot=apply_rot)
    if q_pad.device.type == "cpu":
        with span("ivfadc.scan"):
            return grouped_scan_qc_plain(tile_start, tile_size, c_t, qidx,
                                         q_pad, c_pad, rot_pad, decoded,
                                         scale, ids2d, **kw)
    d = q_pad.shape[1]
    dev = q_pad.device
    if d % 128 or decoded.shape[1] != d or c_pad.shape[1] != d \
            or tuple(rot_pad.shape) != (d, d):
        raise ValueError(f"feature dim must be a 128-multiple shared by the "
                         f"queries, centroids, rotation and decoded cache, "
                         f"got {d} / {c_pad.shape[1]} / "
                         f"{tuple(rot_pad.shape)} / {decoded.shape[1]}")
    with span("ivfadc.tileprep"):
        args = [tile_start.to(torch.int32), tile_size.to(torch.int32),
                c_t.to(torch.int32), qidx.to(torch.int32),
                q_pad.to(torch.float32), c_pad.to(torch.float32),
                rot_pad.to(torch.bfloat16), decoded,
                None if elem == "bf16"
                else scale.to(torch.bfloat16).to(torch.float32),
                ids2d.to(torch.int32), slot_row.to(torch.int64)]
        args = [None if a is None else a.contiguous() for a in args]
        for a in args:
            if a is None:
                continue
            if a.device != dev:
                raise ValueError("qc scan inputs must be on one device")
            if a.data_ptr() % 16:
                raise ValueError("qc scan inputs must be 16-byte aligned")
        out_d = torch.empty((n_rows, nf), dtype=torch.float32, device=dev)
        out_p = torch.empty((n_rows, nf), dtype=torch.int32, device=dev)
    with span("ivfadc.scan"):
        QC_KERNELS[elem](*(None if a is None else a.data_ptr()
                           for a in args),
                         T, d, pb, nf, n_rows, float(norm_coef),
                         float(base_mult), int(apply_rot), out_d.data_ptr(),
                         out_p.data_ptr(), _build.stream_ptr(dev))
    _count_plans(QC_KERNELS[elem], d, pb, nf, 0, dev, n_rows < T * pb)
    return out_d, out_p


def qc_tile_inputs(cells, offsets, sizes, queries, cents, rot, d_dec: int, *,
                   kc: int, pb: int, rank_engine: str | None = None):
    """The qc route's prep (JAX `grouped_dense_scan_qc`, up to its
    pallas_call): the counting-rank tile placement, and per slot only the
    index of its query. Returns (tile_start, tile_size, c_t, qidx, q_pad,
    c_pad, rot_pad, inv_row): queries and centroids zero-padded to d_dec
    features in f32, the rotation (identity when `rot` is None) embedded
    in a (d_dec, d_dec) identity, as bf16; the slot map as `place_tiles`'."""
    B, w = cells.shape
    P = B * w
    dev = queries.device
    c_t, tile_start, tile_size, _, inv_row = _tile_slots(
        cells, offsets, sizes, kc=kc, pb=pb, rank_engine=rank_engine)
    qidx = torch.where(inv_row < P, inv_row // w, -1).to(torch.int32)
    dq = queries.shape[-1]
    q_pad = torch.nn.functional.pad(queries.to(torch.float32),
                                    (0, d_dec - dq))
    c_pad = torch.nn.functional.pad(cents.to(torch.float32), (0, d_dec - dq))
    rot_pad = torch.eye(d_dec, dtype=torch.float32, device=dev)
    if rot is not None:
        dr = rot.shape[0]
        rot_pad[:dr, :dr] = rot.to(torch.float32)
    return (tile_start, tile_size, c_t, qidx, q_pad, c_pad,
            rot_pad.to(torch.bfloat16), inv_row)


def grouped_dense_scan_qc(cells, offsets, sizes, queries, cents, rot,
                          decoded, scale, ids2d, *, kc: int, chunk: int,
                          norm_coef: float = 1.0, pb: int = 16,
                          nf: int = _CAND, apply_rot: bool = False,
                          base_mult: float = 2.0,
                          rank_engine: str | None = None):
    """`grouped_dense_scan` with v and base derived in the kernel (the JAX
    `grouped_dense_scan_qc`): raw (B, dq) queries and (kc, dq) centroids
    instead of placed v/base tiles. Fold merge, emitted ids (ids2d) and
    the counting-rank prep only (kc <= MAX_KC): callers gate on those.
    base_mult is 2 under the reference score (cdist == ||r||^2 for the
    sqeuclidean coarse and quantizer metrics) and 1 under "pure". Returns
    (cand_d (B, w, nf) f32, cand_ids (B, w, nf) i32 external ids). `chunk`
    is kept for the JAX signature (nf | chunk); the tiles are
    `tile_height(pb)` tall."""
    if ids2d is None or kc > MAX_KC:
        raise ValueError(f"the qc scan needs ids2d and kc <= {MAX_KC}")
    if nf % _CAND or chunk % nf:
        raise ValueError(f"nf must be a 128-multiple dividing chunk, "
                         f"got nf={nf}, chunk={chunk}")
    B, w = cells.shape
    pb = tile_height(pb)
    with span("ivfadc.tileprep"):
        tile_start, tile_size, c_t, qidx, q_pad, c_pad, rot_pad, inv_row = \
            qc_tile_inputs(cells, offsets, sizes, queries, cents, rot,
                           decoded.shape[-1], kc=kc, pb=pb,
                           rank_engine=rank_engine)
    out_d, out_p = grouped_scan_qc(
        tile_start, tile_size, c_t, qidx, q_pad, c_pad, rot_pad, decoded,
        scale, ids2d, slot_row=inv_row, n_rows=B * w, pb=pb, nf=nf,
        norm_coef=norm_coef, base_mult=base_mult, apply_rot=apply_rot)
    return out_d.reshape(B, w, nf), out_p.reshape(B, w, nf)
