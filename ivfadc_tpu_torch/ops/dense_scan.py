"""Dense posting scans (port of `ivfadc_tpu/ops/pallas_scan.py`): the
cell-grouped scan of large batches and the per-probe scan of small ones.

The B*w probes of a search batch are grouped by probed cell into tiles of
pb probes of ONE cell, so each cell's decoded rows are read once per tile
and score all of the tile's probes:

  score(q, x) = base' + v . r_hat + ||r_hat||^2,   v = -2 r,  base' = |r|^2
                                                   (+ coarse distance)

This module holds the production variant of the JAX package's grouped scan
(`grouped_dense_scan` with fold merge, emitted external ids, cached row
norms and the int8 decoded cache): the counting-rank prep (`cell_ranks`,
`_tile_map`, the `inv_row` placement with its zero v-row and +inf base-row)
and `_grouped_call`'s output row gather. The scan kernel itself is
`csrc/dense_scan.cu`; `grouped_scan_plain` is the same function as plain
tensor code.

`dense_scan` is the per-probe scan of batches too small to share cells
(B*w < 4*kc, single queries included): one kernel launch over all probes
(`csrc/probe_scan.cu`, `probe_scan_plain`), fold merge with cell-relative
block-index payloads, row norms computed in the kernel.

Not ported yet: the kernels' other variants (bf16 cache, exact merge, and
for the grouped kernel in-kernel norms, position payloads and in-kernel
extraction), `grouped_dense_scan_qc`, and the sort-based prep for
kc > MAX_KC.
"""

from __future__ import annotations

import torch

from ivfadc_tpu_torch import _build
from ivfadc_tpu_torch.ops.cell_rank import MAX_KC, cell_ranks

_CAND = 128          # lanes per fold bank (rows per group)

KERNEL = _build.Kernel("dense_scan", "grouped_scan",
                       [_build.P] * 8 + [_build.I] * 4 + [_build.F]
                       + [_build.P] * 3)
PROBE_KERNEL = _build.Kernel("probe_scan", "probe_scan",
                             [_build.P] * 6 + [_build.I] * 3 + [_build.F]
                             + [_build.P] * 3)


def grouped_scan_plain(tile_start, tile_size, v_tiles, base_tiles, decoded,
                       scale, ids2d, norms2d, *, pb: int, nf: int,
                       norm_coef: float):
    """Plain version of the scan kernel -> (out_d (T*pb, nf) f32,
    out_p (T*pb, nf) i32). Walks every tile's cell in 128-row groups with
    the kernel's arithmetic order (see csrc/dense_scan.cu)."""
    dev = v_tiles.device
    T = tile_start.shape[0]
    d = v_tiles.shape[1]
    nbank = nf // _CAND
    vt = v_tiles.to(torch.bfloat16).to(torch.float32).reshape(T, pb, d)
    bt = base_tiles.to(torch.float32).reshape(T, pb, 1)
    ids = ids2d.reshape(-1)
    nrm = norms2d.reshape(-1)
    sc = scale.to(torch.bfloat16).to(torch.float32)
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
        rows = (decoded[rowidx].to(torch.float32) * sc) \
            .to(torch.bfloat16).to(torch.float32)               # (A, 128, d)
        s = torch.bmm(vt[act], rows.transpose(1, 2))            # (A, pb, 128)
        s = s + bt[act]
        s = torch.where(valid[:, None, :], s, float("inf"))
        s = s + norm_coef * torch.where(valid, nrm[rowidx], 0.0)[:, None, :]
        pay = torch.where(valid, ids[rowidx], -1).to(torch.int32)
        b = slice((G % nbank) * _CAND, (G % nbank + 1) * _CAND)
        cur_d = out_d[act, :, b]
        cur_p = out_p[act, :, b]
        upd = s < cur_d
        out_d[act, :, b] = torch.where(upd, s, cur_d)
        out_p[act, :, b] = torch.where(upd, pay[:, None, :].expand_as(cur_p),
                                       cur_p)
    return out_d.reshape(T * pb, nf), out_p.reshape(T * pb, nf)


def grouped_scan(tile_start, tile_size, v_tiles, base_tiles, decoded, scale,
                 ids2d, norms2d, *, pb: int, nf: int, norm_coef: float):
    """The scan kernel's wrapper. tile_start/tile_size (T,) i32 (cell row
    range per tile, 128-row aligned starts), v_tiles (T*pb, d) bf16,
    base_tiles (T*pb, 1) f32, decoded (rows, d) int8, scale (d,) f32,
    ids2d / norms2d (rows/128, 128) i32 / f32. CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if nf % _CAND or pb % 8 or not 8 <= pb <= 64:
        raise ValueError(f"grouped scan needs nf % 128 == 0 and pb in "
                         f"{{8, 16, ..., 64}}, got nf={nf}, pb={pb}")
    if decoded.dtype != torch.int8:
        raise NotImplementedError(
            "only the int8 decoded cache is ported (bf16 cache: ROADMAP B.8)")
    if v_tiles.device.type == "cpu":
        return grouped_scan_plain(tile_start, tile_size, v_tiles, base_tiles,
                                  decoded, scale, ids2d, norms2d, pb=pb,
                                  nf=nf, norm_coef=norm_coef)
    T = tile_start.shape[0]
    d = v_tiles.shape[1]
    dev = v_tiles.device
    if d % 128 or decoded.shape[1] != d:
        raise ValueError(f"feature dim must be a 128-multiple shared by v "
                         f"and the decoded cache, got {d} / "
                         f"{decoded.shape[1]}")
    args = [tile_start.to(torch.int32), tile_size.to(torch.int32),
            v_tiles.to(torch.bfloat16), base_tiles.to(torch.float32),
            decoded, scale.to(torch.bfloat16).to(torch.float32),
            ids2d.to(torch.int32), norms2d.to(torch.float32)]
    args = [a.contiguous() for a in args]
    for a in args:
        if a.device != dev:
            raise ValueError("grouped scan inputs must be on one device")
        if a.data_ptr() % 16:
            raise ValueError("grouped scan inputs must be 16-byte aligned")
    out_d = torch.empty((T * pb, nf), dtype=torch.float32, device=dev)
    out_p = torch.empty((T * pb, nf), dtype=torch.int32, device=dev)
    KERNEL(*(a.data_ptr() for a in args), T, d, pb, nf, float(norm_coef),
           out_d.data_ptr(), out_p.data_ptr(), _build.stream_ptr(dev))
    return out_d, out_p


def _tile_map(counts, offsets, sizes, pb: int, T_max: int, kc: int):
    """Tile bookkeeping: cell c owns ceil(counts[c]/pb) consecutive tiles
    starting at tile_base[c]. Returns (tile_base (kc,), tile_start,
    tile_size (T_max,) i32): each tile's cell row range, zero on tiles past
    the last one needed."""
    dev = counts.device
    nt = (counts.to(torch.int64) + pb - 1) // pb          # tiles per cell
    tile_base = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           torch.cumsum(nt, 0)[:-1]])
    trange = torch.arange(T_max, dtype=torch.int64, device=dev)
    c_t = torch.clamp(torch.searchsorted(tile_base, trange, right=True) - 1,
                      0, kc - 1)
    tile_valid = trange < torch.sum(nt)
    tile_start = torch.where(tile_valid, offsets.to(torch.int64)[c_t], 0)
    tile_size = torch.where(tile_valid, sizes.to(torch.int64)[c_t], 0)
    return tile_base, tile_start.to(torch.int32), tile_size.to(torch.int32)


def grouped_dense_scan(cells, offsets, sizes, v, base, decoded, scale=None,
                       ids2d=None, norms2d=None, *, kc: int, k_out: int,
                       chunk: int, norm_coef: float = 1.0, pb: int = 16,
                       merge: str = "fold", nf: int = _CAND):
    """Cell-major grouped scan, production variant.

    cells (B, w) i32; offsets/sizes (kc,) i32; v (B, w, d) bf16; base (B, w)
    f32; decoded (rows, d_pad) int8 with d_pad a 128-multiple >= d (v is
    zero-padded up to it here); scale (d_pad,) f32; ids2d / norms2d the
    posting ids and cached ||r_hat||^2 in (rows/128, 128) layout (cells
    128-row aligned). Returns (cand_d (B, w, nf) f32, cand_p (B, w, nf) i32
    EXTERNAL ids) in the original probe order. `k_out` and `chunk` are kept
    for the JAX signature: fold results do not depend on them (nf | chunk).
    """
    if merge != "fold" or ids2d is None or norms2d is None:
        raise NotImplementedError(
            "only the fold + emitted-ids + cached-norms grouped scan is "
            "ported (other variants: ROADMAP B.8)")
    if decoded.dtype != torch.int8 or scale is None:
        raise NotImplementedError(
            "only the int8 decoded cache is ported (bf16 cache: ROADMAP B.8)")
    if nf % _CAND or chunk % nf:
        raise ValueError(f"nf must be a 128-multiple dividing chunk, "
                         f"got nf={nf}, chunk={chunk}")
    if kc > MAX_KC:
        raise NotImplementedError(
            f"kc={kc} > {MAX_KC} needs the sort-based tile prep, not ported "
            f"yet (ROADMAP A.8)")
    d_dec = decoded.shape[-1]
    if v.shape[-1] != d_dec:
        v = torch.nn.functional.pad(v, (0, d_dec - v.shape[-1]))
    B, w, _ = v.shape
    tile_start, tile_size, v_tiles, base_tiles, row = place_tiles(
        cells, offsets, sizes, v, base, kc=kc, pb=pb)
    out_d, out_p = grouped_scan(tile_start, tile_size, v_tiles, base_tiles,
                                decoded, scale, ids2d, norms2d, pb=pb, nf=nf,
                                norm_coef=norm_coef)
    return out_d[row].reshape(B, w, nf), out_p[row].reshape(B, w, nf)


def place_tiles(cells, offsets, sizes, v, base, *, kc: int, pb: int):
    """The counting-rank prep: group the B*w probes by cell into tiles of pb
    probes of one cell. Returns the scan kernel's tile inputs (tile_start,
    tile_size (T_max,) i32, v_tiles (T_max*pb, d) bf16, base_tiles
    (T_max*pb, 1) f32) and `row` (P,), each probe's row in the tile output,
    T_max = P // pb + min(kc, P) + 1 (an upper bound on the tiles needed)."""
    B, w, d = v.shape
    P = B * w
    T_max = P // pb + min(kc, P) + 1
    dev = v.device
    cells_flat = cells.reshape(-1).to(torch.int32)
    ranks, counts = cell_ranks(cells_flat, kc=kc)
    tile_base, tile_start, tile_size = _tile_map(
        counts, offsets, sizes, pb, T_max, kc)
    ranks = ranks.to(torch.int64)
    row = (tile_base[cells_flat.to(torch.int64)] + ranks // pb) * pb \
        + ranks % pb
    # place probes into their tile rows by a gather: invert `row` (slot ->
    # probe; unwritten slots point at the padding row P, whose v is zero
    # and whose base is +inf, so empty slots never score)
    inv_row = torch.full((T_max * pb,), P, dtype=torch.int64, device=dev)
    inv_row[row] = torch.arange(P, dtype=torch.int64, device=dev)
    v_pad = torch.cat([v.reshape(P, d).to(torch.bfloat16),
                       torch.zeros((1, d), dtype=torch.bfloat16, device=dev)])
    base_pad = torch.cat([base.reshape(P, 1).to(torch.float32),
                          torch.full((1, 1), float("inf"), device=dev)])
    return tile_start, tile_size, v_pad[inv_row], base_pad[inv_row], row


def probe_scan_plain(starts, sizes, base, v, decoded, scale, *, nf: int,
                     norm_coef: float):
    """Plain version of the per-probe scan kernel -> (out_d (P, nf) f32,
    out_p (P, nf) i32 cell-relative 128-row block indices). starts / sizes /
    base (P,), v (P, d) bf16, decoded (rows, d) int8, scale (d,). Walks
    every probe's cell in 128-row groups with the kernel's arithmetic order
    (see csrc/probe_scan.cu)."""
    dev = v.device
    P = starts.shape[0]
    nbank = nf // _CAND
    vf = v.to(torch.bfloat16).to(torch.float32)
    bf = base.to(torch.float32)
    sc = scale.to(torch.bfloat16).to(torch.float32)
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
        rows = (decoded[rowidx].to(torch.float32) * sc) \
            .to(torch.bfloat16).to(torch.float32)               # (A, 128, d)
        s = torch.bmm(rows, vf[act, :, None])[:, :, 0]          # (A, 128)
        if norm_coef != 0.0:
            sq = (rows * rows).to(torch.bfloat16).to(torch.float32)
            s = s + norm_coef * torch.sum(sq, dim=-1)
        s = s + bf[act, None]
        s = torch.where(valid, s, float("inf"))
        b = slice((G % nbank) * _CAND, (G % nbank + 1) * _CAND)
        cur_d = out_d[act, b]
        upd = s < cur_d
        out_d[act, b] = torch.where(upd, s, cur_d)
        out_p[act, b] = torch.where(upd, G, out_p[act, b])
    return out_d, out_p


def dense_scan(starts, sizes, v, base, decoded, scale=None, *, k_out: int,
               chunk: int, norm_coef: float = 1.0, merge: str = "fold",
               nf: int = _CAND):
    """Scan the probed cells one probe at a time, production variant.

    starts / sizes (B, w) i32 slot ranges of the probed cells; v (B, w, d);
    base (B, w) f32; decoded (rows, d_pad) int8 with d_pad a 128-multiple
    >= d (v is zero-padded up to it here); scale (d_pad,) f32. Returns
    (dists (B, w, nf) f32 with +inf padding, blocks (B, w, nf) i32: the
    cell-relative 128-row block index of each lane's best row, -1 padding).
    `k_out` and `chunk` are kept for the JAX signature: fold results do not
    depend on them (nf | chunk). CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    if merge != "fold":
        raise NotImplementedError(
            "only the fold merge of the per-probe scan is ported "
            "(merge='exact': ROADMAP B.8)")
    if decoded.dtype != torch.int8 or scale is None:
        raise NotImplementedError(
            "only the int8 decoded cache is ported (bf16 cache: ROADMAP B.8)")
    if nf % _CAND or chunk % nf:
        raise ValueError(f"nf must be a 128-multiple dividing chunk, "
                         f"got nf={nf}, chunk={chunk}")
    d_dec = decoded.shape[-1]
    if v.shape[-1] != d_dec:
        v = torch.nn.functional.pad(v, (0, d_dec - v.shape[-1]))
    B, w, d = v.shape
    P = B * w
    dev = v.device
    args = [starts.reshape(P).to(torch.int32),
            sizes.reshape(P).to(torch.int32),
            base.reshape(P).to(torch.float32),
            v.reshape(P, d).to(torch.bfloat16), decoded,
            scale.to(torch.bfloat16).to(torch.float32)]
    if dev.type == "cpu":
        out_d, out_p = probe_scan_plain(*args, nf=nf, norm_coef=norm_coef)
        return out_d.reshape(B, w, nf), out_p.reshape(B, w, nf)
    if d % 128:
        raise ValueError(f"the decoded cache's feature dim must be a "
                         f"128-multiple, got {d}")
    args = [a.contiguous() for a in args]
    for a in args:
        if a.device != dev:
            raise ValueError("dense scan inputs must be on one device")
        if a.data_ptr() % 16:
            raise ValueError("dense scan inputs must be 16-byte aligned")
    out_d = torch.empty((P, nf), dtype=torch.float32, device=dev)
    out_p = torch.empty((P, nf), dtype=torch.int32, device=dev)
    PROBE_KERNEL(*(a.data_ptr() for a in args), P, d, nf, float(norm_coef),
                 out_d.data_ptr(), out_p.data_ptr(), _build.stream_ptr(dev))
    return out_d.reshape(B, w, nf), out_p.reshape(B, w, nf)
