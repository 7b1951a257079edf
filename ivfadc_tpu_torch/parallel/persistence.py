"""Shard-aware persistence: one payload file per shard and a manifest (port
of `ivfadc_tpu/parallel/persistence.py`, format v2; v1 is read).

A sharded index saves as a DIRECTORY, the JAX package's layout, so a
directory written by either package loads in the other:

    manifest.json    format version, config, dims, shard roster
    common.npz       centroids, codebooks, rotation, two-level arrays, the
                     global cell layout (small, replicated state)
    shard_00000.npz  shard 0's payload: its offsets / sizes, PQ codes and
    ...              ids (wide mode: the uint64 slot -> id translation);
                     compact codes, never the decoded cache, which a load
                     makes again on the devices

Replica 0 of a shard (data group 0's position) writes it, so under a
process group each rank writes only its own shards; every write goes to a
temporary file that is then renamed. A load reads the files of the shards
this rank's devices hold (a missing file of another rank's shard is
fine), reshards to any shard count S' (cell c moves to shard c % S'), and
rebuilds the decoded caches. `consolidate_sharded_index` folds a
directory back into one `IVFADCIndex`, `consolidate_sharded_to_file` into
a format-v1 file, one shard at a time. The header is plain JSON: nothing
runs on load.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

FORMAT_VERSION = 2   # v2: per-shard offsets / sizes in the shard files
                     # (v1 kept them replicated in common.npz)

_WIDE_NO_ID = np.uint64(0xFFFFFFFFFFFFFFFF)


def _write_atomic(path: str, name: str, rank: int, write) -> None:
    """`write(f)` into path/.name.p<rank>, then rename it to path/name: a
    crash mid-write never tears an existing file, and identical writers on
    a shared file system never interleave."""
    tmp = os.path.join(path, f".{name}.p{rank}")
    mode = "w" if name.endswith(".json") else "wb"
    with open(tmp, mode) as f:
        write(f)
    os.replace(tmp, os.path.join(path, name))


def save_sharded_index(path: str, sidx) -> None:
    """Save a ShardedIVFADCIndex as a directory (see the module
    docstring). Every rank writes the manifest and common.npz; the rank of
    a shard's replica 0 writes the shard's file."""
    os.makedirs(path, exist_ok=True)
    base = sidx.index
    meta = {
        "format_version": FORMAT_VERSION,
        "config": base.config.to_dict(),
        "dim": base.dim,
        "data_dtype": np.dtype(base.data_dtype).name,
        "coarse_kind": base.coarse.kind,
        "quantizer_method": base.quantizer.method,
        "n_shards": sidx.n_shards,
        "window": int(sidx.window),
        "align": int(sidx.align),
        "max_cap": int(sidx.max_cap),
        "n": len(base),
        "wide_ids": bool(sidx.wide_ids),
    }
    common = {
        "centroids": base.coarse.centroids.cpu().numpy(),
        "codebooks": base.quantizer.codebooks.cpu().numpy(),
        "rotation": base.quantizer.rotation.cpu().numpy(),
        "global_offsets": base.store.offsets,
        "global_caps": base.store.caps,
        "global_sizes": base.store.sizes,
    }
    if base.coarse.kind == "two_level":
        meta["n_probe_groups"] = base.coarse.n_probe_groups
        common["group_centers"] = base.coarse.group_centers.cpu().numpy()
        common["group_members"] = base.coarse.members.cpu().numpy()
    rank = sidx.mesh.rank
    _write_atomic(path, "manifest.json", rank,
                  lambda f: json.dump(meta, f, indent=1))
    _write_atomic(path, "common.npz", rank,
                  lambda f: np.savez(f, **common))
    code_dtype = base.store.code_dtype
    for s in range(sidx.n_shards):
        view = sidx._group_views[0][s]
        if view is None:                 # replica 0 is another rank's
            continue
        ids = sidx._trans[s] if sidx.wide_ids else view["ids"].cpu().numpy()
        block = dict(codes=view["codes"].cpu().numpy().astype(code_dtype),
                     ids=ids,
                     offsets=sidx._h_offsets[s].astype(np.int32),
                     sizes=sidx._h_sizes[s].astype(np.int32))
        _write_atomic(path, f"shard_{s:05d}.npz", rank,
                      lambda f, b=block: np.savez(f, **b))


def _load_header(path: str, device):
    """manifest + common.npz -> (meta, config, coarse, quantizer, global
    layout, v1 per-shard layout or None), the components on `device`."""
    from ivfadc_tpu_torch.convert import components_from_arrays
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"sharded index format v{meta['format_version']} is newer than "
            f"this library supports (v{FORMAT_VERSION})")
    with np.load(os.path.join(path, "common.npz")) as z:
        arrays = {key: z[key] for key in z.files}
    config, coarse, quantizer = components_from_arrays(arrays, meta, device)
    glayout = dict(offsets=arrays["global_offsets"].copy(),
                   caps=arrays["global_caps"].copy(),
                   sizes=arrays["global_sizes"].copy())
    v1_layout = None
    if meta["format_version"] < 2:         # v1 kept the layout replicated
        v1_layout = (arrays["shard_offsets"].copy(),
                     arrays["shard_sizes"].copy())
    return meta, config, coarse, quantizer, glayout, v1_layout


def _read_shard_files(path: str, S: int, needed, v1_layout, rank: int = 0):
    """The payload files of shards 0..S-1: `needed` must exist (else
    FileNotFoundError), the others are None when missing. Returns (codes,
    ids, offsets, sizes) lists a shard."""
    codes, ids = [None] * S, [None] * S
    offs, sizs = [None] * S, [None] * S
    for s in range(S):
        fp = os.path.join(path, f"shard_{s:05d}.npz")
        if not os.path.exists(fp):
            if s in needed:
                raise FileNotFoundError(
                    f"shard {s} is required by process {rank} but {fp} is "
                    f"missing")
            continue
        with np.load(fp) as z:
            codes[s] = z["codes"].copy()
            ids[s] = z["ids"].copy()
            if v1_layout is None:
                offs[s] = z["offsets"].copy()
                sizs[s] = z["sizes"].copy()
    if v1_layout is not None:
        for s in range(S):
            offs[s], sizs[s] = v1_layout[0][s], v1_layout[1][s]
    return codes, ids, offs, sizs


def _addressable_shards(mesh, S: int):
    """The shards that some position of this rank holds."""
    from ivfadc_tpu_torch.parallel.mesh import DATA_AXIS
    return {s for s in range(S) for g in range(mesh.shape[DATA_AXIS])
            if mesh.is_local(g, s)}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _shard_layout(sizes: np.ndarray, S: int, align: int):
    """`partition_store`'s per-shard layout from the global cell sizes
    (cell c -> shard c % S, owner-only capacity): the same on every rank,
    which makes a reshard on load safe under a process group. Returns
    (offsets_per, sizes_per, caps_per, cap_shard, window)."""
    kc = len(sizes)
    cells = np.arange(kc)
    owners = cells % S
    sizes_per = np.zeros((S, kc), np.int64)
    sizes_per[owners, cells] = sizes
    owner_mask = np.zeros((S, kc), bool)
    owner_mask[owners, cells] = True
    caps_per = np.where(
        owner_mask,
        np.maximum(align, ((sizes_per + 8 + align - 1) // align) * align), 0)
    offsets_per = np.zeros((S, kc), np.int64)
    np.cumsum(caps_per[:, :-1], axis=1, out=offsets_per[:, 1:])
    cap_shard = _round_up(int((offsets_per[:, -1] + caps_per[:, -1]).max()),
                          128)
    window = _round_up(max(1, int(sizes_per.max(initial=0))), 128)
    return offsets_per, sizes_per, caps_per, cap_shard, window


def _row_moves(sizes: np.ndarray):
    """(cell_rep, within) for every live row, in cell order: the gather /
    scatter index arithmetic of consolidation and resharding."""
    sz = np.asarray(sizes, np.int64)
    tot = int(sz.sum())
    cell_rep = np.repeat(np.arange(len(sz)), sz)
    within = np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(sz) - sz, sz)
    return cell_rep, within


def _single_file_arrays(meta, coarse, quantizer, glayout
                        ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """The format-v1 header and small arrays of a consolidated index."""
    from ivfadc_tpu_torch.utils.persistence import \
        FORMAT_VERSION as SINGLE_FMT
    single_meta = {
        "format_version": SINGLE_FMT,
        "config": meta["config"],
        "dim": int(meta["dim"]),
        "data_dtype": meta["data_dtype"],
        "coarse_kind": meta["coarse_kind"],
        "quantizer_method": meta["quantizer_method"],
    }
    small = {
        "centroids": coarse.centroids.cpu().numpy(),
        "codebooks": quantizer.codebooks.cpu().numpy(),
        "rotation": quantizer.rotation.cpu().numpy(),
        "offsets": np.asarray(glayout["offsets"], np.int64),
        "caps": np.asarray(glayout["caps"], np.int64),
        "sizes": np.asarray(glayout["sizes"], np.int64),
    }
    if coarse.kind == "two_level":
        single_meta["n_probe_groups"] = coarse.n_probe_groups
        small["group_centers"] = coarse.group_centers.cpu().numpy()
        small["group_members"] = coarse.members.cpu().numpy()
    return single_meta, small


def consolidate_sharded_index(path: str, device=None):
    """A `save_sharded_index` directory as one plain `IVFADCIndex` on
    `device` (default "cuda"): the payload on the host, every dynamic op
    back. Needs the whole payload in host memory; a large directory
    reshards onto a mesh instead (`load_sharded_index`)."""
    from ivfadc_tpu_torch.convert import index_from_arrays
    device = device if device is not None else "cuda"
    meta, config, coarse, quantizer, glayout, v1_layout = _load_header(
        path, "cpu")
    S = meta["n_shards"]
    codes_b, ids_b, offs_b, _ = _read_shard_files(path, S, set(range(S)),
                                                  v1_layout)
    g_off = np.asarray(glayout["offsets"], np.int64)
    g_caps = np.asarray(glayout["caps"], np.int64)
    # the flat arrays end at the largest cell end, not the last cell's: a
    # grown cell of a host index relocates to the end
    total_cap = int((g_off + g_caps).max()) if config.kc else 0
    codes = np.zeros((total_cap, codes_b[0].shape[1]), codes_b[0].dtype)
    ids = np.full(total_cap, -1, np.int64)
    cell_rep, within = _row_moves(glayout["sizes"])
    if len(cell_rep):
        old_shard = cell_rep % S
        src = np.stack(offs_b).astype(np.int64)[old_shard, cell_rep] + within
        dst = g_off[cell_rep] + within
        for s in range(S):
            msk = old_shard == s
            if msk.any():
                codes[dst[msk]] = codes_b[s][src[msk]]
                # wide directories hold the uint64 translation; ids are
                # < 2^63, which int64 holds exactly
                ids[dst[msk]] = ids_b[s][src[msk]].astype(np.int64)
    single_meta, arrays = _single_file_arrays(meta, coarse, quantizer,
                                              glayout)
    arrays.update(codes=codes, ids=ids)
    return index_from_arrays(arrays, single_meta, device)


def consolidate_sharded_to_file(path: str, out_path: str,
                                chunk_rows: int = 1 << 20) -> None:
    """Out-of-core consolidation: fold a `save_sharded_index` directory
    into a format-v1 file (`IVFADCIndex.load` of either package reads it)
    without holding the whole payload in memory. The global layout is
    known up front, so the flat codes / ids are on-disk memmaps that each
    shard file streams its rows into, one shard at a time; the memmaps
    are then copied into the output's .npz members (stored, chunked)."""
    import io
    import shutil
    import tempfile
    import zipfile

    meta, config, coarse, quantizer, glayout, v1_layout = _load_header(
        path, "cpu")
    S, kc, m = meta["n_shards"], config.kc, config.m
    g_off = np.asarray(glayout["offsets"], np.int64)
    g_caps = np.asarray(glayout["caps"], np.int64)
    g_sizes = np.asarray(glayout["sizes"], np.int64)
    total_cap = int((g_off + g_caps).max()) if kc else 0
    code_dtype = np.dtype(config.code_dtype)
    tmpdir = tempfile.mkdtemp(dir=os.path.dirname(
        os.path.abspath(out_path)) or ".")
    try:
        codes_mm = np.lib.format.open_memmap(
            os.path.join(tmpdir, "codes.npy"), mode="w+",
            dtype=code_dtype, shape=(total_cap, m))    # fresh pages are 0
        ids_mm = np.lib.format.open_memmap(
            os.path.join(tmpdir, "ids.npy"), mode="w+",
            dtype=np.int64, shape=(total_cap,))
        for s0 in range(0, total_cap, chunk_rows):
            ids_mm[s0:s0 + chunk_rows] = -1
        cells = np.arange(kc)
        for s in range(S):
            fp = os.path.join(path, f"shard_{s:05d}.npz")
            if not os.path.exists(fp):
                raise FileNotFoundError(
                    f"consolidation needs every shard file; {fp} is missing")
            with np.load(fp) as z:
                codes_s = z["codes"]
                ids_s = z["ids"]
                offs_s = z["offsets"] if v1_layout is None \
                    else v1_layout[0][s]
            own = cells[cells % S == s]
            if not int(g_sizes[own].sum()):
                continue
            cell_rep_l, within = _row_moves(g_sizes[own])
            cell_rep = own[cell_rep_l]
            src = np.asarray(offs_s, np.int64)[cell_rep] + within
            dst = g_off[cell_rep] + within
            codes_mm[dst] = codes_s[src]
            ids_mm[dst] = ids_s[src].astype(np.int64)
        codes_mm.flush()
        ids_mm.flush()
        del codes_mm, ids_mm
        single_meta, small = _single_file_arrays(meta, coarse, quantizer,
                                                 glayout)
        small["__meta__"] = np.frombuffer(
            json.dumps(single_meta).encode("utf-8"), dtype=np.uint8)
        tmp_out = os.path.join(tmpdir, "out.npz")
        with zipfile.ZipFile(tmp_out, "w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for name, arr in small.items():
                buf = io.BytesIO()
                np.save(buf, np.asarray(arr))
                zf.writestr(f"{name}.npy", buf.getvalue())
            for name in ("codes", "ids"):
                src_fp = os.path.join(tmpdir, f"{name}.npy")
                with zf.open(f"{name}.npy", "w", force_zip64=True) as dst_f, \
                        open(src_fp, "rb") as src_f:
                    shutil.copyfileobj(src_f, dst_f, length=1 << 24)
        os.replace(tmp_out, out_path)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _reshard_parts(path: str, meta, config, glayout, v1_layout, mesh):
    """Re-deal a saved S-shard payload onto an S'-shard mesh: cell c moves
    from old shard c % S to new shard c % S'. The new layout comes from
    the global histogram alone (the same on every rank); a rank fills only
    the new shards it holds and reads only the old files they need."""
    from ivfadc_tpu_torch.parallel.mesh import SHARD_AXIS
    S = meta["n_shards"]
    S_new = mesh.shape[SHARD_AXIS]
    kc = config.kc
    g_sizes = np.asarray(glayout["sizes"], np.int64)
    align = int(meta["align"])
    offsets_per, sizes_per, caps_per, cap_shard, window = _shard_layout(
        g_sizes, S_new, align)
    addressable = _addressable_shards(mesh, S_new)
    cells = np.arange(kc)
    needed = set((cells[np.isin(cells % S_new, list(addressable))] % S)
                 .tolist())
    codes_b, ids_b, offs_b, _ = _read_shard_files(path, S, needed, v1_layout,
                                                  mesh.rank)
    any_loaded = next((s for s in range(S) if codes_b[s] is not None), None)
    if any_loaded is None:
        raise FileNotFoundError(f"no shard files found in {path}")
    m = codes_b[any_loaded].shape[1]
    cap_pad = _round_up(cap_shard + config.scan_chunk + 128, 128)
    wide = bool(meta.get("wide_ids", False))
    new_codes = np.zeros((S_new, cap_pad, m), codes_b[any_loaded].dtype)
    new_ids = np.full((S_new, cap_pad), -1, np.int32)
    new_trans = np.full((S_new, cap_pad), _WIDE_NO_ID, np.uint64) \
        if wide else None
    cell_rep, within = _row_moves(g_sizes)
    if len(cell_rep):
        old_shard = cell_rep % S
        new_shard = (cell_rep % S_new).astype(np.int64)
        offs_full = np.zeros((S, kc), np.int64)
        for s in range(S):
            if offs_b[s] is not None:
                offs_full[s] = offs_b[s]
        src = offs_full[old_shard, cell_rep] + within
        dst = offsets_per[new_shard, cell_rep] + within
        new_addr = np.isin(new_shard, sorted(addressable))
        for s in range(S):
            msk = (old_shard == s) & new_addr
            if msk.any():
                new_codes[new_shard[msk], dst[msk]] = codes_b[s][src[msk]]
                if wide:
                    new_trans[new_shard[msk], dst[msk]] = \
                        ids_b[s][src[msk]].astype(np.uint64)
                    new_ids[new_shard[msk], dst[msk]] = \
                        dst[msk].astype(np.int32)
                else:
                    new_ids[new_shard[msk], dst[msk]] = ids_b[s][src[msk]]
    out = dict(
        offsets=offsets_per.astype(np.int32),
        sizes=sizes_per.astype(np.int32),
        caps=caps_per.astype(np.int64),       # exact, as the JAX package
        pq_codes=new_codes, ids=new_ids, window=window, align=align,
        max_cap=int(caps_per.max(initial=0)))
    if wide:
        out["trans"] = new_trans
    return out


def load_sharded_index(path: str, mesh=None):
    """Restore a sharded view from a `save_sharded_index` directory onto
    `mesh` (default: `make_mesh(n_data=1)`, the card's). The shard count
    may differ from the saved one (cells are re-dealt c -> c % S'). The
    decoded caches are made again on the devices. One process reads every
    file; under a process group a rank reads only what its shards need."""
    from ivfadc_tpu_torch.parallel.collectives import Collectives
    from ivfadc_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh
    from ivfadc_tpu_torch.parallel.sharded import ShardedIVFADCIndex
    mesh = mesh if mesh is not None else make_mesh(n_data=1)
    home = Collectives(mesh).home
    meta, config, coarse, quantizer, glayout, v1_layout = _load_header(
        path, home)
    S = meta["n_shards"]
    wide = bool(meta.get("wide_ids", False))
    if mesh.shape[SHARD_AXIS] != S:
        parts = _reshard_parts(path, meta, config, glayout, v1_layout, mesh)
    else:
        addressable = _addressable_shards(mesh, S)
        codes_b, ids_b, offs_b, sizs_b = _read_shard_files(
            path, S, addressable, v1_layout, mesh.rank)
        ref = next(i for i in range(S) if codes_b[i] is not None)
        for s in range(S):          # zero-fill the shards of other ranks
            if codes_b[s] is None:
                codes_b[s] = np.zeros_like(codes_b[ref])
                ids_b[s] = np.full_like(ids_b[ref],
                                        _WIDE_NO_ID if wide else 0)
                offs_b[s] = np.zeros_like(offs_b[ref])
                sizs_b[s] = np.zeros_like(sizs_b[ref])
        parts = dict(offsets=np.stack(offs_b), sizes=np.stack(sizs_b),
                     pq_codes=np.stack(codes_b), window=int(meta["window"]),
                     align=int(meta["align"]), max_cap=int(meta["max_cap"]))
        if wide:
            trans = np.stack(ids_b).astype(np.uint64)
            parts["trans"] = trans
            parts["ids"] = np.where(
                trans != _WIDE_NO_ID,
                np.arange(trans.shape[1], dtype=np.int64)[None, :],
                -1).astype(np.int32)
        else:
            parts["ids"] = np.stack(ids_b)
    base = ShardedIVFADCIndex._meta_base(config, coarse, quantizer, glayout,
                                         int(meta["dim"]), home)
    return ShardedIVFADCIndex._assemble(base, mesh, parts)
