"""Sharded IVFADC search (port of `ivfadc_tpu/parallel/sharded.py`).

Design, as in the JAX package:
  * cells are dealt round-robin to S shards (cell c -> shard c % S); each
    shard keeps (kc,) offsets and sizes, with size 0 (and capacity 0) for
    the cells it does not own, so the single-card scan runs unchanged on
    every shard;
  * the trained components (centroids, codebooks, rotation) are copied to
    every device that holds a shard;
  * queries are split over the mesh's data axis; each data group searches
    its slice on all S of its shards, and the shards' (B, k) candidates,
    concatenated shard-major on one device, go through one exact top-k:
    the lowest flat position wins a tie, as `lax.top_k` does.

A shard is a dict of tensors on its device with the keys of
`PostingStore.device_view_dense` (`offsets`, `sizes`, `decoded`, `scale`,
`ids`, `ids2d`, `norms2d`, `guard`) plus `codes` (the PQ codes, which the
LUT engine scans): `_dense_finish` and `_lut_search` take it as they take
the single-card view. Shards may share a card; where two data groups
place shard s on one device they share its tensors.

The coarse probe works on the copied components, so the dense route runs
it once per device and data group and hands the same (cells, v, base) to
every shard on that device (the JAX package recomputes it per shard; the
arithmetic, and so every result, is the same).

Wide ids: past the device int32 id cap the shards' id arrays hold per-shard
slot indices and a host (S, cap_pad) uint64 array `_trans` maps (shard,
slot) to the global id; the merge keeps each winner's shard.

Two kinds of view:
  * host-based (`ShardedIVFADCIndex(index, mesh)`): the base index keeps
    the truth, its store's `MutationLog` records what changed, and
    `refresh()` patches the shards (incremental) or re-partitions them
    (full);
  * distributed (`ShardedIVFADCIndex.build`, `load_sharded_index`): the
    base is payload-free (the trained components and the global cell
    layout), and the dynamic ops patch the shards natively: encode on the
    device, scatter rows into the owner shard's cell tails, compact a cell
    in place on delete, re-lay the shards out when a cell outgrows its
    capacity (`_regrow_distributed`), renumber ids on the shards.

Under a process group (parallel/bootstrap.py) every rank calls each entry
point with the same arguments (the JAX package's SPMD contract). A rank
makes only the shards of its own mesh positions; the host layout is
repaired by an element-wise max over the ranks (a per-rank restore zero-
fills the shards it does not hold); a search gathers every position's
candidates across the ranks before the merge, so every rank returns the
whole batch; the native ops compute their host-side coordinates on every
rank alike and write the shards each rank holds. Wide ids raise there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from ivfadc_tpu_torch.config import DTYPE_TO_BITS, device_id_cap
from ivfadc_tpu_torch.models.index import (IVFADCIndex, _bucket_batch,
                                           _dense_finish, _dense_probe,
                                           _env_coarse_engine, _env_extract,
                                           _env_merge_topk, _env_rank_engine,
                                           _lut_search)
from ivfadc_tpu_torch.models.inverted import PostingStore, _row_norms
from ivfadc_tpu_torch.ops import pq as pq_ops
from ivfadc_tpu_torch.ops.gather_scan import plan_gather
from ivfadc_tpu_torch.ops.topk import topk_lastdim
from ivfadc_tpu_torch.parallel.collectives import Collectives
from ivfadc_tpu_torch.parallel.mesh import (DATA_AXIS, SHARD_AXIS,
                                            make_mesh)
from ivfadc_tpu_torch.parallel.mesh import canonical as _canonical
from ivfadc_tpu_torch.parallel.persistence import _row_moves

_LANE = 128

# wide-id mode: dead-slot sentinel in the host slot -> global-id translation
# (global ids live in [0, 2^63), which int64 host stores bound, so the
# all-ones uint64 is never a real id)
WIDE_NO_ID = np.uint64(0xFFFFFFFFFFFFFFFF)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def partition_store(store, n_shards: int, align: int = 0, wide: bool = False):
    """Split one PostingStore into S per-shard CSR array sets (numpy, with
    a leading shard axis), as the JAX package's `partition_store` does.

    Cell c goes to shard c % S. Capacity goes to the owner shard only:
    max(align, round_up(size + 8, align)) rows, 0 elsewhere, so non-owned
    cells scan as empty windows. `align` defaults to the store's own (128
    keeps the cell starts lane-aligned, which the grouped scan's id
    emission needs). `wide=True` stores each row's per-shard slot index as
    its id and returns `trans` (S, cap) uint64: slot -> global id,
    WIDE_NO_ID in dead slots."""
    kc, m = store.kc, store.m
    a = align or store.align
    cells = np.arange(kc)
    owners = cells % n_shards
    sizes_per = np.zeros((n_shards, kc), np.int64)
    sizes_per[owners, cells] = store.sizes
    owner_mask = np.zeros((n_shards, kc), bool)
    owner_mask[owners, cells] = True
    caps_per = np.where(
        owner_mask, np.maximum(a, ((sizes_per + 8 + a - 1) // a) * a), 0)
    offsets_per = np.zeros((n_shards, kc), np.int64)
    np.cumsum(caps_per[:, :-1], axis=1, out=offsets_per[:, 1:])
    totals = offsets_per[:, -1] + caps_per[:, -1]
    cap_shard = _round_up(int(totals.max()), _LANE)
    codes = np.zeros((n_shards, cap_shard, m), store.code_dtype)
    ids = np.full((n_shards, cap_shard), -1, np.int64)
    trans = np.full((n_shards, cap_shard), WIDE_NO_ID, np.uint64) \
        if wide else None
    # one gather / scatter over all live rows: row r of cell c moves from
    # base slot offsets[c] + r to shard-(c % S) slot offsets_per[c % S, c] + r
    sz = np.asarray(store.sizes, np.int64)
    if int(sz.sum()):
        cell_rep, within = _row_moves(sz)
        src = np.asarray(store.offsets, np.int64)[cell_rep] + within
        shard_rep = owners[cell_rep]
        dst = offsets_per[shard_rep, cell_rep] + within
        codes[shard_rep, dst] = store.codes[src]
        if wide:
            ids[shard_rep, dst] = dst
            trans[shard_rep, dst] = store.ids[src].astype(np.uint64)
        else:
            ids[shard_rep, dst] = store.ids[src]
    window = _round_up(max(1, int(sizes_per.max())), _LANE)
    out = dict(offsets=offsets_per.astype(np.int32),
               sizes=sizes_per.astype(np.int32),
               codes=codes, ids=ids.astype(np.int32), window=window,
               align=a, max_cap=int(caps_per.max()), caps=caps_per)
    if wide:
        out["trans"] = trans
    return out


def _on_device(dev: torch.device):
    """`dev` as the current CUDA device for the block (no-op on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _moved(obj, dev: torch.device):
    """A coarse quantizer (frozen dataclass) or ProductQuantizer (named
    tuple) with its tensors on `dev`."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(dev)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})
    return type(obj)(*[a.to(dev) if isinstance(a, torch.Tensor) else a
                       for a in obj])


def _codes_tensor(rows: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host code rows -> the views' code dtype (uint8, or int32 for wider
    codes), as `PostingStore._codes_tensor` makes them."""
    if rows.dtype != np.uint8:
        rows = rows.astype(np.int32)
    return torch.tensor(rows, device=dev)


def merge_candidates(cand_ids, cand_dists, k: int):
    """The exact cross-shard merge: S shards' raw (B, k) candidates,
    concatenated shard-major, -> (ids (B, k), dists (B, k) ascending,
    source shard (B, k) i32). Equal distances keep their flat order (the
    lowest position wins), as the JAX package's `lax.top_k` keeps it; the
    top-k is kernel 6 on the card. A row with fewer than k finite
    candidates ends in (-1, +inf)."""
    all_i = torch.cat(cand_ids, dim=1)
    dists, which = topk_lastdim(torch.cat(cand_dists, dim=1), k)
    which = which.to(torch.int64)
    ids = torch.where(torch.isfinite(dists), torch.gather(all_i, 1, which),
                      -1)
    return ids, dists, (which // k).to(torch.int32)


def _nbytes(t) -> int:
    return 0 if t is None else int(t.numel() * t.element_size())


class ShardedIVFADCIndex:
    """Search-serving view of an IVFADCIndex with its lists sharded over a
    mesh of devices in one process.

        mesh = make_mesh(n_shards=4, devices=["cuda:0"] * 4)
        sidx = ShardedIVFADCIndex(idx, mesh)
        ids, dists = sidx.search_padded(queries, k=10, w=8)

    Results are the single-card index's (the same top-k, merged exactly;
    ids may differ only between equal distances).
    """

    def __init__(self, index: IVFADCIndex, mesh=None):
        mesh = mesh if mesh is not None else make_mesh()
        # wide-id mode once the index outgrows the device int32 id cap
        wide = len(index) > device_id_cap()
        parts = partition_store(index.store, mesh.shape[SHARD_AXIS],
                                wide=wide)
        # guard rows past the last cell for the scans' tile reads: the JAX
        # package's per-shard layout (cap_pad rows), which its shard-dir
        # format stores
        cap = parts["codes"].shape[1]
        pad = _round_up(cap + index.config.scan_chunk + _LANE, _LANE) - cap
        parts["pq_codes"] = np.pad(parts.pop("codes"),
                                   ((0, 0), (0, pad), (0, 0)))
        parts["ids"] = np.pad(parts["ids"], ((0, 0), (0, pad)),
                              constant_values=-1)
        if wide:
            parts["trans"] = np.pad(parts["trans"], ((0, 0), (0, pad)),
                                    constant_values=WIDE_NO_ID)
        self._wire(index, mesh, parts, distributed=False)
        # the base store logs each mutation for refresh()
        self._mlog = index.store.attach_mutation_log()
        self._last_refresh = "init"

    def __repr__(self) -> str:
        return (f"ShardedIVFADCIndex({self.n_shards} shards x "
                f"{self.mesh.shape[DATA_AXIS]} data, scan_mode="
                f"{self.scan_mode}, {len(self.index)} vectors; "
                f"base: {self.index!r})")

    @property
    def device(self) -> torch.device:
        """Where results come from: data group 0's first device in one
        process, this rank's first device of the mesh under a group."""
        return self._home

    def memory_stats(self) -> dict:
        """Base-index accounting plus the shards' device bytes, totals
        across shards, counted as the JAX package counts its stacked
        arrays: the scanned codes (decoded cache in dense mode), ids, ids2d
        (again), offsets, sizes, and the PQ codes where they are not the
        scanned array."""
        out = self.index.memory_stats()
        total = 0
        for view in self.views:
            if view is None:                # a shard of another rank
                continue
            scanned = view.get("decoded") if self.scan_mode == "dense" \
                else view["codes"]
            total += sum(_nbytes(view.get(key)) for key in
                         ("ids", "ids2d", "offsets", "sizes"))
            total += _nbytes(scanned)
            if scanned is not view["codes"]:
                total += _nbytes(view["codes"])
        out["sharded_device_bytes_total"] = total
        out["n_shards"] = self.n_shards
        return out

    # ------------------------------------------------------------ building
    @classmethod
    def build(cls, data, mesh=None, config=None, **kwargs
              ) -> "ShardedIVFADCIndex":
        """Distributed end-to-end build: train, encode and shard without the
        flat posting arrays ever existing on one device (parallel/build.py).
        The view's `.index` is payload-free (config, trained components,
        the global cell histogram); the dynamic ops patch the shards
        natively. `build_timings` holds the seconds of each stage."""
        from ivfadc_tpu_torch.config import IVFADCConfig
        from ivfadc_tpu_torch.parallel.build import build_distributed_parts
        from ivfadc_tpu_torch.utils.profiling import BuildTimer
        if config is None:
            config = IVFADCConfig(**kwargs)
        elif kwargs:
            raise TypeError("pass either a config or kwargs, not both")
        mesh = mesh if mesh is not None else make_mesh(n_data=1)
        home = Collectives(mesh).home
        timer = BuildTimer(home)
        parts, coarse, quantizer, glayout = build_distributed_parts(
            data, mesh, config, timer)
        base = cls._meta_base(config, coarse, quantizer, glayout,
                              int(data.shape[1]), home)
        with timer.phase("views"):
            self = cls._assemble(base, mesh, parts)
        self.build_timings = timer.timings
        return self

    @staticmethod
    def _meta_base(config, coarse, quantizer, glayout, dim,
                   device) -> IVFADCIndex:
        """Payload-free base index: config, trained components and the
        global cell layout; the postings live on the shards."""
        store = PostingStore(
            config.kc, config.m, np.dtype(config.code_dtype),
            offsets=glayout["offsets"], caps=glayout["caps"],
            sizes=glayout["sizes"], codes=None, ids=None, device=device)
        return IVFADCIndex(config, coarse, quantizer, store,
                           np.dtype(np.float32), dim)

    @classmethod
    def _assemble(cls, base: IVFADCIndex, mesh, parts
                  ) -> "ShardedIVFADCIndex":
        """A distributed view around a payload-free base (distributed
        build, sharded load)."""
        self = object.__new__(cls)
        self._wire(base, mesh, parts, distributed=True)
        self._last_refresh = "native"
        return self

    @classmethod
    def build_streaming(cls, chunks, mesh=None, config=None, *,
                        train_data=None, train_sample: int = 1 << 18,
                        device=None, **kwargs) -> "ShardedIVFADCIndex":
        """Out-of-core build straight into a sharded view:
        `IVFADCIndex.build_streaming` (on `device`, by default the mesh's
        first device) with the device id cap lifted, then the view, which
        serves an index past the cap in wide-id mode. The base keeps its
        host codes, so the view takes every dynamic op."""
        mesh = mesh if mesh is not None else make_mesh()
        idx = IVFADCIndex.build_streaming(
            chunks, config, train_data=train_data,
            train_sample=train_sample,
            device=device if device is not None else mesh.devices[0, 0],
            _sharded=True, **kwargs)
        return cls(idx, mesh)

    @classmethod
    def build_from_files(cls, paths, mesh=None, config=None, *,
                         chunk_rows: int = 262144, max_rows=None,
                         train_sample: int = 1 << 18,
                         **kwargs) -> "ShardedIVFADCIndex":
        """`build_streaming` over TEXMEX .fvecs / .bvecs files (several
        files concatenate in order)."""
        from ivfadc_tpu_torch.utils.datasets import VecsChunks
        return cls.build_streaming(
            VecsChunks(paths, chunk_rows=chunk_rows, max_rows=max_rows),
            mesh, config, train_sample=train_sample, **kwargs)

    def _wire(self, base: IVFADCIndex, mesh, parts, *,
              distributed: bool) -> None:
        """Put the per-shard parts on the mesh's devices (this rank's
        positions only) and keep the host layout. `pq_codes` / `ids` are
        (S, cap_pad, ...) numpy (`partition_store` plus the guard rows, a
        load) or one tensor a shard (None where this rank holds none: the
        distributed build, a regrow)."""
        self.index = base
        self.mesh = mesh
        self.n_shards = mesh.shape[SHARD_AXIS]
        self._distributed_build = distributed
        self.scan_mode = base._resolve_scan_mode()
        self.window = parts["window"]
        self.align = parts["align"]
        self.max_cap = parts["max_cap"]
        self.pos8 = parts["max_cap"] <= 127 * _LANE
        self._trans = parts.get("trans")
        self.wide_ids = self._trans is not None
        if self.wide_ids and mesh.multi_process:
            raise NotImplementedError(
                "wide-id mode (ids beyond the device int32 cap) is "
                "single-process: the host's slot -> id translation would "
                "need a per-process exchange under a process group")
        self._col = Collectives(mesh)
        self._home = self._col.home
        self._devices = [[_canonical(d) if mesh.is_local(g, s)
                          else torch.device(d) for s, d in enumerate(row)]
                         for g, row in enumerate(mesh.devices)]
        self._comp = {}
        self._scale = None
        if self.scan_mode == "dense" and base._resolve_cache() == "int8":
            self._scale = pq_ops.cache_scale(base.quantizer)
        made = {}
        for g, row in enumerate(self._devices):
            for s, dev in enumerate(row):
                if mesh.is_local(g, s) and (s, dev) not in made:
                    made[s, dev] = self._make_view(parts, s, dev)
        self._group_views = [[made.get((s, dev)) if mesh.is_local(g, s)
                              else None for s, dev in enumerate(row)]
                             for g, row in enumerate(self._devices)]
        self.views = self._group_views[0]
        # the gathered engine's plan on the per-shard scan: the global caps
        # for its p95, the per-shard max for covers_all
        self.gather_plan = plan_gather(
            np.asarray(base.store.caps), base.config.scan_gather_win,
            max_cap=parts["max_cap"])
        # host snapshot of the per-shard layout, for refresh() and the
        # native ops. Under a group a per-rank restore zero-fills the
        # shards it does not hold: every entry is >= 0 and a zero-fill 0,
        # so the element-wise max over the ranks is the whole layout
        self._h_offsets = self._col.max_host(
            np.asarray(parts["offsets"], np.int64))
        self._h_sizes = self._col.max_host(
            np.asarray(parts["sizes"], np.int64).copy())
        codes = parts["pq_codes"]
        self._cap_pad = int(codes.shape[1]) if isinstance(
            codes, np.ndarray) else int(next(
                c for c in codes if c is not None).shape[0])
        if "caps" in parts:
            self._h_caps = np.asarray(parts["caps"], np.int64)
        else:
            # from the offsets' diff, as the JAX package recovers them: the
            # layout is a cumsum, so off[c+1] - off[c] is cell c's capacity,
            # and the guarded array's tail bounds the last cell (whose cap
            # then runs to the padded tail)
            off = self._h_offsets
            guard = base.config.scan_chunk + _LANE
            total = self._cap_pad - guard
            caps = np.diff(off, axis=1,
                           append=np.full((off.shape[0], 1), total))
            owner = (np.arange(base.config.kc) % self.n_shards)[None, :] \
                == np.arange(self.n_shards)[:, None]
            self._h_caps = np.where(owner, np.maximum(caps, 0), 0)

    def _components(self, dev: torch.device):
        """(coarse quantizer, PQ quantizer, int8 cache scale or None) on
        `dev`: the base index's own objects where they already live there.
        The scale is computed once, on the base's device, and copied."""
        comp = self._comp.get(dev)
        if comp is None:
            base = self.index
            scale = None if self._scale is None else self._scale.to(dev)
            if _canonical(base.device) == dev:
                comp = (base.coarse, base.quantizer, scale)
            else:
                comp = (_moved(base.coarse, dev),
                        _moved(base.quantizer, dev), scale)
            self._comp[dev] = comp
        return comp

    def _make_view(self, parts, s: int, dev: torch.device) -> dict:
        """Shard s's tensors on `dev`: the LUT arrays, and in dense mode the
        decoded cache, ids2d and norms2d made as the single-card dense view
        makes them (so a row's norm is the single card's, bit for bit)."""
        codes, ids = parts["pq_codes"][s], parts["ids"][s]
        if isinstance(codes, torch.Tensor):
            codes, ids = codes.to(dev), ids.to(dev)
        else:
            codes = _codes_tensor(codes, dev)
            ids = torch.tensor(ids, device=dev)
        view = dict(
            offsets=torch.tensor(parts["offsets"][s], device=dev),
            sizes=torch.tensor(parts["sizes"][s], device=dev),
            ids=ids, codes=codes, decoded=None, scale=None, ids2d=None,
            norms2d=None, guard=self.index.config.scan_chunk + _LANE)
        if self.scan_mode != "dense":
            return view
        _, quantizer, scale = self._components(dev)
        with _on_device(dev):
            decoded = self._decode(quantizer, scale, codes)
            d_pad = _round_up(decoded.shape[1], _LANE) - decoded.shape[1]
            decoded = torch.nn.functional.pad(decoded, (0, d_pad))
            if scale is not None:
                scale = torch.nn.functional.pad(scale, (0, d_pad), value=1.0)
            view.update(decoded=decoded, scale=scale,
                        cache=self.index._resolve_cache())
            if self.align % _LANE == 0:
                view["ids2d"] = ids.reshape(-1, _LANE)
                # IVFADC_NORMS is read when the view is built, as the
                # single-card view and the JAX package read it
                if os.environ.get("IVFADC_NORMS", "cache") == "cache":
                    view["norms2d"] = _row_norms(decoded, scale).reshape(
                        -1, _LANE)
        return view

    @staticmethod
    def _decode(quantizer, scale, codes: torch.Tensor) -> torch.Tensor:
        if scale is not None:
            return pq_ops.decode_rotated_int8(quantizer, codes, scale)
        return pq_ops.decode_rotated(quantizer, codes)

    def _copies(self, s: int):
        """Every distinct tensor set of shard s this rank holds (one per
        device holding it)."""
        seen = {}
        for row in self._group_views:
            if row[s] is not None:
                seen[id(row[s])] = row[s]
        return list(seen.values())

    def _local_shards(self):
        return [s for s in range(self.n_shards) if self._copies(s)]

    # ------------------------------------------------------------- refresh
    def refresh(self) -> None:
        """Bring the shards up to date after dynamic ops on the base index.

        Incremental: the base store's mutation log names the changed cells
        and the id renumberings; these are replayed on the shards' ids (or
        on the host translation in wide-id mode) and only the dirty cells'
        rows are re-uploaded. A full re-partition when the log overflowed
        or a cell outgrew its per-shard capacity or the window.
        `_last_refresh` names what ran: noop, incremental or full; on a
        distributed view "native" (its ops patch the shards themselves)."""
        if self._distributed_build:
            self._last_refresh = "native"
            return
        store = self.index.store
        log = self._mlog.drain()
        if log["overflow"]:
            self._repartition()
            return
        cells, ops = sorted(log["cells"]), log["ops"]
        if not cells and not ops:
            self._last_refresh = "noop"
            return
        S = self.n_shards
        for c in cells:
            size = int(store.sizes[c])
            if size > int(self._h_caps[c % S, c]) or size > self.window:
                self._repartition()
                return
        self._apply_incremental(store, cells, ops)
        self._last_refresh = "incremental"

    def _repartition(self) -> None:
        self.__init__(self.index, self.mesh)
        self._last_refresh = "full"

    def _apply_incremental(self, store, cells, ops) -> None:
        S = self.n_shards
        # 1) the id renumberings, in order (padding ids are -1: a shift
        #    moves ids > threshold >= -1, a rank shift ids >= 0); in wide
        #    mode on the host translation, the device holding slot indices
        if self.wide_ids:
            t = self._trans
            for op in ops:
                live = t != WIDE_NO_ID
                if op[0] == "shift":
                    _, thr, delta = op
                    sel = live & (t.view(np.int64) > thr) if thr >= 0 \
                        else live
                    t[sel] = (t[sel].view(np.int64) + delta).view(np.uint64)
                else:
                    dels = np.asarray(op[1]).astype(np.uint64)
                    t[live] -= np.searchsorted(dels, t[live]) \
                        .astype(np.uint64)
        elif ops:
            for s in range(S):
                for view in self._copies(s):
                    ids = view["ids"]
                    for op in ops:
                        if op[0] == "shift":
                            _, thr, delta = op
                            ids.copy_(torch.where(ids > thr, ids + delta,
                                                  ids))
                        else:
                            d = torch.as_tensor(
                                np.asarray(op[1]).astype(np.int32),
                                device=ids.device)
                            below = torch.searchsorted(d, ids,
                                                       out_int32=True)
                            ids.copy_(torch.where(ids >= 0, ids - below,
                                                  ids))
        # 2) the dirty cells: the host truth's rows into the owner shard's
        #    slots, over the old extent too so a shrunk cell's tail clears
        per_shard = {}
        for c in cells:
            s = c % S
            o_dst = int(self._h_offsets[s, c])
            new_sz = int(store.sizes[c])
            span = max(new_sz, int(self._h_sizes[s, c]))
            if span == 0:
                continue
            o_src = int(store.offsets[c])
            rows = np.zeros((span, store.m), store.code_dtype)
            idv = np.full(span, -1, np.int64)
            if new_sz:
                rows[:new_sz] = store._code_rows(
                    np.arange(o_src, o_src + new_sz))
                if self.wide_ids:
                    idv[:new_sz] = np.arange(o_dst, o_dst + new_sz)
                    self._trans[s, o_dst:o_dst + new_sz] = \
                        store.ids[o_src:o_src + new_sz].astype(np.uint64)
                else:
                    idv[:new_sz] = store.ids[o_src:o_src + new_sz]
            if self.wide_ids:
                self._trans[s, o_dst + new_sz:o_dst + span] = WIDE_NO_ID
            per_shard.setdefault(s, []).append(
                (np.arange(o_dst, o_dst + span), idv, rows))
            self._h_sizes[s, c] = new_sz
        for s, parts in per_shard.items():
            self._patch_payload(s, *(np.concatenate(p) for p in zip(*parts)))
        if per_shard:
            self._upload_sizes()

    def _patch_payload(self, s: int, slots, id_vals, code_rows) -> None:
        """Write (id, code) rows at shard s's `slots` in every copy of the
        shard: ids, PQ codes and, in dense mode, the decoded rows and their
        norms, made by the view build's own arithmetic. A dead slot (id
        -1, zero code) takes the zero code's decoded row, as a rebuild
        holds it."""
        for view in self._copies(s):
            dev = view["ids"].device
            _, quantizer, _ = self._components(dev)
            with _on_device(dev):
                sl = torch.as_tensor(slots, device=dev)
                view["ids"][sl] = torch.as_tensor(id_vals.astype(np.int32),
                                                  device=dev)
                codes = code_rows.to(dev) if isinstance(
                    code_rows, torch.Tensor) else _codes_tensor(code_rows, dev)
                view["codes"][sl] = codes
                if view["decoded"] is None:
                    continue
                dec = view["decoded"]
                rows = self._decode(quantizer, view["scale"], codes)
                rows = torch.nn.functional.pad(
                    rows, (0, dec.shape[1] - rows.shape[1])).to(dec.dtype)
                dec[sl] = rows
                if view["norms2d"] is not None:
                    view["norms2d"].view(-1)[sl] = _row_norms(rows,
                                                              view["scale"])

    def _upload_sizes(self) -> None:
        for s in range(self.n_shards):
            sizes = self._h_sizes[s].astype(np.int32)
            for view in self._copies(s):
                view["sizes"].copy_(torch.as_tensor(sizes))

    # ---------------------------------------------------------------- fork
    def fork(self) -> "ShardedIVFADCIndex":
        """Consistent-snapshot clone for epoch-swap serving (serving.py):
        the shards' tensors are copied, the host bookkeeping cloned, the
        base index forked (copy-on-write; a payload-free base copies its
        layout); the trained components are shared. A mutation log the
        parent had not drained is replayed into the fork, so it starts in
        sync with its base."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        clones = {id(None): None}
        for row in self._group_views:
            for view in row:
                if id(view) not in clones:
                    clones[id(view)] = self._clone_view(view)
        new._group_views = [[clones[id(v)] for v in row]
                            for row in self._group_views]
        new.views = new._group_views[0]
        new._h_offsets = self._h_offsets.copy()
        new._h_sizes = self._h_sizes.copy()
        new._h_caps = self._h_caps.copy()
        if self._trans is not None:
            new._trans = self._trans.copy()
        new.index = self.index.fork()
        if self._distributed_build:
            return new
        new._mlog = new.index.store.attach_mutation_log()
        old = self._mlog
        if old.overflow or old.cells or old.ops:
            new._mlog.cells = set(old.cells)
            new._mlog.ops = list(old.ops)
            new._mlog.overflow = old.overflow
            new.refresh()
        return new

    @staticmethod
    def _clone_view(view: dict) -> dict:
        out = {key: (val.clone() if isinstance(val, torch.Tensor) else val)
               for key, val in view.items()}
        if out["ids2d"] is not None:
            out["ids2d"] = out["ids"].reshape(-1, _LANE)
        return out

    # ------------------------------------------------------------ wide ids
    def _ensure_id_headroom(self, extra: int) -> None:
        """Before appending `extra` points: enforce the index_dtype capacity
        law, and switch to wide-id mode when the append crosses the device
        int32 id cap while the dtype still has room."""
        bits = DTYPE_TO_BITS[self.index.config.index_dtype]
        n_after = len(self.index) + extra
        if n_after > (1 << bits):
            raise AssertionError(
                f"Index would exceed capacity for dtype "
                f"{self.index.config.index_dtype} ({1 << bits} vectors)")
        if self.wide_ids or n_after <= device_id_cap():
            return
        if (1 << bits) <= device_id_cap():
            raise AssertionError(
                f"Index would exceed capacity for dtype "
                f"{self.index.config.index_dtype} "
                f"({device_id_cap()} vectors)")
        self._upgrade_to_wide()

    def _upgrade_to_wide(self) -> None:
        """Value mode -> wide-id mode, one way: the global ids go to the
        host translation (through the row moves `partition_store` made, or
        off the shards of a distributed view) and the shards' ids become
        their slot indices."""
        if self.mesh.multi_process:
            raise NotImplementedError(
                "wide-id upgrade is single-process; under a process group "
                "rebuild through ShardedIVFADCIndex.build")
        S = self.n_shards
        cap_pad = self._cap_pad
        trans = np.full((S, cap_pad), WIDE_NO_ID, np.uint64)
        store = self.index.store
        sz = np.asarray(store.sizes, np.int64)
        if self._distributed_build:
            for s in range(S):
                ids_h = self._copies(s)[0]["ids"].cpu().numpy()
                live = ids_h >= 0
                trans[s, live] = ids_h[live].astype(np.uint64)
        elif sz.sum():
            cell_rep, within = _row_moves(sz)
            s_rep = cell_rep % S
            dst = self._h_offsets[s_rep, cell_rep] + within
            src = np.asarray(store.offsets, np.int64)[cell_rep] + within
            trans[s_rep, dst] = store.ids[src].astype(np.uint64)
        live = trans != WIDE_NO_ID
        slot_ids = np.where(live, np.arange(cap_pad, dtype=np.int64)[None, :],
                            -1).astype(np.int32)
        for s in range(S):
            for view in self._copies(s):
                view["ids"].copy_(torch.as_tensor(slot_ids[s]))
        self._trans = trans
        self.wide_ids = True

    # --------------------------------------------------------- dynamic ops
    # A host-based view mutates its base index (the host truth), then
    # refresh() patches the shards; a distributed view patches its shards
    # natively (the JAX package's two branches).
    def push(self, point) -> None:
        """Append with id n."""
        self._ensure_id_headroom(1)
        if not self._distributed_build:
            self.index.push(point)
            self.refresh()
            return
        point = np.asarray(point, np.float32)
        self.index._check_push(point)
        self._native_append(point[None], np.asarray([len(self.index)]))

    def push_batch(self, points) -> None:
        """Append B points, ids n..n+B-1."""
        if not isinstance(points, torch.Tensor):
            points = np.asarray(points, np.float32)
        if points.ndim != 2 or points.shape[1] != self.index.dim:
            raise AssertionError(
                f"push_batch expects (B, {self.index.dim}) points, "
                f"got {tuple(points.shape)}")
        self._ensure_id_headroom(len(points))
        if not self._distributed_build:
            self.index.push_batch(points)
            self.refresh()
            return
        if len(points) == 0:
            return
        n0 = len(self.index)
        self._native_append(points, np.arange(n0, n0 + len(points)))

    def push_front(self, point) -> None:
        """Insert with id 0; every live id moves up by one."""
        self._ensure_id_headroom(1)
        if not self._distributed_build:
            self.index.push_front(point)
            self.refresh()
            return
        point = np.asarray(point, np.float32)
        self.index._check_push(point)
        # append first with the unused id n, then renumber in one pass
        # (n -> 0, every other id + 1): an append that fails leaves every
        # id where it was
        n = len(self.index)
        self._native_append(point[None], np.asarray([n]))
        if self.wide_ids:
            t = self._trans
            live = t != WIDE_NO_ID
            t[live] = np.where(t[live] == np.uint64(n), np.uint64(0),
                               t[live] + np.uint64(1))
            return
        for s in self._local_shards():
            for view in self._copies(s):
                ids = view["ids"]
                ids.copy_(torch.where(ids == n, 0,
                                      torch.where(ids >= 0, ids + 1, ids)))

    def pop(self) -> np.ndarray:
        """Remove and reconstruct the point with id n-1."""
        if not self._distributed_build:
            out = self.index.pop()
            self.refresh()
            return out
        n = len(self.index)
        if n == 0:
            raise IndexError("pop from empty index")
        cell, codes = self._fetch_by_id(n - 1)
        self._native_delete(np.asarray([n - 1], np.int64))
        return self.index._reconstruct_from(cell, codes)

    def pop_front(self) -> np.ndarray:
        """Remove and reconstruct the point with id 0; ids shift down."""
        if not self._distributed_build:
            out = self.index.pop_front()
            self.refresh()
            return out
        if len(self.index) == 0:
            raise IndexError("pop from empty index")
        cell, codes = self._fetch_by_id(0)
        # the delete's rank shift is the pop_front shift: every id > 0
        # drops by one
        self._native_delete(np.zeros(1, np.int64))
        return self.index._reconstruct_from(cell, codes)

    def delete(self, ids) -> None:
        """Delete by 0-based ids; surviving ids shift down to stay
        contiguous."""
        if not self._distributed_build:
            self.index.delete(ids)
            self.refresh()
            return
        self._native_delete(np.unique(np.asarray(list(ids), np.int64)))

    def reconstruct(self, ext_id: int) -> np.ndarray:
        """The stored approximation of a point (non-destructive)."""
        if not self._distributed_build:
            return self.index.reconstruct(ext_id)
        cell, codes = self._fetch_by_id(int(ext_id))
        return self.index._reconstruct_from(cell, codes)

    # ------------------------------------------------- native dynamic ops
    def _slot_to_cell(self, shard: int, slot: int) -> int:
        """Owning cell of a per-shard slot: the offsets are a cumsum, so the
        owner is the last cell whose offset is <= slot (zero-capacity cells
        share its boundary and never win)."""
        return int(np.searchsorted(self._h_offsets[shard], slot,
                                   side="right") - 1)

    def _locate_rows(self, targets: np.ndarray) -> np.ndarray:
        """Flat positions (shard * cap_pad + slot), ascending, of the rows
        holding the ids `targets`: one sweep of each shard's ids on its
        device, gathered over the ranks under a group."""
        found = {}
        for s in self._local_shards():
            ids = self._copies(s)[0]["ids"]
            t = torch.as_tensor(np.asarray(targets).astype(np.int32),
                                device=ids.device)
            slots = torch.nonzero(torch.isin(ids, t))[:, 0]
            found[s] = slots.cpu().numpy().astype(np.int64)
        merged = {}
        for part in self._col.allgather_object(found):
            for s, slots in part.items():
                merged.setdefault(s, slots)
        if not merged:
            return np.zeros(0, np.int64)
        return np.sort(np.concatenate(
            [s * self._cap_pad + slots for s, slots in merged.items()]))

    def _gather_rows(self, s: int, slot: int) -> np.ndarray:
        """The PQ code row at (shard, slot), read where the shard lives and
        shared with every rank."""
        row = None
        if self._copies(s):
            row = self._copies(s)[0]["codes"][slot].cpu().numpy().astype(
                self.index.store.code_dtype)
        if not self.mesh.multi_process:
            return row
        return self._col.broadcast_object(row, int(self.mesh.owners[0, s]))

    def _fetch_by_id(self, ext_id: int):
        """(cell, code row) of one external id, off the shards."""
        if self.wide_ids:
            hits = np.nonzero(self._trans == np.uint64(ext_id))
            if len(hits[0]) != 1:
                raise KeyError(f"id {ext_id} not present in the index")
            s, slot = int(hits[0][0]), int(hits[1][0])
        else:
            pos = self._locate_rows(np.asarray([ext_id]))
            if len(pos) != 1:
                raise KeyError(f"id {ext_id} not present in the index")
            s, slot = divmod(int(pos[0]), self._cap_pad)
        return self._slot_to_cell(s, slot), self._gather_rows(s, slot).copy()

    def _encode_device(self, points):
        """Nearest cell (the coarse search at w = 1) and PQ codes of a batch
        on the base's device, as the base index encodes a push; both stay
        on the device."""
        base = self.index
        q = points.to(base.device, torch.float32) \
            if isinstance(points, torch.Tensor) \
            else torch.as_tensor(np.asarray(points, np.float32),
                                 device=base.device)
        cells, _ = base.coarse.search(q, 1)
        cells = cells[:, 0].to(torch.int64)
        resid = q - base.coarse.centroids[cells]
        codes = pq_ops.encode(base.quantizer, resid,
                              metric=base.quant_metric)
        return cells, codes

    def _native_append(self, points, new_ids: np.ndarray) -> None:
        """Encode the points on the device, re-lay the shards out if a cell
        outgrows its capacity (or the window), then write each row at its
        owner shard's cell tail in every copy of the shard: id (its slot in
        wide mode), PQ code, decoded row and norm. Rows of one cell keep
        their input order (a stable sort), as the JAX package's fused
        append places them."""
        store = self.index.store
        kc, S = store.kc, self.n_shards
        new_ids = np.asarray(new_ids, np.int64)
        cells_d, codes_d = self._encode_device(points)
        cells = cells_d.cpu().numpy()
        new_sizes = store.sizes + np.bincount(cells, minlength=kc)
        allc = np.arange(kc)
        owners = allc % S
        if (bool(np.any(new_sizes > self._h_caps[owners, allc]))
                or bool(np.any(new_sizes > store.caps))
                or int(new_sizes.max(initial=0)) > self.window):
            self._regrow_distributed(new_sizes)
        order = np.argsort(cells, kind="stable")
        sc = cells[order]
        within = np.arange(len(sc)) - np.searchsorted(sc, sc)
        s_idx = sc % S
        slot = self._h_offsets[s_idx, sc] + store.sizes[sc] + within
        vals = slot if self.wide_ids else new_ids[order]
        codes_o = codes_d[torch.as_tensor(order, device=codes_d.device)]
        for s in self._local_shards():
            sel = np.nonzero(s_idx == s)[0]
            if len(sel):
                self._patch_payload(s, slot[sel], vals[sel], codes_o[
                    torch.as_tensor(sel, device=codes_o.device)])
        if self.wide_ids:
            self._trans[s_idx, slot] = new_ids[order].astype(np.uint64)
        store.sizes = new_sizes
        self._h_sizes[owners, allc] = new_sizes
        self._upload_sizes()

    def _native_delete(self, dels: np.ndarray) -> None:
        """Remove rows by external id: compact each dirty cell in place
        (survivors keep their order, the tail clears to zero rows and id
        -1), then rank-shift every surviving id. The coordinates are host
        arithmetic; the rows move on the devices. In wide mode the locate
        and the rank shift run on the host translation."""
        store = self.index.store
        n = len(self.index)
        if dels.size == 0:
            return
        if int(dels[0]) < 0 or int(dels[-1]) >= n:
            raise IndexError(
                f"delete ids must be within [0, {n}), got "
                f"[{int(dels[0])}, {int(dels[-1])}]")
        D = len(dels)
        if self.wide_ids:
            dels_u = dels.astype(np.uint64)
            s_all, slot_all = np.nonzero(np.isin(self._trans, dels_u))
            if len(s_all) != D:
                raise KeyError(
                    f"only {len(s_all)}/{D} of the requested ids are present")
            s_all, slot_all = s_all.astype(np.int64), slot_all.astype(np.int64)
        else:
            pos = self._locate_rows(dels)
            if len(pos) != D:
                raise KeyError(
                    f"only {len(pos)}/{D} of the requested ids are present")
            s_all, slot_all = pos // self._cap_pad, pos % self._cap_pad
        cells_all = np.empty(D, np.int64)
        for s in np.unique(s_all):
            mk = s_all == s
            cells_all[mk] = np.searchsorted(
                self._h_offsets[s], slot_all[mk], side="right") - 1
        moves = {}                               # shard -> (src, dst, live)
        for c in np.unique(cells_all):
            s, sz = int(c) % self.n_shards, int(store.sizes[c])
            off = int(self._h_offsets[s, c])
            span = np.arange(off, off + sz, dtype=np.int64)
            keep = ~np.isin(span, slot_all[(s_all == s) & (cells_all == c)])
            kcnt = int(keep.sum())
            mv = moves.setdefault(s, ([], [], []))
            mv[0].append(np.concatenate([span[keep], span[:sz - kcnt]]))
            mv[1].append(span)
            mv[2].append(np.arange(sz) < kcnt)
            if self.wide_ids:
                span_gids = self._trans[s, span]
                self._trans[s, off:off + kcnt] = span_gids[keep]
                self._trans[s, off + kcnt:off + sz] = WIDE_NO_ID
            store.sizes[c] = kcnt
            self._h_sizes[s, c] = kcnt
        for s in self._local_shards():
            if s in moves:
                self._compact(s, *(np.concatenate(m) for m in moves[s]))
        if self.wide_ids:
            t = self._trans
            live_t = t != WIDE_NO_ID
            t[live_t] -= np.searchsorted(dels_u, t[live_t]).astype(np.uint64)
        else:
            for s in self._local_shards():
                for view in self._copies(s):
                    ids = view["ids"]
                    d = torch.as_tensor(dels.astype(np.int32),
                                        device=ids.device)
                    below = torch.searchsorted(d, ids, out_int32=True)
                    ids.copy_(torch.where(ids >= 0, ids - below, ids))
        self._upload_sizes()

    def _compact(self, s: int, src, dst, live) -> None:
        """In every copy of shard s: the rows at `src` move to `dst` where
        `live`, and `dst` clears (id -1, zero code, zero decoded row and
        norm) elsewhere; what is read is read before anything is written."""
        for view in self._copies(s):
            dev = view["ids"].device
            src_t = torch.as_tensor(src, device=dev)
            dst_t = torch.as_tensor(dst, device=dev)
            lv = torch.as_tensor(live, device=dev)
            ids = view["ids"]
            new = torch.where(lv, dst_t.to(ids.dtype), -1) if self.wide_ids \
                else torch.where(lv, ids[src_t], -1)
            ids[dst_t] = new
            for key in ("codes", "decoded"):
                arr = view.get(key)
                if arr is not None:
                    arr[dst_t] = torch.where(lv[:, None], arr[src_t],
                                             torch.zeros_like(arr[src_t]))
            if view.get("norms2d") is not None:
                flat = view["norms2d"].view(-1)
                flat[dst_t] = torch.where(lv, flat[src_t],
                                          torch.zeros_like(flat[src_t]))

    def _regrow_distributed(self, new_sizes: np.ndarray) -> None:
        """Re-lay the shards out for a grown cell histogram: capacities grow
        to at least 1.5x the new sizes, cells keep their owner (c % S), so
        the move is a gather within each shard; the views (decoded caches,
        norms) are made again by `_wire`."""
        store = self.index.store
        cfg = self.index.config
        kc, S, a = store.kc, self.n_shards, max(int(self.align), 8)
        cells = np.arange(kc)
        owners = cells % S
        grow = max(float(cfg.cell_slack), 1.5)
        sizes_per_new = np.zeros((S, kc), np.int64)
        sizes_per_new[owners, cells] = new_sizes
        want = np.ceil(sizes_per_new * grow).astype(np.int64) + 8
        caps_per = np.where(sizes_per_new > 0,
                            np.maximum(a, ((want + a - 1) // a) * a), 0)
        offsets_per = np.zeros((S, kc), np.int64)
        np.cumsum(caps_per[:, :-1], axis=1, out=offsets_per[:, 1:])
        cap_shard = _round_up(
            int((offsets_per[:, -1] + caps_per[:, -1]).max()), _LANE)
        cap_pad = _round_up(cap_shard + cfg.scan_chunk + _LANE, _LANE)
        cur = np.asarray(store.sizes, np.int64)
        cell_rep, within = _row_moves(cur)
        s_rep = cell_rep % S
        src = self._h_offsets[s_rep, cell_rep] + within
        dst = offsets_per[s_rep, cell_rep] + within
        pq_codes, ids = [None] * S, [None] * S
        for s in self._local_shards():
            view = self._copies(s)[0]
            dev = view["ids"].device
            mk = s_rep == s
            gidx = np.zeros(cap_pad, np.int64)
            gidx[dst[mk]] = src[mk]
            mask = np.zeros(cap_pad, bool)
            mask[dst[mk]] = True
            g = torch.as_tensor(gidx, device=dev)
            m = torch.as_tensor(mask, device=dev)
            pq_codes[s] = torch.where(m[:, None], view["codes"][g], 0)
            ids[s] = torch.where(m, torch.arange(
                cap_pad, dtype=torch.int32, device=dev), -1) \
                if self.wide_ids else torch.where(m, view["ids"][g], -1)
        trans = None
        if self.wide_ids:
            trans = np.full((S, cap_pad), WIDE_NO_ID, np.uint64)
            trans[s_rep, dst] = self._trans[s_rep, src]
        # the global single-store layout keeps the grown sizes too (save,
        # consolidate and reshard derive from it)
        g_want = np.ceil(new_sizes * grow).astype(np.int64) + 8
        g_caps = np.maximum(a, ((g_want + a - 1) // a) * a)
        g_off = np.zeros(kc, np.int64)
        np.cumsum(g_caps[:-1], out=g_off[1:])
        store.caps, store.offsets = g_caps, g_off
        store._total = int((g_off + g_caps).max()) if kc else 0
        sizes_per = np.zeros((S, kc), np.int64)
        sizes_per[owners, cells] = cur
        parts = dict(
            offsets=offsets_per.astype(np.int32),
            sizes=sizes_per.astype(np.int32), caps=caps_per,
            pq_codes=pq_codes, ids=ids,
            window=_round_up(max(1, int(new_sizes.max(initial=0))), _LANE),
            align=self.align, max_cap=int(caps_per.max(initial=0)))
        if trans is not None:
            parts["trans"] = trans
        self._wire(self.index, self.mesh, parts, distributed=True)

    # -------------------------------------------------------------- search
    def _dispatch(self, queries, k: int, w: int, overlap: bool):
        """Pad and split one query wave over the data groups, search every
        shard and merge: (ids (Bp, k), source shards (Bp, k) in wide mode
        else None, dists (Bp, k), B), as tensors on the first device."""
        if k < 1:
            raise AssertionError("k has to be >= 1")
        if w < 1:
            raise AssertionError("w has to be >= 1")
        # the dense kernels keep at most 128 candidates per probe; every
        # shard keeps its PQ codes, so large k reroutes to the LUT scan, as
        # the single-card index does
        dense = self.scan_mode == "dense" and k <= 128
        cfg = self.index.config
        w = min(w, cfg.kc)
        q = queries if isinstance(queries, torch.Tensor) \
            else torch.as_tensor(np.asarray(queries, np.float32))
        q = q.to(torch.float32)
        B = q.shape[0]
        n_data = self.mesh.shape[DATA_AXIS]
        Bp = _bucket_batch(max(B, n_data))
        Bp = ((Bp + n_data - 1) // n_data) * n_data
        if Bp != B:
            q = torch.nn.functional.pad(q, (0, 0, 0, Bp - B))
        metric = self.index.quant_metric
        gather_win, gather_all = self.gather_plan if dense else (0, False)
        extract = _env_extract()
        opts = dict(
            k=k, w=w, dense=dense,
            include_base=(cfg.score_mode == "reference"
                          or not metric.residual_based),
            apply_rot=self.index.quantizer.method == "opq",
            chunk=self.index._effective_chunk(),
            merge=self.index._resolve_merge_mode(),
            gather_win=gather_win, gather_all=gather_all, extract=extract,
            coarse_engine=_env_coarse_engine(),
            rank_engine=_env_rank_engine(), merge_topk=_env_merge_topk())
        Bl = Bp // n_data
        if self.mesh.multi_process:
            ids, dists, shards = self._dispatch_group(q, Bl, overlap, opts)
            return ids, (shards if self.wide_ids else None), \
                metric.finalize(dists), B
        outs = []
        for g in range(n_data):
            q_g = q[g * Bl:(g + 1) * Bl]
            if overlap and Bl >= 16:
                # two halves, each scanned and merged on its own
                h = Bl // 2
                halves = (self._group_search(g, q_g[:h], **opts),
                          self._group_search(g, q_g[h:], **opts))
                outs.append(tuple(torch.cat(p) for p in zip(*halves)))
            else:
                outs.append(self._group_search(g, q_g, **opts))
        dev0 = self.device
        ids, dists, shards = (torch.cat([o[i].to(dev0) for o in outs])
                              for i in range(3))
        dists = metric.finalize(dists)
        return ids, (shards if self.wide_ids else None), dists, B

    def _dispatch_group(self, q, Bl: int, overlap: bool, opts):
        """The search under a process group: every rank scans the shards
        it holds, every position's (Bl, k) candidates are gathered over the
        ranks, and every rank merges every data group (kernel 6), so each
        returns the whole batch -> raw (ids, dists, source shard) on this
        rank's device."""
        D, S, k = self.mesh.shape[DATA_AXIS], self.n_shards, opts["k"]
        waves = [(0, Bl // 2), (Bl // 2, Bl)] if overlap and Bl >= 16 \
            else [(0, Bl)]
        per_wave = []
        for lo, hi in waves:
            cand = [None] * (D * S)
            for g in range(D):
                q_g = q[g * Bl + lo:g * Bl + hi]
                for s, pair in enumerate(self._group_candidates(g, q_g,
                                                                **opts)):
                    cand[g * S + s] = pair
            ids = self._col.gather([None if c is None else c[0]
                                    for c in cand])
            dists = self._col.gather([None if c is None else c[1]
                                      for c in cand])
            with _on_device(self._home):
                per_wave.append([merge_candidates(
                    ids[g * S:(g + 1) * S], dists[g * S:(g + 1) * S], k)
                    for g in range(D)])
        return tuple(torch.cat([torch.cat([w[g][i] for w in per_wave])
                                for g in range(D)]) for i in range(3))

    def _group_search(self, g: int, q: torch.Tensor, **opts):
        """Every shard of data group g on the queries `q`, then the exact
        cross-shard merge on the group's first device -> raw (ids, dists,
        source shard), -1 / +inf padded."""
        dev0 = self._devices[g][0]
        cand = self._group_candidates(g, q, **opts)
        with _on_device(dev0):
            return merge_candidates([c[0].to(dev0) for c in cand],
                                    [c[1].to(dev0) for c in cand], opts["k"])

    def _group_candidates(self, g: int, q: torch.Tensor, *, k, w, dense,
                          include_base, apply_rot, chunk, merge, gather_win,
                          gather_all, extract, coarse_engine, rank_engine,
                          merge_topk):
        """Each shard's raw (ids, dists) candidates of data group g on the
        queries `q`, on its own device; None for a shard of another rank."""
        cfg = self.index.config
        metric = self.index.quant_metric
        probes, out = {}, []
        for s, view in enumerate(self._group_views[g]):
            if view is None:
                out.append(None)
                continue
            dev = self._devices[g][s]
            coarse, quantizer, _ = self._components(dev)
            with _on_device(dev):
                if dev not in probes:
                    qd = q.to(dev)
                    probes[dev] = qd, (_dense_probe(
                        coarse, quantizer.rotation, qd, w=w, metric=metric,
                        include_base=include_base, apply_rot=apply_rot,
                        residual_based=metric.residual_based,
                        extract=extract, coarse_engine=coarse_engine,
                        rank_engine=rank_engine) if dense else None)
                qd, probe = probes[dev]
                if dense:
                    cells, v, base, norm_coef = probe
                    ids_s, d_s = _dense_finish(
                        cells, v, base, view, k=k, w=w, chunk=chunk,
                        pb=cfg.scan_pb, nf=cfg.scan_fold_lanes,
                        norm_coef=norm_coef, merge=merge, pos8=self.pos8,
                        extract=extract, rank_engine=rank_engine,
                        merge_topk=merge_topk, gather_win=gather_win,
                        gather_all=gather_all)
                else:
                    ids_s, d_s = _lut_search(
                        coarse, quantizer.codebooks, quantizer.rotation,
                        view, qd, k=k, w=w, window=self.window,
                        metric=metric, include_base=include_base,
                        apply_rot=apply_rot,
                        residual_based=metric.residual_based,
                        extract=extract, rank_engine=rank_engine)
            out.append((ids_s, d_s))
        return out

    def _translate_wide(self, slots: np.ndarray, shards: np.ndarray
                        ) -> np.ndarray:
        """(slot, shard) winners -> uint64 global ids; empty results (slot
        -1) become WIDE_NO_ID."""
        out = np.full(slots.shape, WIDE_NO_ID, np.uint64)
        valid = slots >= 0
        out[valid] = self._trans[shards[valid], slots[valid]]
        return out

    def _valid_rows(self, ids: np.ndarray) -> np.ndarray:
        """Pad mask of one padded result row."""
        return ids != WIDE_NO_ID if self.wide_ids else ids >= 0

    def search(self, points, k: int, w: int = 1):
        """`IVFADCIndex.search`'s contract: a single point (d,) -> trimmed
        (ids, dists); a batch -> lists per query. `knn_search` takes both
        kinds of index."""
        if isinstance(points, torch.Tensor):
            pts = points
            out_dtype = np.float32
        else:
            pts = np.asarray(points if not isinstance(points, (list, tuple))
                             else np.stack([np.asarray(p) for p in points]))
            out_dtype = pts.dtype if np.issubdtype(pts.dtype, np.floating) \
                else np.float32
        single = pts.ndim == 1
        if single:
            pts = pts[None, :]
        if pts.shape[1] != self.index.dim:
            raise AssertionError(
                f"query dimension {pts.shape[1]} != index dimension "
                f"{self.index.dim}")
        ids, dists = self.search_padded(pts, k, w=w)
        id_dtype = np.dtype(self.index.config.index_dtype)
        if single:
            m = self._valid_rows(ids[0])
            return ids[0][m].astype(id_dtype), dists[0][m].astype(out_dtype)
        out_i, out_d = [], []
        for row_i, row_d in zip(ids, dists):
            m = self._valid_rows(row_i)
            out_i.append(row_i[m].astype(id_dtype))
            out_d.append(row_d[m].astype(out_dtype))
        return out_i, out_d

    def search_padded(self, queries, k: int, w: int = 1, *,
                      overlap: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """One blocking wave -> numpy (ids (B, k), dists (B, k)).
        `overlap=False` (the default) keeps the results equal to the
        single-card path's; `overlap=True` scans and merges each half of a
        data group's batch (16 queries or more) on its own. Wide-id mode
        returns uint64 ids padded with WIDE_NO_ID, otherwise int32 ids
        padded with -1."""
        ids, shards, dists, B = self._dispatch(queries, k, w, overlap)
        return self._host_ids(ids, shards, B), dists[:B].cpu().numpy()

    def _host_ids(self, ids, shards, B: int) -> np.ndarray:
        ids_h = ids[:B].cpu().numpy()
        if self.wide_ids:
            return self._translate_wide(ids_h, shards[:B].cpu().numpy())
        return ids_h

    def search_stream(self, queries, k: int, w: int = 1, *,
                      batch: int = 16384, overlap: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Search a large query set in waves queued back to back (the host
        reads nothing until the end), as `IVFADCIndex.search_stream`."""
        if not isinstance(queries, torch.Tensor):
            queries = np.asarray(queries, np.float32)
        n = queries.shape[0]
        if n == 0:
            return (np.empty((0, k), np.int32), np.empty((0, k), np.float32))
        outs = [self._dispatch(queries[s:s + batch], k, w, overlap)
                for s in range(0, n, batch)]
        ids = np.concatenate([self._host_ids(i, sh, b)
                              for i, sh, _, b in outs])
        dists = np.concatenate([d[:b].cpu().numpy() for _, _, d, b in outs])
        return ids, dists
