"""Flat padded-CSR posting storage (port of `ivfadc_tpu/models/inverted.py`).

All postings live in two flat arrays, cell-major:

    codes : (total_cap, m)  uint8 — PQ codes
    ids   : (total_cap,)    external 0-based positional ids, -1 in padding

with cell c owning the slot range [offsets[c], offsets[c] + caps[c]) of
which the first sizes[c] slots are live. After a build the flat arrays live
on the index's device and the host copy is made on first use (save,
introspection); after a load they start on the host.

`device_view` holds what the LUT search reads (codes, ids, offsets, sizes);
`device_view_dense` derives what the dense search reads: the decoded
residual cache, int8 with its per-column scale or bf16 (guard-padded past
every cell, feature dim padded to a 128-multiple), and the ids and cached
row norms in (rows/128, 128) layout.

Mutation (append, swap-remove, id shifts, deletes, cell growth) runs on the
host. The first mutation brings codes and ids to the host, where they stay
the truth; the device arrays of the build are dropped. `find` reads ids
only, and a single code row (`_code_rows`) is one device gather until then.
A small delete's renumbering of the survivors waits on the host (`_gone`:
the deleted ids in the host ids' numbering) until something reads the
ids, which then come back current; `find`, `cell_entries` and the flush
convert just what they read. The id -> slot map, once built, is kept up
by every append, swap-remove, grow and small delete.
Mutations record dirty slots, and the next view access patches each cached
view in place, one batched scatter per array, with rows decoded and normed
exactly as a rebuild makes them: a patched view equals a rebuilt one bit
for bit. Dead slots hold a zero code row in the host arrays, so in every
view they hold what a zero code decodes to. Id renumberings run on the
views as one `torch.where` or `searchsorted`. A grown cell relocates to
the end of the flat arrays; a view moves its rows in place while its
guard rows cover the new end and it holds no norm stream, and is dropped
for a rebuild otherwise. `fork` shares the views copy-on-write: the first
write to a shared tensor clones it.

Concurrent readers: a lock per store covers the view accessors (the flush
of pending patches and a view's build) and `fork`, so a search that finds
no pending patch runs after the patches another thread queued, never
before them, and a view is built once. Mutations themselves take no lock:
a caller serializes them with readers (serving.py does).

`MutationLog` records, per consumer, the cells and id renumberings since
its last drain (the JAX package's sharded views replay them).

A store built with neither host nor device arrays is metadata-only
(`has_payload` False): the layout and histogram of a distributed view's
payload-free base, whose postings live on the shards; reading its codes
or ids raises.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ivfadc_tpu_torch.models.graphs import SearchGraphs
from ivfadc_tpu_torch.utils.profiling import count, span

_LANE = 128

# dirty slots beyond max(_DIRTY_LIMIT, total_cap // 8) drop the views for
# a rebuild instead of a patch (the JAX package drops them past 8192, the
# cost of its scatters on the TPU; on the GPU one batched scatter of a
# slot list stays cheaper than a rebuild up to a sizable share of the rows)
_DIRTY_LIMIT = 8192


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _row_norms(decoded: torch.Tensor, scale: Optional[torch.Tensor],
               block: int = 262144) -> torch.Tensor:
    """Per-row ||r_hat||^2 of a decoded cache, from the rows the scan
    kernel sees (int8 with `scale`: bf16 dequantized; bf16 with None: as
    they are), squared in f32. The sum runs in the order of the JAX
    package's reduction on 128-wide rows — sequentially within each
    32-column block, then across the blocks — so the cached norms match it
    bit for bit."""
    n, d = decoded.shape
    outs = []
    for s0 in range(0, n, block):
        rows = decoded[s0:s0 + block].to(torch.bfloat16)
        if scale is not None:
            rows = rows * scale[None, :].to(torch.bfloat16)
        r = rows.to(torch.float32)
        sq = r * r
        if d % 32:
            sq = torch.nn.functional.pad(sq, (0, 32 - d % 32))
        sq = sq.reshape(sq.shape[0], -1, 32)
        part = sq[:, :, 0]
        for i in range(1, 32):
            part = part + sq[:, :, i]
        total = part[:, 0]
        for b in range(1, part.shape[1]):
            total = total + part[:, b]
        outs.append(total)
    return torch.cat(outs) if outs else torch.empty(
        0, dtype=torch.float32, device=decoded.device)


class MutationLog:
    """Per-consumer record of store mutations since the last drain: dirty
    cells plus the ordered global-id renumbering ops. Once either bound is
    exceeded the log collapses to a bare overflow flag (a full re-partition
    is cheaper than replaying that much churn) and stops accumulating."""

    __slots__ = ("cells", "ops", "overflow", "_kc", "__weakref__")

    def __init__(self, kc: int):
        self._kc = kc
        self._reset()

    def _reset(self) -> None:
        self.cells: set = set()
        self.ops: list = []
        self.overflow = False

    def _overflowed(self) -> None:
        self.overflow = True
        self.cells = set()
        self.ops = []

    def log_cell(self, cell: int) -> None:
        if self.overflow:
            return
        self.cells.add(cell)
        if len(self.cells) > max(64, self._kc // 4):
            self._overflowed()

    def log_op(self, op) -> None:
        if self.overflow:
            return
        self.ops.append(op)
        if len(self.ops) > 1024:
            self._overflowed()

    def drain(self) -> dict:
        """-> {"cells": set, "ops": [("shift", t, d) | ("rank", dels)],
        "overflow": bool} and reset."""
        out = dict(cells=self.cells, ops=self.ops, overflow=self.overflow)
        self._reset()
        return out


class PostingStore:
    def __init__(self, kc: int, m: int, code_dtype, *, offsets: np.ndarray,
                 caps: np.ndarray, sizes: np.ndarray,
                 codes: Optional[np.ndarray], ids: Optional[np.ndarray],
                 device, codes_dev: Optional[torch.Tensor] = None,
                 ids_dev: Optional[torch.Tensor] = None):
        self.kc = kc
        self.m = m
        self.code_dtype = np.dtype(code_dtype)
        self.offsets = np.asarray(offsets, np.int64)     # (kc,)
        self.caps = np.asarray(caps, np.int64)           # (kc,)
        self.sizes = np.asarray(sizes, np.int64)         # (kc,)
        self.device = torch.device(device)
        # cell alignment in rows: 128 when every cell start and capacity is
        # lane-aligned (lets the grouped scan read ids in (rows/128, 128)
        # layout and emit external ids), else 8. Derived, so it survives
        # save/load via `caps`.
        self.align = 128 if (len(self.caps)
                             and (self.caps % 128 == 0).all()
                             and (self.offsets % 128 == 0).all()) else 8
        # length of the flat arrays; changed only by _grow_cell. The host
        # arrays may be longer (grown ahead, zero / -1 rows past the end)
        self._total = int((self.offsets + self.caps).max()) if kc else 0
        self._codes_h = codes        # (>= total_cap, m) host | None
        self._ids_h = ids            # (>= total_cap,) int64 host | None
        self._codes_dev = codes_dev  # device arrays from build_device
        self._ids_dev = ids_dev
        self._device: Optional[Dict] = None
        self._device_dense: Optional[Dict] = None
        self._dense_quantizer = None
        # (caps, key, value) of the index's scan chunk (_effective_chunk)
        # and of its gather plan (_gather_plan)
        self._chunk_cache: Optional[tuple] = None
        self._gather_cache: Optional[tuple] = None
        self._dirty_slots: set = set()
        # id -> slot map for find() and the small delete, in the host ids'
        # numbering; built lazily, kept up by appends, removes, grows and
        # small deletes, dropped by shifts and the bulk delete
        self._slot_of: Optional[np.ndarray] = None
        # deleted ids whose renumbering the host ids still wait for, sorted,
        # in the host ids' numbering (None: the host ids are current), and
        # _gone - arange, which maps a current id back to that numbering
        self._gone: Optional[np.ndarray] = None
        self._gone_q: Optional[np.ndarray] = None
        # cells sorted by offset, for slot -> cell (offsets stop being
        # sorted once a grown cell relocates to the end)
        self._cell_order: Optional[np.ndarray] = None
        self._mlogs: "weakref.WeakSet[MutationLog]" = weakref.WeakSet()
        # grows whose rows moved inside the cached views (no rebuild)
        self.grow_patches = 0
        # the index's captured dense searches, which read the dense view's
        # tensors by address: dropped with any view a rebuild replaces, or
        # a tensor a copy-on-write clones
        self.graphs = SearchGraphs()
        # the view accessors and fork (module docstring)
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        return (f"PostingStore({self.kc} cells, m={self.m}, "
                f"{self.code_dtype.name} codes), {int(self.sizes.sum())} "
                f"vectors" + ("" if self.has_payload else " [metadata-only]"))

    @property
    def has_payload(self) -> bool:
        """False for a metadata-only store (the base of a distributed
        view): the cell layout and histogram exist, the codes and ids live
        on the shards."""
        return not (self._codes_h is None and self._codes_dev is None)

    def _payload_missing(self):
        return RuntimeError(
            "metadata-only PostingStore (distributed build) has no host "
            "payload: search and save through the sharded view")

    # ---- host views (hydrated from the device on first use) ----

    @property
    def codes(self) -> np.ndarray:
        if self._codes_h is None:
            if self._codes_dev is None:
                raise self._payload_missing()
            # a copy (astype), never the device tensor's own memory, which
            # a fork may still read
            self._codes_h = self._codes_dev.cpu().numpy().astype(
                self.code_dtype)
        return self._codes_h[:self._total]

    @property
    def ids(self) -> np.ndarray:
        """The host ids, current (a pending renumbering runs first)."""
        ids = self._host_ids()
        self._renumber()
        return ids

    def _host_ids(self) -> np.ndarray:
        """The host ids as held: in the numbering before the pending
        deletes (`_gone`)."""
        if self._ids_h is None:
            if self._ids_dev is None:
                raise self._payload_missing()
            self._ids_h = self._ids_dev.cpu().numpy().astype(np.int64)
        return self._ids_h[:self._total]

    def _renumber(self) -> None:
        """Run the pending renumbering: each live host id drops by the count
        of pending deleted ids below it, and the slot map loses their
        entries. One gather from a running count over the held numbering
        (a live id is never pending, so the count up to it is the count
        below it); its last entry, 0, is what a dead slot's -1 reads."""
        gone = self._gone
        if gone is None:
            return
        self._gone = self._gone_q = None
        ids = self._ids_h[:self._total]
        below = np.zeros(max(int(ids.max()), int(gone[-1])) + 2, np.int64)
        below[gone] = 1
        np.cumsum(below, out=below)
        below[-1] = 0
        ids -= below[ids]
        if self._slot_of is not None:
            self._slot_of = np.delete(self._slot_of,
                                      gone[gone < len(self._slot_of)])

    def _held_ids(self, ids: np.ndarray) -> np.ndarray:
        """Current ids -> the host ids' numbering."""
        if self._gone is None:
            return ids
        return ids + np.searchsorted(self._gone_q, ids, side="right")

    def _current_ids(self, held: np.ndarray) -> np.ndarray:
        """Host ids as held -> current ones (-1 stays -1)."""
        if self._gone is None:
            return held
        return np.where(held >= 0, held - np.searchsorted(self._gone, held),
                        held)

    def _materialize_for_mutation(self) -> None:
        """Host arrays become the truth: the build's device arrays are
        dropped (views already built keep their own tensors)."""
        _ = self.codes, self._host_ids()
        self._codes_dev = None
        self._ids_dev = None

    def _code_rows(self, slots: np.ndarray) -> np.ndarray:
        """Code rows of `slots`: host rows once hydrated, else one device
        gather of just these rows."""
        slots = np.asarray(slots, np.int64)
        if self._codes_h is not None:
            return self._codes_h[slots]
        rows = self._codes_dev[torch.as_tensor(slots, device=self.device)]
        return rows.cpu().numpy().astype(self.code_dtype)

    def fork(self) -> "PostingStore":
        """Copy-on-write clone: host arrays are copied; the build's device
        arrays are shared (no mutation writes them); the cached views are
        shallow-copied dicts whose tensors both sides mark shared, so the
        first write on either side clones the tensor it writes."""
        with self._lock:
            return self._fork()

    def _fork(self) -> "PostingStore":
        t = self._total
        new = PostingStore(
            self.kc, self.m, self.code_dtype,
            offsets=self.offsets.copy(), caps=self.caps.copy(),
            sizes=self.sizes.copy(),
            codes=None if self._codes_h is None else self._codes_h[:t].copy(),
            ids=None if self._ids_h is None else self._ids_h[:t].copy(),
            device=self.device, codes_dev=self._codes_dev,
            ids_dev=self._ids_dev)
        for name in ("_device", "_device_dense"):
            view = getattr(self, name)
            if view is not None:
                view["shared"] = {k for k, v in view.items()
                                  if isinstance(v, torch.Tensor)}
                child = dict(view)
                child["shared"] = set(view["shared"])
                setattr(new, name, child)
        new._dense_quantizer = self._dense_quantizer
        new._dirty_slots = set(self._dirty_slots)
        new._slot_of = None if self._slot_of is None else self._slot_of.copy()
        new._gone, new._gone_q = self._gone, self._gone_q   # never written
        new._cell_order = self._cell_order
        return new

    # ------------------------------------------------------------------ build
    @classmethod
    def build_device(cls, assignments: torch.Tensor, codes: torch.Tensor,
                     kc: int, slack: float = 1.25,
                     align: int = 8) -> "PostingStore":
        """Sort n points by cell (stable, so ids stay in insertion order
        within a cell) into padded CSR on the device of `codes`; only the
        (kc,) cell counts cross to the host."""
        dev = codes.device
        assignments = assignments.to(torch.int64)
        n, m = codes.shape
        counts = torch.bincount(assignments, minlength=kc).cpu().numpy() \
            .astype(np.int64)
        caps = (counts.astype(np.float64) * slack).astype(np.int64) + 8
        caps = np.maximum(align, ((caps + align - 1) // align) * align)
        offsets = np.zeros(kc, np.int64)
        np.cumsum(caps[:-1], out=offsets[1:])
        total = int(offsets[-1] + caps[-1])
        starts = np.zeros(kc, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        order = torch.argsort(assignments, stable=True)
        a_sorted = assignments[order]
        within = torch.arange(n, device=dev) - \
            torch.as_tensor(starts, device=dev)[a_sorted]
        slots = torch.as_tensor(offsets, device=dev)[a_sorted] + within
        flat_codes = torch.zeros((total, m), dtype=codes.dtype, device=dev)
        flat_codes[slots] = codes[order]
        flat_ids = torch.full((total,), -1, dtype=torch.int32, device=dev)
        flat_ids[slots] = order.to(torch.int32)
        code_dtype = np.uint8 if codes.dtype == torch.uint8 else np.uint16
        return cls(kc, m, code_dtype, offsets=offsets, caps=caps,
                   sizes=counts, codes=None, ids=None, device=dev,
                   codes_dev=flat_codes, ids_dev=flat_ids)

    # ------------------------------------------------------------- properties
    @property
    def n(self) -> int:
        return int(self.sizes.sum())

    @property
    def total_cap(self) -> int:
        """Length of the flat arrays. Not sum(caps): a grown cell relocates
        to the end and leaves its old region dead."""
        return self._total

    @property
    def window(self) -> int:
        """Gather width of the LUT search (>= every cell size)."""
        return _round_up(max(1, int(self.caps.max())), _LANE)

    def valid_mask(self) -> np.ndarray:
        return self._host_ids() >= 0

    def cell_entries(self, cell: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, codes) of one cell."""
        o, s = int(self.offsets[cell]), int(self.sizes[cell])
        return (self._current_ids(self._host_ids()[o:o + s]).copy(),
                self.codes[o:o + s].copy())

    def _slots_to_cells(self, slots) -> np.ndarray:
        """Live flat slots -> their cells, through the offset-sorted cell
        order (dead regions map to no cell)."""
        if self._cell_order is None:
            self._cell_order = np.argsort(self.offsets, kind="stable")
        order = self._cell_order
        pos = np.searchsorted(self.offsets[order], slots, side="right") - 1
        return order[pos]

    def _slot_map(self) -> np.ndarray:
        """id in the host ids' numbering -> slot (-1 for dead entries),
        built in one vectorized pass."""
        if self._slot_of is None:
            ids = self._host_ids()
            live = np.nonzero(ids >= 0)[0]
            gone = 0 if self._gone is None else len(self._gone)
            smap = np.full(self.n + gone, -1, np.int64)
            smap[ids[live]] = live
            self._slot_of = smap
        return self._slot_of

    def _note_slots(self, held: np.ndarray, slots: np.ndarray) -> None:
        """The map's entries of ids `held` (host numbering) -> `slots`. The
        map grows ahead by a quarter of its length, so a stream of pushes
        copies it rarely."""
        m = self._slot_of
        if m is None or not held.size:
            return
        top = int(held.max())
        if top >= len(m):
            grow = max(top + 1, len(m) + len(m) // 4) - len(m)
            self._slot_of = m = np.concatenate(
                [m, np.full(grow, -1, np.int64)])
        m[held] = slots

    def find(self, ext_id: int) -> Tuple[int, int]:
        """-> (cell, slot) through the id -> slot map. Reads `ids` only,
        never `codes`."""
        ext_id = int(ext_id)
        smap = self._slot_map()
        held = int(self._held_ids(np.asarray([ext_id]))[0])
        if not (0 <= held < len(smap)) or smap[held] < 0:
            raise KeyError(f"id {ext_id} not in index")
        slot = int(smap[held])
        cell = int(self._slots_to_cells(np.asarray([slot], np.int64))[0])
        return cell, slot

    # ------------------------------------------------------- mutation logging
    def attach_mutation_log(self) -> MutationLog:
        """Attach a fresh per-consumer log; the store keeps only a weak
        reference, so the caller holds it and drains it."""
        log = MutationLog(self.kc)
        self._mlogs.add(log)
        return log

    def _log_cell(self, cell: int) -> None:
        for log in self._mlogs:
            log.log_cell(int(cell))

    def _log_op(self, op) -> None:
        for log in self._mlogs:
            log.log_op(op)

    # ------------------------------------------------- device-view upkeep
    def _invalidate(self) -> None:
        """Drop the cached device views, the index's caches keyed on caps
        and its search graphs; the next search rebuilds them (and reads
        IVFADC_NORMS again)."""
        if self._device is not None or self._device_dense is not None:
            count("view_rebuilds")
        self._device = None
        self._device_dense = None
        self._chunk_cache = None
        self._gather_cache = None
        self._dirty_slots = set()
        self.graphs.clear()

    def _views(self):
        return [v for v in (self._device, self._device_dense) if v is not None]

    def _writable(self, view: Dict, key: str) -> torch.Tensor:
        """view[key] for writing in place: cloned first while a fork still
        shares it (ids2d, a reshape of ids, follows the clone)."""
        shared = view.get("shared")
        if shared and key in shared:
            shared.discard(key)
            view[key] = view[key].clone()
            self.graphs.clear()
            if key == "ids" and view.get("ids2d") is not None:
                view["ids2d"] = view["ids"].reshape(-1, _LANE)
                shared.discard("ids2d")
        return view[key]

    def _dirty_limit(self) -> int:
        return max(_DIRTY_LIMIT, self._total // 8)

    def _mark_dirty(self, slot: int) -> None:
        if self._device is None and self._device_dense is None:
            return
        self._dirty_slots.add(int(slot))
        if len(self._dirty_slots) > self._dirty_limit():
            self._invalidate()

    def _codes_tensor(self, rows: np.ndarray) -> torch.Tensor:
        """Host code rows -> a device tensor in the views' code dtype
        (uint8, or int32 for wider codes); always a copy."""
        if rows.dtype != np.uint8:
            rows = rows.astype(np.int32)
        return torch.tensor(rows, device=self.device)

    def _decode_rows(self, view: Dict, codes: torch.Tensor) -> torch.Tensor:
        """Code rows -> the dense view's decoded rows (feature-padded), by
        the same gathers as a rebuild."""
        from ivfadc_tpu_torch.ops import pq as pq_ops
        q = self._dense_quantizer
        if view["scale"] is not None:
            rows = pq_ops.decode_rotated_int8(q, codes, view["scale"])
        else:
            rows = pq_ops.decode_rotated(q, codes)
        d_pad = view["decoded"].shape[1] - rows.shape[1]
        return torch.nn.functional.pad(rows, (0, d_pad)).to(
            view["decoded"].dtype)

    def _flush_dirty(self) -> None:
        """Patch every cached view at the dirty slots from host truth: one
        batched scatter per array (codes or decoded rows, ids, norms2d),
        and the sizes copied in place."""
        if not self._dirty_slots:
            return
        with span("ivfadc.flush"):
            slots = np.fromiter(self._dirty_slots, np.int64,
                                len(self._dirty_slots))
            slots.sort()
            self._dirty_slots = set()
            count("flushed_slots", slots.size)
            sl = torch.as_tensor(slots, device=self.device)
            code_rows = self._codes_tensor(self.codes[slots])
            held = self._host_ids()[slots]
            id_rows = torch.as_tensor(
                self._current_ids(held).astype(np.int32), device=self.device)
            sizes = torch.as_tensor(self.sizes.astype(np.int32),
                                    device=self.device)
            if self._device is not None:
                view = self._device
                self._writable(view, "codes")[sl] = code_rows
                self._writable(view, "ids")[sl] = id_rows
                self._writable(view, "sizes").copy_(sizes)
            if self._device_dense is not None:
                view = self._device_dense
                rows = self._decode_rows(view, code_rows)
                self._writable(view, "decoded")[sl] = rows
                self._writable(view, "ids")[sl] = id_rows
                if view["norms2d"] is not None:
                    self._writable(view, "norms2d").view(-1)[sl] = \
                        _row_norms(rows, view["scale"])
                self._writable(view, "sizes").copy_(sizes)

    def _dev_shift_ids(self, threshold: int, delta: int) -> None:
        for view in self._views():
            ids = self._writable(view, "ids")
            ids.copy_(torch.where(ids > threshold, ids + delta, ids))

    def _dev_rank_shift(self, dels: np.ndarray) -> None:
        """Each live device id drops by the count of deleted ids below it."""
        views = self._views()
        if not views:
            return
        d = torch.as_tensor(dels.astype(np.int32), device=self.device)
        for view in views:
            ids = self._writable(view, "ids")
            below = torch.searchsorted(d, ids, out_int32=True)
            ids.copy_(torch.where(ids >= 0, ids - below, ids))

    # -------------------------------------------------------------- mutation
    def append(self, cell: int, code_row: np.ndarray, ext_id: int) -> None:
        self._materialize_for_mutation()
        if self.sizes[cell] >= self.caps[cell]:
            self._grow_cell(cell)
        slot = int(self.offsets[cell] + self.sizes[cell])
        held = self._held_ids(np.asarray([ext_id], np.int64))
        self._codes_h[slot] = code_row
        self._ids_h[slot] = held[0]
        self.sizes[cell] += 1
        self._note_slots(held, np.asarray([slot]))
        self._mark_dirty(slot)
        self._log_cell(cell)

    def append_batch(self, cells: np.ndarray, code_rows: np.ndarray,
                     first_ext_id: int) -> None:
        """Point i goes to cells[i] with id first_ext_id + i: the same
        state as len(cells) sequential `append` calls (within a cell in
        input order), written in one vectorized pass."""
        self._materialize_for_mutation()
        cells = np.asarray(cells, np.int64)
        code_rows = np.asarray(code_rows)
        need = np.bincount(cells, minlength=self.kc)
        for c in np.nonzero(self.sizes + need > self.caps)[0]:
            while self.sizes[c] + need[c] > self.caps[c]:
                self._grow_cell(int(c))
        order = np.argsort(cells, kind="stable")
        sorted_cells = cells[order]
        uniq, first = np.unique(sorted_cells, return_index=True)
        within = np.arange(len(cells)) - \
            first[np.searchsorted(uniq, sorted_cells)]
        slots = self.offsets[sorted_cells] + self.sizes[sorted_cells] + within
        held = self._held_ids(first_ext_id + order)
        self._codes_h[slots] = code_rows[order]
        self._ids_h[slots] = held
        self.sizes += need
        self._note_slots(held, slots)
        if self._device is not None or self._device_dense is not None:
            if len(self._dirty_slots) + len(slots) > self._dirty_limit():
                self._invalidate()
            else:
                self._dirty_slots.update(slots.tolist())
        if self._mlogs:
            for c in uniq:
                self._log_cell(int(c))

    def _grow_cell(self, cell: int) -> None:
        """Double one cell's capacity by relocating it to the end of the
        flat arrays; its old region goes dead. The host arrays grow ahead
        by half their length, so a grow copies only the cell's rows."""
        self._materialize_for_mutation()
        count("cell_grows")
        a = self.align
        old_off = int(self.offsets[cell])
        s = int(self.sizes[cell])
        new_cap = ((max(int(self.caps[cell]) * 2, 16) + a - 1) // a) * a
        new_off = self._total
        new_total = new_off + new_cap
        if new_total > len(self._codes_h):
            rows = max(new_total, len(self._codes_h) * 3 // 2) \
                - len(self._codes_h)
            self._codes_h = np.concatenate(
                [self._codes_h, np.zeros((rows, self.m), self.code_dtype)])
            self._ids_h = np.concatenate(
                [self._ids_h, np.full(rows, -1, np.int64)])
        if s:
            self._codes_h[new_off:new_off + s] = \
                self._codes_h[old_off:old_off + s]
            self._codes_h[old_off:old_off + s] = 0
            self._ids_h[new_off:new_off + s] = self._ids_h[old_off:old_off + s]
            self._ids_h[old_off:old_off + s] = -1
            self._note_slots(self._ids_h[new_off:new_off + s],
                             np.arange(new_off, new_off + s))
        if self._dirty_slots:         # remap pending patches that moved
            self._dirty_slots = {
                (d - old_off + new_off if old_off <= d < old_off + s else d)
                for d in self._dirty_slots}
        self.offsets[cell] = new_off
        self.caps[cell] = new_cap
        self._total = new_total
        self._cell_order = None
        self._patch_views_after_grow(old_off, new_off, s, new_cap)

    def _patch_views_after_grow(self, old_off: int, new_off: int, s: int,
                                new_cap: int) -> None:
        """Move the grown cell's rows inside each cached view whose guard
        rows already cover the new end and which holds no norm stream
        (whose rows would have to move too); drop any other view for a
        rebuild. The vacated and the new rows take a zero code's row, as
        the host arrays hold them."""
        views, dropped = [], False
        for name, key in (("_device", "codes"), ("_device_dense", "decoded")):
            view = getattr(self, name)
            if view is None:
                continue
            need = self._total + view.get("guard", 0)
            if (view.get("norms2d") is not None
                    or view[key].shape[0] < need
                    or view["ids"].shape[0] < need):
                setattr(self, name, None)
                self.graphs.clear()
                dropped = True
            else:
                views.append((view, key))
        if dropped:
            count("view_rebuilds")
        if self._device is None and self._device_dense is None:
            self._dirty_slots = set()
        offsets = torch.as_tensor(self.offsets.astype(np.int32),
                                  device=self.device)
        zero = self._codes_tensor(np.zeros((1, self.m), self.code_dtype))
        for view, key in views:
            arr = self._writable(view, key)
            ids = self._writable(view, "ids")
            fill = zero if key == "codes" else self._decode_rows(view, zero)
            if s:
                arr[new_off:new_off + s] = arr[old_off:old_off + s]
                ids[new_off:new_off + s] = ids[old_off:old_off + s]
                arr[old_off:old_off + s] = fill
                ids[old_off:old_off + s] = -1
            arr[new_off + s:new_off + new_cap] = fill
            self._writable(view, "offsets").copy_(offsets)
        if views:
            self.grow_patches += 1

    def remove_slot(self, cell: int, slot: int) -> np.ndarray:
        """Swap-remove one posting: the cell's last row moves into `slot`;
        returns the removed code row."""
        self._materialize_for_mutation()
        codes, ids = self._codes_h, self._ids_h
        last = int(self.offsets[cell] + self.sizes[cell] - 1)
        code = codes[slot].copy()
        removed_id = int(ids[slot])
        moved_id = int(ids[last])
        codes[slot] = codes[last]
        ids[slot] = moved_id if slot != last else -1
        codes[last] = 0
        ids[last] = -1
        self.sizes[cell] -= 1
        if self._slot_of is not None:
            if 0 <= removed_id < len(self._slot_of):
                self._slot_of[removed_id] = -1
            if slot != last:
                self._note_slots(np.asarray([moved_id]), np.asarray([slot]))
        if slot != last:
            self._mark_dirty(slot)
        self._mark_dirty(last)
        self._log_cell(cell)
        return code

    def shift_ids(self, threshold: int, delta: int) -> None:
        """ids > threshold += delta over every cell, on the host and on
        the views."""
        self._materialize_for_mutation()
        ids = self.ids
        ids[ids > threshold] += delta
        self._slot_of = None          # wholesale renumber: rebuild lazily
        self._dev_shift_ids(threshold, delta)
        self._log_op(("shift", int(threshold), int(delta)))

    def delete_ids_incremental(self, dels: np.ndarray) -> int:
        """Small-batch delete that keeps the views patchable, in a bounded
        number of vectorized steps. The hits come from the id -> slot map.
        Each hit cell swap-removes its hits from its highest slot down, each
        hole taking the cell's current last row: round r removes the r-th
        highest hit of every cell at once, so the rounds leave the state of
        `remove_slot` called hit by hit (cells ascending, slots descending)
        and a hole may take a row an earlier round moved. The survivors'
        renumbering by rank runs on the views now and waits on the host
        (`_gone`)."""
        self._materialize_for_mutation()
        dels = np.unique(np.asarray(dels, np.int64))
        held = self._held_ids(dels)
        smap = self._slot_map()
        slots = np.full(dels.size, -1, np.int64)
        known = (held >= 0) & (held < len(smap))
        slots[known] = smap[held[known]]
        if (slots < 0).any():
            raise KeyError(
                f"ids not in index: {dels[slots < 0][:10].tolist()}")
        cells = self._slots_to_cells(slots)
        order = np.lexsort((-slots, cells))
        cells, slots, held = cells[order], slots[order], held[order]
        # each hit's rank among its cell's hits, highest slot first
        starts = np.flatnonzero(np.r_[True, cells[1:] != cells[:-1]])
        rank = np.arange(cells.size) - np.repeat(
            starts, np.diff(np.r_[starts, cells.size]))
        codes, ids = self._codes_h, self._ids_h
        dirty = []
        for r in range(int(rank.max()) + 1 if rank.size else 0):
            pick = rank == r
            c, hole = cells[pick], slots[pick]
            last = self.offsets[c] + self.sizes[c] - 1
            moved = ids[last]
            codes[hole] = codes[last]
            ids[hole] = moved
            codes[last] = 0
            ids[last] = -1
            self.sizes[c] -= 1
            swap = hole != last
            smap[held[pick]] = -1
            smap[moved[swap]] = hole[swap]
            dirty += [hole[swap], last]
        if dirty and self._views():
            self._dirty_slots.update(np.concatenate(dirty).tolist())
            if len(self._dirty_slots) > self._dirty_limit():
                self._invalidate()
        if self._mlogs:
            for c in np.unique(cells):
                self._log_cell(int(c))
        if held.size:
            gone = np.sort(held)
            if self._gone is not None:
                gone = np.insert(self._gone,
                                 np.searchsorted(self._gone, gone), gone)
            self._gone = gone
            self._gone_q = gone - np.arange(gone.size)
            # more pending ids than a quarter of the slots renumber the host
            # ids at once, which bounds the pending list and the slot map's
            # dead entries
            if gone.size > self._total // 4:
                self._renumber()
        self._dev_rank_shift(dels)
        self._log_op(("rank", dels.copy()))
        return int(dels.size)

    def delete_ids(self, ext_ids: np.ndarray) -> int:
        """Batch delete: each hit cell compacts its kept rows in order, and
        every surviving id drops by the number of deleted ids below it; the
        views are rebuilt."""
        dels = np.unique(np.asarray(ext_ids, np.int64))
        if dels.size == 0:
            return 0
        self._materialize_for_mutation()
        codes, ids = self.codes, self.ids
        hit = np.isin(ids, dels) & (ids >= 0)
        hit_slots = np.nonzero(hit)[0]
        if hit_slots.size != dels.size:
            missing = np.setdiff1d(dels, ids[hit_slots])
            raise KeyError(f"ids not in index: {missing[:10].tolist()}")
        cells = self._slots_to_cells(hit_slots)
        for cell in np.unique(cells):
            o, s = int(self.offsets[cell]), int(self.sizes[cell])
            keep = ~hit[o:o + s]
            kept = int(keep.sum())
            codes[o:o + kept] = codes[o:o + s][keep]
            ids[o:o + kept] = ids[o:o + s][keep]
            codes[o + kept:o + s] = 0
            ids[o + kept:o + s] = -1
            self.sizes[cell] = kept
        live = ids >= 0
        ids[live] -= np.searchsorted(dels, ids[live])
        self._slot_of = None
        self._invalidate()
        for c in np.unique(cells):
            self._log_cell(int(c))
        self._log_op(("rank", dels.copy()))
        return int(dels.size)

    # ---------------------------------------------------------------- device
    def _bucket_rows(self, rows: int) -> int:
        """Pad device-array row counts to coarse buckets (the JAX package's
        layout, kept so both packages hold identical device views)."""
        b = 65536 if rows > 65536 else 1024
        return _round_up(rows, b)

    def _codes_on_device(self) -> torch.Tensor:
        if self._codes_dev is not None:
            return self._codes_dev
        return self._codes_tensor(self.codes)

    def _ids_on_device(self) -> torch.Tensor:
        if self._ids_dev is not None:
            return self._ids_dev
        return torch.as_tensor(self.ids.astype(np.int32), device=self.device)

    def _csr_on_device(self) -> Dict:
        return dict(
            offsets=torch.as_tensor(self.offsets.astype(np.int32),
                                    device=self.device),
            sizes=torch.as_tensor(self.sizes.astype(np.int32),
                                  device=self.device))

    def device_view(self) -> Dict:
        """Cached arrays for the LUT search: the flat codes and ids, row
        counts padded to the bucket (-1 ids), and the CSR offsets/sizes.
        The view owns its tensors (patches write them in place)."""
        with self._lock:
            return self._device_view()

    def _device_view(self) -> Dict:
        self._flush_dirty()
        if self._device is None:
            codes = self._codes_on_device()
            ids = self._ids_on_device()
            pad = self._bucket_rows(codes.shape[0]) - codes.shape[0]
            codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
            self._device = dict(codes=codes, ids=ids,
                                **self._csr_on_device())
        return self._device

    def device_view_dense(self, quantizer, chunk: int,
                          cache: str = "int8") -> Dict:
        """Cached arrays for the dense scan: resident decoded residuals
        (rotated space) — cache="int8" with a per-column scale, "bf16" as
        bf16 rows with no scale — guard-padded past every cell and
        zero-padded on the feature dim to a 128-multiple (zero features
        change neither dot products nor norms); ids, and — for 128-row
        aligned stores — ids2d and the cached row norms norms2d in
        (rows/128, 128) layout; `guard`, the rows a scan may read past the
        last cell. The view is rebuilt when the cache type changes or after
        `_invalidate()`, and patched in place after mutations.
        IVFADC_NORMS is read when the view is built, as the JAX package
        reads it: set to anything but "cache" it leaves norms2d out (None),
        and the grouped scan then computes the row norms in its kernel;
        toggling it takes effect at the next rebuild."""
        if cache not in ("int8", "bf16"):
            raise ValueError(f"cache must be 'int8' or 'bf16', got {cache!r}")
        with self._lock:
            return self._device_view_dense(quantizer, chunk, cache)

    def _device_view_dense(self, quantizer, chunk: int, cache: str) -> Dict:
        from ivfadc_tpu_torch.ops import pq as pq_ops
        self._dense_quantizer = quantizer
        if (self._device_dense is not None
                and self._device_dense["cache"] != cache):
            self._device_dense = None            # cache type switch: rebuild
            count("view_rebuilds")
            self.graphs.clear()
        self._flush_dirty()
        if self._device_dense is None:
            if cache == "int8":
                scale = pq_ops.cache_scale(quantizer)
                decoded = pq_ops.decode_rotated_int8(
                    quantizer, self._codes_on_device(), scale)
            else:
                scale = None
                decoded = pq_ops.decode_rotated(quantizer,
                                                self._codes_on_device())
            total = decoded.shape[0]
            guard = self._bucket_rows(total + chunk + _LANE) - total
            d_pad = _round_up(decoded.shape[1], _LANE) - decoded.shape[1]
            decoded = torch.nn.functional.pad(decoded, (0, d_pad, 0, guard))
            if scale is not None:
                # padded columns hold zero codes; their scale only has to
                # be finite for the kernel's multiply
                scale = torch.nn.functional.pad(scale, (0, d_pad), value=1.0)
            ids = torch.nn.functional.pad(self._ids_on_device(), (0, guard),
                                          value=-1)
            ids2d = None
            if self.align % _LANE == 0 and ids.shape[0] % _LANE == 0:
                ids2d = ids.reshape(-1, _LANE)
            norms2d = None
            if ids2d is not None and \
                    os.environ.get("IVFADC_NORMS", "cache") == "cache":
                norms2d = _row_norms(decoded, scale).reshape(-1, _LANE)
            self._device_dense = dict(
                decoded=decoded, ids=ids, ids2d=ids2d, norms2d=norms2d,
                scale=scale, cache=cache, guard=chunk + _LANE,
                **self._csr_on_device())
        return self._device_dense
