"""Flat padded-CSR posting storage (port of `ivfadc_tpu/models/inverted.py`,
read-only part).

All postings live in two flat arrays, cell-major:

    codes : (total_cap, m)  uint8 — PQ codes
    ids   : (total_cap,)    external 0-based positional ids, -1 in padding

with cell c owning the slot range [offsets[c], offsets[c] + caps[c]) of
which the first sizes[c] slots are live. After a build the flat arrays live
on the index's device and the host copy is made on first use (save,
introspection); after a load they start on the host.

`device_view` holds what the LUT search reads (codes, ids, offsets, sizes);
`device_view_dense` derives what the dense search reads: the int8 decoded
residual cache (guard-padded past every cell, feature dim padded to a
128-multiple), its per-column scale, and the ids and cached row norms in
(rows/128, 128) layout. Mutation (push/pop/delete), overlays and mutation
logs are not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_LANE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _row_norms(decoded: torch.Tensor, scale: torch.Tensor,
               block: int = 262144) -> torch.Tensor:
    """Per-row ||r_hat||^2 of an int8 decoded cache, from the rows the scan
    kernel sees (bf16 dequantized, squared in f32). The sum runs in the
    order of the JAX package's reduction on 128-wide rows — sequentially
    within each 32-column block, then across the blocks — so the cached
    norms match it bit for bit."""
    n, d = decoded.shape
    outs = []
    for s0 in range(0, n, block):
        rows = decoded[s0:s0 + block].to(torch.bfloat16) \
            * scale[None, :].to(torch.bfloat16)
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
        self._codes_h = codes        # (total_cap, m) host | None
        self._ids_h = ids            # (total_cap,) int64 host | None
        self._codes_dev = codes_dev  # device arrays from build_device
        self._ids_dev = ids_dev
        self._device: Optional[Dict] = None
        self._device_dense: Optional[Dict] = None

    # ---- host views (hydrated from the device on first use) ----
    @property
    def codes(self) -> np.ndarray:
        if self._codes_h is None:
            self._codes_h = self._codes_dev.cpu().numpy().astype(
                self.code_dtype, copy=False)
        return self._codes_h

    @property
    def ids(self) -> np.ndarray:
        if self._ids_h is None:
            self._ids_h = self._ids_dev.cpu().numpy().astype(np.int64)
        return self._ids_h

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
        """Length of the flat arrays."""
        if self.kc == 0:
            return 0
        return int((self.offsets + self.caps).max())

    @property
    def window(self) -> int:
        """Gather width of the LUT search (>= every cell size)."""
        return _round_up(max(1, int(self.caps.max())), _LANE)

    def cell_entries(self, cell: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, codes) of one cell."""
        o, s = int(self.offsets[cell]), int(self.sizes[cell])
        return self.ids[o:o + s].copy(), self.codes[o:o + s].copy()

    def _bucket_rows(self, rows: int) -> int:
        """Pad device-array row counts to coarse buckets (the JAX package's
        layout, kept so both packages hold identical device views)."""
        b = 65536 if rows > 65536 else 1024
        return _round_up(rows, b)

    def _codes_on_device(self) -> torch.Tensor:
        if self._codes_dev is not None:
            return self._codes_dev
        codes = self.codes
        if codes.dtype != np.uint8:
            codes = codes.astype(np.int32)
        return torch.as_tensor(codes, device=self.device)

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
        counts padded to the bucket (-1 ids), and the CSR offsets/sizes."""
        if self._device is None:
            codes = self._codes_on_device()
            ids = self._ids_on_device()
            pad = self._bucket_rows(codes.shape[0]) - codes.shape[0]
            if pad:
                codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
                ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
            self._device = dict(codes=codes, ids=ids,
                                **self._csr_on_device())
        return self._device

    def device_view_dense(self, quantizer, chunk: int,
                          cache: str = "int8") -> Dict:
        """Cached arrays for the dense scan: resident int8 decoded residuals
        (rotated space) and their per-column scale, guard-padded past every
        cell and zero-padded on the feature dim to a 128-multiple (zero
        features change neither dot products nor norms); ids, and — for
        128-row aligned stores — ids2d and the cached row norms norms2d in
        (rows/128, 128) layout. IVFADC_NORMS set to anything but "cache"
        leaves norms2d out (None): the grouped scan then computes the row
        norms in its kernel."""
        from ivfadc_tpu_torch.ops import pq as pq_ops
        if cache != "int8":
            raise NotImplementedError(
                f"the {cache!r} decoded cache is a grouped-scan variant not "
                f"ported yet (ROADMAP B.8)")
        if self._device_dense is None:
            scale = pq_ops.cache_scale(quantizer)
            decoded = pq_ops.decode_rotated_int8(
                quantizer, self._codes_on_device(), scale)
            total = decoded.shape[0]
            guard = self._bucket_rows(total + chunk + _LANE) - total
            d_pad = _round_up(decoded.shape[1], _LANE) - decoded.shape[1]
            decoded = torch.nn.functional.pad(decoded, (0, d_pad, 0, guard))
            # padded columns hold zero codes; their scale only has to be
            # finite for the kernel's multiply
            scale = torch.nn.functional.pad(scale, (0, d_pad), value=1.0)
            ids = torch.nn.functional.pad(self._ids_on_device(), (0, guard),
                                          value=-1)
            ids2d = None
            if self.align % _LANE == 0 and ids.shape[0] % _LANE == 0:
                ids2d = ids.reshape(-1, _LANE)
            self._device_dense = dict(
                decoded=decoded, ids=ids, ids2d=ids2d, norms2d=None,
                scale=scale, **self._csr_on_device())
        view = self._device_dense
        if os.environ.get("IVFADC_NORMS", "cache") != "cache":
            return {**view, "norms2d": None}
        if view["norms2d"] is None and view["ids2d"] is not None:
            view["norms2d"] = _row_norms(view["decoded"], view["scale"]) \
                .reshape(-1, _LANE)
        return view
