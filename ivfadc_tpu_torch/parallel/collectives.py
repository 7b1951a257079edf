"""Collectives over a mesh's positions: the port's stand-in for the XLA
collectives inside the JAX package's `shard_map` programs.

A `Collectives` object spans a list of mesh positions (g, s). Over both
axes the positions are numbered p = g * S + s, data-major, as
`ivfadc_tpu/parallel/build.py` numbers devices; over the data axis alone
there is one position a data group, (g, 0). Each position's tensor lives
on its own device.

  * One process: every position is local, and a collective is moving
    tensors between devices.
  * Under a process group (parallel/bootstrap.py): each rank holds the
    tensors of the positions it owns (None elsewhere), and the ops go
    through `torch.distributed`. Under gloo the buffers move through host
    memory (gloo's collectives take CPU tensors); the compute stays on
    the devices.

Every float reduction is deterministic and independent of the process
layout: the per-position partials are gathered in position order and
summed in that order on one device (this process's first device of the
mesh, `home`). A group of any size then equals the single-process run bit
for bit, which `all_reduce` (the backend's summation order) would not.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ivfadc_tpu_torch.parallel.mesh import (DATA_AXIS, SHARD_AXIS, Mesh,
                                            canonical)


def _positions(mesh: Mesh, axes) -> List[tuple]:
    D, S = mesh.shape[DATA_AXIS], mesh.shape[SHARD_AXIS]
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    if set(axes) == {DATA_AXIS, SHARD_AXIS}:
        return [(g, s) for g in range(D) for s in range(S)]
    if axes == (DATA_AXIS,):
        return [(g, 0) for g in range(D)]
    raise ValueError(f"unsupported collective axes {axes!r}")


class Collectives:
    """Collectives over the positions of `mesh` along `axes` (the data axis,
    or both axes)."""

    def __init__(self, mesh: Mesh, axes=(DATA_AXIS, SHARD_AXIS)):
        self.mesh = mesh
        self.positions = _positions(mesh, axes)
        self.owners = [int(mesh.owners[g, s]) for g, s in self.positions]
        self.rank = mesh.rank
        self.devices = [canonical(mesh.devices[g, s]) if o == self.rank
                        else torch.device(mesh.devices[g, s])
                        for (g, s), o in zip(self.positions, self.owners)]
        self.local = [i for i, o in enumerate(self.owners) if o == self.rank]
        self.multi = mesh.multi_process
        flat = [(g, s) for g in range(mesh.shape[DATA_AXIS])
                for s in range(mesh.shape[SHARD_AXIS])]
        self.home = canonical(next(mesh.devices[g, s] for g, s in flat
                                   if mesh.is_local(g, s)))
        self.group = None
        self.backend = None
        if self.multi:
            from ivfadc_tpu_torch.parallel import bootstrap
            st = bootstrap.state()
            self.group, self.backend = st["group"], st["backend"]
            self.world = st["world"]
            if not self.local:
                raise ValueError(
                    f"rank {self.rank} holds no position along {axes!r}; "
                    f"every rank of the group must hold one")

    def __len__(self) -> int:
        return len(self.positions)

    # ------------------------------------------------------------ placement
    def split(self, full, n_rows: int) -> list:
        """Rows [i * n_rows, (i + 1) * n_rows) of `full` (host array or
        tensor, already padded) on position i's device; None where the
        position is not local."""
        out = [None] * len(self)
        for i in self.local:
            rows = full[i * n_rows:(i + 1) * n_rows]
            out[i] = torch.as_tensor(rows).to(self.devices[i])
        return out

    # --------------------------------------------------------- transports
    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.home) if self.backend == "nccl" else t.cpu()

    def _from_wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.home)

    def allgather_object(self, obj) -> list:
        """One object from every rank, in rank order (a list of one entry
        in one process)."""
        if not self.multi:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj, src_rank: int):
        if not self.multi:
            return obj
        import torch.distributed as dist
        box = [obj if self.rank == src_rank else None]
        dist.broadcast_object_list(box, src=src_rank)
        return box[0]

    # ---------------------------------------------------------- collectives
    def gather(self, parts: Sequence[Optional[torch.Tensor]]
               ) -> List[torch.Tensor]:
        """Every position's tensor (all of one shape and dtype), in position
        order, on `home`."""
        if not self.multi:
            return [p.to(self.home) for p in parts]
        import torch.distributed as dist
        ref = parts[self.local[0]]
        shape, dtype = tuple(ref.shape), ref.dtype
        per_rank = [[i for i, o in enumerate(self.owners) if o == r]
                    for r in range(self.world)]
        width = max(len(p) for p in per_rank)
        buf = torch.zeros((width,) + shape, dtype=dtype)
        buf = self._to_wire(buf)
        for j, i in enumerate(self.local):
            buf[j].copy_(parts[i])
        bufs = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(bufs, buf, group=self.group)
        out = [None] * len(self)
        for r, idx in enumerate(per_rank):
            for j, i in enumerate(idx):
                out[i] = self._from_wire(bufs[r][j])
        return out

    def sum(self, parts: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """Sum over positions, taken in position order on `home`."""
        gathered = self.gather(parts)
        total = gathered[0].clone()
        for t in gathered[1:]:
            total = total + t
        return total

    def broadcast(self, t: Optional[torch.Tensor], src: int = 0
                  ) -> torch.Tensor:
        """Position `src`'s tensor on every rank's `home`."""
        if not self.multi:
            return t.to(self.home)
        import torch.distributed as dist
        src_rank = self.owners[src]
        meta = self.broadcast_object(
            (tuple(t.shape), t.dtype) if self.rank == src_rank else None,
            src_rank)
        buf = self._to_wire(t) if self.rank == src_rank else \
            self._to_wire(torch.empty(meta[0], dtype=meta[1]))
        dist.broadcast(buf, src=src_rank, group=self.group)
        return self._from_wire(buf)

    def take_rows(self, parts: Sequence[Optional[torch.Tensor]],
                  idx: np.ndarray, n_rows: int) -> torch.Tensor:
        """Rows `idx` (sorted global row numbers) of the row-split array
        whose position i holds rows [i * n_rows, (i + 1) * n_rows), in
        `idx` order, on `home`."""
        idx = np.asarray(idx, np.int64)
        pos = idx // n_rows
        sel = [idx[pos == i] - i * n_rows for i in range(len(self))]
        width = max(1, max(len(x) for x in sel))
        ref = parts[self.local[0]]
        blocks = [None] * len(self)
        for i in self.local:
            blk = torch.zeros((width,) + tuple(ref.shape[1:]),
                              dtype=ref.dtype, device=self.devices[i])
            rows = torch.as_tensor(sel[i], device=self.devices[i])
            blk[:len(sel[i])] = parts[i][rows]
            blocks[i] = blk
        gathered = self.gather(blocks)
        return torch.cat([g[:len(s)] for g, s in zip(gathered, sel)])

    def exchange(self, payloads: Sequence[Optional[torch.Tensor]],
                 dests: Sequence[Optional[torch.Tensor]],
                 wanted: Dict[int, Sequence[int]]) -> Dict[int,
                                                           torch.Tensor]:
        """Route rows to the ranks that want their destination: position i
        sends payloads[i] (n_i, W) uint8 row by row to `dests[i]` (n_i,)
        i64; `wanted[r]` names the destinations rank r takes. Returns
        {destination this rank wants: its rows (uint8, on `home`)}, rows
        from earlier positions first."""
        if not self.multi:
            out = {}
            for d in wanted[self.rank]:
                out[d] = torch.cat([payloads[i][dests[i] == d].to(self.home)
                                    for i in self.local])
            return out
        import torch.distributed as dist
        W = next(payloads[i].shape[1] for i in self.local)
        send, counts = [], []
        for r in range(self.world):
            want = torch.as_tensor(list(wanted[r]), dtype=torch.int64)
            rows = []
            for i in self.local:
                d = dests[i]
                hit = torch.isin(d, want.to(d.device))
                tag = d[hit].to(torch.int64).contiguous().view(
                    torch.uint8).reshape(-1, 8)
                rows.append(torch.cat([tag, payloads[i][hit]], dim=1))
            rows = torch.cat(rows) if rows else torch.zeros(
                (0, W + 8), dtype=torch.uint8)
            send.append(self._to_wire(rows))
            counts.append(rows.shape[0])
        mat = self.allgather_object(counts)        # mat[src][dst]
        recv_n = [mat[src][self.rank] for src in range(self.world)]
        inp = torch.cat([s.reshape(-1) for s in send])
        out = self._to_wire(torch.empty(sum(recv_n) * (W + 8),
                                        dtype=torch.uint8))
        dist.all_to_all_single(out, inp, [n * (W + 8) for n in recv_n],
                               [n * (W + 8) for n in counts],
                               group=self.group)
        rows = self._from_wire(out).reshape(-1, W + 8)
        tag = rows[:, :8].contiguous().view(torch.int64).reshape(-1)
        return {d: rows[tag == d, 8:] for d in wanted[self.rank]}

    def max_host(self, arr: np.ndarray) -> np.ndarray:
        """Element-wise max of a host array over the ranks."""
        if not self.multi:
            return arr
        return np.max(np.stack(self.allgather_object(arr)), axis=0)
