"""Device meshes for the sharded view (port of `ivfadc_tpu/parallel/mesh.py`).

A mesh is an (n_data, n_shards) grid of torch devices: inverted lists are
sharded over the "shard" axis, query batches over the "data" axis, and
the trained components (centroids, codebooks) are copied to every device
that holds a shard. A device may appear more than once: several shards
then share one card (or the CPU), each with arrays of its own.

Under a process group (parallel/bootstrap.py) `make_mesh()` lays out the
GLOBAL device list: every process's local devices, in process order, as
JAX orders global devices. The mesh records the rank that owns each
position (g, s); a position is addressable where that rank is this
process. A mesh made from an explicit device list is this process's
alone.

The JAX package's `shard_spec` / `replicated_spec` / `data_spec` have no
counterpart here: every per-shard tensor names its device explicitly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

SHARD_AXIS = "shard"
DATA_AXIS = "data"


def canonical(dev) -> torch.device:
    """A device with its index spelled out ("cuda" -> "cuda:<current>"), so
    equal devices compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An (n_data, n_shards) grid of torch devices. `devices[g, s]` holds
    shard s of data group g; `shape` maps each axis name to its size, as
    a JAX mesh's does."""

    def __init__(self, devices: np.ndarray, owners=None, rank: int = 0):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is 2-D (data, shard), got "
                             f"{devices.shape}")
        self.devices = devices
        self.shape = {DATA_AXIS: devices.shape[0],
                      SHARD_AXIS: devices.shape[1]}
        # owning rank of each position, and this process's rank
        self.owners = (np.zeros(devices.shape, np.int64) if owners is None
                       else np.asarray(owners, np.int64).reshape(
                           devices.shape))
        self.rank = rank
        self.process_count = int(self.owners.max()) + 1

    @property
    def multi_process(self) -> bool:
        return self.process_count > 1

    def is_local(self, g: int, s: int) -> bool:
        """Position (g, s) is addressable in this process."""
        return int(self.owners[g, s]) == self.rank

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[DATA_AXIS]} data x "
                f"{self.shape[SHARD_AXIS]} shards: "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def make_mesh(n_shards: int = 0, n_data: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, shard) mesh. n_shards=0 -> use all remaining devices.
    `devices` defaults to every visible CUDA device (there is no CPU
    default), or under a process group to the global device list; an
    explicit list may name one device more than once."""
    from ivfadc_tpu_torch.parallel import bootstrap
    owners = None
    if devices is None and bootstrap.is_multi_process():
        st = bootstrap.state()
        devices = [d for devs in st["per_rank"] for d in devs]
        owners = [r for r, devs in enumerate(st["per_rank"]) for _ in devs]
    elif devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass `devices` "
                "explicitly (e.g. [torch.device('cpu')] * 8) to place "
                "shards elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_shards == 0:
        n_shards = len(devices) // n_data
        if n_shards == 0:
            raise ValueError(
                f"n_data={n_data} exceeds the {len(devices)} available "
                "devices — no room for a shard axis")
    need = n_data * n_shards
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    if owners is None:
        return Mesh(grid.reshape(n_data, n_shards))
    if len(set(owners[:need])) != bootstrap.state()["world"]:
        raise ValueError(
            f"a {n_data} x {n_shards} mesh leaves a process without a "
            f"position; every process of the group must hold one")
    return Mesh(grid.reshape(n_data, n_shards), owners[:need],
                bootstrap.state()["rank"])
