"""Multi-process bootstrap: the `torch.distributed` entry path (port of
`ivfadc_tpu/parallel/bootstrap.py`).

Call `initialize_cluster()` first thing in every process of a job; then
`make_mesh()` sees the GLOBAL device list (every process's local devices,
in process order), and `ShardedIVFADCIndex.build` / `save_sharded_index` /
`load_sharded_index` work per process on the shards its devices hold.

Where the settings come from, in this order: the arguments; the
`IVFADC_COORDINATOR` (host:port of process 0) / `IVFADC_NUM_PROCESSES` /
`IVFADC_PROCESS_ID` / `IVFADC_LOCAL_DEVICE_IDS` (comma-separated)
environment variables; torchrun's `MASTER_ADDR` + `MASTER_PORT` +
`WORLD_SIZE` + `RANK` (+ `LOCAL_RANK` for the card). torch resolves no
TPU / SLURM / MPI metadata, so these stand in for JAX's auto-detection.
With none of them this is a no-op returning False.

The process group is formed on gloo; each process then publishes its
local devices (`host|device`) to every other. When every process drives
cards of its own, the collectives run on an NCCL group made beside it;
otherwise (several processes on one card, or the CPU) on gloo, which then
moves the collectives' buffers through host memory (parallel/collectives.py).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional, Sequence

import torch

_INITIALIZED = False
# rank, world, local devices, every rank's devices, backend, the
# collectives' process group (None: the default group)
_STATE: dict = {}

# how long a collective waits for a missing rank before it raises
_TIMEOUT = datetime.timedelta(seconds=600)


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _local_devices(local_device_ids: Optional[Sequence[int]],
                   rank: int) -> List[str]:
    """This process's devices: the named cards (default: LOCAL_RANK, else
    rank modulo the visible cards), or as many CPU entries as ids named
    where no card is visible."""
    if torch.cuda.is_available():
        if local_device_ids is None:
            lr = _int_env("LOCAL_RANK")
            local_device_ids = [lr if lr is not None
                                else rank % torch.cuda.device_count()]
        return [f"cuda:{int(i)}" for i in local_device_ids]
    return ["cpu"] * len(local_device_ids or [0])


def _gather_devices(local: List[str]) -> List[List[str]]:
    """Every rank's `host|device` list, in rank order (one collective on
    the default group)."""
    import torch.distributed as dist
    host = socket.gethostname()
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, [f"{host}|{d}" for d in local])
    return out


def _choose_backend(per_rank: List[List[str]]) -> str:
    """nccl when every rank drives cards no other rank drives, else gloo
    (NCCL refuses two ranks on one card)."""
    owner = {}
    for r, devs in enumerate(per_rank):
        for d in devs:
            if "|cuda" not in d or owner.setdefault(d, r) != r:
                return "gloo"
    return "nccl"


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       local_device_ids: Optional[Sequence[int]] = None,
                       ) -> bool:
    """Join (or form) the process group. Returns True iff a multi-process
    runtime was initialized (idempotent: repeat calls after a successful
    init return True and touch nothing). With no arguments and no cluster
    environment it returns False and touches nothing."""
    global _INITIALIZED
    if _INITIALIZED:
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get("IVFADC_COORDINATOR")
    if num_processes is None:
        num_processes = _int_env("IVFADC_NUM_PROCESSES")
    if process_id is None:
        process_id = _int_env("IVFADC_PROCESS_ID")
    if local_device_ids is None:
        raw = env.get("IVFADC_LOCAL_DEVICE_IDS")
        if raw:
            local_device_ids = [int(x) for x in raw.split(",")]
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None or local_device_ids is not None)
    if not explicit:
        if not all(v in env for v in ("MASTER_ADDR", "MASTER_PORT",
                                      "WORLD_SIZE", "RANK")):
            return False                          # single-process: no-op
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize_cluster needs the coordinator address, the number "
            "of processes and this process's id (arguments, IVFADC_* or "
            "torchrun's variables)")
    import torch.distributed as dist
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    local = _local_devices(local_device_ids, int(process_id))
    if local[0].startswith("cuda"):
        torch.cuda.set_device(torch.device(local[0]))
    dist.init_process_group(backend="gloo", init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=_TIMEOUT)
    per_rank = _gather_devices(local)
    backend = _choose_backend(per_rank)
    group = dist.new_group(backend="nccl") if backend == "nccl" else None
    _STATE.update(rank=int(process_id), world=int(num_processes),
                  local=[torch.device(d) for d in local],
                  per_rank=[[torch.device(d.split("|", 1)[1]) for d in devs]
                            for devs in per_rank],
                  backend=backend, group=group)
    _INITIALIZED = True
    return True


def shutdown_cluster() -> None:
    """Tear down the process group (end-of-job cleanup)."""
    global _INITIALIZED
    if _INITIALIZED:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        _STATE.clear()
        _INITIALIZED = False


def is_multi_process() -> bool:
    return _INITIALIZED and _STATE.get("world", 1) > 1


def state() -> dict:
    """The cluster's settings (empty when not initialized)."""
    return _STATE


def process_info() -> dict:
    """This process's view of the cluster: counts for logging and sanity
    checks, under the JAX package's keys."""
    if _INITIALIZED:
        return {
            "process_index": _STATE["rank"],
            "process_count": _STATE["world"],
            "local_device_count": len(_STATE["local"]),
            "global_device_count": sum(len(d) for d in _STATE["per_rank"]),
            "initialized": True,
            "backend": _STATE["backend"],
        }
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_index": 0, "process_count": 1,
            "local_device_count": n, "global_device_count": n,
            "initialized": False}
