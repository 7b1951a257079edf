"""Inputs of a run, made on the device from the run's seed.

A frozen copy of `ivfadc_tpu_torch.utils.datasets.synthetic_clustered_device`
(centers plus Gaussian noise, drawn by a `torch.Generator` on the device),
kept here so that a change to the program cannot change the data the
benchmark measures it on.
"""

from __future__ import annotations

import hashlib

import torch

# streams of one run seed: each input has a generator of its own
# (STREAM_TRAIN: the reference's own training)
STREAM_BASE, STREAM_QUERIES, STREAM_CONFIG, STREAM_TRAIN, \
    STREAM_SAMPLE = range(5)


def sub_seed(seed: int, stream: int) -> int:
    """A 62-bit seed for one stream of a run seed (any whole number)."""
    h = hashlib.sha256(f"annbench:{int(seed)}:{int(stream)}".encode())
    return int(h.hexdigest()[:15], 16) >> 2


def clustered(n: int, d: int, n_clusters: int, noise: float, seed: int,
              device) -> torch.Tensor:
    """(n, d) float32 Gaussian-mixture points on `device`."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(seed, STREAM_BASE))
    centers = torch.randn((n_clusters, d), generator=g, device=dev)
    which = torch.randint(0, n_clusters, (n,), generator=g, device=dev)
    return centers[which] + noise * torch.randn((n, d), generator=g,
                                                device=dev)


def near_base(base: torch.Tensor, nq: int, noise: float,
              seed: int) -> torch.Tensor:
    """(nq, d) queries: base points drawn from the seed plus `noise`
    Gaussian noise, on the base's device."""
    g = torch.Generator(device=base.device)
    g.manual_seed(sub_seed(seed, STREAM_QUERIES))
    idx = torch.randint(0, base.shape[0], (nq,), generator=g,
                        device=base.device)
    return base[idx] + noise * torch.randn((nq, base.shape[1]), generator=g,
                                           device=base.device)


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    """(base, queries) of a cell: the configuration's data and the
    traffic's query pool."""
    data = cfg["data"]
    base = clustered(data["n"], data["d"], data["n_clusters"], data["noise"],
                     seed, device)
    queries = near_base(base, traffic["pool"], traffic["query_noise"], seed)
    return base, queries
