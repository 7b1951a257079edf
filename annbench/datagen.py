"""Inputs of a run, made on the device from the run's seed.

A frozen copy of `ivfadc_tpu_torch.utils.datasets.synthetic_clustered_device`
(centers plus Gaussian noise, drawn by a `torch.Generator` on the device),
kept here so that a change to the program cannot change the data the
benchmark measures it on. The points a mutating driver pushes (`pushed`)
are drawn from the same mixture, on streams of their own.
"""

from __future__ import annotations

import hashlib

import torch

# streams of one run seed: each input has a generator of its own
# (STREAM_TRAIN: the reference's own training; STREAM_PUSH, STREAM_DELETE:
# a mutating driver's pushed points and deleted ids, one part a mutation)
STREAM_BASE, STREAM_QUERIES, STREAM_CONFIG, STREAM_TRAIN, \
    STREAM_SAMPLE, STREAM_PUSH, STREAM_DELETE = range(7)


def sub_seed(seed: int, stream: int, part: int = None) -> int:
    """A 62-bit seed for one stream of a run seed (any whole number), or
    for one `part` of it."""
    key = f"annbench:{int(seed)}:{int(stream)}"
    if part is not None:
        key += f":{int(part)}"
    h = hashlib.sha256(key.encode())
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


def centers(d: int, n_clusters: int, seed: int, device) -> torch.Tensor:
    """The mixture's (n_clusters, d) centers: the first draw of the base
    stream, as `clustered` draws them."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(seed, STREAM_BASE))
    return torch.randn((n_clusters, d), generator=g, device=dev)


def pushed(data: dict, seed: int, first: int, count: int,
           device) -> torch.Tensor:
    """(count, d) float32 points `first .. first+count-1` of the run's
    pushed stream: the configuration's mixture (the base's centers and
    noise), drawn by a generator of their own from (seed, first)."""
    dev = torch.device(device)
    c = centers(data["d"], data["n_clusters"], seed, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(seed, STREAM_PUSH, first))
    which = torch.randint(0, c.shape[0], (count,), generator=g, device=dev)
    return c[which] + data["noise"] * torch.randn(
        (count, c.shape[1]), generator=g, device=dev)


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
