"""Carry an index's parameters across from the JAX package.

`index_from_arrays` builds a port index from the format-v1 arrays (numpy)
and header; `from_reference` reads a live `ivfadc_tpu` index by attribute
access and `np.asarray` alone, so this module never imports JAX. Loading a
file is `np.load` plus `index_from_arrays` (utils/persistence.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ivfadc_tpu_torch.config import IVFADCConfig
from ivfadc_tpu_torch.models.coarse import (NaiveCoarseQuantizer,
                                            TwoLevelCoarseQuantizer)
from ivfadc_tpu_torch.models.index import IVFADCIndex
from ivfadc_tpu_torch.models.inverted import PostingStore
from ivfadc_tpu_torch.ops.metrics import get_metric
from ivfadc_tpu_torch.ops.pq import ProductQuantizer

ARRAY_KEYS = ("centroids", "codebooks", "rotation", "offsets", "caps",
              "sizes", "codes", "ids")
# a two-level coarse quantizer adds "group_centers" and "group_members"
# (and `n_probe_groups` in meta)


def components_from_arrays(arrays: dict, meta: dict, device):
    """(config, coarse quantizer, product quantizer) on `device` from the
    format's arrays and header (shared with the shard-dir format)."""
    dev = torch.device(device)
    config = IVFADCConfig.from_dict(meta["config"])

    def f32(key):
        return torch.as_tensor(np.array(arrays[key], np.float32),
                               device=dev)

    cmetric = get_metric(config.coarse_metric)
    if meta.get("coarse_kind", "naive") == "two_level":
        coarse = TwoLevelCoarseQuantizer.create(
            np.array(arrays["centroids"], np.float32),
            arrays["group_centers"], arrays["group_members"], cmetric,
            int(meta["n_probe_groups"]), device=dev)
    else:
        coarse = NaiveCoarseQuantizer(f32("centroids"), cmetric)
    quantizer = ProductQuantizer(f32("codebooks"), f32("rotation"),
                                 meta["quantizer_method"])
    return config, coarse, quantizer


def index_from_arrays(arrays: dict, meta: dict, device) -> IVFADCIndex:
    """arrays: the format-v1 arrays (ARRAY_KEYS) as numpy; meta: the header
    (config dict, dim, data_dtype, coarse_kind, quantizer_method)."""
    dev = torch.device(device)
    config, coarse, quantizer = components_from_arrays(arrays, meta, dev)
    codes = np.array(arrays["codes"])
    store = PostingStore(
        config.kc, config.m, codes.dtype,
        offsets=np.array(arrays["offsets"], np.int64),
        caps=np.array(arrays["caps"], np.int64),
        sizes=np.array(arrays["sizes"], np.int64),
        codes=codes, ids=np.array(arrays["ids"], np.int64), device=dev)
    return IVFADCIndex(config, coarse, quantizer, store,
                       np.dtype(meta["data_dtype"]), int(meta["dim"]))


def from_reference(jax_index, device="cuda") -> IVFADCIndex:
    """A port index holding the same parameters as a live `ivfadc_tpu`
    index (either coarse quantizer), on `device` (default: the card, as
    every entry point of the port; pass "cpu" for the CPU)."""
    arrays = {
        "centroids": np.asarray(jax_index.coarse.centroids),
        "codebooks": np.asarray(jax_index.quantizer.codebooks),
        "rotation": np.asarray(jax_index.quantizer.rotation),
        "offsets": np.asarray(jax_index.store.offsets),
        "caps": np.asarray(jax_index.store.caps),
        "sizes": np.asarray(jax_index.store.sizes),
        "codes": np.asarray(jax_index.store.codes),
        "ids": np.asarray(jax_index.store.ids),
    }
    meta = {
        "config": jax_index.config.to_dict(),
        "dim": int(jax_index.dim),
        "data_dtype": np.dtype(jax_index.data_dtype).name,
        "coarse_kind": jax_index.coarse.kind,
        "quantizer_method": jax_index.quantizer.method,
    }
    if jax_index.coarse.kind == "two_level":
        meta["n_probe_groups"] = int(jax_index.coarse.n_probe_groups)
        arrays["group_centers"] = np.asarray(jax_index.coarse.group_centers)
        arrays["group_members"] = np.asarray(jax_index.coarse.members)
    return index_from_arrays(arrays, meta, device)
