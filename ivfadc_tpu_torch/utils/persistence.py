"""Index persistence, format v1 (port of `ivfadc_tpu/utils/persistence.py`).

A plain `.npz` archive of named arrays plus a JSON header in `__meta__`:
the same file layout as the JAX package, so each package reads the
other's files. A two-level coarse quantizer adds its grouping
(`group_centers`, `group_members`, `n_probe_groups`); its scan arrays are
derived again on load. No code runs on load.
"""

from __future__ import annotations

import json
import os

import numpy as np

FORMAT_VERSION = 1


def save_index(path: str, index) -> None:
    meta = {
        "format_version": FORMAT_VERSION,
        "config": index.config.to_dict(),
        "dim": index.dim,
        "data_dtype": np.dtype(index.data_dtype).name,
        "coarse_kind": index.coarse.kind,
        "quantizer_method": index.quantizer.method,
    }
    arrays = {
        "centroids": index.coarse.centroids.cpu().numpy(),
        "codebooks": index.quantizer.codebooks.cpu().numpy(),
        "rotation": index.quantizer.rotation.cpu().numpy(),
        "offsets": index.store.offsets,
        "caps": index.store.caps,
        "sizes": index.store.sizes,
        "codes": index.store.codes,
        "ids": index.store.ids,
    }
    if index.coarse.kind == "two_level":
        meta["n_probe_groups"] = index.coarse.n_probe_groups
        arrays["group_centers"] = index.coarse.group_centers.cpu().numpy()
        arrays["group_members"] = index.coarse.members.cpu().numpy()
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8)
    # atomic write (temp + rename): a crash mid-save leaves the old file
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_index(path: str, device=None):
    """np.load + `convert.index_from_arrays`, onto `device` (default cuda)."""
    from ivfadc_tpu_torch.convert import index_from_arrays

    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        if meta["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"index file format v{meta['format_version']} is newer than "
                f"this library supports (v{FORMAT_VERSION})")
        arrays = {key: z[key] for key in z.files if key != "__meta__"}
    return index_from_arrays(arrays, meta,
                             device if device is not None else "cuda")
