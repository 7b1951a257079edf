"""The port's search entry point and multi-chip dry run (the
counterparts of the repo's `__graft_entry__.py`, under the same names).

    python -m ivfadc_tpu_torch.dryrun [n]      # entry(), then the dry run
                                               # over n mesh positions (8)

entry()              -> (forward, example_args): the batched LUT search
                        forward (`models/index._lut_search`) over a tiny
                        index, on plain tensors.
dryrun_multichip(n)  -> the whole multi-device life of an index over an
                        n-position (data, shard) mesh, step by step with
                        the JAX dry run's asserts: the train step over the
                        data axis, a sharded view searched against the
                        single index, the distributed build, native
                        push_batch / delete / pop, a sharded save and a
                        load onto half the shards, a host view's refresh,
                        the streamed sharded build and the wide-id
                        lifecycle. Returns each step's results.

Both run on the card unless the caller passes device="cpu"; without a
visible CUDA device they raise. The dry run uses n distinct cards when
that many are visible; otherwise its mesh positions repeat one card (a
mesh position may repeat a device), so one H100 runs every step, though
no step then measures anything across cards.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from ivfadc_tpu_torch.models.index import IVFADCIndex, _lut_search
from ivfadc_tpu_torch.ops.metrics import SQEUCLIDEAN
from ivfadc_tpu_torch.parallel import (SHARD_AXIS, ShardedIVFADCIndex,
                                       load_sharded_index, make_mesh,
                                       save_sharded_index)
from ivfadc_tpu_torch.parallel.distributed import train_step


def _device(device) -> torch.device:
    """The run's device; a CUDA device must be visible (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun: no CUDA device is visible; pass "
                           "device='cpu' to run on the CPU")
    return dev


def tiny_index(device="cuda", n: int = 512, d: int = 32, kc: int = 16,
               m: int = 4, k: int = 16, seed: int = 0):
    """(points (n, d) f32, index built on `device`): kc Gaussian clusters
    of n // kc points around centres of scale 4, the JAX dry run's data."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(kc, d).astype(np.float32) * 4
    data = np.concatenate(
        [c + rng.randn(n // kc, d).astype(np.float32) for c in centers])
    return data, IVFADCIndex.build(data, kc=kc, k=k, m=m, seed=seed,
                                   coarse_maxiter=8, quantization_maxiter=8,
                                   device=_device(device))


def entry(device="cuda"):
    """The batched search forward (k=10, w=4, sqeuclidean, the reference
    score, no rotation) over the tiny index's LUT view, and its example
    arguments: (forward, (queries, coarse, codebooks, rotation, offsets,
    sizes, codes, ids)). forward returns (ids (B, 10), dists (B, 10))."""
    data, idx = tiny_index(device)
    view = idx.store.device_view()
    window = idx.store.window

    def forward(queries, coarse, codebooks, rotation, offsets, sizes, codes,
                ids):
        out_ids, out_dists = _lut_search(
            coarse, codebooks, rotation,
            dict(offsets=offsets, sizes=sizes, codes=codes, ids=ids),
            queries, k=10, w=4, window=window, metric=SQEUCLIDEAN,
            include_base=True, apply_rot=False, residual_based=True)
        return out_ids, SQEUCLIDEAN.finalize(out_dists)

    example_args = (torch.as_tensor(data[:64], device=idx.device),
                    idx.coarse, idx.quantizer.codebooks,
                    idx.quantizer.rotation, view["offsets"], view["sizes"],
                    view["codes"], view["ids"])
    return forward, example_args


def _mesh_devices(n_devices: int, dev: torch.device):
    """n_devices distinct cards when so many are visible, else `dev`
    repeated n_devices times -> (devices, "distinct" or "repeated")."""
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)], \
            "distinct"
    return [dev] * n_devices, "repeated"


def _placed_ids(view) -> np.ndarray:
    """The sorted live ids of a view's shards (data group 0)."""
    ids = np.concatenate([v["ids"].cpu().numpy() for v in view.views])
    return np.sort(ids[ids >= 0])


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The JAX dry run's steps, asserts and order over an (n_data, S)
    mesh, n_data = 2 when n_devices is even and >= 4. Returns each step's
    results (numpy) under the step's name."""
    dev = _device(device)
    devices, spread = _mesh_devices(n_devices, dev)
    n_data = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    mesh = make_mesh(n_shards=n_devices // n_data, n_data=n_data,
                     devices=devices)
    print(f"dryrun_multichip: {n_devices} mesh positions on "
          + (f"{n_devices} cards" if spread == "distinct"
             else f"{dev} repeated"), flush=True)
    out = {"mesh": dict(mesh.shape), "devices": spread}

    data, idx = tiny_index(dev)
    n, d = data.shape
    m = idx.config.m

    # --- the train step: a summed Lloyd step over the data axis, then the
    # residuals' PQ codes
    n_pad = ((n + n_data - 1) // n_data) * n_data
    xp = np.pad(data.astype(np.float32), ((0, n_pad - n), (0, 0)))
    mask = np.pad(np.ones(n, np.float32), (0, n_pad - n))
    centers = idx.coarse.centroids
    new_centers, assignments, codes = train_step(
        centers, idx.quantizer.codebooks, xp, mask, mesh=mesh,
        metric=SQEUCLIDEAN, m=m)
    assert new_centers.shape == centers.shape
    assert codes.shape == (n_pad, m)
    out["train_step"] = tuple(t.cpu().numpy() for t in
                              (new_centers, assignments, codes))

    # --- the sharded view of the single index, held to it
    sidx = ShardedIVFADCIndex(idx, mesh)
    ids, dists = sidx.search_padded(data[:16], k=5, w=4)
    assert ids.shape == (16, 5)
    assert np.isfinite(dists[ids >= 0]).all()
    # the single index on each data group's slice of the batch: the view
    # scans a group's queries as one batch, and on the dense path a
    # batch's size picks its route (B*w >= 4*kc: grouped, cached row
    # norms; else per probe, norms in the kernel), whose distances differ
    # in rounding
    per = 16 // n_data
    ids1, dists1 = (np.concatenate(r) for r in zip(*[
        idx.search_padded(data[s:s + per], 5, w=4)
        for s in range(0, 16, per)]))
    match = np.mean([set(a[a >= 0]) == set(b[b >= 0])
                     for a, b in zip(ids, ids1)])
    assert match == 1.0, f"sharded/single-card mismatch: {match}"
    out.update(sharded_search=(ids, dists), single_search=(ids1, dists1),
               match=float(match))

    # --- the distributed build (no card holds the flat arrays), searched
    didx = ShardedIVFADCIndex.build(data, mesh, kc=idx.config.kc, k=16,
                                    m=m, seed=0, coarse_maxiter=6,
                                    quantization_maxiter=6)
    assert not didx.index.store.has_payload      # metadata-only base
    dids, ddists = didx.search_padded(data[:16], k=5, w=4)
    assert dids.shape == (16, 5)
    assert np.isfinite(ddists[dids >= 0]).all()
    placed = _placed_ids(didx)
    assert np.array_equal(placed, np.arange(n)), "ids lost in redistribution"
    out["build_search"] = (dids, ddists)

    # --- native dynamic ops on the distributed view: device encode, owner
    # shard scatter, ids renumbered on the shards
    didx.push_batch(data[:8] + 0.01)
    assert len(didx.index) == n + 8
    didx.delete([0, 5, n + 3])
    assert len(didx.index) == n + 5
    live = _placed_ids(didx)
    assert np.array_equal(live, np.arange(n + 5)), "id renumbering broke"
    v = didx.pop()
    assert v.shape == (d,) and len(didx.index) == n + 4
    pids, pdists = didx.search_padded(data[:8], k=5, w=4)
    assert pids.shape == (8, 5)
    out.update(native_live=live, popped=v, native_search=(pids, pdists))

    # --- a sharded save, a load onto half the shards, then the host-based
    # view takes a push_batch and a refresh
    with tempfile.TemporaryDirectory() as td:
        save_sharded_index(td, didx)
        S = mesh.shape[SHARD_AXIS]
        S2 = max(1, S // 2)
        mesh2 = make_mesh(n_shards=S2, n_data=1, devices=devices[:S2])
        ridx = load_sharded_index(td, mesh2)
        rids, rdists = ridx.search_padded(data[:8], k=5, w=4)
        pids_h, _ = didx.search_padded(data[:8], k=5, w=4)
        assert np.array_equal(rids, pids_h), "resharded restore diverged"
    sidx.push_batch(data[:4] + 0.02)
    sidx.refresh()
    assert len(sidx.index) == n + 4
    out.update(reload_search=(rids, rdists), reload_shards=S2,
               refreshed_search=sidx.search_padded(data[:8], k=5, w=4))

    # --- the streamed sharded build (out-of-core ingest)
    chunks = [data[i:i + 128] for i in range(0, n, 128)]
    stream_idx = ShardedIVFADCIndex.build_streaming(
        chunks, mesh, kc=idx.config.kc, k=16, m=m, seed=0,
        coarse_maxiter=6, quantization_maxiter=6)
    s_ids, s_dists = stream_idx.search_padded(data[:8], k=5, w=4)
    assert s_ids.shape == (8, 5)
    out["stream_search"] = (s_ids, s_dists)

    # --- wide ids (past the device int32 cap, lowered here to 256): the
    # distributed build, a uint64 search, native mutations
    prev = os.environ.get("IVFADC_DEVICE_ID_CAP")
    os.environ["IVFADC_DEVICE_ID_CAP"] = "256"
    try:
        widx = ShardedIVFADCIndex.build(data, mesh, kc=idx.config.kc, k=16,
                                        m=m, seed=0, coarse_maxiter=6,
                                        quantization_maxiter=6,
                                        index_dtype="uint64")
        assert widx.wide_ids
        wids, wdists = widx.search_padded(data[:8], k=5, w=4)
        assert wids.dtype == np.uint64
        widx.push_batch(data[:4] + 0.01)
        widx.delete([1, 7])
        assert len(widx.index) == n + 2
        out.update(wide_search=(wids, wdists),
                   wide_search_after=widx.search_padded(data[:8], k=5, w=4))
    finally:
        if prev is None:
            del os.environ["IVFADC_DEVICE_ID_CAP"]
        else:
            os.environ["IVFADC_DEVICE_ID_CAP"] = prev

    print(f"dryrun_multichip OK: mesh={dict(mesh.shape)}, "
          f"train_step + sharded search + distributed end-to-end "
          f"build->search + native dynamic ops + mesh-portable save/load + "
          f"streamed sharded build + wide-id (beyond-2^31) lifecycle "
          f"verified on {n_devices} devices", flush=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    fn, args = entry()
    ids, dists = fn(*args)
    print("entry OK:", (tuple(ids.shape), tuple(dists.shape)), flush=True)
    dryrun_multichip(n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
