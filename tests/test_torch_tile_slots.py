"""The grouped scan's fused tile prep (`cell_rank.tile_slots`) against the
JAX package, on the CPU.

The JAX package computes the prep as a chain of steps inside one jit
program (`ops/pallas_scan.py:631-653`): the counting ranks (its Pallas
kernel, here in interpret mode, both engines), `_tile_map`, and the `row` /
`inv_row` lines. The port fuses them into one kernel launch on the card;
its plain version, which the CPU runs, must give the same bits. The CUDA
kernel is held to that plain version on the card (tests/test_torch_cuda.py
and tests/test_torch_cuda_routes.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ivfadc_tpu import IVFADCIndex as JaxIndex
from ivfadc_tpu.ops import cell_rank as j_rank
from ivfadc_tpu.ops import pallas_scan as j_scan
from ivfadc_tpu_torch.convert import from_reference
from ivfadc_tpu_torch.ops import cell_rank as t_rank
from ivfadc_tpu_torch.ops import dense_scan as t_scan
from ivfadc_tpu_torch.utils.datasets import synthetic_clustered

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)


def _cells(rng, P: int, kc: int, empty: int | None = None):
    """Skewed cells: 30 % of the probes in 5 hot cells, the rest uniform;
    `empty` is a cell no probe takes."""
    cells = np.where(rng.rand(P) < 0.3, rng.randint(0, min(kc, 5), P),
                     rng.randint(0, kc, P)).astype(np.int32)
    if empty is not None and kc > 1:
        cells[cells == empty] = (empty + 1) % kc
    return cells


def _jax_prep(cells, offsets, sizes, kc: int, pb: int, engine: str):
    """The JAX package's own steps of the counting prep."""
    P = cells.shape[0]
    T_max = P // pb + min(kc, P) + 1
    c = jnp.asarray(cells)
    ranks, counts = j_rank.cell_ranks(c, kc=kc, interpret=True,
                                      engine=engine)
    tile_base, c_t, _, _, tile_start, tile_size = j_scan._tile_map(
        counts, jnp.asarray(offsets), jnp.asarray(sizes), pb, T_max, kc)
    row = (tile_base[c] + ranks // pb) * pb + ranks % pb
    inv_row = jnp.full((T_max * pb,), P, jnp.int32) \
        .at[row].set(jnp.arange(P, dtype=jnp.int32), unique_indices=True)
    return [np.asarray(a) for a in (counts, c_t, tile_start, tile_size, row,
                                    inv_row)]


@pytest.mark.parametrize("engine", ["v1", "v2"])
@pytest.mark.parametrize("P,kc,pb", [
    (3000, 300, 16),      # skewed, an empty cell, P not a 1024-multiple
    (2048, 1, 8),         # one cell: every probe in its tiles
    (1500, 4096, 64),     # kc = MAX_KC: most cells empty, many zero scans
    (4100, 64, 8),        # more tiles than probes per block, pb = 8
    (5, 3, 64),           # fewer probes than one tile
])
def test_tile_slots_plain_matches_jax(P, kc, pb, engine):
    rng = np.random.RandomState(P + kc + pb)
    cells = _cells(rng, P, kc, empty=1)
    sizes = rng.randint(0, 400, kc).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes[:-1] + 7)]) \
        .astype(np.int32)
    want = _jax_prep(cells, offsets, sizes, kc, pb, engine)
    got = t_rank.tile_slots(torch.from_numpy(cells),
                            torch.from_numpy(offsets),
                            torch.from_numpy(sizes), kc=kc, pb=pb,
                            engine=engine)
    names = ("counts", "c_t", "tile_start", "tile_size", "row", "inv_row")
    for name, g, w in zip(names, got, want):
        # row and inv_row in torch's index type, the rest as in JAX
        assert g.dtype == (torch.int64 if "row" in name else torch.int32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # the dense scan's seam gives the same layout, cells in (B, w)
    lay = t_scan._tile_slots(torch.from_numpy(cells).reshape(-1, 1),
                             torch.from_numpy(offsets),
                             torch.from_numpy(sizes), kc=kc, pb=pb,
                             rank_engine=engine)
    for g, w in zip(lay, want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)


def test_tile_slots_rejects_bad_arguments():
    cells = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="kc"):
        t_rank.tile_slots(cells, cells, cells, kc=8192, pb=16)
    with pytest.raises(ValueError, match="rank engine"):
        t_rank.tile_slots(cells, cells[:4], cells[:4], kc=4, pb=16,
                          engine="v3")


def _integer_index(rng):
    """A JAX-built dense index whose centroids, codebooks and queries are
    made integer-valued (the codebooks' column maxima 127, so the int8
    cache's scale is 1): every product and sum of the search is an integer
    below 2^24, exact in f32 in any order."""
    data = synthetic_clustered(3000, 128, seed=7)
    jidx = JaxIndex.build(data, kc=64, m=8, k=16, seed=0, scan_mode="dense")
    cents = rng.randint(-12, 13, (64, 128)).astype(np.float32)
    cb = rng.randint(-6, 7, np.asarray(jidx.quantizer.codebooks).shape) \
        .astype(np.float32)
    cb[:, -1, :] = 127.0
    jidx = JaxIndex(jidx.config,
                    dataclasses.replace(jidx.coarse,
                                        centroids=jnp.asarray(cents)),
                    jidx.quantizer._replace(codebooks=jnp.asarray(cb)),
                    jidx.store, jidx.data_dtype, jidx.dim)
    jidx.store._invalidate()
    q = rng.randint(-12, 13, (64, 128)).astype(np.float32)
    return jidx, q


@pytest.mark.parametrize("engine", ["v1", "v2"])
def test_grouped_search_integer_valued_matches_jax(engine, monkeypatch):
    # B*w = 512 >= 4*kc = 256: the grouped scan behind the fused prep
    monkeypatch.setenv("IVFADC_RANK_ENGINE", engine)
    jidx, q = _integer_index(np.random.RandomState(9))
    tidx = from_reference(jidx, "cpu")
    calls = []
    real = t_scan.tile_slots

    def spy(*args, **kw):
        calls.append(kw.get("engine"))
        return real(*args, **kw)

    monkeypatch.setattr(t_scan, "tile_slots", spy)
    ti, td = tidx.search_padded(q, 10, w=8)
    ji, jd = jidx.search_padded(q, 10, w=8)
    assert calls == [engine]
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ti, ji)
