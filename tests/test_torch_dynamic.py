"""The port's dynamic ops against the JAX package, op by op.

Ports of `tests/test_dynamic.py` and `tests/test_fuzz_dynamic.py` as parity
tests: one JAX-built index (the shared 243 x 10 fixture of
`tests/conftest.py`) is carried across to the port (`convert.from_reference`
on the CPU), the same operations run on both, and after each one the
stores must hold the same state exactly: offsets, caps, sizes, the host
ids and codes (dead regions included), n, total_cap, and the results of
find, reconstruct, pop and cell_entries. Dense searches run the JAX
package's kernels in interpret mode and the port's plain versions; on the
integer-valued indexes (`_integer_pair`: integer centroids and queries,
half-integer codewords, an int8 scale of exactly 1/2) every score is a
multiple of 1/4 far below 2^22 and every square is exact in bf16, so ids
and distances must agree exactly. The port's patched views
must equal rebuilt ones bit for bit, and a fork must be isolated both
ways.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from ivfadc_tpu import IVFADCIndex as JaxIndex
from ivfadc_tpu.models.inverted import PostingStore as JaxStore
from ivfadc_tpu_torch import IVFADCIndex, delete_from_index, load_ivfadc_index
from ivfadc_tpu_torch.convert import from_reference
from ivfadc_tpu_torch.models.inverted import PostingStore
from tests.conftest import build_random_index

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)

NROWS = 10
NVECTORS = 243
# reconstructions: the same f32 centroid + decoded residual in both
# packages (OPQ-free), cast to the data dtype
RECON_TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(data, coarse_quantizer="naive", **overrides):
    """(JAX index, port index on the CPU) over the same parameters."""
    j = build_random_index(data, coarse_quantizer=coarse_quantizer,
                           **overrides)
    return j, from_reference(j, "cpu")


def _integer_pair(data, coarse_quantizer="naive", cache="int8", align=128,
                  **overrides):
    """A pair on integer centroids (x16, rounded) and codewords that are
    multiples of 1/2 in [-7.5, 7.5], but for the last codeword of every
    subspace, 63.5: it makes the int8 cache's scale exactly 1/2 and is
    never stored (stored codes that name it are moved to codeword 0) nor
    ever the nearest to a residual of a point within 16 of its centroid.
    With integer-valued queries every score the dense routes compute is
    then exact (squares included, which the kernels take in bf16)."""
    import jax.numpy as jnp
    from ivfadc_tpu.models.coarse import (NaiveCoarseQuantizer,
                                          TwoLevelCoarseQuantizer)
    from ivfadc_tpu.ops.pq import ProductQuantizer
    j = build_random_index(data, coarse_quantizer=coarse_quantizer,
                           cell_align=align, **overrides)
    cents = np.round(np.asarray(j.coarse.centroids) * 16)
    shape = j.quantizer.codebooks.shape
    cb = np.random.RandomState(shape[1]).randint(-15, 16, shape) / 2
    cb[:, -1, :] = 63.5
    codes = j.store.codes
    codes[codes == shape[1] - 1] = 0
    cents, cb = jnp.asarray(cents, jnp.float32), jnp.asarray(cb, jnp.float32)
    if j.coarse.kind == "two_level":
        coarse = TwoLevelCoarseQuantizer.create(
            cents, j.coarse.group_centers * 16, j.coarse.members,
            j.coarse.metric, j.coarse.n_probe_groups)
    else:
        coarse = NaiveCoarseQuantizer(cents, j.coarse.metric)
    j = JaxIndex(dataclasses.replace(j.config, scan_mode="dense",
                                     scan_cache=cache),
                 coarse, ProductQuantizer(cb, j.quantizer.rotation,
                                          j.quantizer.method),
                 j.store, j.data_dtype, j.dim)
    return j, from_reference(j, "cpu")


def _assert_same_state(j, t):
    js, ts = j.store, t.store
    for key in ("offsets", "caps", "sizes", "codes", "ids"):
        a, b = np.asarray(getattr(js, key)), getattr(ts, key)
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(b, a, err_msg=key)
    assert ts.codes.dtype == np.asarray(js.codes).dtype
    assert (len(t), ts.total_cap, ts.window) == (len(j), js.total_cap,
                                                 js.window)
    n = len(j)
    for ext in {0, n // 3, n // 2, n - 1} if n else ():
        assert ts.find(ext) == js.find(ext)
    for cell in (0, j.config.kc // 2, j.config.kc - 1):
        for a, b in zip(js.cell_entries(cell), ts.cell_entries(cell)):
            np.testing.assert_array_equal(b, a)


def _assert_views_rebuild(t):
    """The port's cached views (patched in place) equal a rebuild of the
    same host state, bit for bit."""
    st = t.store
    fresh = t.fork()
    fresh.store._invalidate()
    cache = t._resolve_cache()
    got = dict(lut=st.device_view(),
               dense=st.device_view_dense(t.quantizer, t.config.scan_chunk,
                                          cache=cache))
    want = dict(lut=fresh.store.device_view(),
                dense=fresh.store.device_view_dense(
                    t.quantizer, t.config.scan_chunk, cache=cache))
    for name in got:
        for key, a in want[name].items():
            if not isinstance(a, torch.Tensor):
                continue
            b = got[name][key]
            assert b is not None and a.dtype == b.dtype, (name, key)
            assert torch.equal(a, b), (name, key)
        for key in ("ids2d", "norms2d"):
            assert (want[name].get(key) is None) == \
                (got[name].get(key) is None), (name, key)
    if got["dense"]["ids2d"] is not None:
        assert torch.equal(got["dense"]["ids2d"].reshape(-1),
                           got["dense"]["ids"])


def _assert_same_search(j, t, q, k, w):
    ji, jd = j.search_padded(q, k, w=w)
    ti, td = t.search_padded(q, k, w=w)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def _both(j, t, op, *args):
    """Run one op on both packages; the results must agree."""
    if op == "delete_bulk":                   # the > 2048-id path
        return j.store.delete_ids(*args), t.store.delete_ids(*args)
    a, b = getattr(j, op)(*args), getattr(t, op)(*args)
    if a is not None:
        assert a.dtype == b.dtype
        np.testing.assert_allclose(b, a, **RECON_TOL)
    return a, b


# ---------------------------------------------------------------- sequences
@pytest.mark.parametrize("align", [128, 8])
@pytest.mark.parametrize("cache", ["int8", "bf16"])
@pytest.mark.parametrize("coarse", ["naive", "hnsw"])
def test_op_sequence_matches_jax(random_data, coarse, cache, align):
    """Every op of the store, both delete paths and cell growth: the state
    after each op, the mutation logs, the patched views against rebuilt
    ones, and dense searches on both scan routes (per probe: B*w < 4*kc;
    grouped: B*w >= 4*kc)."""
    j, t = _integer_pair(random_data, coarse, cache, align)
    rng = np.random.RandomState(align + len(cache))
    q = rng.randint(0, 17, (8, NROWS)).astype(np.float32)
    qg = rng.randint(0, 17, (128, NROWS)).astype(np.float32)
    t.search_padded(q, 5, w=6)                # build the views to patch
    t.store.device_view()
    j.search_padded(q, 5, w=6)
    jlog, tlog = j.store.attach_mutation_log(), t.store.attach_mutation_log()
    cent0 = np.asarray(j.coarse.centroids[0])
    # 150 points near one centroid overflow its cell at either alignment
    crowd = cent0 + 0.5 * rng.rand(150, NROWS)
    ops = [("push", rng.rand(NROWS) * 16),
           ("push_front", rng.rand(NROWS) * 16),
           ("push_batch", crowd),
           ("delete", [17]),
           ("delete", [3, 40, 41, 200, 251]),
           ("pop",), ("pop_front",),
           ("delete_bulk", np.arange(60, 90)),
           ("push_batch", rng.rand(20, NROWS) * 16)]
    grows = 0
    for step, (op, *args) in enumerate(ops):
        caps_before = t.store.caps.copy()
        _both(j, t, op, *args)
        grows += int((t.store.caps != caps_before).sum())
        _assert_same_state(j, t)
        if op in ("push_batch", "delete", "pop_front") and step % 2 == 0:
            _assert_views_rebuild(t)
    assert grows > 0
    _assert_views_rebuild(t)
    live = np.sort(t.store.ids[t.store.ids >= 0])
    assert np.array_equal(live, np.arange(len(t)))
    _assert_same_search(j, t, q, 5, 6)
    _assert_same_search(j, t, qg, 5, 4)
    a, b = jlog.drain(), tlog.drain()
    assert a["cells"] == b["cells"] and a["overflow"] == b["overflow"]
    assert len(a["ops"]) == len(b["ops"])
    for x, y in zip(a["ops"], b["ops"]):
        assert x[0] == y[0]
        assert [np.asarray(v).tolist() for v in x[1:]] == \
            [np.asarray(v).tolist() for v in y[1:]]


def test_in_place_grow_patch_at_8_row_alignment(random_data, monkeypatch):
    """An 8-row-aligned store's views (no norm stream) move a grown cell's
    rows in place; a 128-row store with cached norms is rebuilt instead,
    and so is one whose guard rows no longer cover the new end."""
    rng = np.random.RandomState(5)
    for align, patched in ((8, True), (128, False)):
        j, t = _integer_pair(random_data, align=align)
        t.search_padded(rng.randint(0, 17, (8, NROWS)).astype(np.float32),
                        5, w=6)
        cent0 = np.asarray(j.coarse.centroids[0])
        t.push_batch(cent0 + 0.5 * rng.rand(150, NROWS))
        # 8-row cells: the first grows move rows in place, until the
        # guard rows no longer cover the new end (then a rebuild)
        assert (t.store.grow_patches > 0) == patched, align
        _assert_views_rebuild(t)
    # 128-row cells under IVFADC_NORMS=off hold no norm stream: patched
    monkeypatch.setenv("IVFADC_NORMS", "off")
    j, t = _integer_pair(random_data, align=128)
    q = rng.randint(0, 17, (8, NROWS)).astype(np.float32)
    t.search_padded(q, 5, w=6)
    before = t.store.grow_patches
    _both(j, t, "push_batch", np.asarray(j.coarse.centroids[1])
          + 0.5 * rng.rand(150, NROWS))
    assert t.store.grow_patches > before
    _assert_views_rebuild(t)
    _assert_same_search(j, t, q, 5, 6)


@pytest.mark.parametrize("coarse_quantizer", ["naive", "hnsw"])
def test_push_to_capacity_and_overflow(random_data, coarse_quantizer):
    # tests/test_dynamic.py: index_dtype uint8 (capacity 256)
    rng = np.random.RandomState(0)
    j, t = _pair(random_data, coarse_quantizer, index_dtype="uint8")
    for _ in range(256 - NVECTORS):
        _both(j, t, "push", rng.rand(NROWS))
    assert len(t) == 256
    _assert_same_state(j, t)
    with pytest.raises(AssertionError):
        t.push(rng.rand(NROWS))               # full
    with pytest.raises(AssertionError):
        t.push_batch(rng.rand(1, NROWS))      # full
    _both(j, t, "delete", [0])
    with pytest.raises(AssertionError):
        t.push(rng.rand(NROWS + 1))           # wrong dimension
    for i in range(5):
        _both(j, t, "delete", [i])
    for _ in range(6):
        _both(j, t, "push_front", rng.rand(NROWS))
    with pytest.raises(AssertionError):
        t.push_front(rng.rand(NROWS))         # full again
    _assert_same_state(j, t)


@pytest.mark.parametrize("coarse_quantizer", ["naive", "hnsw"])
def test_pop_and_popfirst(random_data, coarse_quantizer):
    j, t = _pair(random_data, coarse_quantizer, index_dtype="uint8")
    n = len(t)
    _, v = _both(j, t, "pop")
    assert isinstance(v, np.ndarray) and v.shape == (NROWS,)
    assert v.dtype == random_data.dtype       # in the data's dtype
    _, v = _both(j, t, "pop_front")
    assert v.shape == (NROWS,) and len(t) == n - 2
    _assert_same_state(j, t)
    with pytest.raises(IndexError):
        empty = from_reference(build_random_index(
            random_data[:30], kc=5, k=8, m=2), "cpu")
        while True:
            empty.pop()


def test_push_past_device_id_cap_then_search_raises(random_data,
                                                    monkeypatch):
    # host ids are int64: pushes past the device int32 cap (lowered here)
    # succeed as in the JAX package, and the device search refuses
    j, t = _pair(random_data)
    monkeypatch.setenv("IVFADC_DEVICE_ID_CAP", str(NVECTORS + 1))
    rng = np.random.RandomState(6)
    for _ in range(2):
        _both(j, t, "push", rng.rand(NROWS))
    _assert_same_state(j, t)
    for x in (j, t):
        with pytest.raises(AssertionError, match="device int32 id cap"):
            x.search_padded(random_data[:4], 3, w=2)


def test_push_then_pop_roundtrip_id_semantics(random_data):
    j, t = _pair(random_data)
    n0 = len(t)
    pt = np.full(NROWS, 0.5)
    _both(j, t, "push", pt)                   # id n0
    assert len(t) == n0 + 1
    _, rec = _both(j, t, "pop")               # removes id n0 again
    assert len(t) == n0 and rec.shape == pt.shape
    assert np.abs(rec - pt).mean() < 1.0      # lossy, in the ballpark
    _assert_same_state(j, t)


def test_pushfirst_shifts_all_ids(random_data):
    j, t = _pair(random_data)
    before = t.store.ids.copy()
    _both(j, t, "push_front", np.full(NROWS, 0.25))
    after = t.store.ids[:len(before)]
    moved = before >= 0
    # every id still in place moved up by one (the new point took id 0)
    np.testing.assert_array_equal(after[moved & (after >= 0)],
                                  before[moved & (after >= 0)] + 1)
    live = np.sort(t.store.ids[t.store.ids >= 0])
    assert np.array_equal(live, np.arange(len(t)))
    _assert_same_state(j, t)


@pytest.mark.parametrize("coarse_quantizer", ["naive", "hnsw"])
def test_delete_from_index_id_shift_semantics(random_data, coarse_quantizer):
    """tests/test_dynamic.py's big delete: head, middle and tail ranges;
    every survivor's codes sit at its shifted id."""
    from ivfadc_tpu import delete_from_index as j_delete
    j, t = _pair(random_data, coarse_quantizer)
    before = {c: t.store.cell_entries(c) for c in range(t.config.kc)}
    n = len(t)
    dels = np.array(list(range(0, 5)) + list(range(9, 30))
                    + list(range(n - 6, n)))
    j_delete(j, dels)
    delete_from_index(t, dels)
    assert len(t) == n - len(dels)
    _assert_same_state(j, t)
    for c, (ids_b, codes_b) in before.items():
        ids_a, codes_a = t.store.cell_entries(c)
        assert len(ids_b) == len(ids_a) + len(np.intersect1d(ids_b, dels))
        for pos, old in enumerate(ids_b):
            if old in dels:
                continue
            hit = np.nonzero(ids_a == old - np.searchsorted(dels, old))[0]
            assert hit.size == 1
            np.testing.assert_array_equal(codes_a[hit[0]], codes_b[pos])


def test_delete_missing_id_raises(random_data):
    j, t = _pair(random_data)
    n = len(t)
    for ids in ([n + 10], [0, n + 10]):
        with pytest.raises(KeyError):
            t.delete(ids)
        with pytest.raises(KeyError):
            j.delete(ids)
    with pytest.raises(KeyError):
        t.store.delete_ids(np.array([1, n + 10]))
    with pytest.raises(KeyError):
        t.reconstruct(n + 3)


def test_ids_always_contiguous_after_mixed_ops(random_data):
    rng = np.random.RandomState(3)
    j, t = _pair(random_data)
    for op, *args in [("push", rng.rand(NROWS)),
                      ("push_front", rng.rand(NROWS)),
                      ("delete", [5, 17, 200]), ("pop",), ("pop_front",),
                      ("push", rng.rand(NROWS))]:
        _both(j, t, op, *args)
        live = np.sort(t.store.ids[t.store.ids >= 0])
        assert np.array_equal(live, np.arange(len(t)))
    _assert_same_state(j, t)


def test_search_after_dynamic_ops(random_data):
    j, t = _pair(random_data)
    target = np.full(NROWS, 0.123)
    _both(j, t, "push", target)
    new_id = len(t) - 1
    ids, _ = t.search(target, 3, w=10)
    assert new_id in set(ids.tolist())
    _both(j, t, "delete", [0])                # the pushed id shifts down
    ids, _ = t.search(target, 3, w=10)
    jids, _ = j.search(target, 3, w=10)
    assert (new_id - 1) in set(ids.tolist())
    np.testing.assert_array_equal(ids, jids)


def test_reconstruct(random_data):
    j, t = _pair(random_data)
    rec = t.reconstruct(42)
    assert rec.shape == (NROWS,)
    assert np.abs(rec - random_data[42]).mean() < 0.5
    for ext in (0, 42, NVECTORS - 1):
        np.testing.assert_allclose(t.reconstruct(ext), j.reconstruct(ext),
                                   **RECON_TOL)


def test_incremental_device_cache_matches_cold_rebuild(random_data):
    """After push / delete / pop / push_front, the patched views equal a
    cold rebuild bit for bit, and so do the searches."""
    j, t = _integer_pair(random_data, align=8)
    rng = np.random.RandomState(9)
    q = rng.randint(0, 17, (4, NROWS)).astype(np.float32)
    t.search_padded(q, 5, w=6)
    t.store.device_view()
    for op, *args in [("push", rng.rand(NROWS) * 16), ("delete", [7]),
                      ("pop",), ("push_front", rng.rand(NROWS) * 16)]:
        _both(j, t, op, *args)
    assert t.store._dirty_slots
    _assert_views_rebuild(t)
    cold = from_reference(j, "cpu")
    np.testing.assert_array_equal(cold.search_padded(q, 5, w=6)[0],
                                  t.search_padded(q, 5, w=6)[0])
    _assert_same_search(j, t, q, 5, 6)


def test_cell_growth_on_overflowing_pushes(random_data):
    # 8-row cells (capacity 16 here): 60 near-identical points regrow one
    j, t = _pair(random_data, cell_align=8)
    n0 = len(t)
    target = np.full(NROWS, 0.5, np.float32)
    caps0 = t.store.caps.copy()
    for i in range(60):
        t.push(target + 1e-4 * i)
    j.push_batch(np.stack([target + 1e-4 * i for i in range(60)]))
    assert len(t) == n0 + 60
    assert (t.store.caps != caps0).any()
    _assert_same_state(j, t)
    ids, _ = t.search(target, 5, w=4)
    assert len(ids) == 5 and (np.asarray(ids) >= n0).all()


def test_device_cache_consistency_under_churn(random_data):
    """Interleaved push_batch / delete / push / pop_front / search: the
    patched views' results equal those after `_invalidate()`."""
    rng = np.random.RandomState(9)
    j, t = _integer_pair(random_data, cache="bf16")
    q = rng.randint(0, 17, (16, NROWS)).astype(np.float32)
    t.search_padded(q, 5, w=6)
    for _ in range(3):
        for op, *args in [("push_batch", rng.rand(20, NROWS) * 16),
                          ("delete", rng.choice(len(t), 7, replace=False)),
                          ("push", rng.rand(NROWS) * 16), ("pop_front",)]:
            _both(j, t, op, *args)
        ids_p, d_p = t.search_padded(q, 5, w=6)
        t.store._invalidate()
        ids_f, d_f = t.search_padded(q, 5, w=6)
        np.testing.assert_array_equal(ids_p, ids_f)
        np.testing.assert_array_equal(d_p, d_f)
    _assert_same_state(j, t)
    _assert_same_search(j, t, q, 5, 6)


def test_search_after_emptying_index(random_data):
    rng = np.random.RandomState(2)
    data = rng.rand(30, NROWS).astype(np.float32)
    j, t = _pair(data, kc=5, k=8, m=2)
    while len(t):
        _both(j, t, "pop")
    _assert_same_state(j, t)
    ids, dists = t.search(data[0], 3, w=5)
    assert len(ids) == 0 and len(dists) == 0
    t.push(data[1])
    ids, _ = t.search(data[1], 1, w=5)
    assert list(ids) == [0]


def test_push_batch_matches_scalar_pushes():
    # one push_batch equals B pushes (per-cell order, patched views), and
    # equals the JAX package's push_batch
    rng = np.random.RandomState(11)
    base = rng.randn(2000, 16).astype(np.float32)
    j = JaxIndex.build(base, kc=8, k=16, m=4, seed=0)
    a, b = from_reference(j, "cpu"), from_reference(j, "cpu")
    a.search_padded(base[:4], 3, w=2)
    b.search_padded(base[:4], 3, w=2)
    new = rng.randn(150, 16).astype(np.float32)
    b.push_batch(new)
    for p in new:
        a.push(p)
    j.push_batch(new)
    for key in ("offsets", "caps", "sizes", "codes", "ids"):
        np.testing.assert_array_equal(getattr(a.store, key),
                                      getattr(b.store, key))
    _assert_same_state(j, b)
    np.testing.assert_array_equal(a.search_padded(new[:8], 3, w=4)[0],
                                  b.search_padded(new[:8], 3, w=4)[0])


def test_find_and_reconstruct_do_not_hydrate_codes():
    """After a build on the device, find and reconstruct read the ids and
    one code row only; the first mutation brings the codes to the host,
    where they stay the truth, and the ops then equal a shadow index that
    hydrated everything first."""
    rng = np.random.RandomState(7)
    data = rng.randn(3000, 16).astype(np.float32)
    kw = dict(kc=8, k=32, m=4, seed=0, device="cpu")
    idx = IVFADCIndex.build(data, **kw)
    shadow = IVFADCIndex.build(data, **kw)
    shadow.store._materialize_for_mutation()
    assert idx.store._codes_h is None
    cell, slot = idx.store.find(777)
    assert idx.store.ids[slot] == 777 and idx.store._codes_h is None
    np.testing.assert_array_equal(idx.reconstruct(777),
                                  shadow.reconstruct(777))
    assert idx.store._codes_h is None
    q = data[:32]
    for step in range(4):
        p = rng.randn(16).astype(np.float32)
        dels = [int(rng.randint(0, len(idx)))] if step % 2 else [0, 5, 11]
        for x in (idx, shadow):
            x.push(p)
            x.delete(dels)
        np.testing.assert_array_equal(idx.pop(), shadow.pop())
        for a, b in zip(idx.search_padded(q, 5, w=4),
                        shadow.search_padded(q, 5, w=4)):
            np.testing.assert_array_equal(a, b)
    assert idx.store._codes_dev is None and idx.store._codes_h is not None


# --------------------------------------------------------------------- fork
@pytest.mark.parametrize("align", [128, 8])
def test_fork_is_isolated_both_ways(random_data, align):
    """A fork shares the views copy-on-write: mutating either side (grows
    patched in place included) leaves the other side's view tensors and
    search results unchanged, bit for bit."""
    rng = np.random.RandomState(align)
    _, t = _integer_pair(random_data, align=align)
    q = rng.randint(0, 17, (8, NROWS)).astype(np.float32)
    qg = rng.randint(0, 17, (128, NROWS)).astype(np.float32)

    def snapshot(x):
        views = dict(lut=x.store.device_view(),
                     dense=x.store.device_view_dense(
                         x.quantizer, x.config.scan_chunk, cache="int8"))
        return ({(n, k): v.clone() for n, view in views.items()
                 for k, v in view.items() if isinstance(v, torch.Tensor)},
                x.search_padded(q, 5, w=6), x.search_padded(qg, 5, w=4))

    def assert_unchanged(x, snap):
        now = snapshot(x)
        assert now[0].keys() == snap[0].keys()
        for key, v in snap[0].items():
            assert torch.equal(now[0][key], v), key
        for a, b in zip(now[1:], snap[1:]):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])

    parent_snap = snapshot(t)
    child = t.fork()
    cent0 = t.coarse.centroids[0].numpy()
    child.push_batch(cent0 + 0.5 * rng.rand(150, NROWS))   # grows cell 0
    child.delete([1, 2, 3])
    child.delete([9])
    child.pop_front()
    child.search_padded(q, 5, w=6)                # flush into the child
    assert_unchanged(t, parent_snap)
    child_snap = snapshot(child)
    t.push_batch(t.coarse.centroids[2].numpy() + 0.5 * rng.rand(150, NROWS))
    t.delete([4, 5])
    t.push_front(rng.rand(NROWS) * 16)
    t.search_padded(q, 5, w=6)
    assert_unchanged(child, child_snap)
    _assert_views_rebuild(t)
    _assert_views_rebuild(child)


# ------------------------------------------------------------- persistence
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mutated_index_round_trips_format_v1(tmp_path, random_data,
                                             direction):
    """A mutated index (grown and relocated cells, dead regions) saved by
    one package loads in the other with the same state and searches."""
    rng = np.random.RandomState(4)
    j, t = _integer_pair(random_data, align=8)
    cent0 = np.asarray(j.coarse.centroids[0])
    for op, *args in [("push_batch", cent0 + 0.5 * rng.rand(40, NROWS)),
                      ("delete", [1, 2, 30]), ("pop_front",),
                      ("push", rng.rand(NROWS) * 16)]:
        _both(j, t, op, *args)
    assert t.store.total_cap > t.store.caps.sum()     # a dead region
    path = str(tmp_path / "mutated.npz")
    q = rng.randint(0, 17, (8, NROWS)).astype(np.float32)
    if direction == "jax_to_port":
        j.save(path)
        loaded = load_ivfadc_index(path, device="cpu")
        _assert_same_state(j, loaded)
        _assert_same_search(j, loaded, q, 5, 6)
    else:
        t.save(path)
        loaded = JaxIndex.load(path)
        _assert_same_state(loaded, t)
        loaded.config = dataclasses.replace(loaded.config, scan_mode="dense")
        _assert_same_search(loaded, t, q, 5, 6)


# --------------------------------------------------------------------- fuzz
def _apply(model, op, arg=None):
    """model: list of tokens ordered by current id."""
    if op == "push":
        model.append(arg)
    elif op == "push_front":
        model.insert(0, arg)
    elif op == "pop":
        return model.pop()
    elif op == "pop_front":
        return model.pop(0)
    elif op == "delete":
        for i in sorted(arg, reverse=True):
            del model[i]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzzed_op_sequences_match_shadow_model(random_data, seed):
    """tests/test_fuzz_dynamic.py's shadow model of positional ids, with a
    fixed seed and 12 ops; the JAX package runs the same ops and the
    states must stay equal after each."""
    r = np.random.RandomState(seed)
    j, t = _pair(random_data)
    n0 = len(t)
    pool = np.concatenate([np.asarray(random_data, np.float32),
                           r.rand(64, NROWS).astype(np.float32)])
    model = list(range(n0))
    recon = {tok: t.reconstruct(tok) for tok in range(n0)}
    next_tok = n0
    for step in range(12):
        op = r.choice(["push", "push_front", "pop", "pop_front", "delete",
                       "noop"])
        if op == "push" and next_tok < len(pool):
            _both(j, t, "push", pool[next_tok])
            _apply(model, "push", next_tok)
            recon[next_tok] = t.reconstruct(len(t) - 1)
            next_tok += 1
        elif op == "push_front" and next_tok < len(pool):
            _both(j, t, "push_front", pool[next_tok])
            _apply(model, "push_front", next_tok)
            recon[next_tok] = t.reconstruct(0)
            next_tok += 1
        elif op in ("pop", "pop_front") and len(model) > 5:
            _, v = _both(j, t, op)
            np.testing.assert_allclose(v, recon[_apply(model, op)],
                                       **RECON_TOL)
        elif op == "delete" and len(model) > 8:
            dels = sorted(set(r.randint(0, len(model), 4).tolist()))
            _both(j, t, "delete", dels)
            _apply(model, "delete", dels)
        assert len(t) == len(model), (seed, step, op)
        live = np.sort(t.store.ids[t.store.ids >= 0])
        assert np.array_equal(live, np.arange(len(model))), (seed, step, op)
        _assert_same_state(j, t)
    for cur in range(0, len(model), max(1, len(model) // 40)):
        np.testing.assert_allclose(t.reconstruct(cur), recon[model[cur]],
                                   **RECON_TOL)


def test_append_heavy_growth_kc4096_wallclock():
    """Cell growth relocates one cell, not the store: 20000 appends over
    4096 cells (hundreds of grows) stay within 20 s on the CPU and end in
    the JAX store's state."""
    kc, m, n0 = 4096, 8, 4096
    rng = np.random.RandomState(0)
    assignments = np.arange(n0) % kc
    codes = rng.randint(0, 256, (n0, m)).astype(np.uint8)
    store = PostingStore.build_device(torch.from_numpy(assignments),
                                      torch.from_numpy(codes), kc, slack=1.0,
                                      align=8)
    ref = JaxStore.build(assignments, codes, kc, slack=1.0, align=8)
    n_app = 20000
    cells = rng.randint(0, kc, n_app)
    rows = rng.randint(0, 256, (n_app, m)).astype(np.uint8)
    t0 = time.perf_counter()
    for i in range(0, n_app, 500):
        store.append_batch(cells[i:i + 500], rows[i:i + 500], n0 + i)
    elapsed = time.perf_counter() - t0
    assert store.n == n0 + n_app
    assert elapsed < 20.0, f"append-heavy growth took {elapsed:.1f}s"
    for i in range(0, n_app, 500):
        ref.append_batch(cells[i:i + 500], rows[i:i + 500], n0 + i)
    for key in ("offsets", "caps", "sizes", "codes", "ids"):
        np.testing.assert_array_equal(getattr(store, key),
                                      np.asarray(getattr(ref, key)))
    live = np.sort(store.ids[store.ids >= 0])
    assert np.array_equal(live, np.arange(store.n))
    for ext in rng.randint(0, store.n, 50):
        cell, slot = store.find(int(ext))
        assert store.ids[slot] == ext and (cell, slot) == ref.find(int(ext))
        o, c = int(store.offsets[cell]), int(store.caps[cell])
        assert o <= slot < o + c


def test_find_does_not_hydrate_codes():
    rng = np.random.RandomState(1)
    n, m, kc = 2048, 4, 32
    assignments = rng.randint(0, kc, n)
    codes = rng.randint(0, 256, (n, m)).astype(np.uint8)
    store = PostingStore.build_device(torch.from_numpy(assignments),
                                      torch.from_numpy(codes), kc)
    cell, slot = store.find(777)
    assert store._codes_h is None, "find() hydrated the codes array"
    assert int(store.ids[slot]) == 777
    ref = JaxStore.build(assignments, codes, kc)
    assert (cell, slot) == ref.find(777)
    np.testing.assert_array_equal(store._code_rows([slot])[0], codes[777])
    assert store._codes_h is None
