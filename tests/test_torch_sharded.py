"""The port's sharded view (`ivfadc_tpu_torch.parallel`) against the JAX
package's, on the CPU.

The JAX side is `ShardedIVFADCIndex(idx, make_mesh(...))` over a
host-built index on the suite's virtual CPU devices (never its distributed
build). The port's side is a view over the same index, saved by the JAX
package and loaded by the port, with its shards on
`[torch.device("cpu")] * 8`. On the integer-valued index of
tests/test_torch_dynamic.py (`_integer_pair`) every dense score is exact,
so the two packages' sharded results, and the port's sharded and
single-card results, agree bit for bit; on random floats within C.6's
3e-4 relative (the JAX package's interpret-mode kernels keep some products
in f32 that the port rounds to bf16).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ivfadc_tpu.parallel.mesh import make_mesh as jax_mesh
from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex as JaxSharded
from ivfadc_tpu.parallel.sharded import partition_store as jax_partition
from ivfadc_tpu_torch import (BatchingSearcher, IVFADCIndex, knn_search,
                              make_mesh)
from ivfadc_tpu_torch.parallel.sharded import (WIDE_NO_ID,
                                               ShardedIVFADCIndex,
                                               merge_candidates,
                                               partition_store)
from tests.conftest import build_random_index
from tests.test_torch_dynamic import _integer_pair

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)

MESHES = [(1, 1), (2, 4), (4, 2), (8, 1)]
CPUS = [torch.device("cpu")] * 8
NROWS = 10
T = 30                                  # seconds any single wait may take


def _load(j, tmp_path, name="j.npz"):
    """The port's copy of a JAX index, through the JAX package's file."""
    path = str(tmp_path / name)
    j.save(path)
    return IVFADCIndex.load(path, device="cpu")


def _views(j, t, S, D):
    return (JaxSharded(j, jax_mesh(n_shards=S, n_data=D)),
            ShardedIVFADCIndex(t, make_mesh(n_shards=S, n_data=D,
                                            devices=CPUS)))


def _queries(seed, n):
    """Integer-valued queries: every dense score of the integer pair is
    then exact."""
    return np.random.RandomState(seed).randint(0, 17, (n, NROWS)) \
        .astype(np.float32)


def _assert_bit_equal(js, ts, q, k, w, **kw):
    ji, jd = js.search_padded(q, k, w=w, **kw)
    ti, td = ts.search_padded(q, k, w=w, **kw)
    assert ti.dtype == ji.dtype
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    return ti, td


def _assert_equal_but_ties(a_ids, b_ids, dists):
    """Ids equal as a set within every group of equal distances, but for
    the row's last distance, whose group may reach past k."""
    for ai, bi, di in zip(a_ids, b_ids, dists):
        for v in np.unique(di[di < di[-1]]):
            assert set(ai[di == v]) == set(bi[di == v])


def _port_arrays(ts) -> dict:
    """The port view's shards as stacked numpy arrays (JAX's layout)."""
    def stack(key):
        if ts.views[0][key] is None:
            return None
        return np.stack([v[key].float().numpy() if key == "decoded"
                         else v[key].numpy() for v in ts.views])
    out = {key: stack(key) for key in ("offsets", "sizes", "ids", "codes",
                                       "decoded")}
    out["norms"] = None if ts.views[0]["norms2d"] is None else np.stack(
        [v["norms2d"].reshape(-1).numpy() for v in ts.views])
    return out


def _jax_arrays(js) -> dict:
    a = js.arrays
    dense = js.scan_mode == "dense"
    out = dict(offsets=np.asarray(a["offsets"]), sizes=np.asarray(a["sizes"]),
               ids=np.asarray(a["ids"]), codes=np.asarray(js.shard_pq_codes),
               decoded=np.asarray(a["codes"], np.float32) if dense else None,
               norms=None)
    if a.get("norms2d") is not None:
        out["norms"] = np.asarray(a["norms2d"]).reshape(len(out["ids"]), -1)
    return out


def _live_rows(arrs, S):
    """(shard, slot) of every live row, cell by cell."""
    s_l, r_l = [], []
    for s in range(S):
        sz = arrs["sizes"][s].astype(np.int64)
        cell = np.repeat(np.arange(len(sz)), sz)
        within = np.arange(sz.sum()) - np.repeat(np.cumsum(sz) - sz, sz)
        s_l.append(np.full(len(cell), s))
        r_l.append(arrs["offsets"][s].astype(np.int64)[cell] + within)
    return np.concatenate(s_l), np.concatenate(r_l)


def _assert_same_live_rows(a, b, S, ids=True):
    """Equal cell sizes, and each cell's live rows equal in the same
    order: ids (unless `ids` is False: layouts differ in wide mode), PQ
    codes, decoded rows and cached norms (where both hold them)."""
    np.testing.assert_array_equal(a["sizes"], b["sizes"])
    sa, ra = _live_rows(a, S)
    sb, rb = _live_rows(b, S)
    keys = ["codes", "decoded", "norms"] + (["ids"] if ids else [])
    for key in keys:
        if a[key] is None or b[key] is None:
            assert a[key] is None and b[key] is None, key
            continue
        np.testing.assert_array_equal(a[key][sa, ra], b[key][sb, rb],
                                      err_msg=key)


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("S", [1, 3, 8])
def test_partition_store_equals_jax(random_data, tmp_path, S, wide):
    j = build_random_index(random_data)
    t = _load(j, tmp_path)
    a, b = jax_partition(j.store, S, wide=wide), partition_store(t.store, S,
                                                                 wide=wide)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]),
                                      err_msg=key)
        if isinstance(a[key], np.ndarray):
            assert b[key].dtype == a[key].dtype, key


@pytest.mark.parametrize("S,D", MESHES)
def test_shard_views_and_search_equal_jax(random_data, tmp_path, S, D):
    """Per-shard layout, PQ codes, decoded rows, ids2d and norms2d equal
    the JAX view's (over the live rows: the guard and dead rows hold the
    zero code's row in both), and search_padded equals it bit for bit on
    both scan routes (B*w < 4*kc per probe, >= 4*kc grouped) and equals
    the single-card port."""
    j, _ = _integer_pair(random_data)
    t = _load(j, tmp_path)
    js, ts = _views(j, t, S, D)
    a, b = _jax_arrays(js), _port_arrays(ts)
    for key in ("offsets", "sizes", "ids", "codes"):
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    _assert_same_live_rows(a, b, S)
    for view in ts.views:
        assert torch.equal(view["ids2d"].reshape(-1), view["ids"])
    assert (ts.window, ts.max_cap, ts.pos8, ts.gather_plan) == \
        (js.window, js.max_cap, js.pos8, js.gather_plan)
    q = _queries(S + D, 128 * D)
    # per data group 8 / D or 128 queries at w = 6 against 4 * kc = 400
    for B in (8, 128 * D):
        ti, td = _assert_bit_equal(js, ts, q[:B], 10, 6)
        si, sd = t.search_padded(q[:B], 10, w=6)
        np.testing.assert_array_equal(td, sd)
        _assert_equal_but_ties(ti, si, td)


@pytest.mark.parametrize("S,D", MESHES)
def test_random_float_search_close_to_jax(random_data, tmp_path, S, D):
    """A plain float index (trained codebooks, int8 cache): the dense route
    close to the JAX view (C.6) and bit-equal to the single-card port; the
    LUT route (scan_mode="auto" on the CPU) bit-equal to the single-card
    LUT route."""
    j = build_random_index(random_data)
    j_dense = dataclasses.replace(j.config, scan_mode="dense")
    j = type(j)(j_dense, j.coarse, j.quantizer, j.store, j.data_dtype,
                j.dim)
    t = _load(j, tmp_path)
    js, ts = _views(j, t, S, D)
    q = np.asarray(random_data[:128], np.float32) + 0.01
    ji, jd = js.search_padded(q, 5, w=8)
    ti, td = ts.search_padded(q, 5, w=8)
    # C.6's bound is on each term of a score (base, v.r, ||r||^2), not on
    # the score: hold the scores to 2e-3 of the largest, as the port's
    # single-card scan tests do, and the ids where no near-tie swaps them
    np.testing.assert_allclose(td, jd, rtol=0, atol=2e-3 * np.abs(jd).max())
    assert (ti == ji).mean() >= 0.95
    # the sharded view equals the single-card port bit for bit on each
    # data group's slice (the slice's size picks the scan route)
    si, sd = map(np.concatenate, zip(*[
        t.search_padded(q[g:g + 128 // D], 5, w=8)
        for g in range(0, 128, 128 // D)]))
    np.testing.assert_array_equal(td, sd)
    _assert_equal_but_ties(ti, si, td)
    t_lut = ShardedIVFADCIndex(
        IVFADCIndex(dataclasses.replace(t.config, scan_mode="auto"),
                    t.coarse, t.quantizer, t.store, t.data_dtype, t.dim),
        ts.mesh)
    assert t_lut.scan_mode == "lut"
    li, ld = t_lut.search_padded(q, 5, w=8)
    ri, rd = IVFADCIndex(t_lut.index.config, t.coarse, t.quantizer, t.store,
                         t.data_dtype, t.dim).search_padded(q, 5, w=8)
    np.testing.assert_array_equal(ld, rd)


# ------------------------------------------------------------------ routes
def test_two_level_coarse_and_gathered_engine(random_data, tmp_path):
    """The two-level coarse quantizer and the gathered engine (8-row
    cells, scan_gather_win=256: its plan covers every cell) through the
    sharded view, bit-equal to the JAX view."""
    j, _ = _integer_pair(random_data, "hnsw")
    t = _load(j, tmp_path)
    js, ts = _views(j, t, 4, 2)
    q = _queries(1, 256)
    for B in (16, 256):
        _assert_bit_equal(js, ts, q[:B], 10, 4)
    j, _ = _integer_pair(random_data, align=8, scan_gather_win=256)
    t = _load(j, tmp_path, "g.npz")
    js, ts = _views(j, t, 4, 2)
    assert ts.gather_plan == js.gather_plan and ts.gather_plan[0] > 0
    _assert_bit_equal(js, ts, q[:16], 10, 4)


@pytest.mark.parametrize("S,D", [(4, 2), (8, 1)])
def test_large_k_reroute_and_overlap(random_data, tmp_path, S, D):
    """k > 128 reroutes the dense view to the LUT scan; overlap=True scans
    and merges each half of a data group's batch on its own (16 queries or
    more): both bit-equal to the JAX view, and overlap to the blocking
    wave (the integer scores do not depend on the split)."""
    j, _ = _integer_pair(random_data)
    t = _load(j, tmp_path)
    js, ts = _views(j, t, S, D)
    q = _queries(2, 48)
    _assert_bit_equal(js, ts, q, 150, 8)
    ti, td = _assert_bit_equal(js, ts, q, 10, 6, overlap=True)
    bi, bd = ts.search_padded(q, 10, w=6)
    np.testing.assert_array_equal(td, bd)
    si, sd = ts.search_stream(q, 10, w=6, batch=16)
    np.testing.assert_array_equal(sd, bd)


def test_merge_keeps_lax_top_k_tie_order():
    """The cross-shard merge on tie-heavy rows (small integers, +inf pads
    with id -1) picks what the JAX package's `lax.top_k(-d, k)` picks:
    equal distances in flat (shard-major) order."""
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    S, B, k = 4, 64, 10
    d = rng.randint(0, 6, (S, B, k)).astype(np.float32)
    d[:, :8, 5:] = np.inf
    ids = rng.randint(0, 1000, (S, B, k)).astype(np.int32)
    ids[np.isinf(d)] = -1
    got_i, got_d, got_s = merge_candidates(
        [torch.from_numpy(ids[s]) for s in range(S)],
        [torch.from_numpy(d[s]) for s in range(S)], k)
    all_i = np.moveaxis(ids, 0, 1).reshape(B, S * k)
    all_d = np.moveaxis(d, 0, 1).reshape(B, S * k)
    neg, which = jax.lax.top_k(-jnp.asarray(all_d), k)
    which = np.asarray(which)
    np.testing.assert_array_equal(got_d.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(got_i.numpy(),
                                  np.take_along_axis(all_i, which, 1))
    finite = np.isfinite(got_d.numpy())
    np.testing.assert_array_equal(got_s.numpy()[finite], (which // k)[finite])


# ----------------------------------------------------------------- refresh
@pytest.mark.parametrize("S,D", MESHES)
def test_refresh_sequence_matches_jax(random_data, tmp_path, S, D):
    """The refresh sequence of tests/test_sharded.py on both packages:
    `_last_refresh` equal after every step (noop, incremental, full), the
    patched shards' live rows equal to the JAX view's and to a fresh
    port view's, and searches bit-equal to both."""
    j, _ = _integer_pair(random_data)
    t = _load(j, tmp_path)
    js, ts = _views(j, t, S, D)
    rng = np.random.RandomState(11)
    q = _queries(3, 8 * D * 16)

    def both(fn):
        fn(j)
        fn(t)
        js.refresh()
        ts.refresh()
        assert ts._last_refresh == js._last_refresh
        _assert_same_live_rows(_jax_arrays(js), _port_arrays(ts), S)
        fresh = ShardedIVFADCIndex(t, ts.mesh)
        _assert_same_live_rows(_port_arrays(fresh), _port_arrays(ts), S)
        for B in (8, len(q)):
            _assert_bit_equal(js, ts, q[:B], 10, 6)
            for a, b in zip(fresh.search_padded(q[:B], 10, w=6),
                            ts.search_padded(q[:B], 10, w=6)):
                np.testing.assert_array_equal(a, b)
        return ts._last_refresh

    p1, p2 = rng.rand(NROWS) * 16, rng.rand(NROWS) * 16

    def mixed(ix):
        ix.push(p1)
        ix.push_front(p2)
        ix.delete([2, 40, 41])
        ix.pop()

    assert both(mixed) == "incremental"
    assert both(lambda ix: None) == "noop"
    for r in range(2):
        pts = rng.rand(6, NROWS) * 16
        mid = len(t) // 2
        assert both(lambda ix: (ix.push_batch(pts),
                                ix.delete([mid]))) == "incremental"
    crowd = rng.rand(400, NROWS) * 16      # dirty cells beyond kc // 4
    assert both(lambda ix: ix.push_batch(crowd)) == "full"


def test_view_mutators_and_cap_overflow(random_data, tmp_path):
    """The view's own mutators refresh as they go; a cell pushed past its
    per-shard capacity forces a full re-partition, as in the JAX view."""
    j, _ = _integer_pair(random_data)
    t = _load(j, tmp_path)
    js, ts = _views(j, t, 4, 2)
    rng = np.random.RandomState(4)
    q = _queries(5, 64)
    cent = np.asarray(j.coarse.centroids[5])
    steps = [("push", rng.rand(NROWS) * 16), ("push_front", cent + 0.1),
             ("delete", [0, 7, 100]), ("pop",), ("pop_front",),
             ("push_batch", cent + 0.1 * rng.rand(130, NROWS))]
    for name, *args in steps:
        a, b = getattr(js, name)(*args), getattr(ts, name)(*args)
        if a is not None:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
        assert ts._last_refresh == js._last_refresh, name
        _assert_bit_equal(js, ts, q, 10, 6)
    assert ts._last_refresh == "full"          # cell 5 outgrew its cap
    np.testing.assert_allclose(ts.reconstruct(3), js.reconstruct(3),
                               rtol=1e-6, atol=1e-6)


def test_fork_is_independent(random_data, tmp_path):
    """A fork copies the shards and forks the base: mutations on either
    side leave the other's results unchanged, and a log the parent had not
    drained is replayed into the fork."""
    j, _ = _integer_pair(random_data)
    t = _load(j, tmp_path)
    ts = ShardedIVFADCIndex(t, make_mesh(n_shards=4, n_data=2,
                                         devices=CPUS))
    q = _queries(6, 128)
    rng = np.random.RandomState(6)
    before = ts.search_padded(q, 10, w=6)
    kid = ts.fork()
    kid.push_batch(rng.rand(20, NROWS) * 16)
    kid.delete([1, 2, 3])
    for a, b in zip(before, ts.search_padded(q, 10, w=6)):
        np.testing.assert_array_equal(a, b)
    kid_res = kid.search_padded(q, 10, w=6)
    ts.push(rng.rand(NROWS) * 16)
    ts.delete([0])
    for a, b in zip(kid_res, kid.search_padded(q, 10, w=6)):
        np.testing.assert_array_equal(a, b)
    # pending: the base mutated, the view not yet refreshed
    ts.index.push_front(rng.rand(NROWS) * 16)
    kid2 = ts.fork()
    assert kid2._last_refresh == "incremental"
    ts.refresh()
    fresh = ShardedIVFADCIndex(ts.index, ts.mesh)
    for view in (ts, kid2):
        for a, b in zip(fresh.search_padded(q, 10, w=6),
                        view.search_padded(q, 10, w=6)):
            np.testing.assert_array_equal(a, b)
    assert len(kid2.index) == len(ts.index) and len(kid.index) != len(t)


# ---------------------------------------------------------------- wide ids
def test_wide_ids_upgrade_on_push(random_data, tmp_path, monkeypatch):
    """A value-mode view crossing the (lowered) device id cap on push
    upgrades to wide ids in place: its uint64 ids equal an uncapped twin's
    and the JAX view's, distances bit-equal, further deletes in wide mode
    too; the plain index's search on the capped base raises."""
    j, _ = _integer_pair(random_data)
    t = _load(j, tmp_path)
    q = _queries(7, 64)
    pts = np.random.RandomState(7).rand(20, NROWS) * 16
    twin = ShardedIVFADCIndex(t.fork(), make_mesh(n_shards=4, n_data=2,
                                                  devices=CPUS))
    twin.push_batch(pts)
    ref_i, ref_d = twin.search_padded(q, 10, w=6)
    monkeypatch.setenv("IVFADC_DEVICE_ID_CAP", "250")
    js, ts = _views(j, t, 4, 2)
    assert not ts.wide_ids and len(t) == 243
    js.push_batch(pts)
    ts.push_batch(pts)
    assert ts.wide_ids and js.wide_ids and ts._last_refresh == "incremental"
    ids, dists = _assert_bit_equal(js, ts, q, 10, 6)
    assert ids.dtype == np.uint64
    live = ref_i >= 0
    np.testing.assert_array_equal(ids[live].astype(np.int64), ref_i[live])
    assert (ids[~live] == WIDE_NO_ID).all()
    np.testing.assert_array_equal(dists, ref_d)
    np.testing.assert_array_equal(ts._trans, js._trans)
    _assert_same_live_rows(_jax_arrays(js), _port_arrays(ts), 4)
    with pytest.raises(AssertionError, match="id cap"):
        t.search_padded(q, 10, w=6)
    for view in (twin, js, ts):
        view.delete([0, 5, 250])
    ids, _ = _assert_bit_equal(js, ts, q, 10, 6)
    ref_i, _ = twin.search_padded(q, 10, w=6)
    live = ref_i >= 0
    np.testing.assert_array_equal(ids[live].astype(np.int64), ref_i[live])
    got = ts.search(q[0], 10, w=6)[0]
    assert got.dtype == np.uint32 and (got == ref_i[0][ref_i[0] >= 0]).all()


def test_streaming_build_past_the_cap(monkeypatch):
    """ShardedIVFADCIndex.build_streaming crosses the device id cap into a
    wide view equal to an uncapped twin's; the plain build raises, naming
    the sharded view."""
    data = np.random.RandomState(8).rand(1300, 12).astype(np.float32)
    chunks = [data[s:s + 400] for s in range(0, len(data), 400)]
    kw = dict(kc=32, k=16, m=2, index_dtype="uint64", coarse_maxiter=8,
              quantization_maxiter=8, seed=3, scan_mode="dense")
    mesh = make_mesh(n_shards=4, devices=CPUS)
    twin = ShardedIVFADCIndex.build_streaming(chunks, mesh, train_data=data,
                                              **kw)
    monkeypatch.setenv("IVFADC_DEVICE_ID_CAP", "1024")
    with pytest.raises(AssertionError, match="ShardedIVFADCIndex"):
        IVFADCIndex.build_streaming(chunks, train_data=data, device="cpu",
                                    **kw)
    with pytest.raises(AssertionError, match="ShardedIVFADCIndex"):
        IVFADCIndex.build(data, device="cpu", **kw)
    sidx = ShardedIVFADCIndex.build_streaming(chunks, mesh, train_data=data,
                                              **kw)
    assert sidx.wide_ids and not twin.wide_ids
    assert sidx.index.device.type == "cpu"
    q = data[:64] + 0.01
    ids, dists = sidx.search_padded(q, 10, w=8)
    ref_i, ref_d = twin.search_padded(q, 10, w=8)
    np.testing.assert_array_equal(ids.astype(np.int64), ref_i)
    np.testing.assert_array_equal(dists, ref_d)


# ----------------------------------------------------------- API, serving
def test_api_surface(random_data, tmp_path):
    """make_mesh raises as the JAX package's does (and never defaults to
    the CPU), knn_search takes a sharded view, memory_stats and repr
    follow the JAX view's."""
    import ivfadc_tpu_torch
    assert "ShardedIVFADCIndex" in ivfadc_tpu_torch.__all__
    with pytest.raises(ValueError, match="no room for a shard axis"):
        make_mesh(n_data=9, devices=CPUS)
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        make_mesh(n_shards=9, devices=CPUS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    mesh = make_mesh(n_shards=4, n_data=2, devices=CPUS)
    assert mesh.shape == {"data": 2, "shard": 4}
    j, _ = _integer_pair(random_data)
    t = _load(j, tmp_path)
    js, ts = _views(j, t, 4, 2)
    q = _queries(9, 4)
    ji, jd = js.search(q, 10, w=6)
    ti, td = knn_search(ts, q, 10, w=6)
    for a, b in zip(ji + jd, ti + td):
        np.testing.assert_array_equal(b, a)
    one = knn_search(ts, q[0], 10, w=6)
    np.testing.assert_array_equal(one[0], ji[0])
    ms_j, ms_t = js.memory_stats(), ts.memory_stats()
    assert ms_t["n_shards"] == ms_j["n_shards"] == 4
    assert ms_t["sharded_device_bytes_total"] == \
        ms_j["sharded_device_bytes_total"]
    assert repr(ts).startswith("ShardedIVFADCIndex(4 shards x 2 data, "
                               "scan_mode=dense, 243 vectors; base: ")


def test_batching_searcher_over_sharded_view(random_data, tmp_path):
    """BatchingSearcher drives a sharded view (fork, search_padded, the
    mutators): served rows equal the view's own search_padded, before and
    after mutations through the searcher, and equal the JAX searcher's."""
    from ivfadc_tpu.serving import BatchingSearcher as JaxSearcher
    j, _ = _integer_pair(random_data)
    t = _load(j, tmp_path)
    js, ts = _views(j, t, 4, 2)
    q = _queries(10, 16)
    pts = np.random.RandomState(10).rand(5, NROWS) * 16
    with BatchingSearcher(ts, max_batch=64, max_wait_ms=5) as s, \
            JaxSearcher(js, max_batch=64, max_wait_ms=5) as sj:
        for r in range(2):
            got = [f.result(timeout=T) for f in
                   [s.submit(q[i], 10, w=6) for i in range(16)]]
            got_j = [f.result(timeout=T) for f in
                     [sj.submit(q[i], 10, w=6) for i in range(16)]]
            ids_d, dists_d = ts.search_padded(q, 10, w=6)
            for i, ((gi, gd), (hi, hd)) in enumerate(zip(got, got_j)):
                np.testing.assert_array_equal(gi, ids_d[i])
                np.testing.assert_array_equal(gd, dists_d[i])
                np.testing.assert_array_equal(gi, hi)
                np.testing.assert_array_equal(gd, hd)
            for searcher in (s, sj):
                searcher.push_batch(pts + r)
                searcher.delete([3])
    assert len(t) == len(j) == 243 + 8
