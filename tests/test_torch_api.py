"""The rest of the port's static API against the JAX package: OPQ training,
the gathered tiny-cell engine, `search_stream`, `bytes_per_vector` and
`__repr__`, and the cosine coarse metric against the NumPy oracle.

On the CPU the JAX package runs its Pallas kernels in interpret mode and
the port runs its kernels' plain versions. The gathered-engine checks run
on `_integer_pair`'s integer-valued indexes (tests/test_torch_dynamic.py),
where every score is exact, so ids and distances must agree exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks.oracle import ReferenceOracle
from ivfadc_tpu import IVFADCIndex as JaxIndex
from ivfadc_tpu_torch import IVFADCIndex
from ivfadc_tpu_torch.convert import from_reference
from ivfadc_tpu_torch.ops import gather_scan
from ivfadc_tpu_torch.ops import pq as t_pq
from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
from ivfadc_tpu_torch.utils.evaluation import brute_force_topk, recall_at_r
from tests.test_torch_dynamic import (NROWS, _assert_same_search,
                                      _integer_pair, _pair)

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)


def _recon_err(q, x):
    codes = t_pq.encode(q, x)
    return float(((t_pq.decode(q, codes) - x) ** 2).sum())


# ---------------------------------------------------------------------- OPQ
def test_opq_rotation_is_orthogonal_and_helps_on_correlated_data():
    # tests/test_pq.py: strongly correlated dimensions, which OPQ's
    # rotation decorrelates across subspaces
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randn(1000, 4) @ rng.randn(4, 16))
                         .astype(np.float32))
    qpq = t_pq.train_quantizer(3, x, m=4, k=16, maxiter=15)
    qopq = t_pq.train_quantizer(3, x, m=4, k=16, method="opq", maxiter=15,
                                opq_iters=5)
    r = qopq.rotation.numpy().astype(np.float64)
    assert qopq.method == "opq"
    assert np.abs(r @ r.T - np.eye(16)).max() < 1e-4
    assert _recon_err(qopq, x) < _recon_err(qpq, x)


def test_opq_sequential_layout_is_orthogonal_and_equal(monkeypatch):
    # the one-subspace-at-a-time layout draws the batched layout's streams
    rng = np.random.RandomState(7)
    x = torch.from_numpy((rng.randn(300, 12) @ rng.randn(12, 12))
                         .astype(np.float32))
    kw = dict(m=3, k=8, maxiter=6, method="opq", opq_iters=2)
    batched = t_pq.train_quantizer(1, x, **kw)
    monkeypatch.setattr(t_pq, "_SEQ_TRAIN_BYTES", 0)
    seq = t_pq.train_quantizer(1, x, **kw)
    r = seq.rotation.numpy().astype(np.float64)
    np.testing.assert_allclose(r @ r.T, np.eye(12), atol=1e-4)
    torch.testing.assert_close(seq.codebooks, batched.codebooks, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(seq.rotation, batched.rotation, rtol=1e-5,
                               atol=1e-5)
    assert np.mean((t_pq.decode(seq, t_pq.encode(seq, x)) - x).numpy() ** 2) \
        < float(np.mean(x.numpy() ** 2))


def test_opq_build_recall_matches_jax():
    """The RNGs differ, so the two OPQ builds differ bit for bit; at this
    configuration (every cell probed, 256 codewords, 1000 queries) the
    recall@10 of independent builds varies by about 0.005, and the port's
    must be within 0.01 of the JAX package's. The build is reproducible."""
    data = synthetic_clustered(4096, 32, seed=3)
    rng = np.random.RandomState(1)
    q = (data[rng.randint(0, 4096, 1000)]
         + 0.05 * rng.randn(1000, 32)).astype(np.float32)
    kw = dict(kc=16, m=8, k=256, seed=0, quantization_method="opq",
              opq_iters=3, quantization_maxiter=10, scan_mode="dense")
    j = JaxIndex.build(data, **kw)
    t = IVFADCIndex.build(data, device="cpu", **kw)
    assert t.quantizer.method == "opq"
    r = t.quantizer.rotation.numpy().astype(np.float64)
    assert np.abs(r @ r.T - np.eye(32)).max() < 1e-4
    _, gt = brute_force_topk(data, q, 10)
    r_jax = recall_at_r(j.search_padded(q, 10, w=16)[0], gt, 10)
    r_port = recall_at_r(t.search_padded(q, 10, w=16)[0], gt, 10)
    assert r_jax > 0.6
    assert abs(r_port - r_jax) <= 0.01, (r_port, r_jax)
    again = IVFADCIndex.build(data, device="cpu", **kw)
    assert torch.equal(again.quantizer.rotation, t.quantizer.rotation)
    np.testing.assert_array_equal(again.store.codes, t.store.codes)


def test_cosine_coarse_metric_matches_oracle():
    """tests/test_oracle_parity.py's cosine check on the port: the coarse
    k-means trains under cosine, probes rank by cosine, and the score is
    cosine coarse distance + sqeuclidean residual tables, as the oracle
    composes them."""
    rng = np.random.RandomState(11)
    dirs = rng.randn(8, 12)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    data = np.concatenate([
        (dv[None, :] + 0.08 * rng.randn(50, 12))
        * rng.uniform(0.5, 5.0, (50, 1)) for dv in dirs]).astype(np.float32)
    idx = IVFADCIndex.build(data, device="cpu", kc=8, k=16, m=3, seed=3,
                            coarse_metric="cosine", coarse_maxiter=10,
                            quantization_maxiter=8)
    oracle = ReferenceOracle.from_index(idx)
    assert oracle.coarse_metric == "cosine"
    queries = data[rng.choice(len(data), 16)] + \
        0.02 * rng.randn(16, 12).astype(np.float32)
    for w in (1, 3):
        ours_i, ours_d = idx.search(queries, 8, w=w)
        for q, oi, od in zip(queries, ours_i, ours_d):
            ri, rd = oracle.search(q, 8, w)
            kth = rd[-1]
            tol = 2e-2 * max(1.0, abs(float(kth)))
            for cand, cd in zip(oi.tolist(), od.tolist()):
                assert cand in set(ri.tolist()) or abs(cd - kth) <= tol, \
                    (w, cand, cd, kth)
            np.testing.assert_allclose(np.sort(od), np.sort(rd), rtol=2e-2,
                                       atol=2e-2)


# ---------------------------------------------------------- gathered engine
def test_gathered_engine_covers_all_then_hybrid_after_growth(random_data):
    """8-row cells of capacity 16: the plan's window covers every cell and
    the scan kernel is skipped; a cell grown in place past the window
    turns the plan hybrid (the grown cell goes to the scan kernel) and
    none of its postings drops out. Exact against the JAX package on
    both plans."""
    j, t = _integer_pair(random_data, align=8, scan_gather_win=64)
    rng = np.random.RandomState(0)
    q = rng.randint(0, 17, (8, NROWS)).astype(np.float32)
    win0, covers0 = t._gather_plan()
    assert (win0, covers0) == j._gather_plan() and covers0 and win0 <= 64
    assert 8 * 6 < 4 * t.config.kc                # the per-probe route
    _assert_same_search(j, t, q, 5, 6)
    cent0 = np.asarray(j.coarse.centroids[0])
    crowd = cent0 + 0.5 * rng.rand(4 * win0, NROWS)
    j.push_batch(crowd)
    t.push_batch(crowd)
    assert int(t.store.caps.max()) > 64          # past the window limit
    win1, covers1 = t._gather_plan()
    assert (win1, covers1) == j._gather_plan() and not covers1 and win1 > 0
    qc = np.round(crowd[:8]).astype(np.float32)
    _assert_same_search(j, t, q, 5, 6)
    _assert_same_search(j, t, qc, 5, 2)
    # nothing dropped: the LUT engine scores every probed posting, and on
    # these integer scores its distances are the dense route's exactly
    lut = IVFADCIndex(dataclasses.replace(t.config, scan_mode="lut"),
                      t.coarse, t.quantizer, t.store, t.data_dtype, t.dim)
    for qq, w in ((q, 6), (qc, 2)):
        np.testing.assert_array_equal(t.search_padded(qq, 5, w=w)[1],
                                      lut.search_padded(qq, 5, w=w)[1])


def test_gathered_plan_is_keyed_on_caps_and_limit(random_data):
    _, t = _integer_pair(random_data, align=8, scan_gather_win=64)
    plan = t._gather_plan()
    assert t.store._gather_cache[2] == plan
    t.config = dataclasses.replace(t.config, scan_gather_win=8)
    assert t._gather_plan() == gather_scan.plan_gather(t.store.caps, 8)
    t.config = dataclasses.replace(t.config, scan_gather_win=0)
    assert t._gather_plan() == (0, False)
    t.config = dataclasses.replace(t.config, scan_gather_win=64)
    assert t._gather_plan() == plan
    t.store.caps[0] += 128                       # grown in place
    assert t._gather_plan() == gather_scan.plan_gather(t.store.caps, 64)
    assert t._gather_plan() != plan


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_gathered_hybrid_oversized_cell_matches_jax(metric):
    """One heavily populated cell above the gather window: its probes go
    through the scan kernel and merge with the gathered candidates. Float
    data: ids agree but at near-ties (the two packages sum the gathered
    contraction in other orders), distances within C.6's bound (~3e-4 of
    the score's terms: the JAX package's interpret mode keeps products in
    f32 that the port rounds to bf16)."""
    rng = np.random.RandomState(5)
    d, kc = 16, 32
    centers = rng.randn(kc, d).astype(np.float32) * 6
    small = np.concatenate(
        [c + 0.1 * rng.randn(6, d).astype(np.float32) for c in centers[1:]])
    big = centers[0] + 0.1 * rng.randn(400, d).astype(np.float32)
    base = np.concatenate([big, small])
    j = JaxIndex.build(base, kc=kc, k=16, m=4, seed=0, coarse_maxiter=10,
                       quantization_maxiter=10, scan_gather_win=16,
                       cell_align=8, scan_mode="dense",
                       quantization_metric=metric)
    t = from_reference(j, "cpu")
    win, covers_all = t._gather_plan()
    assert (win, covers_all) == j._gather_plan() and win and not covers_all
    assert int(t.store.caps.max()) > win
    q = np.concatenate([big[:4], small[:4]])
    ji, jd = j.search_padded(q, 10, w=4)
    ti, td = t.search_padded(q, 10, w=4)
    same = ti == ji
    assert same.mean() >= 0.95
    np.testing.assert_allclose(td[same], jd[same], rtol=3e-4, atol=1e-3)


def test_gathered_scan_scores_and_masks():
    # the score formula of the scan kernels (bf16 rows, bf16 squares, f32
    # sums) on integer-valued rows and scan vectors, where it is exact;
    # lanes past each cell's size hold +inf and -1
    rng = np.random.RandomState(2)
    rows, d, B, w, win = 512, 128, 4, 3, 24
    decoded = torch.from_numpy(rng.randint(-7, 8, (rows, d)).astype(np.int8))
    scale = torch.full((d,), 0.5)
    starts = torch.from_numpy(rng.randint(0, rows - win, (B, w)))
    sizes = torch.from_numpy(rng.randint(0, win + 1, (B, w)))
    v = torch.from_numpy(rng.randint(-8, 9, (B, w, d)).astype(np.float32))
    base = torch.from_numpy(rng.randint(0, 50, (B, w)).astype(np.float32))
    ids = torch.arange(rows, dtype=torch.int32) * 3
    for coef in (1.0, 0.0):
        gd, gi = gather_scan.gathered_scan(starts, sizes, v, base, decoded,
                                           scale, ids, win=win,
                                           norm_coef=coef)
        for b in range(B):
            for c in range(w):
                n, s0 = int(sizes[b, c]), int(starts[b, c])
                r = decoded[s0:s0 + n].double() * 0.5
                want = r @ v[b, c].double() + coef * (r * r).sum(1) \
                    + float(base[b, c])
                np.testing.assert_array_equal(gd[b, c, :n].double().numpy(),
                                              want.numpy())
                assert (gi[b, c, :n].numpy() == 3 * (s0 + np.arange(n))).all()
                assert (gi[b, c, n:] == -1).all()
                assert torch.isinf(gd[b, c, n:]).all()


# -------------------------------------------------------------- static API
def test_search_stream_equals_stacked_search_padded(random_data):
    j, t = _pair(random_data)
    q = np.random.RandomState(3).rand(50, NROWS).astype(np.float32)

    class Stats:
        calls = []

        def record(self, n, seconds):
            self.calls.append((n, seconds))

    stats = Stats()
    ids, dists = t.search_stream(q, 5, w=4, batch=16, stats=stats)
    want = [t.search_padded(q[s:s + 16], 5, w=4) for s in range(0, 50, 16)]
    np.testing.assert_array_equal(ids, np.concatenate([a for a, _ in want]))
    np.testing.assert_array_equal(dists, np.concatenate([b for _, b in want]))
    assert stats.calls[0][0] == 50 and stats.calls[0][1] > 0
    ji, jd = j.search_stream(q, 5, w=4, batch=16)
    np.testing.assert_array_equal(ids, ji)
    np.testing.assert_allclose(dists, jd, rtol=1e-5)
    e_ids, e_d = t.search_stream(q[:0], 5)
    assert e_ids.shape == (0, 5) and e_d.shape == (0, 5)


@pytest.mark.parametrize("overrides", [
    dict(), dict(index_dtype="uint8"), dict(coarse_quantizer="hnsw"),
    dict(k=300, index_dtype="uint16"),
])
def test_bytes_per_vector_and_repr_equal_jax(random_data, overrides):
    overrides = dict(overrides)
    if "k" in overrides:             # 300 codewords need 300 points
        data = np.random.RandomState(1).rand(400, NROWS)
        j, t = _pair(data, quantization_maxiter=2, coarse_maxiter=2,
                     **overrides)
    else:
        j, t = _pair(random_data, **overrides)
    assert t.bytes_per_vector() == j.bytes_per_vector()
    assert repr(t) == repr(j)
    assert repr(t.store) == repr(j.store)


# ------------------------------------- memory_stats, probe_stats, autotune
@pytest.mark.parametrize("coarse", ["naive", "hnsw"])
def test_memory_stats_equal_jax(random_data, coarse):
    """The same index in both packages reports the same dict: before any
    view exists, then with the dense and the LUT views built (the JAX
    package's accounting: decoded + 4 bytes a row of ids2d; codes + ids),
    and after a mutation's patches."""
    j, t = _integer_pair(random_data, coarse_quantizer=coarse)
    assert t.memory_stats() == j.memory_stats()
    assert t.store._device is None and t.store._device_dense is None
    q = np.random.RandomState(2).randint(0, 17, (8, NROWS)) \
        .astype(np.float32)
    for ix in (j, t):
        ix.search_padded(q, 5, w=6)
        ix.store.device_view()
    got = t.memory_stats()
    assert got == j.memory_stats()
    dense = t.store._device_dense
    assert got["device_scan_cache_bytes"] == (
        dense["decoded"].numel() * dense["decoded"].element_size()
        + dense["ids2d"].numel() * 4)
    for ix in (j, t):
        ix.push(q[0])
        ix.search_padded(q, 5, w=6)
    assert t.memory_stats() == j.memory_stats()


@pytest.mark.parametrize("w", [1, 6, 500])
def test_probe_stats_equal_jax(random_data, w):
    from ivfadc_tpu.utils.profiling import probe_stats as j_probe_stats
    from ivfadc_tpu_torch.utils.profiling import probe_stats
    j, t = _pair(random_data)
    q = np.random.RandomState(4).rand(16, NROWS).astype(np.float32)
    assert probe_stats(t, q, w) == j_probe_stats(j, q, w)


def test_autotune_applies_best_and_preserves_results():
    """autotune times the candidates, applies the fastest, and the tuned
    index returns the same results; pb = 128, which the grouped kernels
    run as 64-row tiles (`tile_height`), is timed like the others, and
    every candidate's results equal the default config's."""
    rng = np.random.RandomState(3)
    data = rng.rand(2048, 32).astype(np.float32)
    idx = IVFADCIndex.build(data, kc=16, m=4, k=16, seed=0,
                            scan_mode="dense", device="cpu")
    q = data[:32]                     # B*w = 128 >= 4*kc: the grouped scan
    before_i, before_d = idx.search_padded(q, 5, w=4)
    cfg0 = idx.config
    out = idx.autotune(q, k=5, w=4, pbs=(8, 16, 128), chunks=(128, 256),
                       reps=2)
    assert out["applied"] and out["best"] is not None
    assert {"pb", "chunk", "merge", "seconds"} <= set(out["best"])
    assert not [r for r in out["results"] if "error" in r]
    assert len(out["results"]) == 6
    assert idx.config.scan_pb == out["best"]["pb"]
    assert idx.config.scan_chunk == out["best"]["chunk"]
    assert dataclasses.replace(idx.config, scan_pb=cfg0.scan_pb,
                               scan_chunk=cfg0.scan_chunk,
                               scan_merge=cfg0.scan_merge) == cfg0
    assert idx.store._chunk_cache is None
    after_i, after_d = idx.search_padded(q, 5, w=4)
    np.testing.assert_array_equal(before_i, after_i)
    np.testing.assert_array_equal(before_d, after_d)
    tuned = idx.config
    for r in out["results"]:
        idx.config = dataclasses.replace(cfg0, scan_pb=r["pb"],
                                         scan_chunk=r["chunk"])
        idx._drop_plans()
        got_i, got_d = idx.search_padded(q, 5, w=4)
        np.testing.assert_array_equal(got_i, before_i)
        np.testing.assert_array_equal(got_d, before_d)
    idx.config = tuned
    idx._drop_plans()
    # apply=False leaves the config untouched
    cfg = idx.config
    out2 = idx.autotune(q, k=5, w=4, pbs=(8,), chunks=(128,), reps=1,
                        apply=False)
    assert not out2["applied"] and idx.config is cfg


def test_autotune_lut_mode_and_bad_queries_equal_jax():
    rng = np.random.RandomState(4)
    data = rng.rand(256, 16).astype(np.float32)
    kw = dict(kc=8, m=4, k=16, scan_mode="lut")
    j = JaxIndex.build(data, **kw)
    t = IVFADCIndex.build(data, device="cpu", **kw)
    assert t.autotune(data[:8], k=3, w=2) == j.autotune(data[:8], k=3, w=2)
    dense = IVFADCIndex.build(data, device="cpu",
                              **dict(kw, scan_mode="dense"))
    with pytest.raises(AssertionError):
        dense.autotune(data[0], k=3, w=2)       # 1-D queries


def test_profiling_utils(tmp_path, random_data):
    """BuildTimer sums repeated phases (as the JAX package's does);
    SearchStats counts what search_stream and the serving layer record;
    true_time times a unary or nullary function on the host clock off the
    card; trace writes a Chrome trace."""
    import os
    from ivfadc_tpu_torch.utils.profiling import (BuildTimer, SearchStats,
                                                  trace)
    from ivfadc_tpu_torch.utils.timing import true_time
    timer = BuildTimer("cpu")
    for _ in range(3):
        with timer.phase("a"):
            pass
    with timer.phase("b"):
        pass
    assert set(timer.timings) == {"a", "b"} and timer.timings["a"] >= 0
    _, t = _pair(random_data)
    stats = SearchStats()
    q = np.random.RandomState(3).rand(40, NROWS).astype(np.float32)
    t.search_stream(q, 5, w=4, batch=16, stats=stats)
    t.search_stream(q[:8], 5, w=4, stats=stats)
    assert (stats.queries, stats.batches) == (48, 2) and stats.qps > 0
    calls = []
    assert true_time(lambda i: calls.append(i), reps=3, warm=2) >= 0
    assert calls == [-1, -2, 0, 1, 2]
    assert true_time(lambda: t.search_padded(q[:8], 5, w=4), reps=2) > 0
    with trace(str(tmp_path / "tr")):
        t.search_padded(q[:8], 5, w=4)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
