"""The port's build and batched dense search against the JAX package.

One JAX-built index (n=4096, d=128, kc=128, m=8, k=16, scan_mode="dense")
is carried across to the port, by attribute access and through format-v1
files in both directions; the port's own build is held to the JAX build's
recall. On the CPU the JAX package runs its Pallas kernels in interpret
mode and the port runs its kernels' plain versions.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ivfadc_tpu import IVFADCIndex as JaxIndex
from ivfadc_tpu_torch import IVFADCConfig, IVFADCIndex, load_ivfadc_index
from ivfadc_tpu_torch import config as t_config
from ivfadc_tpu_torch.convert import from_reference
from ivfadc_tpu_torch.ops import dense_scan as t_scan
from ivfadc_tpu_torch.ops import pq as t_pq
from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
from ivfadc_tpu_torch.utils.evaluation import brute_force_topk, recall_at_r

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = dict(kc=128, m=8, k=16, seed=0, scan_mode="dense")
K, W, B = 10, 8, 64


@pytest.fixture(scope="module")
def data():
    return synthetic_clustered(4096, 128, seed=0)


@pytest.fixture(scope="module")
def queries(data):
    rng = np.random.RandomState(1)
    return (data[rng.randint(0, len(data), B)]
            + 0.05 * rng.randn(B, data.shape[1])).astype(np.float32)


@pytest.fixture(scope="module")
def jax_index(data):
    return JaxIndex.build(data, **BUILD)


@pytest.fixture(scope="module")
def jax_result(jax_index, queries):
    return jax_index.search_padded(queries, K, w=W)


@pytest.fixture(scope="module")
def port_index(jax_index):
    return from_reference(jax_index, "cpu")


def test_device_view_dense_bit_identical(jax_index, port_index):
    jv = jax_index.store.device_view_dense(
        jax_index.quantizer, jax_index.config.scan_chunk, cache="int8")
    tv = port_index.store.device_view_dense(
        port_index.quantizer, port_index.config.scan_chunk, cache="int8")
    for key in ("decoded", "scale", "ids2d", "norms2d", "offsets", "sizes",
                "ids"):
        a, b = np.asarray(jv[key]), tv[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(b, a, err_msg=key)


def test_store_introspection_matches_jax(jax_index, port_index):
    js, ts = jax_index.store, port_index.store
    assert (ts.n, ts.total_cap, ts.window) == (js.n, js.total_cap, js.window)
    for cell in (0, 5, jax_index.config.kc - 1):
        for a, b in zip(ts.cell_entries(cell), js.cell_entries(cell)):
            np.testing.assert_array_equal(a, b)


def _assert_matches_jax(ids, dists, jax_result):
    ji, jd = jax_result
    assert ids.shape == ji.shape == (B, K)
    # same index, same kernels' arithmetic; f32 sums in another order may
    # swap near-tied neighbours, so ids agree on >= 99% of slots and the
    # distances (~1e2) agree to 1e-5 relative where the ids do
    same = ids == ji
    assert same.mean() >= 0.99
    np.testing.assert_allclose(dists[same], jd[same], rtol=1e-5, atol=1e-4)


def test_search_padded_matches_jax(port_index, queries, jax_result):
    ids, dists = port_index.search_padded(queries, K, w=W)
    _assert_matches_jax(ids, dists, jax_result)


def test_search_lists_match_jax(port_index, jax_index, queries):
    # batch search -> per-query id / distance lists trimmed of padding, in
    # the config's id dtype, through the free function as well
    from ivfadc_tpu_torch import knn_search
    ids, dists = knn_search(port_index, queries, K, w=W)
    jids, jdists = jax_index.search(queries, K, w=W)
    assert len(ids) == len(jids) == B
    assert ids[0].dtype == jids[0].dtype == np.uint32
    agree = np.mean([np.array_equal(a, b) for a, b in zip(ids, jids)])
    assert agree >= 0.9
    for a, b in zip(dists, jdists):
        np.testing.assert_allclose(np.sort(a), np.sort(b), rtol=1e-4,
                                   atol=1e-4)


def test_jax_file_loads_in_port(tmp_path, jax_index, port_index, queries,
                                jax_result):
    path = str(tmp_path / "jax.npz")
    jax_index.save(path)
    loaded = load_ivfadc_index(path, device="cpu")
    assert len(loaded) == len(jax_index) and loaded.shape == jax_index.shape
    ids, dists = loaded.search_padded(queries, K, w=W)
    ref_ids, ref_dists = port_index.search_padded(queries, K, w=W)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(dists, ref_dists)
    _assert_matches_jax(ids, dists, jax_result)


def test_port_file_loads_in_jax(tmp_path, jax_index, port_index, queries,
                                jax_result):
    path = str(tmp_path / "port.npz")
    port_index.save(path)
    loaded = JaxIndex.load(path)
    np.testing.assert_array_equal(loaded.store.ids, jax_index.store.ids)
    np.testing.assert_array_equal(loaded.store.codes, jax_index.store.codes)
    ids, dists = loaded.search_padded(queries, K, w=W)
    np.testing.assert_array_equal(ids, jax_result[0])
    np.testing.assert_array_equal(dists, jax_result[1])


def test_port_build_recall_matches_jax(data, queries, jax_result):
    # the RNGs differ, so the two builds differ bit for bit; hold the
    # port's build to the JAX build's recall@10 within 0.05
    idx = IVFADCIndex.build(data, device="cpu", **BUILD)
    assert len(idx) == len(data) and idx.store.align == 128
    assert set(idx.build_timings) >= {"coarse_kmeans", "encode"}
    _, gt = brute_force_topk(data, queries, K)
    ids, _ = idx.search_padded(queries, K, w=W)
    r_port = recall_at_r(ids, gt, K)
    r_jax = recall_at_r(jax_result[0], gt, K)
    assert r_jax > 0.5
    assert abs(r_port - r_jax) <= 0.05, (r_port, r_jax)
    # and a rebuild from the same seed is identical
    again = IVFADCIndex.build(data, device="cpu", **BUILD)
    np.testing.assert_array_equal(again.store.codes, idx.store.codes)
    np.testing.assert_array_equal(again.store.ids, idx.store.ids)


def test_pq_layouts_agree(monkeypatch):
    # the batched and the one-subspace-at-a-time PQ training layouts draw
    # the same per-subspace random streams
    res = torch.from_numpy(np.random.RandomState(3).randn(600, 32)
                           .astype(np.float32))
    a = t_pq.train_quantizer(5, res, m=4, k=8, maxiter=5)
    monkeypatch.setattr(t_pq, "_SEQ_TRAIN_BYTES", 0)
    b = t_pq.train_quantizer(5, res, m=4, k=8, maxiter=5)
    torch.testing.assert_close(a.codebooks, b.codebooks, rtol=1e-5,
                               atol=1e-5)


def test_config_round_trip_and_validation(jax_index):
    d = jax_index.config.to_dict()
    cfg = IVFADCConfig.from_dict(d)
    assert cfg.to_dict() == d
    assert IVFADCConfig.from_dict({**d, "unknown": 1}) == cfg
    with pytest.raises(ValueError):
        IVFADCConfig(scan_fold_lanes=96)
    with pytest.raises(ValueError):
        IVFADCConfig(quantization_method="lsq")
    bad = [(dict(kc=1), 100, 8), (dict(k=256), 100, 8),
           (dict(m=9), 100, 8), (dict(coarse_maxiter=0), 100, 8),
           (dict(index_dtype="uint8"), 1000, 8)]
    for kwargs, n, dim in bad:
        with pytest.raises(AssertionError):
            IVFADCConfig(**kwargs).validate_for_data(n, dim)
    IVFADCConfig(kc=4, k=16, m=8).validate_for_data(100, 8)


def test_device_id_cap_clamps_override(monkeypatch):
    monkeypatch.setenv("IVFADC_DEVICE_ID_CAP", str(1 << 40))
    assert t_config.device_id_cap() == 1 << 31
    monkeypatch.setenv("IVFADC_DEVICE_ID_CAP", "1000")
    assert t_config.device_id_cap() == 1000
    with pytest.raises(AssertionError):
        IVFADCConfig(kc=4, k=16, m=8).validate_for_data(2000, 8)


def _variant(index, **changes):
    return IVFADCIndex(dataclasses.replace(index.config, **changes),
                       index.coarse, index.quantizer, index.store,
                       index.data_dtype, index.dim)


@pytest.mark.parametrize("case", ["gather_win"])
def test_unported_routes_raise(case, port_index, jax_index, queries):
    # no route raises any more: the gathered engine (the last one that did)
    # searches, and on these ~32-row cells its window exceeds the limit,
    # so the plan is off on both packages and the results are the default
    # route's (tests/test_torch_api.py holds the engine itself)
    idx = _variant(port_index, scan_gather_win=64)
    jidx = dataclasses.replace(jax_index.config, scan_gather_win=64)
    assert idx._gather_plan() == JaxIndex(
        jidx, jax_index.coarse, jax_index.quantizer, jax_index.store,
        jax_index.data_dtype, jax_index.dim)._gather_plan()
    ids, dists = idx.search_padded(queries, K, w=W)
    want = port_index.search_padded(queries, K, w=W)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(dists, want[1])


def test_unported_build_parts_raise(data, port_index):
    # OPQ builds now (tests/test_torch_api.py holds it to the JAX
    # package); an unknown method still raises
    with pytest.raises(ValueError):
        t_pq.train_quantizer(0, torch.zeros(64, 8), m=2, k=4, method="lsq")
    opq = IVFADCIndex.build(data[:512], device="cpu", kc=16, m=8, k=16,
                            quantization_method="opq", opq_iters=1,
                            coarse_maxiter=2, quantization_maxiter=2)
    assert opq.quantizer.method == "opq"
    # what used to raise here is ported: the grouped scan without emitted
    # ids, the sort-based prep past 4096 cells, 8-row cells on the grouped
    # scan (tests/test_torch_variants.py holds them to the JAX package)
    loose = IVFADCIndex.build(data[:2048], device="cpu", kc=16, m=8, k=16,
                              cell_align=8, scan_mode="dense",
                              coarse_maxiter=2, quantization_maxiter=2)
    assert loose.store.align == 8
    ids, dists = loose.search_padded(data[:64], 5, w=4)      # 256 >= 4 * 16
    assert (ids >= 0).all() and (np.diff(dists, axis=1) >= 0).all()
    # the per-probe scan scores alike (in-kernel norms, block payloads);
    # two quantizer iterations leave many tied codes, so the LUT route's
    # f32 scores would pick other ids among equals
    small = np.concatenate([loose.search_padded(data[s:s + 8], 5, w=4)[0]
                            for s in range(0, 64, 8)])       # 32 < 64
    assert np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ids, small)]) \
        >= 0.95


def test_import_loads_no_jax():
    # every module of the package, found by walking it
    code = ("import sys, pkgutil, importlib, ivfadc_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "ivfadc_tpu_torch.__path__, 'ivfadc_tpu_torch.')]\n"
            "assert {'ivfadc_tpu_torch.ops.adc', "
            "'ivfadc_tpu_torch.models.coarse', "
            "'ivfadc_tpu_torch.utils.repro', "
            "'ivfadc_tpu_torch.utils.lloyd_timing', "
            "'ivfadc_tpu_torch.ops.gather_scan', "
            "'ivfadc_tpu_torch.models.inverted', "
            "'ivfadc_tpu_torch.parallel.mesh', "
            "'ivfadc_tpu_torch.parallel.sharded', "
            "'ivfadc_tpu_torch.parallel.bootstrap', "
            "'ivfadc_tpu_torch.parallel.build', "
            "'ivfadc_tpu_torch.parallel.collectives', "
            "'ivfadc_tpu_torch.parallel.distributed', "
            "'ivfadc_tpu_torch.parallel.persistence', "
            "'ivfadc_tpu_torch.dryrun'} <= set(mods), mods\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'ivfadc_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'ivfadc_tpu.'))]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
    # the smoke script stands beside the package and imports neither
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "ivfadc_tpu")], names


@pytest.mark.parametrize("variant", [
    # OPQ rotation: the fused probe applies it (apply_rot) before v and base
    dict(dim=128, quantization_method="opq", opq_iters=1),
    # d not a 128-multiple (v and the decoded cache are zero-padded to 128),
    # euclidean metrics (sqrt finalize) and the "pure" score
    dict(dim=96, coarse_metric="euclidean", quantization_metric="euclidean",
         score_mode="pure"),
])
def test_search_variants_match_jax(variant):
    variant = dict(variant)
    dim = variant.pop("dim")
    data = synthetic_clustered(2048, dim, seed=2)
    rng = np.random.RandomState(4)
    q = (data[rng.randint(0, 2048, B)]
         + 0.05 * rng.randn(B, dim)).astype(np.float32)
    jidx = JaxIndex.build(data, kc=64, m=8, k=16, seed=0, scan_mode="dense",
                          **variant)
    ji, jd = jidx.search_padded(q, K, w=W)
    ti, td = from_reference(jidx, "cpu").search_padded(q, K, w=W)
    same = ti == ji
    assert same.mean() >= 0.99
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-4, atol=1e-4)


def test_effective_chunk_cached_per_caps(monkeypatch):
    # the p95 cell capacity is cached per (caps identity, caps max), as the
    # JAX package caches it: unchanged caps are not recomputed, caps grown
    # in place are, and the store's _invalidate() drops the value
    data = synthetic_clustered(1024, 32, seed=5)
    idx = IVFADCIndex.build(data, kc=16, m=4, k=16, seed=0, device="cpu")
    caps, nf = idx.store.caps, idx.config.scan_fold_lanes
    real = np.percentile

    def expected():
        p95 = int(real(caps, 95))
        return max(nf, min(idx.config.scan_chunk, -(-p95 // nf) * nf))

    first = idx._effective_chunk()
    assert first == expected()
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(np, "percentile", spy)
    assert idx._effective_chunk() == first and not calls
    caps[int(np.argmax(caps))] += 8 * nf       # one cell past the p95
    grown = idx._effective_chunk()
    assert len(calls) == 1 and grown == expected() and grown > first
    assert idx._effective_chunk() == grown and len(calls) == 1
    idx.store._invalidate()
    assert idx._effective_chunk() == grown and len(calls) == 2
