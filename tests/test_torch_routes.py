"""Every search route of a static naive-coarse index against the JAX package.

One JAX-built index (n=3000, d=128, kc=64, m=8, k=16) is carried across to
the port (`convert.from_reference`); route variants swap the configuration
or the coarse metric on BOTH sides over the same trained components, so
each route runs on identical parameters: the small-batch dense path
(B*w < 4*kc), the LUT engine (scan_mode="lut", k > 128, "auto" on the CPU,
a metric without a dot-product form), the unfused dense probe
(inner-product scores on both dense branches) and the coarse quantizer's
search under every metric. On the CPU the JAX package runs its Pallas
kernels in interpret mode and the port runs its kernels' plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ivfadc_tpu import IVFADCIndex as JaxIndex
from ivfadc_tpu.models.coarse import NaiveCoarseQuantizer as JaxCoarse
from ivfadc_tpu.ops.metrics import get_metric as j_get_metric
from ivfadc_tpu_torch import IVFADCIndex
from ivfadc_tpu_torch.convert import from_reference
from ivfadc_tpu_torch.models.coarse import NaiveCoarseQuantizer
from ivfadc_tpu_torch.ops.metrics import get_metric
from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
from ivfadc_tpu_torch.utils.evaluation import brute_force_topk, recall_at_r

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)

N, D, KC = 3000, 128, 64
K, W = 10, 8


@pytest.fixture(scope="module")
def data():
    return synthetic_clustered(N, D, seed=3)


@pytest.fixture(scope="module")
def queries(data):
    rng = np.random.RandomState(5)
    return (data[rng.randint(0, N, 64)]
            + 0.05 * rng.randn(64, D)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_index(data):
    return JaxIndex.build(data, kc=KC, m=8, k=16, seed=0, scan_mode="dense")


def _jax_variant(index, coarse_metric=None, **changes):
    coarse = index.coarse if coarse_metric is None else \
        JaxCoarse(index.coarse.centroids, j_get_metric(coarse_metric))
    if coarse_metric is not None:
        changes["coarse_metric"] = coarse_metric
    return JaxIndex(dataclasses.replace(index.config, **changes), coarse,
                    index.quantizer, index.store, index.data_dtype, index.dim)


def _pair(jax_index, **changes):
    """The same route variant in both packages."""
    jv = _jax_variant(jax_index, **changes)
    return jv, from_reference(jv, "cpu")


def _agreement(ti, td, ji, jd, *, ids_min, rtol, atol=1e-4):
    assert ti.shape == ji.shape and ti.dtype == ji.dtype == np.int32
    assert td.dtype == jd.dtype == np.float32
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    same = ti == ji
    assert same.mean() >= ids_min, same.mean()
    fin = same & np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=rtol, atol=atol)


# ------------------------------------------------- small-batch dense path
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("nf", [128, 256])
def test_small_batch_dense_matches_jax(jax_index, queries, B, nf):
    # B*w = 64 < 4*kc = 256: per-probe scan + top-k with indices +
    # position resolution (nf=256: the block index carries the bank).
    # Distances are ~1e2; the interpret-mode kernel may keep the in-kernel
    # bf16 squares in f32 (up to ~3e-4 relative on the norm term), so ids
    # agree on >= 97% of slots and distances to 1e-3 relative where they do
    jv, tv = _pair(jax_index, scan_fold_lanes=nf, scan_chunk=256)
    ji, jd = jv.search_padded(queries[:B], K, w=W)
    ti, td = tv.search_padded(queries[:B], K, w=W)
    assert ti.shape == (B, K)
    _agreement(ti, td, ji, jd, ids_min=0.97, rtol=1e-3)
    assert (ti >= 0).all() and (np.diff(td, axis=1) >= 0).all()


def test_single_point_search_matches_jax(jax_index, queries):
    _, tv = _pair(jax_index, index_dtype="uint16")
    jv = _jax_variant(jax_index, index_dtype="uint16")
    ids, dists = tv.search(queries[0], K, w=W)
    jids, jdists = jv.search(queries[0], K, w=W)
    assert ids.dtype == jids.dtype == np.uint16
    assert dists.dtype == jdists.dtype == np.float32
    assert ids.shape == jids.shape == (K,)
    assert len(set(ids) & set(jids)) >= K - 1
    np.testing.assert_allclose(dists, jdists, rtol=1e-3)
    # a tensor query stays a tensor query; float64 in, float64 out
    ids_t, dists_t = tv.search(torch.from_numpy(queries[0]).double(), K, w=W)
    np.testing.assert_array_equal(ids_t, ids)
    assert dists_t.dtype == np.float64
    # w past the cell supply and k past the candidates: trimmed, no padding
    few_i, few_d = tv.search(queries[0], 5000, w=1)
    assert 0 < len(few_i) == len(few_d) < 5000
    assert len(set(few_i.tolist())) == len(few_i)


def test_small_and_grouped_paths_agree(jax_index, queries):
    # the two dense branches score with different norm streams (in-kernel
    # bf16 squares vs cached f32 norms): near-identical neighbours
    _, tv = _pair(jax_index)
    gi, gd = tv.search_padded(queries, K, w=W)              # 512 >= 256
    si = np.concatenate([tv.search_padded(queries[s:s + 8], K, w=W)[0]
                         for s in range(0, 64, 8)])
    overlap = np.mean([len(set(a) & set(b)) / K for a, b in zip(gi, si)])
    assert overlap >= 0.95, overlap


# ---------------------------------------------------------------- LUT engine
@pytest.mark.parametrize("case", ["lut_k10", "lut_k200", "auto_on_cpu",
                                  "dense_k_over_128", "cityblock",
                                  "pure_score", "inner_product"])
def test_lut_routes_match_jax(jax_index, queries, case):
    k, changes = K, dict(scan_mode="lut")
    if case == "lut_k200":
        k = 200
    elif case == "auto_on_cpu":          # "auto" resolves to LUT off the GPU
        changes = dict(scan_mode="auto")
    elif case == "dense_k_over_128":     # dense keeps <= 128 per probe
        k, changes = 129, dict(scan_mode="dense")
    elif case == "cityblock":            # no dot-product form: LUT under auto
        changes = dict(scan_mode="auto", quantization_metric="cityblock")
    elif case == "pure_score":
        changes = dict(scan_mode="lut", score_mode="pure")
    elif case == "inner_product":
        changes = dict(scan_mode="lut", quantization_metric="inner_product")
    jv, tv = _pair(jax_index, **changes)
    ji, jd = jv.search_padded(queries, k, w=W)
    ti, td = tv.search_padded(queries, k, w=W)
    assert ti.shape == (64, k)
    # exact f32 table sums in both packages, ties in candidate order in
    # both: ids agree on >= 99.5% of slots (f32 table entries built by
    # matmuls of another summation order may swap near-ties), distances to
    # 1e-5 relative (+1e-4 near zero: inner products cross it)
    _agreement(ti, td, ji, jd, ids_min=0.995, rtol=1e-5, atol=1e-4)
    valid = ti >= 0
    for row, m in zip(ti, valid):        # no posting twice in one answer
        assert len(set(row[m].tolist())) == m.sum()


def test_lut_blocks_do_not_change_results(jax_index, queries, monkeypatch):
    from ivfadc_tpu_torch.models import index as t_index
    _, tv = _pair(jax_index, scan_mode="lut")
    whole = tv.search_padded(queries, K, w=W)
    # 5-query blocks: 64 queries take 13 blocks, the last one ragged
    monkeypatch.setattr(t_index, "_LUT_BLOCK_ELEMS", 5 * W * tv.store.window)
    blocked = tv.search_padded(queries, K, w=W)
    # queries are independent, so the neighbours are the same; the matmul
    # library may sum a table entry in another order for another batch
    # shape, so distances are held to 1e-5 relative, not bit for bit
    np.testing.assert_array_equal(blocked[0], whole[0])
    np.testing.assert_allclose(blocked[1], whole[1], rtol=1e-5)


def test_lut_view_matches_jax(jax_index):
    tv = from_reference(jax_index, "cpu")
    jview, tview = jax_index.store.device_view(), tv.store.device_view()
    assert tv.store.window == jax_index.store.window
    for key in ("codes", "ids", "offsets", "sizes"):
        a, b = np.asarray(jview[key]), tview[key].numpy()
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(b, a, err_msg=key)


# ------------------------------------------------------- unfused dense probe
@pytest.mark.parametrize("B", [8, 64])       # per-probe and grouped scans
@pytest.mark.parametrize("changes", [
    dict(quantization_metric="inner_product"),
    dict(coarse_metric="cityblock"),         # residual metric, unfused probe
], ids=["inner_product", "cityblock_coarse"])
def test_unfused_probe_matches_jax(jax_index, queries, B, changes):
    jv, tv = _pair(jax_index, scan_mode="dense", **changes)
    ji, jd = jv.search_padded(queries[:B], K, w=W)
    ti, td = tv.search_padded(queries[:B], K, w=W)
    # inner-product scores are ~-1e2..1e2 sums of bf16 products whose
    # dequantized rows the interpret-mode kernel may keep in f32 (2^-9
    # relative a term): ids agree on >= 95% of slots, scores to 2e-3 of
    # their magnitude (+0.05 absolute where they cancel)
    _agreement(ti, td, ji, jd, ids_min=0.95, rtol=2e-3, atol=0.05)


def test_inner_product_recall(data, queries, jax_index):
    # the inner-product route finds the true maximum-inner-product
    # neighbours about as often through the dense scans as through the LUT
    gt = np.argsort(-(queries @ data.T), axis=1, kind="stable")[:, :K]
    recalls = {}
    for mode in ("dense", "lut"):
        _, tv = _pair(jax_index, scan_mode=mode,
                      quantization_metric="inner_product")
        ids, _ = tv.search_padded(queries, K, w=W)
        recalls[mode] = recall_at_r(ids, gt, K)
    assert abs(recalls["dense"] - recalls["lut"]) <= 0.03, recalls


# ------------------------------------------------------------ coarse search
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cityblock",
                                    "inner_product", "cosine"])
@pytest.mark.parametrize("w", [1, 8])
def test_coarse_search_matches_jax(jax_index, queries, metric, w):
    cents = np.array(jax_index.coarse.centroids)
    jc, jd = JaxCoarse(jnp.asarray(cents), j_get_metric(metric)).search(
        jnp.asarray(queries), w)
    tc, td = NaiveCoarseQuantizer(torch.from_numpy(cents),
                                  get_metric(metric)).search(
        torch.from_numpy(queries), w)
    assert tc.dtype == torch.int32 and tuple(tc.shape) == (64, w)
    # distances from matmuls of another summation order: cells agree on
    # >= 99% of probes, distances to 1e-4 relative (+1e-4: cosine ~1e-1)
    assert (tc.numpy() == np.asarray(jc)).mean() >= 0.99
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)


def test_coarse_search_wide_probe(jax_index, queries):
    # w > 128 leaves the fused kernel's range in both packages
    cents = np.array(jax_index.coarse.centroids)
    big = np.concatenate([cents, cents + 1.0, cents - 1.0])     # kc = 192
    jc, jd = JaxCoarse(jnp.asarray(big), j_get_metric("sqeuclidean")).search(
        jnp.asarray(queries), 160)
    tc, td = NaiveCoarseQuantizer(torch.from_numpy(big),
                                  get_metric("sqeuclidean")).search(
        torch.from_numpy(queries), 160)
    assert (tc.numpy() == np.asarray(jc)).mean() >= 0.99
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-3)


# -------------------------------------------------------------------- build
def test_build_device_default_is_cuda(data):
    # tensors follow the same rule as arrays: no `device` means the GPU
    # (here there is none, so the build must fail, not run on the CPU);
    # device="cpu" is the explicit form
    small = torch.from_numpy(data[:600])
    kw = dict(kc=8, m=8, k=16, seed=0, coarse_maxiter=3,
              quantization_maxiter=3)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            IVFADCIndex.build(small, **kw)
    idx = IVFADCIndex.build(small, device="cpu", **kw)
    assert idx.device.type == "cpu" and len(idx) == 600
    ids, _ = idx.search(data[7], 3, w=4)           # "auto" on the CPU: LUT
    assert 7 in ids
    _, gt = brute_force_topk(data[:600], data[:32], 1)
    found, _ = idx.search_padded(data[:32], 1, w=8)
    assert recall_at_r(found, gt, 1) >= 0.8


# ------------------------------------ grouped scan with in-kernel row norms
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_norms_off_route_matches_jax(data, queries, metric, monkeypatch):
    # IVFADC_NORMS=off leaves the cached norms out of the dense view in
    # both packages: the grouped scan (B*w = 512 >= 4*kc) then computes the
    # row norms in its kernel (inner product: no norm term at all)
    from ivfadc_tpu_torch.ops import dense_scan
    monkeypatch.setenv("IVFADC_NORMS", "off")
    jidx = JaxIndex.build(data, kc=KC, m=8, k=16, seed=0, scan_mode="dense",
                          quantization_metric=metric, coarse_maxiter=5,
                          quantization_maxiter=5)
    tidx = from_reference(jidx, "cpu")
    seen = []
    real = dense_scan.grouped_scan

    def spy(*args, **kw):
        seen.append(args[7])
        return real(*args, **kw)

    monkeypatch.setattr(dense_scan, "grouped_scan", spy)
    ji, jd = jidx.search_padded(queries, K, w=W)
    ti, td = tidx.search_padded(queries, K, w=W)
    assert seen == [None]                   # no norms stream reached the scan
    view = jidx.store.device_view_dense(jidx.quantizer,
                                        jidx.config.scan_chunk, cache="int8")
    assert view["norms2d"] is None
    # bf16 squares kept in f32 by the interpret-mode kernel: as on the
    # per-probe path, ids agree on >= 97% and distances to 1e-3 relative
    _agreement(ti, td, ji, jd, ids_min=0.97, rtol=1e-3)
    # IVFADC_NORMS is read when the view is built, in both packages: back
    # on the default, each view keeps its choice until it is invalidated
    monkeypatch.delenv("IVFADC_NORMS")
    for idx in (jidx, tidx):
        def norms2d():
            return idx.store.device_view_dense(
                idx.quantizer, idx.config.scan_chunk, cache="int8")["norms2d"]
        assert norms2d() is None
        idx.store._invalidate()
        assert norms2d() is not None
    ci, _ = tidx.search_padded(queries, K, w=W)
    # a score without a norm term reads no norms stream (C.12)
    assert (seen[-1] is not None) == (metric == "sqeuclidean")
    assert np.mean([len(set(a) & set(b)) / K for a, b in zip(ci, ti)]) >= 0.95


def test_inner_product_grouped_scan_reads_no_norms(jax_index, queries,
                                                   monkeypatch):
    # inner-product scores have no norm term (norm_coef = 0): under the
    # default IVFADC_NORMS the view holds cached norms, yet neither package
    # streams them into the grouped scan (B*w = 1024 >= 4*kc), which then
    # runs its in-kernel-norms variant
    import jax
    from ivfadc_tpu.ops import pallas_scan as j_scan
    from ivfadc_tpu_torch.ops import dense_scan as t_scan
    jax.clear_caches()             # the JAX side records at trace time
    seen = {"jax": [], "port": []}
    for side, mod, at in (("jax", j_scan, 8), ("port", t_scan, 8)):
        real = mod.grouped_dense_scan

        def spy(*args, _real=real, _side=side, _at=at, **kw):
            seen[_side].append(args[_at] if len(args) > _at
                               else kw.get("norms2d"))
            return _real(*args, **kw)

        monkeypatch.setattr(mod, "grouped_dense_scan", spy)
    jv, tv = _pair(jax_index, quantization_metric="inner_product")
    for idx in (jv, tv):
        assert idx.store.device_view_dense(
            idx.quantizer, idx.config.scan_chunk,
            cache="int8")["norms2d"] is not None
    q = np.concatenate([queries, queries])
    ji, jd = jv.search_padded(q, K, w=W)
    ti, td = tv.search_padded(q, K, w=W)
    assert seen == {"jax": [None], "port": [None]}
    _agreement(ti, td, ji, jd, ids_min=0.95, rtol=2e-3, atol=0.05)
