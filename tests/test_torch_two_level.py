"""The port's two-level coarse quantizer and large-kc index pieces against
the JAX package, on the CPU.

The same numpy inputs (from a seed) go through both packages. The JAX
package runs its grouped Pallas scan in interpret mode (stage 2 picks that
by itself off the TPU); the port runs its kernels' plain versions. Builds
differ bit for bit (the RNGs differ), so index-level checks carry one built
index across, by attribute access and through format-v1 files.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivfadc_tpu import IVFADCIndex as JaxIndex
from ivfadc_tpu.models import coarse as j_coarse
from ivfadc_tpu.ops.metrics import get_metric as j_metric
from ivfadc_tpu_torch import IVFADCIndex, load_ivfadc_index
from ivfadc_tpu_torch.convert import from_reference
from ivfadc_tpu_torch.models import coarse as t_coarse
from ivfadc_tpu_torch.ops.kmeans import make_generator
from ivfadc_tpu_torch.ops.metrics import get_metric as t_metric
from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
from ivfadc_tpu_torch.utils.evaluation import brute_force_topk, recall_at_r

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)

DERIVED = ("centroids", "group_centers", "members", "csr_offsets",
           "csr_sizes", "cent_scan", "cent_scale", "perm2d")


def _pair(centroids, group_centers, members, gp, metric="sqeuclidean"):
    """The same (centroids, members) as a JAX and a port quantizer."""
    jq = j_coarse.TwoLevelCoarseQuantizer.create(
        centroids, group_centers, members, j_metric(metric), gp)
    tq = t_coarse.TwoLevelCoarseQuantizer.create(
        centroids, group_centers, members, t_metric(metric), gp)
    return jq, tq


def _grouping(centroids, g, rng, gaps=False):
    """Random groups of the centroids: (group_centers, members) with -1
    padding at the row ends, or anywhere in the rows with `gaps`."""
    kc = len(centroids)
    assign = rng.randint(0, g, kc)
    counts = np.bincount(assign, minlength=g)
    width = int(counts.max()) + (3 if gaps else 0)
    members = np.full((g, width), -1, np.int32)
    for gi in range(g):
        ids = np.nonzero(assign == gi)[0]
        cols = np.sort(rng.permutation(width)[:len(ids)]) if gaps \
            else np.arange(len(ids))
        members[gi, cols] = ids
    centers = np.stack([centroids[assign == gi].mean(0) if counts[gi]
                        else np.zeros(centroids.shape[1], np.float32)
                        for gi in range(g)]).astype(np.float32)
    return centers, members


@pytest.fixture(scope="module")
def small():
    """kc = 512 centroids (d = 32) in 23 groups: the gather stage."""
    rng = np.random.RandomState(0)
    cents = rng.randn(512, 32).astype(np.float32)
    centers, members = _grouping(cents, 23, rng)
    q = rng.randn(64, 32).astype(np.float32)
    return cents, centers, members, q


@pytest.fixture(scope="module")
def large():
    """kc = 8192 random centroids (d = 32) in 91 groups: above the gather
    cutoff, so stage 2 is the grouped scan."""
    rng = np.random.RandomState(1)
    cents = rng.randn(8192, 32).astype(np.float32)
    centers, members = _grouping(cents, 91, rng)
    q = rng.randn(64, 32).astype(np.float32)
    return cents, centers, members, q


@pytest.mark.parametrize("which,gaps", [("small", False), ("small", True),
                                        ("large", False)])
def test_create_arrays_byte_equal(which, gaps, request):
    cents, centers, members, _ = request.getfixturevalue(which)
    if gaps:
        centers, members = _grouping(cents, 23, np.random.RandomState(5),
                                     gaps=True)
    jq, tq = _pair(cents, centers, members, 8)
    for name in DERIVED:
        a, b = np.asarray(getattr(jq, name)), getattr(tq, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert (tq.kc, tq.dim, tq.kind) == (jq.kc, jq.dim, jq.kind)
    assert repr(tq) == repr(jq)
    # one empty group: its 128 slots stay -1 and it never yields a cell
    members[3] = -1
    jq, tq = _pair(cents, centers, members, 8)
    np.testing.assert_array_equal(tq.perm2d.numpy(), np.asarray(jq.perm2d))
    assert int(tq.csr_sizes[3]) == 0


@pytest.mark.parametrize("w", [1, 8, 32])
@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine"])
def test_gather_stage_search_matches_jax(small, w, metric):
    cents, centers, members, q = small
    jq, tq = _pair(cents, centers, members, 8, metric)
    jc, jd = jq.search(jnp.asarray(q), w)
    tc, td = tq.search(torch.from_numpy(q), w)
    assert tc.dtype == torch.int32 and tuple(tc.shape) == (64, w)
    # exact f32 scores of gathered centroids in both: equal cells (a
    # few-ulp tie could flip one; none does at this seed)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


def test_gather_stage_runs_for_non_euclidean_metrics_at_large_kc(large):
    # the scan's |q|^2 - 2 q.c + |c|^2 form holds for (sq)euclidean only
    cents, centers, members, q = large
    jq, tq = _pair(cents, centers, members, 8, "inner_product")
    jc, _ = jq.search(jnp.asarray(q[:8]), 4)
    tc, _ = tq.search(torch.from_numpy(q[:8]), 4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("w", [4, 32])
def test_scan_stage_search_random_floats(large, w):
    cents, centers, members, q = large
    jq, tq = _pair(cents, centers, members, 23)
    assert tq.kc > tq._GATHER_MAX
    jc, jd = jq.search(jnp.asarray(q), w)
    tc, td = tq.search(torch.from_numpy(q), w)
    jc, jd, tc, td = np.asarray(jc), np.asarray(jd), tc.numpy(), td.numpy()
    # the interpret-mode kernel may keep the dequantized rows and their
    # squares above bf16 precision, the port rounds them as the TPU does
    # (one part in 2^9 per element). The error scales with the terms
    # |q|^2 + |c|^2 (~64 here), which are 2-3x the distances (~25): measured
    # up to 1.3e-3 of the distance, 5e-4 of the terms; near-tied cells may
    # swap
    overlap = np.mean([len(set(a) & set(b)) / w for a, b in zip(tc, jc)])
    assert overlap >= 0.99, overlap
    same = tc == jc
    np.testing.assert_allclose(td[same], jd[same], rtol=3e-3, atol=1e-3)
    # and both are close to the true squared distances (bf16 products)
    true_d = ((q[:, None, :] - cents[tc]) ** 2).sum(-1)
    np.testing.assert_allclose(td, true_d, rtol=2e-2, atol=1e-2)


def _integer_case(rng, kc, g):
    """Integer-valued centroids whose int8 table is exact (every column's
    max is 127, so the scale is 1) and whose squares are exact in bf16
    (|c| <= 16), apart from one far-away row of 127s that carries the
    column maxima and is never among the nearest."""
    cents = rng.randint(-16, 17, (kc, 32)).astype(np.float32)
    cents[0] = 127.0
    centers, members = _grouping(cents, g, rng)
    q = rng.randint(-8, 9, (64, 32)).astype(np.float32)
    return cents, centers, members, q


def test_scan_stage_search_integer_valued_is_exact():
    cents, centers, members, q = _integer_case(np.random.RandomState(2),
                                               8192, 91)
    jq, tq = _pair(cents, centers, members, 23)
    np.testing.assert_array_equal(tq.cent_scale.numpy()[:32], 1.0)
    jc, jd = jq.search(jnp.asarray(q), 16)
    tc, td = tq.search(torch.from_numpy(q), 16)
    # every product and sum is an integer < 2^24: exact in any order
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    true_d = ((q[:, None, :] - cents[tc.numpy()]) ** 2).sum(-1)
    np.testing.assert_array_equal(td.numpy(), true_d)


def test_scan_stage_on_a_small_quantizer(monkeypatch):
    # kc = 512 through the scan stage: the cutoff lowered on both classes
    monkeypatch.setattr(j_coarse.TwoLevelCoarseQuantizer, "_GATHER_MAX", 64)
    monkeypatch.setattr(t_coarse.TwoLevelCoarseQuantizer, "_GATHER_MAX", 64)
    cents, centers, members, q = _integer_case(np.random.RandomState(3),
                                               512, 23)
    jq, tq = _pair(cents, centers, members, 8)
    jc, jd = jq.search(jnp.asarray(q), 8)
    tc, td = tq.search(torch.from_numpy(q), 8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("stage", ["gather", "scan"])
def test_fewer_candidates_than_w_pad_with_cell_zero(stage, monkeypatch):
    # 16 centroids in 4 groups, one group probed: ~4 candidates for w = 8
    if stage == "scan":
        for mod in (j_coarse, t_coarse):
            monkeypatch.setattr(mod.TwoLevelCoarseQuantizer, "_GATHER_MAX", 0)
    rng = np.random.RandomState(4)
    cents = rng.randint(-8, 9, (16, 32)).astype(np.float32)
    cents[0] = 127.0
    centers, members = _grouping(cents, 4, rng)
    q = rng.randint(-8, 9, (8, 32)).astype(np.float32)
    jq, tq = _pair(cents, centers, members, 1)
    jc, jd = jq.search(jnp.asarray(q), 8)
    tc, td = tq.search(torch.from_numpy(q), 8)
    assert tuple(tc.shape) == (8, 8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    pad = ~np.isfinite(td.numpy())
    assert pad.any() and (tc.numpy()[pad] == 0).all()


@pytest.mark.parametrize("kc,n_groups,gp", [(512, 0, 8), (512, 128, 32),
                                            (4096, 0, 16), (8, 1, 1)])
def test_build_two_level_group_rules(kc, n_groups, gp):
    # g = ceil(sqrt(kc)) unless given; gp = g/4 tapering to g/16, >= 8
    cents = torch.from_numpy(np.random.RandomState(kc).randn(kc, 8)
                             .astype(np.float32))
    tq = t_coarse.build_two_level(make_generator(0, 2, "cpu"), cents,
                                  t_metric("sqeuclidean"), n_groups=n_groups,
                                  maxiter=2)
    g = n_groups or int(np.ceil(np.sqrt(kc)))
    assert tq.group_centers.shape[0] == g and tq.n_probe_groups == gp
    # every centroid sits in exactly one group
    m = tq.members.numpy()
    assert sorted(m[m >= 0].tolist()) == list(range(kc))
    # the JAX package's rule gives the same dial
    jq = j_coarse.build_two_level(jax.random.PRNGKey(0), jnp.asarray(cents),
                                  j_metric("sqeuclidean"), n_groups=n_groups,
                                  maxiter=2)
    assert jq.n_probe_groups == gp


def test_make_coarse_quantizer_kinds():
    cents = torch.from_numpy(np.random.RandomState(0).randn(64, 8)
                             .astype(np.float32))
    metric = t_metric("sqeuclidean")
    gen = make_generator(0, 2, "cpu")
    assert t_coarse.make_coarse_quantizer("naive", cents, metric).kind \
        == "naive"
    for kind in ("hnsw", "two_level"):
        cq = t_coarse.make_coarse_quantizer(kind, cents, metric,
                                            generator=gen, n_probe_groups=3)
        assert cq.kind == "two_level" and cq.n_probe_groups == 3
    with pytest.raises(ValueError):
        t_coarse.make_coarse_quantizer("graph", cents, metric)
    assert repr(t_coarse.NaiveCoarseQuantizer(cents, metric)) == repr(
        j_coarse.NaiveCoarseQuantizer(jnp.asarray(cents.numpy()),
                                      j_metric("sqeuclidean")))


# ------------------------------------------------------------ whole index
BUILD = dict(kc=512, m=8, k=16, seed=0, scan_mode="dense",
             coarse_quantizer="hnsw", coarse_maxiter=8,
             quantization_maxiter=8)
K, W = 10, 8


@pytest.fixture(scope="module")
def data():
    return synthetic_clustered(4096, 32, seed=0)


@pytest.fixture(scope="module")
def queries(data):
    rng = np.random.RandomState(1)
    return (data[rng.randint(0, len(data), 256)]
            + 0.05 * rng.randn(256, data.shape[1])).astype(np.float32)


@pytest.fixture(scope="module")
def jax_index(data):
    return JaxIndex.build(data, **BUILD)


def _assert_ids_match(ids, dists, ref_ids, ref_dists, per_probe=True):
    """Same index, same kernels' arithmetic. The grouped scan reads cached
    f32 norms in both packages: only f32 sums in another order differ. The
    per-probe scan squares in bf16 in its kernel, which the interpret-mode
    JAX kernel may keep in f32: up to ~1.3e-3 of these distances (~1, the
    size of the norm term), so near-tied neighbours may swap."""
    same = ids == ref_ids
    assert same.mean() >= (0.97 if per_probe else 0.99), same.mean()
    rtol, atol = (2e-3, 1e-3) if per_probe else (1e-5, 1e-4)
    np.testing.assert_allclose(dists[same], ref_dists[same], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("B", [64, 256])
def test_jax_built_index_through_from_reference(jax_index, queries, B):
    # B*w = 512 < 4*kc: the per-probe scan; 2048 >= 2048: the grouped scan
    port = from_reference(jax_index, "cpu")
    assert port.coarse.kind == "two_level"
    assert port.coarse.n_probe_groups == jax_index.coarse.n_probe_groups
    ji, jd = jax_index.search_padded(queries[:B], K, w=W)
    ti, td = port.search_padded(queries[:B], K, w=W)
    _assert_ids_match(ti, td, ji, jd, per_probe=B == 64)


def test_jax_file_loads_in_port_and_back(tmp_path, jax_index, queries):
    path = str(tmp_path / "jax.npz")
    jax_index.save(path)
    loaded = load_ivfadc_index(path, device="cpu")
    assert repr(loaded.coarse) == repr(jax_index.coarse)
    ji, jd = jax_index.search_padded(queries[:64], K, w=W)
    ti, td = loaded.search_padded(queries[:64], K, w=W)
    _assert_ids_match(ti, td, ji, jd)
    ref = from_reference(jax_index, "cpu").search_padded(queries[:64], K, w=W)
    np.testing.assert_array_equal(ti, ref[0])
    np.testing.assert_array_equal(td, ref[1])
    # the port's file of the same index loads back in the JAX package
    back = str(tmp_path / "port.npz")
    loaded.save(back)
    again = JaxIndex.load(back)
    for name in DERIVED:
        np.testing.assert_array_equal(
            np.asarray(getattr(again.coarse, name)),
            np.asarray(getattr(jax_index.coarse, name)), err_msg=name)
    bi, bd = again.search_padded(queries[:64], K, w=W)
    np.testing.assert_array_equal(bi, ji)
    np.testing.assert_array_equal(bd, jd)


def test_lut_engine_under_two_level_matches_jax(jax_index, queries):
    import dataclasses
    port = from_reference(jax_index, "cpu")
    lut = IVFADCIndex(dataclasses.replace(port.config, scan_mode="lut"),
                      port.coarse, port.quantizer, port.store,
                      port.data_dtype, port.dim)
    jlut = JaxIndex(dataclasses.replace(jax_index.config, scan_mode="lut"),
                    jax_index.coarse, jax_index.quantizer, jax_index.store,
                    jax_index.data_dtype, jax_index.dim)
    ji, jd = jlut.search_padded(queries[:64], K, w=W)
    ti, td = lut.search_padded(queries[:64], K, w=W)
    same = ti == ji
    assert same.mean() >= 0.99
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-4)


def test_port_builds_searches_saves_and_jax_loads(tmp_path, data, queries,
                                                  jax_index):
    idx = IVFADCIndex.build(data, device="cpu", **BUILD)
    assert idx.coarse.kind == "two_level" and len(idx) == len(data)
    assert "coarse_quantizer" in idx.build_timings
    g = idx.coarse.group_centers.shape[0]
    assert g == 23 and idx.coarse.n_probe_groups == 8
    q = queries[:64]
    _, gt = brute_force_topk(data, q, K)
    ids, dists = idx.search_padded(q, K, w=W)
    r_port = recall_at_r(ids, gt, K)
    r_jax = recall_at_r(jax_index.search_padded(q, K, w=W)[0], gt, K)
    # the RNGs differ, so the builds do: hold the port to the JAX recall
    assert r_jax > 0.5 and abs(r_port - r_jax) <= 0.05, (r_port, r_jax)
    one_i, one_d = idx.search(q[0], K, w=W)
    np.testing.assert_array_equal(one_i, ids[0][ids[0] >= 0])
    # a rebuild from the same seed is identical, groups included
    again = IVFADCIndex.build(data, device="cpu", **BUILD)
    np.testing.assert_array_equal(again.store.codes, idx.store.codes)
    assert torch.equal(again.coarse.members, idx.coarse.members)
    path = str(tmp_path / "port_built.npz")
    idx.save(path)
    loaded = IVFADCIndex.load(path, device="cpu")
    li, ld = loaded.search_padded(q, K, w=W)
    np.testing.assert_array_equal(li, ids)
    np.testing.assert_array_equal(ld, dists)
    ji, jd = JaxIndex.load(path).search_padded(q, K, w=W)
    _assert_ids_match(ids, dists, ji, jd)
