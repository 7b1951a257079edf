"""The port's plain tensor modules (metrics, PQ codecs, k-means assignment)
against the JAX package's, on the CPU, with the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ivfadc_tpu.ops import kmeans as j_kmeans
from ivfadc_tpu.ops import metrics as j_metrics
from ivfadc_tpu.ops import pq as j_pq
from ivfadc_tpu_torch.ops import kmeans as t_kmeans
from ivfadc_tpu_torch.ops import metrics as t_metrics
from ivfadc_tpu_torch.ops import pq as t_pq

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["sqeuclidean", "euclidean", "cityblock",
                                  "inner_product", "cosine"])
def test_metrics_match_jax(name):
    rng = np.random.RandomState(0)
    x = rng.randn(20, 16).astype(np.float32)
    y = rng.randn(7, 16).astype(np.float32)
    jm, tm = j_metrics.get_metric(name), t_metrics.get_metric(name)
    assert (tm.additive, tm.trainable, tm.residual_based) == \
        (jm.additive, jm.trainable, jm.residual_based)
    jd = np.asarray(jm.pairwise(jnp.asarray(x), jnp.asarray(y)))
    td = tm.pairwise(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    # f32 matmuls summed in another order: distances of magnitude ~1..100
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.finalize(torch.from_numpy(td)).numpy(),
                               np.asarray(jm.finalize(jnp.asarray(td))),
                               rtol=1e-6)


def test_metric_registry():
    with pytest.raises(ValueError):
        t_metrics.get_metric("hamming")
    custom = t_metrics.Metric("sq2", t_metrics.SQEUCLIDEAN.pairwise,
                              lambda d: d, additive=True)
    t_metrics.register_metric(custom)
    try:
        assert t_metrics.get_metric("sq2") is custom
    finally:
        del t_metrics._REGISTRY["sq2"]


def _quantizers(method: str):
    rng = np.random.RandomState(1)
    m, k, dsub = 4, 16, 8
    cb = rng.randn(m, k, dsub).astype(np.float32)
    rot = np.linalg.qr(rng.randn(m * dsub, m * dsub))[0].astype(np.float32) \
        if method == "opq" else np.eye(m * dsub, dtype=np.float32)
    return (j_pq.ProductQuantizer(jnp.asarray(cb), jnp.asarray(rot), method),
            t_pq.ProductQuantizer(torch.from_numpy(cb), torch.from_numpy(rot),
                                  method), rng)


@pytest.mark.parametrize("method", ["pq", "opq"])
def test_pq_codecs_match_jax(method):
    jq, tq, rng = _quantizers(method)
    res = rng.randn(300, 32).astype(np.float32)
    jc = np.asarray(j_pq.encode(jq, jnp.asarray(res)))
    tc = t_pq.encode(tq, torch.from_numpy(res)).numpy()
    assert tc.dtype == jc.dtype == np.uint8
    # argmin over f32 distances summed in another order: only a near-tie
    # could flip a code (none at this seed)
    np.testing.assert_array_equal(tc, jc)
    codes = rng.randint(0, tq.k, (300, tq.m)).astype(np.uint8)
    # OPQ decode applies rot^T in an f32 matmul (another summation order);
    # plain PQ decode is a gather, exact
    np.testing.assert_allclose(
        t_pq.decode(tq, torch.from_numpy(codes)).numpy(),
        np.asarray(j_pq.decode(jq, jnp.asarray(codes))),
        rtol=1e-5, atol=1e-5 if method == "opq" else 0)
    # the rotated-space decodes are codeword gathers in both (the JAX
    # package's one-hot matmul picks entries exactly): bit-identical
    np.testing.assert_array_equal(
        t_pq.decode_rotated(tq, torch.from_numpy(codes)).float().numpy(),
        np.asarray(j_pq.decode_rotated(jq, jnp.asarray(codes))
                   .astype(jnp.float32)))
    js, ts = j_pq.cache_scale(jq), t_pq.cache_scale(tq)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        t_pq.decode_rotated_int8(tq, torch.from_numpy(codes), ts).numpy(),
        np.asarray(j_pq.decode_rotated_int8(jq, jnp.asarray(codes), js)))


def test_kmeans_assign_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(1000, 16).astype(np.float32)
    c = rng.randn(37, 16).astype(np.float32)
    ja = np.asarray(j_kmeans.assign(jnp.asarray(x), jnp.asarray(c),
                                    block=256))
    ta = t_kmeans.assign(torch.from_numpy(x), torch.from_numpy(c), block=256)
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), ja)


def test_kmeans_is_seeded_and_reseeds_empty_cells():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(200, 4).astype(np.float32))
    runs = [t_kmeans.kmeans(t_kmeans.make_generator(9, 0, "cpu"), x, 6,
                            maxiter=5, block=64) for _ in range(2)]
    assert torch.equal(runs[0].centers, runs[1].centers)
    assert torch.equal(runs[0].assignments, runs[1].assignments)
    # a center far from every point gets no points: the Lloyd update moves
    # it onto a data point (the farthest one of some block)
    init = torch.cat([x[:3], torch.full((1, 4), 1e6)])
    centers, _ = t_kmeans._lloyd(x[None], init[None], 1, 64,
                                 t_metrics.SQEUCLIDEAN)
    assert (x == centers[0, 3]).all(dim=1).any()


# ------------------------------------------------- k-means|| and large k
def _separated_clusters():
    """48 well-separated clusters of 50 points: the data of the JAX
    package's own k-means|| seeding test."""
    rng = np.random.RandomState(0)
    k = 48
    centers_true = rng.randn(k, 8).astype(np.float32) * 30
    data = np.concatenate(
        [c + 0.1 * rng.randn(50, 8).astype(np.float32)
         for c in centers_true])
    return k, centers_true, data


def _objective(data, seeds):
    return ((data[:, None, :] - seeds[None]) ** 2).sum(-1).min(1).sum()


def test_kmeans_parallel_seeds():
    import jax
    k, centers_true, data = _separated_clusters()
    x = torch.from_numpy(data)
    seeds = t_kmeans.kmeans_parallel(t_kmeans.make_generator(0, 0, "cpu"),
                                     x, k).numpy()
    assert seeds.shape == (k, 8)
    # k distinct data points
    assert len(np.unique(seeds, axis=0)) == k
    assert all((data == s).all(axis=1).any() for s in seeds)
    # the same seed gives the same seeds, another seed other ones
    again = t_kmeans.kmeans_parallel(t_kmeans.make_generator(0, 0, "cpu"),
                                     x, k).numpy()
    np.testing.assert_array_equal(again, seeds)
    other = t_kmeans.kmeans_parallel(t_kmeans.make_generator(1, 0, "cpu"),
                                     x, k).numpy()
    assert not np.array_equal(other, seeds)
    # spread: nearly every true cluster holds a seed, and the seeding
    # objective is no worse than 1.1x the JAX seeding's on the same data
    owner = ((seeds[:, None, :] - centers_true[None]) ** 2).sum(-1).argmin(1)
    assert len(np.unique(owner)) >= int(0.9 * k)
    jseeds = np.asarray(j_kmeans.kmeans_parallel(jax.random.PRNGKey(0),
                                                 jnp.asarray(data), k))
    assert _objective(data, seeds) <= 1.1 * _objective(data, jseeds)


def test_kmeans_parallel_needs_k_points():
    with pytest.raises(AssertionError):
        t_kmeans.kmeans_parallel(t_kmeans.make_generator(0, 0, "cpu"),
                                 torch.zeros(5, 2), 6)


def test_kmeans_switches_to_parallel_seeding_past_the_cutoff(monkeypatch):
    calls = []
    real = t_kmeans._kmeans_parallel

    def spy(gen, x, k, *args):
        calls.append((x.shape[0], k))
        return real(gen, x, k, *args)

    monkeypatch.setattr(t_kmeans, "_kmeans_parallel", spy)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.rand(600, 6).astype(np.float32))
    gen = lambda: t_kmeans.make_generator(3, 0, "cpu")      # noqa: E731
    t_kmeans.kmeans(gen(), x, 32, maxiter=2)
    assert calls == []                      # k-means++ up to the cutoff
    monkeypatch.setattr(t_kmeans, "_PP_MAX_K", 8)
    r1 = t_kmeans.kmeans(gen(), x, 32, maxiter=4, pp_sample=16)
    # the sample is raised to min(n, 2k) points: k distinct seeds need them
    assert calls == [(64, 32)]
    r2 = t_kmeans.kmeans(gen(), x, 32, maxiter=4, pp_sample=16)
    assert torch.equal(r1.centers, r2.centers)
    assert int(r1.assignments.max()) < 32
    assert len(torch.unique(r1.assignments)) >= 28
    # and the real cutoff: 4097 centers seed and run (one pass)
    big = torch.from_numpy(rng.rand(5000, 2).astype(np.float32))
    res = t_kmeans.kmeans(t_kmeans.make_generator(0, 0, "cpu"), big, 4097,
                          maxiter=1)
    assert res.centers.shape == (4097, 2) and calls[-1] == (5000, 4097)


def test_segment_sum_lloyd_matches_one_hot_lloyd():
    # Lloyd's sums come from a sorted segment sum and the assignment folds
    # ||c||^2 into the matmul: the same clustering as the one-hot Lloyd of
    # the JAX package, written out here in numpy from the same seeds
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3000, 12).astype(np.float32))
    gen = lambda: t_kmeans.make_generator(3, 0, "cpu")      # noqa: E731
    b = t_kmeans.kmeans(gen(), x, 40, maxiter=6, block=512)
    xn = x.numpy().astype(np.float64)
    centers = t_kmeans.kmeans_plus_plus(gen(), x, 40).numpy() \
        .astype(np.float64)

    def nearest(c):
        return ((xn[:, None, :] - c[None]) ** 2).sum(-1).argmin(1)

    for _ in range(6):
        onehot = np.eye(40)[nearest(centers)]
        assert onehot.sum(0).min() > 0                  # no empty cluster
        centers = (onehot.T @ xn) / onehot.sum(0)[:, None]
    np.testing.assert_allclose(b.centers.numpy(), centers, rtol=1e-5,
                               atol=1e-5)
    assert (b.assignments.numpy() != nearest(centers)).mean() <= 0.001
    sums, counts = t_kmeans._segment_sums(
        x, b.assignments.to(torch.int64), 40)
    onehot = torch.nn.functional.one_hot(b.assignments.to(torch.int64), 40) \
        .to(torch.float32)
    torch.testing.assert_close(sums, onehot.T @ x, rtol=1e-5, atol=1e-4)
    assert torch.equal(counts, onehot.sum(0))


def test_gumbel_sampling_follows_the_weights():
    # argmax(log w + gumbel) draws index i with probability w_i / sum(w);
    # zero-weight points are never drawn
    w = torch.tensor([[0.0, 1.0, 3.0, 0.0, 4.0]])
    gen = t_kmeans.make_generator(7, 0, "cpu")
    draws = torch.stack([torch.argmax(t_kmeans._gumbel_keys([gen], w), dim=1)
                         for _ in range(4000)]).reshape(-1)
    freq = torch.bincount(draws, minlength=5).float() / 4000
    assert freq[0] == 0 and freq[3] == 0
    np.testing.assert_allclose(freq.numpy(), [0, 0.125, 0.375, 0, 0.5],
                               atol=0.03)


def test_eight_row_aligned_dense_view_matches_jax():
    # kc > 16384 builds 8-row cells; the same layout at a small size through
    # cell_align=8, d = 96 (d_pad = 128): no (rows/128, 128) streams
    from ivfadc_tpu import IVFADCIndex as JaxIndex
    from ivfadc_tpu_torch.convert import from_reference
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    data = synthetic_clustered(2048, 96, seed=3)
    jidx = JaxIndex.build(data, kc=64, m=8, k=16, seed=0, cell_align=8,
                          scan_mode="dense", coarse_maxiter=4,
                          quantization_maxiter=4)
    tidx = from_reference(jidx, "cpu")
    assert tidx.store.align == jidx.store.align == 8
    assert (tidx.store.offsets % 128 != 0).any()
    jv = jidx.store.device_view_dense(jidx.quantizer, jidx.config.scan_chunk,
                                      cache="int8")
    tv = tidx.store.device_view_dense(tidx.quantizer, tidx.config.scan_chunk,
                                      cache="int8")
    assert jv["ids2d"] is None and tv["ids2d"] is None
    assert jv["norms2d"] is None and tv["norms2d"] is None
    for key in ("decoded", "scale", "offsets", "sizes", "ids"):
        a, b = np.asarray(jv[key]), tv[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(b, a, err_msg=key)
    assert tv["decoded"].shape[1] == 128
    # and the per-probe search over those cells agrees (in-kernel bf16
    # squares: see tests/test_torch_routes.py)
    q = data[:8]
    ji, jd = jidx.search_padded(q, 5, w=4)
    ti, td = tidx.search_padded(q, 5, w=4)
    assert (ti == ji).mean() >= 0.95
    same = ti == ji
    np.testing.assert_allclose(td[same], jd[same], rtol=2e-3, atol=1e-3)
