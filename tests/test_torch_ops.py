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
