"""The small-batch path's kernel modules against the JAX package, on the CPU.

Same scheme as tests/test_torch_kernels.py: numpy inputs from a seed go to
the `ivfadc_tpu` wrapper (Pallas kernel in interpret mode) and to the
`ivfadc_tpu_torch` wrapper (the kernel's plain PyTorch version on CPU
tensors): the per-probe fold scan, the top-k with indices and the exact
top-w coarse probe.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ivfadc_tpu.ops import coarse_scan as j_coarse
from ivfadc_tpu.ops import pallas_scan as j_scan
from ivfadc_tpu.ops import topk as j_topk
from ivfadc_tpu_torch.ops import coarse_scan as t_coarse
from ivfadc_tpu_torch.ops import dense_scan as t_scan
from ivfadc_tpu_torch.ops import topk as t_topk

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)


# ---------------------------------------------------------- per-probe scan
def _probe_inputs(rng, kind: str, chunk: int):
    kc, d, B, w = 8, 128, 8, 4
    caps = np.full(kc, 512)
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])]).astype(np.int32)
    # an empty cell, sizes that are no multiple of 128, cells over a chunk
    sizes = np.array([0, 5, 128, 130, 300, 511, 1, 257], np.int32)
    rows = int(caps.sum()) + chunk + 128          # guard past the last cell
    cells = rng.randint(0, kc, (B, w)).astype(np.int32)
    cells[0, :2] = (0, 3)                         # always probe these two
    if kind == "integer":
        # every product and sum is an integer < 2^24, and every square is
        # <= 9 (exact in bf16): f32 is exact in any summation order, so the
        # two packages must agree bit for bit
        decoded = rng.randint(-3, 4, (rows, d)).astype(np.int8)
        scale = np.ones(d, np.float32)
        v = rng.randint(-4, 5, (B, w, d)).astype(np.float32)
        base = rng.randint(0, 100, (B, w)).astype(np.float32)
    else:
        decoded = rng.randint(-127, 128, (rows, d)).astype(np.int8)
        if kind == "pow2":
            # power-of-two scales: int8 * scale is exact in bf16, so the
            # dequantized rows are the same however they are rounded
            scale = (2.0 ** -rng.randint(5, 8, d)).astype(np.float32)
        else:
            scale = (0.01 + 0.02 * rng.rand(d)).astype(np.float32)
        v = rng.randn(B, w, d).astype(np.float32)
        base = (10 + rng.rand(B, w)).astype(np.float32)
    base[1, 0] = np.inf                           # a padded probe
    return dict(starts=offsets[cells], sizes=sizes[cells], v=v, base=base,
                decoded=decoded, scale=scale)


@pytest.mark.parametrize("norm_coef", [1.0, 0.0])
@pytest.mark.parametrize("nf,chunk,kind", [
    (128, 128, "integer"), (128, 256, "integer"), (256, 256, "integer"),
    (256, 512, "integer"), (128, 256, "pow2"), (256, 256, "pow2"),
    (128, 256, "float"), (256, 256, "float")])
def test_dense_scan_matches_jax(nf, chunk, kind, norm_coef):
    rng = np.random.RandomState(nf + chunk)
    a = _probe_inputs(rng, kind, chunk)
    kw = dict(k_out=10, chunk=chunk, norm_coef=norm_coef, merge="fold", nf=nf)
    jd, jp = j_scan.dense_scan(
        jnp.asarray(a["starts"]), jnp.asarray(a["sizes"]),
        jnp.asarray(a["v"]), jnp.asarray(a["base"]),
        jnp.asarray(a["decoded"]), jnp.asarray(a["scale"]), interpret=True,
        **kw)
    td, tp = t_scan.dense_scan(
        torch.from_numpy(a["starts"]), torch.from_numpy(a["sizes"]),
        torch.from_numpy(a["v"]), torch.from_numpy(a["base"]),
        torch.from_numpy(a["decoded"]), torch.from_numpy(a["scale"]), **kw)
    jd, jp, td, tp = np.asarray(jd), np.asarray(jp), td.numpy(), tp.numpy()
    assert td.shape == jd.shape == (8, 4, nf) and tp.dtype == np.int32
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    # the empty cell and the +inf-base probe hold no candidate
    assert np.isinf(td[0, 0]).all() and (tp[0, 0] == -1).all()
    assert np.isinf(td[1, 0]).all() and (tp[1, 0] == -1).all()
    fin = np.isfinite(jd)
    if kind == "integer":
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)
    elif kind == "pow2" and norm_coef == 0.0:
        # identical rows, exact bf16 x bf16 products: only the order of the
        # f32 sum of 128 terms differs (terms ~1, scores ~10)
        np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-4)
        assert (tp == jp).mean() >= 0.999
    else:
        # the interpret-mode kernel may keep the dequantized rows ("float")
        # and their squares (both kinds) above bf16 precision, 2^-9 relative
        # a term: over 128 terms that is up to ~3e-4 of the summed
        # magnitude, which the norms dominate when they are on. Hold the
        # scores to 2e-3 of the largest score magnitude.
        tol = 2e-3 * np.abs(jd[fin]).max()
        np.testing.assert_allclose(td[fin], jd[fin], rtol=0, atol=tol)
        assert (tp == jp).mean() >= 0.98


def test_dense_scan_unported_variants_raise():
    z = torch.zeros((1, 1), dtype=torch.int32)
    v, base = torch.zeros((1, 1, 128)), torch.zeros((1, 1))
    dec8 = torch.zeros((256, 128), dtype=torch.int8)
    with pytest.raises(NotImplementedError):          # exact merge
        t_scan.dense_scan(z, z, v, base, dec8, torch.ones(128), k_out=10,
                          chunk=128, merge="exact")
    with pytest.raises(NotImplementedError):          # bf16 cache
        t_scan.dense_scan(z, z, v, base, dec8.to(torch.bfloat16), None,
                          k_out=10, chunk=128)
    with pytest.raises(ValueError):                   # nf must divide chunk
        t_scan.dense_scan(z, z, v, base, dec8, torch.ones(128), k_out=10,
                          chunk=128, nf=256)


# ------------------------------------------------------ top-k with indices
@pytest.mark.parametrize("N", [256, 1024])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_topk_lastdim_matches_jax(N, k):
    rng = np.random.RandomState(N + k)
    B = 64
    x = rng.randint(0, 50, (B, N)).astype(np.float32)       # many ties
    # +inf tails: some rows keep fewer than k finite entries
    tail = rng.randint(0, N, B)
    tail[:8] = N - 3
    x[np.arange(N)[None, :] >= tail[:, None]] = np.inf
    jv, ji = j_topk.topk_lastdim(jnp.asarray(x), k, interpret=True)
    tv, ti = t_topk.topk_lastdim(torch.from_numpy(x), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("N,k", [(100, 7), (300, 200), (64, 64)])
def test_topk_lastdim_odd_shapes_and_large_k(N, k):
    # shapes the JAX wrapper hands to lax.top_k (N no multiple of 128, or
    # k > 128): values equal; among finite values ties come in index order
    # in both packages
    rng = np.random.RandomState(N)
    x = rng.randint(0, 40, (16, N)).astype(np.float32)
    x[:4, N // 2:] = np.inf
    jv, ji = j_topk.topk_lastdim(jnp.asarray(x), k, interpret=True)
    tv, ti = t_topk.topk_lastdim(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    fin = np.isfinite(np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy()[fin], np.asarray(ji)[fin])
    with pytest.raises(ValueError):
        t_topk.topk_lastdim(torch.from_numpy(x), N + 1)


# ------------------------------------------------------- exact top-w probe
@pytest.mark.parametrize("B,d,kc,w", [
    (64, 128, 128, 8), (8, 128, 256, 1), (16, 128, 128, 128),
    (64, 96, 128, 8),        # d: the JAX wrapper returns None
    (64, 128, 100, 8),       # kc: the JAX wrapper returns None
])
def test_coarse_topw_matches_jax(B, d, kc, w):
    rng = np.random.RandomState(B + d + kc + w)
    q = rng.randn(B, d).astype(np.float32)
    c = rng.randn(kc, d).astype(np.float32)
    fused = j_coarse.coarse_topw(jnp.asarray(q), jnp.asarray(c), w,
                                 interpret=True)
    if d % 128 or kc % 128:
        # the port's kernel takes every d and kc: hold it to the route the
        # JAX caller falls back to, pairwise distances + top-k
        assert fused is None
        from ivfadc_tpu.ops.metrics import get_metric
        dist = get_metric("sqeuclidean").pairwise(jnp.asarray(q),
                                                  jnp.asarray(c))
        jd, jc = j_topk.topk_lastdim(dist, w, interpret=True)
    else:
        jc, jd = fused
    tc, td = t_coarse.coarse_topw(torch.from_numpy(q), torch.from_numpy(c), w)
    assert tc.dtype == torch.int32 and tuple(tc.shape) == (B, w)
    # f32 scores summed in another order: cells may differ only where two
    # centroids tie to within a few ulps (none do at these seeds); the
    # squared distances (~2d) agree to 1e-5 relative
    assert (tc.numpy() == np.asarray(jc)).mean() >= 0.999
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)
    assert (np.diff(td.numpy(), axis=1) >= 0).all()


def test_coarse_topw_equals_fused_probe_cells():
    # the two probe kernels share their score code: same cells, same
    # distances, on the plain versions as on the card
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(32, 128).astype(np.float32))
    c = torch.from_numpy(rng.randn(256, 128).astype(np.float32))
    cells, dists = t_coarse.coarse_topw(q, c, 8)
    fc, fd, _, _ = t_coarse.coarse_probe_vbase(q, c, 8, torch.eye(128),
                                               False, True)
    assert torch.equal(cells, fc) and torch.equal(dists, fd)
    with pytest.raises(NotImplementedError):
        t_coarse.coarse_topw(q, c, 129)


def test_naive_coarse_takes_any_kc_through_the_probe_wrappers(monkeypatch):
    # no shape sends a euclidean naive-coarse search around the probe
    # wrappers: a table far past one shared-memory score row (kc = 50000)
    # goes through coarse_topw / coarse_probe_vbase like a small one
    from ivfadc_tpu_torch.models import index as t_index
    from ivfadc_tpu_torch.models.coarse import NaiveCoarseQuantizer
    from ivfadc_tpu_torch.ops.metrics import get_metric
    rng = np.random.RandomState(6)
    q = torch.from_numpy(rng.randn(4, 8).astype(np.float32))
    c = torch.from_numpy(rng.randn(50000, 8).astype(np.float32))
    calls = []
    real_topw, real_vbase = t_coarse.coarse_topw, t_index.coarse_probe_vbase
    monkeypatch.setattr(t_coarse, "coarse_topw", lambda *a, **k: (
        calls.append("topw"), real_topw(*a, **k))[1])
    monkeypatch.setattr(t_index, "coarse_probe_vbase", lambda *a, **k: (
        calls.append("vbase"), real_vbase(*a, **k))[1])
    metric = get_metric("sqeuclidean")
    cq = NaiveCoarseQuantizer(c, metric)
    cells, dists = cq.search(q, 16)
    exact = torch.cdist(q.double(), c.double()) ** 2
    want = torch.argsort(exact, dim=1, stable=True)[:, :16]
    assert torch.equal(cells.to(torch.int64), want)
    np.testing.assert_allclose(dists.numpy(),
                               torch.gather(exact, 1, want).numpy(),
                               rtol=1e-4, atol=1e-4)
    fcells = t_index._dense_probe(
        cq, torch.eye(8), q, w=16, metric=metric, include_base=True,
        apply_rot=False, residual_based=True)[0]
    assert torch.equal(fcells, cells)
    assert calls == ["topw", "vbase"]
