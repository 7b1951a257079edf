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
def _probe_inputs(rng, kind: str, chunk: int, dv: int = 128):
    """(B, w) probes over 8 cells of a 128-wide cache; v of width dv <= 128
    (the wrappers take v's missing features as 0)."""
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
        v = rng.randint(-4, 5, (B, w, dv)).astype(np.float32)
        base = rng.randint(0, 100, (B, w)).astype(np.float32)
    else:
        decoded = rng.randint(-127, 128, (rows, d)).astype(np.int8)
        if kind == "pow2":
            # power-of-two scales: int8 * scale is exact in bf16, so the
            # dequantized rows are the same however they are rounded
            scale = (2.0 ** -rng.randint(5, 8, d)).astype(np.float32)
        else:
            scale = (0.01 + 0.02 * rng.rand(d)).astype(np.float32)
        v = rng.randn(B, w, dv).astype(np.float32)
        base = (10 + rng.rand(B, w)).astype(np.float32)
    base[1, 0] = np.inf                           # a padded probe
    return dict(starts=offsets[cells], sizes=sizes[cells], v=v, base=base,
                decoded=decoded, scale=scale)


_PROBE_PARAMS = [
    (128, 128, "integer", 128), (128, 256, "integer", 128),
    (256, 256, "integer", 128), (256, 512, "integer", 128),
    (128, 256, "pow2", 128), (256, 256, "pow2", 128),
    (128, 256, "float", 128), (256, 256, "float", 128),
    # v narrower than the cache
    (128, 256, "integer", 96), (256, 256, "integer", 100),
    (128, 256, "float", 96)]


@pytest.mark.parametrize("norm_coef", [1.0, 0.0])
@pytest.mark.parametrize("nf,chunk,kind,dv", _PROBE_PARAMS, ids=[
    "-".join(map(str, p[:3])) + ("" if p[3] == 128 else f"-dv{p[3]}")
    for p in _PROBE_PARAMS])
def test_dense_scan_matches_jax(nf, chunk, kind, dv, norm_coef):
    rng = np.random.RandomState(nf + chunk)
    a = _probe_inputs(rng, kind, chunk, dv)
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
    # the exact merge and the bf16 cache are ported (held to the JAX
    # package in tests/test_torch_variants.py); what the JAX package
    # refuses, the port refuses too
    z = torch.zeros((1, 1), dtype=torch.int32)
    v, base = torch.zeros((1, 1, 128)), torch.zeros((1, 1))
    dec8 = torch.zeros((256, 128), dtype=torch.int8)
    with pytest.raises(ValueError):                   # exact: one 128 buffer
        t_scan.dense_scan(z, z, v, base, dec8, torch.ones(128), k_out=10,
                          chunk=256, merge="exact", nf=256)
    with pytest.raises(ValueError):                   # int8 needs a scale
        t_scan.dense_scan(z, z, v, base, dec8, None, k_out=10, chunk=128)
    with pytest.raises(ValueError):                   # nf must divide chunk
        t_scan.dense_scan(z, z, v, base, dec8, torch.ones(128), k_out=10,
                          chunk=128, nf=256)
    out = t_scan.dense_scan(z, z, v, base, dec8.to(torch.bfloat16), None,
                            k_out=10, chunk=128, merge="exact")
    assert torch.isinf(out[0]).all() and (out[1] == -1).all()


def test_dense_scan_v_wider_than_the_cache_raises():
    a = _probe_inputs(np.random.RandomState(0), "integer", 128, dv=136)
    t = {k: torch.from_numpy(x) for k, x in a.items()}
    with pytest.raises(ValueError, match="wider"):
        t_scan.dense_scan(t["starts"], t["sizes"], t["v"], t["base"],
                          t["decoded"], t["scale"], k_out=10, chunk=128)


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


def _tie_inputs(B, kc, d, seed):
    """Integer-valued queries and centroids (entries in -2..2: every f32
    sum is exact in any order, and most scores tie), with copies of one
    centroid row on both sides of the kernels' 128-centroid tile and
    1024-centroid boundaries: the contract is the lowest index first."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-2, 3, (B, d)).astype(np.float32)
    c = rng.randint(-2, 3, (kc, d)).astype(np.float32)
    for at in (127, 128, 1023, 1024, kc - 1):
        if at < kc:
            c[at] = c[0]
    return q, c


@pytest.mark.parametrize("B,d,kc,w", [
    (8, 128, 2048, 8),       # kc > 1024: the JAX package's fused kernel
    (8, 96, 1280, 128),      # w = 128: its pairwise + top-k route
    (16, 128, 128, 128),     # w = kc
    (1, 96, 1152, 32),       # B = 1
    (1, 100, 100, 100),      # w = kc off the 128 grid
])
def test_coarse_probes_break_integer_ties_as_jax(B, d, kc, w):
    # the contract the CUDA kernels are held to on the card: the exact
    # top-w by (distance, lowest index), here through the plain versions
    # against the JAX package's naive coarse search
    from ivfadc_tpu.models.coarse import NaiveCoarseQuantizer
    from ivfadc_tpu.ops.metrics import get_metric
    q, c = _tie_inputs(B, kc, d, seed=B + kc + d + w)
    jc, jd = NaiveCoarseQuantizer(jnp.asarray(c), get_metric(
        "sqeuclidean")).search(jnp.asarray(q), w)
    jc, jd = np.asarray(jc), np.asarray(jd)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    cells, dists = t_coarse.coarse_topw(tq, tc, w)
    np.testing.assert_array_equal(cells.numpy(), jc)
    np.testing.assert_allclose(dists.numpy(), jd, rtol=1e-6)
    for engine in ("v1", "v2"):
        fc, fd, fv, fb = t_coarse.coarse_probe_vbase(
            tq, tc, w, torch.eye(d), False, True, engine=engine)
        np.testing.assert_array_equal(fc.numpy(), jc)
        np.testing.assert_allclose(fd.numpy(), jd, rtol=1e-6)
        # v = bf16(-2 (q - c)) of each winning cell: small integers, exact
        np.testing.assert_array_equal(
            fv.float().numpy(), -2.0 * (q[:, None, :] - c[jc]))


@pytest.mark.parametrize("B,kc,splits,tps", [
    (1, 1024, 8, 1),              # one query tile: a split per tile
    (256, 1024, 8, 1),            # 4 query tiles x 8 splits
    (4096, 1 << 18, 4, 512),      # 64 query tiles x 4: two blocks a SM
    (16384, 1024, 1, 8),          # 256 query tiles fill the card alone
    (1, 1 << 18, 256, 8),         # tiles spread evenly over the splits
    (100000, 1024, 1, 8),         # more query tiles than SMs
    (0, 1024, 8, 1),              # no query tile: no block either way
])
def test_coarse_split_plan_fills_one_wave(B, kc, splits, tps):
    # 132 SMs holding 2 blocks each, query tiles of 64, centroid tiles of
    # 128, d = 128: the cost model's cheapest split, with no empty split,
    # fills at most one wave of the card's 264 resident blocks (one split
    # where the query tiles alone pass them)
    sms, bq, bc = 132, 64, 128
    assert t_coarse.split_plan(B, kc, bq, bc, sms) == (splits, tps)
    tiles, qtiles = -(-kc // bc), -(-B // bq)
    assert (splits - 1) * tps < tiles <= splits * tps   # no empty split
    assert qtiles * splits <= max(2 * sms, qtiles)      # one wave


# What `coarse_fit` reported on an H100 (132 SMs) for the v/base kernel at
# w = 8: (shared bytes, resident blocks a SM) of each query tile tq
FITS_D128 = {1: (51652, 2), 4: (96004, 2)}
FITS_D960 = {1: (104900, 2), 4: (80644, 2)}
H100_FITS = {d: {tq: dict(bq=16 * tq, bc=128, smem_bytes=smem,
                          blocks_per_sm=per_sm)
                 for tq, (smem, per_sm) in fits.items()}
             for d, fits in {128: FITS_D128, 960: FITS_D960}.items()}


@pytest.mark.parametrize("B,d,tq,splits", [
    (10240, 960, 4, 4),           # gist1m.batch: 640 blocks, 4 or 5 a SM
    (10240, 128, 4, 1),           # sift1m.batch
    (65536, 128, 4, 1),           # sift1m.batch64k
    (4096, 128, 1, 1), (2048, 960, 4, 8), (1024, 960, 1, 4),
    (16, 960, 1, 8), (256, 960, 1, 8), (256, 128, 1, 8), (1, 128, 1, 8),
])
def test_coarse_tile_choice_at_the_cells_shapes(B, d, tq, splits):
    """`choose` at the benchmark cells' shapes and beside them (kc = 1024,
    w = 8) on the fits an H100 reported picks the plan that ran fastest of
    every (tq, S) in an H100 sweep of this kernel (PERF.md; B = 1 as
    B = 16). The cells' batches take query tiles of at least 64 rows over
    a grid that gives every SM a block; batches of 256 and fewer keep
    16-query tiles (`narrow`). At d = 960 the blocks spread evenly over
    the SMs, none more than 5 % above the mean; at d = 128 one split of
    64-query tiles ran faster than two or four, though 28 SMs run two of
    its 160 blocks."""
    sms, kc = 132, 1024
    p = t_coarse.choose(B, d, kc, 8, sms, H100_FITS[d])
    assert (p["tq"], p["splits"]) == (tq, splits)
    assert p["narrow"] == (tq == 1) and p["bq"] == 16 * tq
    assert p["grid"] == -(-B // p["bq"]) * p["splits"]
    tiles = -(-kc // p["bc"])
    assert (p["splits"] - 1) * p["tiles_per_split"] < tiles \
        <= p["splits"] * p["tiles_per_split"]
    if B >= 10240:
        assert p["bq"] >= 64 and p["grid"] >= sms
    if B <= 256:
        assert p["narrow"]
    if d == 960 and not p["narrow"]:
        assert -(-p["grid"] // sms) * sms <= 1.05 * p["grid"]


# What `coarse_fit` reported on an H100 for the v/base kernel at d = 128,
# w = 64, the large-w selection: (shared bytes, resident blocks a SM,
# candidate places a row) of each query tile tq
WIDE_FITS_D128 = {tq: dict(bq=16 * tq, bc=128, smem_bytes=smem,
                           blocks_per_sm=per_sm, wide=True, cap=cap)
                  for tq, (smem, per_sm, cap) in {1: (57796, 2, 32),
                                                  4: (115460, 2, 22)}.items()}


@pytest.mark.parametrize("B,kc,d,w,tq,splits", [
    (10240, 1024, 960, 8, 4, 4),      # gist1m.batch
    (10240, 1024, 128, 8, 4, 1),      # sift1m.batch
    (65536, 1024, 128, 8, 4, 1),      # sift1m.batch64k
    (10240, 8192, 128, 8, 4, 4),      # sift1m.ivf8192's shape at w = 8
    (10240, 8192, 128, 64, 4, 1),     # sift1m.ivf8192
])
def test_coarse_plan_weighs_the_large_w_selection(B, kc, d, w, tq, splits):
    """`choose` on the fits an H100 reported: the plan runs the large-w
    selection (`wide`) only where the fit reports it (w > 32), and only
    there does a split's cost grow with w. The w = 8 cells' plans are the
    w-blind model's, dict for dict; at `sift1m.ivf8192`'s shape w = 64's
    split cost keeps one split where the w-blind model took four (an H100
    sweep in turns: S = 1-3 within 1 %, S = 4 5 % slower, PERF.md)."""
    sms = 132
    fits = WIDE_FITS_D128 if w > 32 else H100_FITS[d]
    p = t_coarse.choose(B, d, kc, w, sms, fits)
    assert (p["tq"], p["splits"]) == (tq, splits)
    assert p["wide"] == (w > 32)
    blind = t_coarse.choose(B, d, kc, 8, sms, {
        k: dict(f, wide=False) for k, f in fits.items()})
    if w <= 32:
        assert blind == p
    else:
        assert (blind["tq"], blind["splits"]) == (4, 4)
    # w alone moves no cost: only the large-w selection's splits weigh it
    tiles = -(-kc // 128)
    for s in (2, 4):
        args = (B, 64, sms, d, 4, s, -(-tiles // s))
        assert t_coarse.plan_cost(*args, w=64) == t_coarse.plan_cost(*args)
        assert t_coarse.plan_cost(*args, w=64, wide=True) \
            > t_coarse.plan_cost(*args, w=8, wide=True) \
            == t_coarse.plan_cost(*args)


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
