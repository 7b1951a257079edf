"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (Hopper: the kernels are built for
sm_90a) and skips without one. This file imports no JAX, so it also runs
where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""
"""

import time
import types

import numpy as np
import pytest
import torch

from ivfadc_tpu_torch.ops import cell_rank, coarse_scan, dense_scan, topk

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_topk_payload_kernel_exact(dev):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 50, (64, 1024)).astype(np.float32))
    x[:8, 1000:] = float("inf")                       # +inf tails, ties
    p = torch.from_numpy(rng.randint(0, 1 << 20, (64, 1024)).astype(np.int32))
    for k in (1, 10, 128):
        n0 = topk.KERNEL.launches
        kv, kp = topk.topk_lastdim_payload(x.to(dev), p.to(dev), k)
        assert topk.KERNEL.launches == n0 + 1
        pv, pp = topk.topk_lastdim_payload_plain(x, p, k)
        assert torch.equal(kv.cpu(), pv) and torch.equal(kp.cpu(), pp)


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [300, 4096])
def test_cell_rank_kernel_exact(dev, kc):
    rng = np.random.RandomState(kc)
    cells = np.where(rng.rand(5000) < 0.3, rng.randint(0, 5, 5000),
                     rng.randint(0, kc, 5000)).astype(np.int32)
    c = torch.from_numpy(cells)
    kr, kn = cell_rank.cell_ranks(c.to(dev), kc=kc)
    pr, pn = cell_rank.cell_ranks_plain(c, kc)
    assert torch.equal(kr.cpu(), pr) and torch.equal(kn.cpu(), pn)


def _scan_inputs(rng, integer: bool, d: int = 128):
    kc, B, w, chunk = 8, 16, 4, 256
    caps = np.full(kc, 512)
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])]).astype(np.int32)
    sizes = np.array([0, 5, 128, 130, 300, 511, 1, 257], np.int32)
    rows = -(-(int(caps.sum()) + chunk + 128) // 128) * 128
    cells = rng.randint(0, kc, (B, w)).astype(np.int32)
    ids2d = rng.permutation(rows).astype(np.int32).reshape(-1, 128)
    if integer:
        decoded = rng.randint(-3, 4, (rows, d)).astype(np.int8)
        scale = np.ones(d, np.float32)
        v = rng.randint(-4, 5, (B, w, d)).astype(np.float32)
        base = rng.randint(0, 100, (B, w)).astype(np.float32)
        norms = rng.randint(0, 50, rows).astype(np.float32)
    else:
        decoded = rng.randint(-127, 128, (rows, d)).astype(np.int8)
        scale = (0.01 + 0.02 * rng.rand(d)).astype(np.float32)
        v = rng.randn(B, w, d).astype(np.float32)
        base = (10 + rng.rand(B, w)).astype(np.float32)
        norms = (5 + rng.rand(rows)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (cells, offsets, sizes, v, base,
                                       decoded, scale, ids2d,
                                       norms.reshape(-1, 128))]
    t[3] = t[3].to(torch.bfloat16)
    return t, dict(kc=kc, k_out=10, chunk=chunk, norm_coef=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("pb,nf", [(8, 128), (16, 256), (64, 128)])
@pytest.mark.parametrize("integer", [True, False])
def test_grouped_scan_kernel(dev, pb, nf, integer):
    args, kw = _scan_inputs(np.random.RandomState(pb + nf), integer)
    n0 = dense_scan.KERNEL.launches
    kd, kp = dense_scan.grouped_dense_scan(*[a.to(dev) for a in args],
                                           pb=pb, nf=nf, **kw)
    assert dense_scan.KERNEL.launches == n0 + 1
    pd, pp = dense_scan.grouped_dense_scan(*args, pb=pb, nf=nf, **kw)
    assert dense_scan.KERNEL.launches == n0 + 1      # plain path: no launch
    if integer:             # integer-valued: every f32 sum exact -> equal
        assert torch.equal(kd.cpu(), pd) and torch.equal(kp.cpu(), pp)
    else:                   # f32 sums in another order
        fin = torch.isfinite(pd)
        assert torch.equal(torch.isfinite(kd.cpu()), fin)
        torch.testing.assert_close(kd.cpu()[fin], pd[fin], rtol=1e-5,
                                   atol=1e-4)
        assert (kp.cpu() == pp).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("pb,nf,d", [(8, 128, 128), (16, 256, 256),
                                     (64, 128, 128)])
@pytest.mark.parametrize("norm_coef", [1.0, 0.0])
@pytest.mark.parametrize("integer", [True, False])
def test_grouped_scan_knorm_kernel(dev, pb, nf, d, norm_coef, integer):
    # the variant that computes the row norms itself (no norms2d); the cell
    # sizes include an empty cell (tiles of size 0) and groups that are not
    # 128-multiples (5, 130, 300, 511, 1, 257 rows)
    args, kw = _scan_inputs(np.random.RandomState(pb + nf), integer, d=d)
    args[8] = None
    kw["norm_coef"] = norm_coef
    n0 = (dense_scan.NORMS_KERNEL.launches, dense_scan.KERNEL.launches)
    kd, kp = dense_scan.grouped_dense_scan(
        *[a if a is None else a.to(dev) for a in args], pb=pb, nf=nf, **kw)
    assert (dense_scan.NORMS_KERNEL.launches,
            dense_scan.KERNEL.launches) == (n0[0] + 1, n0[1])
    pd, pp = dense_scan.grouped_dense_scan(*args, pb=pb, nf=nf, **kw)
    assert dense_scan.NORMS_KERNEL.launches == n0[0] + 1   # plain: no launch
    empty = args[0] == 0                                    # cell 0 is empty
    assert torch.isinf(pd[empty]).all() and (pp[empty] == -1).all()
    if integer:             # integer-valued: every f32 sum exact -> equal
        assert torch.equal(kd.cpu(), pd) and torch.equal(kp.cpu(), pp)
    else:                   # f32 sums in another order
        fin = torch.isfinite(pd)
        assert torch.equal(torch.isfinite(kd.cpu()), fin)
        torch.testing.assert_close(kd.cpu()[fin], pd[fin], rtol=1e-5,
                                   atol=1e-4)
        assert (kp.cpu() == pp).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("apply_rot", [False, True])
def test_coarse_probe_kernel(dev, apply_rot):
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(256, 128).astype(np.float32))
    c = torch.from_numpy(rng.randn(1024, 128).astype(np.float32))
    rot = torch.from_numpy(np.linalg.qr(rng.randn(128, 128))[0]
                           .astype(np.float32))
    kc_, kd_, kv_, kb_ = coarse_scan.coarse_probe_vbase(
        q.to(dev), c.to(dev), 8, rot.to(dev), apply_rot, True)
    pc_, pd_, pv_, pb_ = coarse_scan.coarse_probe_vbase(
        q, c, 8, rot, apply_rot, True)
    same = kc_.cpu() == pc_
    assert same.float().mean() >= 0.999       # near-ties may flip
    torch.testing.assert_close(kd_.cpu(), pd_, rtol=1e-5, atol=1e-4)
    if apply_rot:
        torch.testing.assert_close(kv_.cpu()[same].float(),
                                   pv_[same].float(), rtol=2 ** -7, atol=1e-6)
    else:
        assert torch.equal(kv_.cpu()[same], pv_[same])
    torch.testing.assert_close(kb_.cpu()[same], pb_[same], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
def test_topk_index_kernel_exact(dev):
    rng = np.random.RandomState(2)
    for n in (1024, 100, 4097):             # any N >= k, not only 128-multiples
        x = torch.from_numpy(rng.randint(0, 50, (70, n)).astype(np.float32))
        x[:8, n - 30:] = float("inf")                 # +inf tails, ties
        for k in (1, 10, min(n, 128)):
            n0 = topk.INDEX_KERNEL.launches
            kv, ki = topk.topk_lastdim(x.to(dev), k)
            assert topk.INDEX_KERNEL.launches == n0 + 1
            pv, pi = topk.topk_lastdim_plain(x, k)
            assert torch.equal(kv.cpu(), pv) and torch.equal(ki.cpu(), pi)


def _topk_rows(B: int, N: int, seed: int):
    """(B, N) f32 rows cycling through the kinds of the top-k contract:
    integer ties with zeros of both signs, +0 / -0 tied at the minimum in
    both orders, -inf entries, all +inf, three entries below +inf, all
    equal, descending, random normals with +inf tails, ascending normals."""
    rng = np.random.RandomState(seed)
    x = rng.randint(1, 50, (B, N)).astype(np.float32)
    kinds = np.arange(B) % 9
    zero = rng.rand(B, N) < 0.2
    x[(kinds == 0)[:, None] & zero] = 0.0
    x[(kinds == 0)[:, None] & zero & (rng.rand(B, N) < 0.5)] = -0.0
    for r in np.flatnonzero(kinds == 1):
        i, j = sorted(rng.choice(N, 2, replace=False)) if N > 1 else (0, 0)
        x[r, i], x[r, j] = (0.0, -0.0) if r % 2 else (-0.0, 0.0)
    x[(kinds == 2)[:, None] & (rng.rand(B, N) < 0.05)] = -np.inf
    x[kinds == 3] = np.inf
    for r in np.flatnonzero(kinds == 4):
        x[r] = np.inf
        x[r, rng.randint(0, N, 3)] = rng.randint(-5, 5, 3)
    x[kinds == 5] = 7.0
    x[kinds == 6] = np.arange(N, 0, -1, dtype=np.float32)
    rnd = kinds == 7
    x[rnd] = rng.randn(int(rnd.sum()), N).astype(np.float32)
    x[rnd[:, None] & (np.arange(N)[None, :] >= N - N // 8)] = np.inf
    x[kinds == 8] = np.sort(rng.randn(int((kinds == 8).sum()), N), axis=1) \
        .astype(np.float32)
    return torch.from_numpy(x)


def _topk_both(x, k, dev, seed=0):
    """Both top-k kernels on x (a CUDA tensor) against their plain
    versions on the card, bit for bit (values compared as int32 bits, so
    a zero's sign counts), each launching its kernel once."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.randint(0, 1 << 30, x.shape, generator=g, device=dev,
                      dtype=torch.int32)
    n0 = (topk.KERNEL.launches, topk.INDEX_KERNEL.launches)
    kv, kp = topk.topk_lastdim_payload(x, p, k)
    iv, ii = topk.topk_lastdim(x, k)
    assert (topk.KERNEL.launches, topk.INDEX_KERNEL.launches) == \
        (n0[0] + 1, n0[1] + 1)
    pv, pp = topk.topk_lastdim_payload_plain(x, p, k)
    qv, qi = topk.topk_lastdim_plain(x, k)
    bits = lambda t: t.contiguous().view(torch.int32)   # noqa: E731
    assert torch.equal(bits(kv), bits(pv)) and torch.equal(kp, pp)
    assert torch.equal(bits(iv), bits(qv)) and torch.equal(ii, qi)


@pytest.mark.cuda
@pytest.mark.parametrize("N,k", [(1, 1), (100, 1), (100, 10), (100, 32),
                                 (100, 100), (1024, 1), (1024, 10),
                                 (1024, 32), (1024, 128), (4097, 1),
                                 (4097, 10), (4097, 32), (4097, 128),
                                 (49152, 10), (49152, 128)])
def test_topk_kernels_edge_rows(dev, N, k):
    for B in (1, 7, 33):
        _topk_both(_topk_rows(B, N, seed=N + k + B).to(dev), k, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("N,k", [(1024, 10), (4097, 32), (512, 128)])
def test_topk_kernels_many_rows(dev, N, k):
    _topk_both(_topk_rows(4096, N, seed=N + k).to(dev), k, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,k", [(16384, 1024, 10), (4096, 4096, 32),
                                   (4096, 4096, 10), (4096, 512, 32),
                                   (256, 1024, 10)])
def test_topk_kernels_path_shapes(dev, B, N, k):
    """The five shapes the search paths give the kernels, on rows shaped
    like w probes' fold buffers (probe u's 128 lanes near u, empty lanes
    +inf) and on random normals."""
    g = torch.Generator(device=dev).manual_seed(B + N + k)
    lanes = torch.arange(N, device=dev) // 128
    x = lanes + torch.rand((B, N), generator=g, device=dev)
    x[torch.rand((B, N), generator=g, device=dev) < 0.05] = float("inf")
    _topk_both(x, k, dev)
    _topk_both(torch.randn((B, N), generator=g, device=dev), k, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("off", [1, 2, 3])
def test_topk_kernels_rows_off_alignment(dev, off):
    """Rows that start off 16 bytes: a view at an offset of 1-3 floats
    (contiguous, so the wrapper passes it as it is), N = 1024 and 1027."""
    for N in (1024, 1027):
        flat = _topk_rows(40, N, seed=off).reshape(-1).to(dev)
        buf = torch.cat([torch.zeros(off, device=dev), flat])
        x = buf[off:].view(40, N)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4 * off
        _topk_both(x, 10, dev)


@pytest.mark.cuda
def test_topk_fit_reports_no_spills(dev):
    for B, N, k in ((16384, 1024, 10), (4096, 4096, 32), (256, 1024, 10),
                    (1, 100, 100)):
        for payload in (True, False):
            fit = topk.topk_fit(B, N, k, payload)
            assert fit["local_bytes"] == 0, fit
            assert fit["blocks_per_sm"] >= 1 and fit["warps"] >= 1
            assert fit["grid"] * fit["warps"] >= B


def _probe_inputs(rng, integer: bool):
    kc, d, B, w = 8, 256, 8, 4
    caps = np.full(kc, 512)
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])]).astype(np.int32)
    sizes = np.array([0, 5, 128, 130, 300, 511, 1, 257], np.int32)
    rows = int(caps.sum())                  # no guard rows past the last cell
    cells = rng.randint(0, kc, (B, w))
    cells[0, :2] = (0, 7)                   # the empty cell and the last one
    if integer:
        decoded = rng.randint(-3, 4, (rows, d)).astype(np.int8)
        scale = np.ones(d, np.float32)
        v = rng.randint(-4, 5, (B, w, d)).astype(np.float32)
        base = rng.randint(0, 100, (B, w)).astype(np.float32)
    else:
        decoded = rng.randint(-127, 128, (rows, d)).astype(np.int8)
        scale = (0.01 + 0.02 * rng.rand(d)).astype(np.float32)
        v = rng.randn(B, w, d).astype(np.float32)
        base = (10 + rng.rand(B, w)).astype(np.float32)
    base[1, 0] = np.inf                     # a padded probe
    return [torch.from_numpy(a) for a in (
        offsets[cells], sizes[cells], v, base, decoded, scale)]


@pytest.mark.cuda
@pytest.mark.parametrize("nf", [128, 256])
@pytest.mark.parametrize("norm_coef", [1.0, 0.0])
@pytest.mark.parametrize("integer", [True, False])
def test_probe_scan_kernel(dev, nf, norm_coef, integer):
    args = _probe_inputs(np.random.RandomState(nf), integer)
    kw = dict(k_out=10, chunk=256, norm_coef=norm_coef, nf=nf)
    n0 = dense_scan.PROBE_KERNEL.launches
    kd, kp = dense_scan.dense_scan(*[a.to(dev) for a in args], **kw)
    assert dense_scan.PROBE_KERNEL.launches == n0 + 1
    pd, pp = dense_scan.dense_scan(*args, **kw)
    assert dense_scan.PROBE_KERNEL.launches == n0 + 1  # plain path: no launch
    assert torch.isinf(pd[0, 0]).all() and (pp[0, 0] == -1).all()
    if integer:             # integer-valued: every f32 sum exact -> equal
        assert torch.equal(kd.cpu(), pd) and torch.equal(kp.cpu(), pp)
    else:                   # f32 sums in another order
        fin = torch.isfinite(pd)
        assert torch.equal(torch.isfinite(kd.cpu()), fin)
        torch.testing.assert_close(kd.cpu()[fin], pd[fin], rtol=1e-5,
                                   atol=1e-4)
        assert (kp.cpu() == pp).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("B,d,kc,w", [(256, 128, 1024, 8), (8, 128, 1024, 8),
                                      (33, 96, 100, 5), (16, 128, 256, 128),
                                      (40, 96, 10000, 32),
                                      (24, 128, 9000, 16),
                                      (17, 32, 70000, 128),
                                      (10240, 128, 8192, 64)])
def test_coarse_topw_kernel(dev, B, d, kc, w):
    # kc > 128: the table is scored in 128-centroid tiles, split over
    # blocks, each keeping a running top-w
    rng = np.random.RandomState(B + kc)
    q = torch.from_numpy(rng.randn(B, d).astype(np.float32))
    c = torch.from_numpy(rng.randn(kc, d).astype(np.float32))
    n0 = coarse_scan.TOPW_KERNEL.launches
    kcells, kd = coarse_scan.coarse_topw(q.to(dev), c.to(dev), w)
    assert coarse_scan.TOPW_KERNEL.launches == n0 + 1
    pcells, pd = coarse_scan.coarse_topw(q, c, w)
    assert (kcells.cpu() == pcells).float().mean() >= 0.999  # near-ties flip
    torch.testing.assert_close(kd.cpu(), pd, rtol=1e-5, atol=1e-4)
    if d == 128:            # the fused probe shares the score code
        fcells = coarse_scan.coarse_probe_vbase(
            q.to(dev), c.to(dev), min(w, 128), torch.eye(d, device=dev),
            False, True)[0]
        assert torch.equal(fcells, kcells)


def _tie_table(rng, B, kc, d, dev, w):
    """Integer-valued queries and centroids (entries in -2..2: every f32
    sum is exact in any order, and most scores tie), with copies of one
    centroid row on both sides of every 128-centroid tile boundary, the
    1024-centroid boundaries and the boundaries of the kernels' kc splits
    at this batch (the top-w kernel's and the fused probe's)."""
    q = rng.randint(-2, 3, (B, d)).astype(np.float32)
    c = rng.randint(-2, 3, (kc, d)).astype(np.float32)
    tps = coarse_scan.plan(B, d, kc, w, "topw", dev)["tiles_per_split"]
    vb = coarse_scan.plan(B, d, kc, w, "vbase", dev)
    span = vb["bc"] * vb["tiles_per_split"]
    for edge in list(range(128, kc, 128)) + list(range(1024, kc, 1024)) \
            + list(range(128 * tps, kc, 128 * tps)) \
            + list(range(span, kc, span)):
        c[edge - 1] = c[edge] = c[0]
    c[kc - 1] = c[0]
    return torch.from_numpy(q), torch.from_numpy(c)


@pytest.mark.cuda
@pytest.mark.parametrize("kc,w", [(9001, 64), (4096, 128), (12288, 1),
                                  (65536, 32)])
def test_coarse_kernels_break_ties_by_index_across_chunks(dev, kc, w):
    # integer-valued inputs: every score is exact and most tie, within a
    # tile of 128 centroids, across tiles and across the splits of the
    # table that the kernels score in separate blocks (the plan's, and
    # one tile a split past the plan: every tile boundary a split's), so
    # both kernels must return the plain version's cells (lowest index
    # first) bit for bit
    rng = np.random.RandomState(kc)
    B, d = 37, 16
    q, c = _tie_table(rng, B, kc, d, dev, w)
    cn = torch.sum(c * c, dim=1)
    pvals, pcells = coarse_scan.coarse_topw_plain(q, c, cn, w)
    kcells, kd = coarse_scan.coarse_topw(q.to(dev), c.to(dev), w)
    assert torch.equal(kcells.cpu(), pcells)
    qn = torch.sum(q * q, dim=1, keepdim=True)
    assert torch.equal(kd.cpu(), torch.clamp_min(pvals + qn, 0.0))
    n0 = coarse_scan.KERNEL.launches
    fvals, fcells, fv, frn = coarse_scan.coarse_vbase(
        q.to(dev), c.to(dev), cn.to(dev), torch.eye(d, device=dev), w, False)
    assert coarse_scan.KERNEL.launches == n0 + 1
    pv = coarse_scan.coarse_vbase_plain(q, c, cn, torch.eye(d), w, False)
    assert torch.equal(fvals.cpu(), pv[0]) and torch.equal(fcells.cpu(), pv[1])
    assert torch.equal(fv.cpu(), pv[2]) and torch.equal(frn.cpu(), pv[3])
    tiles = -(-kc // 128)
    qd, cd, cnd = q.to(dev), c.to(dev), cn.to(dev)
    for kind, want in (("topw", (pvals, pcells)), ("vbase", pv)):
        got = _forced(kind, qd, cd, cnd, w, 1, tiles)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), kind


@pytest.mark.cuda
@pytest.mark.parametrize("B,kc,d,w", [
    (1, 8, 96, 8), (1, 128, 128, 128), (7, 1000, 100, 8),
    (7, 1000, 96, 128), (256, 1024, 128, 8), (256, 1024, 128, 128),
    (256, 4097, 100, 32), (4096, 1024, 100, 1), (4096, 4097, 96, 32),
    (7, 65536, 128, 1), (1, 65536, 96, 128), (4096, 65536, 96, 32),
    (1024, 32768, 96, 32), (10240, 8192, 128, 64),
    (300, 4096, 128, 32), (300, 4096, 128, 33), (300, 4096, 128, 64),
    (300, 4096, 128, 100), (300, 4096, 128, 128)])
def test_coarse_kernels_integer_ties_bit_equal(dev, B, kc, d, w):
    # kernels 7, 1 and 10 on integer-tie tables at every batch shape the
    # split plan distinguishes (one query tile, a few, many), and about the
    # switch to the large-w selection (w = 32 | 33), held to the plain
    # versions bit for bit on the card: (vals, cells) for 7, (vals, cells,
    # v, rn) for 1, and kernel 10's cells equal to kernel 1's; each wrapper
    # launches exactly once per call
    rng = np.random.RandomState(B * 7 + kc + d + w)
    q, c = (t.to(dev) for t in _tie_table(rng, B, kc, d, dev, w))
    cn = torch.sum(c * c, dim=1)
    eye = torch.eye(d, device=dev)
    counts = [k.launches for k in (coarse_scan.TOPW_KERNEL,
                                   coarse_scan.KERNEL, coarse_scan.V2_KERNEL)]
    kcells, kd = coarse_scan.coarse_topw(q, c, w)
    k1 = coarse_scan.coarse_vbase(q, c, cn, eye, w, False)
    hi, lo = coarse_scan.hi_lo_split(c, eye, False)
    k10 = coarse_scan.coarse_vbase_v2(q, c, cn, eye, hi, lo, w, False)
    assert [k.launches for k in (coarse_scan.TOPW_KERNEL, coarse_scan.KERNEL,
                                 coarse_scan.V2_KERNEL)] == \
        [n + 1 for n in counts]
    pvals, pcells = coarse_scan.coarse_topw_plain(q, c, cn, w)
    qn = torch.sum(q * q, dim=1, keepdim=True)
    assert torch.equal(kcells, pcells)
    assert torch.equal(kd, torch.clamp_min(pvals + qn, 0.0))
    p1 = coarse_scan.coarse_vbase_plain(q, c, cn, eye, w, False)
    assert all(torch.equal(a, b) for a, b in zip(k1, p1))
    assert torch.equal(k10[1], k1[1]) and torch.equal(k10[0], k1[0])
    assert torch.equal(k10[2], k1[2])       # no rotation: v is exact


@pytest.mark.cuda
def test_build_defaults_to_the_card_and_serves_small_batches(dev):
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    data = synthetic_clustered(20000, 128, seed=0)
    kw = dict(kc=64, m=8, k=16, seed=0, coarse_maxiter=3,
              quantization_maxiter=3)
    idx = IVFADCIndex.build(torch.from_numpy(data), **kw)   # CPU tensor in
    assert idx.device.type == "cuda"
    n0 = (dense_scan.PROBE_KERNEL.launches, topk.INDEX_KERNEL.launches)
    ids, dists = idx.search(data[5], 10, w=8)               # per-probe path
    assert (dense_scan.PROBE_KERNEL.launches,
            topk.INDEX_KERNEL.launches) == (n0[0] + 1, n0[1] + 1)
    assert len(ids) == 10 and (np.diff(dists) >= 0).all()
    # the same index on the CPU answers through the plain versions
    cpu = IVFADCIndex.build(data, device="cpu", scan_mode="dense", **kw)
    assert cpu.device.type == "cpu"


@pytest.mark.cuda
def test_build_is_reproducible_across_processes(dev):
    # two builds in this process and one in a fresh process give one digest
    import os
    import subprocess
    import sys
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    from ivfadc_tpu_torch.utils.repro import index_digest
    data = synthetic_clustered(100000, 64, seed=0)
    kw = dict(kc=256, m=8, k=64, seed=0, kmeanspp_sample=16384)
    here = [index_digest(IVFADCIndex.build(data, **kw)) for _ in range(2)]
    assert here[0] == here[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("from ivfadc_tpu_torch import IVFADCIndex\n"
            "from ivfadc_tpu_torch.utils.datasets import synthetic_clustered\n"
            "from ivfadc_tpu_torch.utils.repro import index_digest\n"
            f"kw = {kw!r}\n"
            "data = synthetic_clustered(100000, 64, seed=0)\n"
            "print(index_digest(IVFADCIndex.build(data, **kw)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == here[0]


def _variant_inputs(rng, integer: bool, elem: str, pb: int):
    """Grouped-scan inputs for every variant: 8-row aligned cell starts, an
    empty cell (tiles of size 0), cells that are no 128-multiple, and one
    cell of 126 full blocks plus one row (block index 126, pos8's top)."""
    kc, d, B, w = 8, 128, 16, 4
    sizes = np.array([0, 5, 128, 130, 300, 126 * 128 + 1, 1, 257], np.int32)
    caps = (sizes // 8 + 2) * 8
    offsets = np.concatenate([[8], 8 + np.cumsum(caps[:-1])]).astype(np.int32)
    rows = -(-(int(offsets[-1] + caps[-1]) + 1024 + 128) // 128) * 128
    cells = rng.randint(0, kc, (B, w)).astype(np.int32)
    cells[0, :3] = (0, 5, 7)
    if integer:
        decoded = rng.randint(-3, 4, (rows, d)).astype(np.int8)
        scale = np.ones(d, np.float32)
        v = rng.randint(-4, 5, (B, w, d)).astype(np.float32)
        base = rng.randint(0, 100, (B, w)).astype(np.float32)
        # the big cell's last row (block 126) is the only zero row there:
        # it scores the probe's base, every other row far more
        big = slice(offsets[5], offsets[5] + sizes[5] - 1)
        decoded[big] = 3
        decoded[offsets[5] + sizes[5] - 1] = 0
    else:
        decoded = rng.randint(-127, 128, (rows, d)).astype(np.int8)
        scale = (0.01 + 0.02 * rng.rand(d)).astype(np.float32)
        v = rng.randn(B, w, d).astype(np.float32)
        base = (10 + rng.rand(B, w)).astype(np.float32)
    base[1, 0] = np.inf                         # a padded probe
    dec = torch.from_numpy(decoded)
    sc = torch.from_numpy(scale)
    if elem == "bf16":                          # the rows, no scale
        dec = (dec.float() * sc.to(torch.bfloat16).float()).to(torch.bfloat16)
        sc = None
    return [torch.from_numpy(cells), torch.from_numpy(offsets),
            torch.from_numpy(sizes), torch.from_numpy(v).to(torch.bfloat16),
            torch.from_numpy(base), dec, sc], kc


def _aligned128(args):
    """The same inputs on 128-row aligned cells, with ids2d and norms2d."""
    cells, offsets, sizes, v, base, dec, sc = args
    caps = (sizes.long() // 128 + 1) * 128
    off = torch.cat([torch.zeros(1, dtype=torch.long), torch.cumsum(caps, 0)[:-1]])
    rows = int(off[-1] + caps[-1]) + 1024 + 128
    rows = -(-rows // 128) * 128
    src = torch.arange(rows) % dec.shape[0]
    g = torch.Generator().manual_seed(5)
    ids2d = torch.randperm(rows, generator=g).to(torch.int32).reshape(-1, 128)
    norms2d = torch.randint(0, 50, (rows,), generator=g).float().reshape(-1, 128)
    return [cells, off.to(torch.int32), sizes, v, base, dec[src], sc], \
        ids2d, norms2d


def _close_topk(kd, kp, pd, pp, k):
    """Exact-merge buffers on random floats (f32 sums in another order):
    per probe the sorted k smallest distances agree to f32 rounding, and
    their slots agree on >= 99 %."""
    kd, kp = kd.reshape(-1, kd.shape[-1]), kp.reshape(-1, kp.shape[-1])
    pd, pp = pd.reshape(-1, pd.shape[-1]), pp.reshape(-1, pp.shape[-1])
    ks, ki = torch.sort(kd, dim=1)
    ps, pi = torch.sort(pd, dim=1)
    fin = torch.isfinite(ps[:, :k])
    assert torch.equal(torch.isfinite(ks[:, :k]), fin)
    torch.testing.assert_close(ks[:, :k][fin], ps[:, :k][fin], rtol=1e-5,
                               atol=1e-4)
    ka = torch.gather(kp, 1, ki[:, :k])
    pa = torch.gather(pp, 1, pi[:, :k])
    assert (ka == pa)[fin].float().mean() >= 0.99


_VARIANT_KW = {
    "pos8": dict(merge="fold", nf=128, pos8=True, pb=32),
    "pos": dict(merge="fold", nf=256, pos8=False, pb=16),
    "exact": dict(merge="exact", nf=128, pb=64),
    "extract": dict(merge="fold", nf=256, extract_k=10, pb=16),
    "ids": dict(merge="fold", nf=128, pb=64),
    "knorm": dict(merge="fold", nf=128, pb=8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(_VARIANT_KW))
@pytest.mark.parametrize("elem", ["int8", "bf16"])
@pytest.mark.parametrize("integer", [True, False])
def test_grouped_scan_variant_kernels(dev, variant, elem, integer):
    kw = dict(_VARIANT_KW[variant])
    args, kc = _variant_inputs(np.random.RandomState(len(variant)), integer,
                               elem, kw["pb"])
    ids2d = norms2d = None
    if variant in ("extract", "ids", "knorm"):
        args, ids2d, norms2d = _aligned128(args)
        if variant != "ids":
            norms2d = None
    kern = dense_scan.GROUPED_KERNELS[variant, elem]
    call = dict(kc=kc, k_out=10, chunk=1024, norm_coef=1.0, **kw)
    n0 = kern.launches
    kd, kp = dense_scan.grouped_dense_scan(
        *[None if a is None else a.to(dev) for a in args],
        None if ids2d is None else ids2d.to(dev),
        None if norms2d is None else norms2d.to(dev), **call)
    assert kern.launches == n0 + 1
    pd, pp = dense_scan.grouped_dense_scan(*args, ids2d, norms2d, **call)
    assert kern.launches == n0 + 1                   # plain path: no launch
    assert kp.dtype == pp.dtype == (torch.int8 if variant == "pos8"
                                    else torch.int32)
    kd, kp = kd.cpu(), kp.cpu()
    assert torch.isinf(pd[0, 0]).all() and (pp[0, 0] == -1).all()  # empty
    assert torch.isinf(pd[1, 0]).all() and (pp[1, 0] == -1).all()  # +inf base
    if integer:             # every f32 sum exact: bit for bit, any variant
        assert torch.equal(kd, pd) and torch.equal(kp, pp)
        if variant.startswith("pos"):       # block 126 of the big cell
            assert (pp[0, 1] == 126).any()
    elif variant == "exact":
        _close_topk(kd, kp, pd, pp, 10)
    else:                   # f32 sums in another order
        fin = torch.isfinite(pd)
        assert torch.equal(torch.isfinite(kd), fin)
        torch.testing.assert_close(kd[fin], pd[fin], rtol=1e-5, atol=1e-4)
        assert (kp == pp).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["fold", "exact"])
@pytest.mark.parametrize("elem", ["int8", "bf16"])
@pytest.mark.parametrize("integer", [True, False])
def test_probe_scan_variant_kernels(dev, merge, elem, integer):
    args = _probe_inputs(np.random.RandomState(7), integer)
    if elem == "bf16":
        args[4] = (args[4].float() * args[5].to(torch.bfloat16).float()) \
            .to(torch.bfloat16)
        args[5] = None
    kw = dict(k_out=10, chunk=256, norm_coef=1.0, nf=128, merge=merge)
    kern = dense_scan.PROBE_KERNELS[merge, elem]
    n0 = kern.launches
    kd, kp = dense_scan.dense_scan(
        *[None if a is None else a.to(dev) for a in args], **kw)
    _finish()
    assert kern.launches == n0 + 1
    pd, pp = dense_scan.dense_scan(*args, **kw)
    kd, kp = kd.cpu(), kp.cpu()
    assert torch.isinf(pd[0, 0]).all() and (pp[0, 0] == -1).all()
    if integer:
        assert torch.equal(kd, pd) and torch.equal(kp, pp)
    elif merge == "exact":
        _close_topk(kd, kp, pd, pp, 10)
    else:
        fin = torch.isfinite(pd)
        assert torch.equal(torch.isfinite(kd), fin)
        torch.testing.assert_close(kd[fin], pd[fin], rtol=1e-5, atol=1e-4)
        assert (kp == pp).float().mean() >= 0.99


@pytest.mark.cuda
def test_sort_prep_feeds_the_scan_kernel_deterministically(dev):
    # kc = 8192 > MAX_KC: ranks from one sort; two calls give the same
    # tiles, and kernel 3 on them equals its plain version
    rng = np.random.RandomState(3)
    kc, d, B, w, pb = 8192, 128, 512, 8, 16
    sizes = rng.randint(0, 200, kc).astype(np.int32)
    caps = (sizes // 128 + 1) * 128
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])]).astype(np.int32)
    rows = -(-(int(offsets[-1] + caps[-1]) + 1024 + 128) // 128) * 128
    cells = np.where(rng.rand(B, w) < 0.5, rng.randint(0, 16, (B, w)),
                     rng.randint(0, kc, (B, w))).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (cells, offsets, sizes)]
    v = torch.from_numpy(rng.randint(-4, 5, (B, w, d)).astype(np.float32)) \
        .to(torch.bfloat16).to(dev)
    base = torch.from_numpy(rng.randint(0, 100, (B, w)).astype(np.float32)) \
        .to(dev)
    first = dense_scan.place_tiles(*t, v, base, kc=kc, pb=pb)
    second = dense_scan.place_tiles(*t, v, base, kc=kc, pb=pb)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    plain = dense_scan.place_tiles(*[a.cpu() for a in t], v.cpu(),
                                   base.cpu(), kc=kc, pb=pb)
    for a, b in zip(first, plain):
        assert torch.equal(a.cpu(), b)
    dec = torch.from_numpy(rng.randint(-3, 4, (rows, d)).astype(np.int8))
    ids2d = torch.from_numpy(rng.permutation(rows).astype(np.int32)
                             .reshape(-1, 128))
    norms2d = torch.from_numpy(rng.randint(0, 50, rows).astype(np.float32)
                               .reshape(-1, 128))
    call = dict(kc=kc, k_out=10, chunk=256, norm_coef=1.0, pb=pb)
    n0 = dense_scan.KERNEL.launches
    kd, kp = dense_scan.grouped_dense_scan(
        *t, v, base, dec.to(dev), torch.ones(d, device=dev), ids2d.to(dev),
        norms2d.to(dev), **call)
    assert dense_scan.KERNEL.launches == n0 + 1
    pd, pp = dense_scan.grouped_dense_scan(
        *[a.cpu() for a in t], v.cpu(), base.cpu(), dec, torch.ones(d), ids2d,
        norms2d, **call)
    assert torch.equal(kd.cpu(), pd) and torch.equal(kp.cpu(), pp)


@pytest.mark.cuda
def test_kc_8192_index_takes_the_grouped_scan(dev):
    # kc = 8192 > 4096 at B*w = 4*kc: the sort-based tile prep feeds kernel
    # 3 (128-row cells); the counting-rank kernel stays idle. The same
    # queries in per-probe batches find near-identical neighbours
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    data = synthetic_clustered(40000, 64, seed=0)
    idx = IVFADCIndex.build(data, kc=8192, m=8, k=16, seed=0,
                            coarse_maxiter=3, quantization_maxiter=3)
    q = data[:4096]
    n0 = (dense_scan.KERNEL.launches, cell_rank.KERNEL.launches,
          dense_scan.PROBE_KERNEL.launches)
    ids, dists = idx.search_padded(q, 10, w=8)           # 4096 * 8 = 4 * kc
    assert (dense_scan.KERNEL.launches, cell_rank.KERNEL.launches,
            dense_scan.PROBE_KERNEL.launches) == (n0[0] + 1, n0[1], n0[2])
    assert (ids >= 0).all() and (np.diff(dists, axis=1) >= 0).all()
    small = np.concatenate([idx.search_padded(q[s:s + 512], 10, w=8)[0]
                            for s in range(0, 4096, 512)])
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, small)])
    assert overlap >= 0.95, overlap


# ------------------------------------------------- the opt-in engines
@pytest.mark.cuda
@pytest.mark.parametrize("kc,P", [(300, 5000), (4096, 5000), (1024, 131072),
                                  (1, 3000)])
def test_cell_rank_v2_kernel_exact(dev, kc, P):
    rng = np.random.RandomState(kc + P)
    cells = np.where(rng.rand(P) < 0.3, rng.randint(0, min(kc, 5), P),
                     rng.randint(0, kc, P)).astype(np.int32)
    c = torch.from_numpy(cells)
    n0 = cell_rank.KERNEL_V2.launches
    kr, kn = cell_rank.cell_ranks(c.to(dev), kc=kc, engine="v2")
    assert cell_rank.KERNEL_V2.launches == n0 + 1
    pr, pn = cell_rank.cell_ranks_plain(c, kc)
    assert torch.equal(kr.cpu(), pr) and torch.equal(kn.cpu(), pn)
    # cells outside [0, kc): counted nowhere, ranked as kernel 2 ranks them
    bad = c.clone()
    bad[::7] = -1
    bad[3::11] = kc + 3
    k1 = cell_rank.cell_ranks(bad.to(dev), kc=kc, engine="v1")
    k2 = cell_rank.cell_ranks(bad.to(dev), kc=kc, engine="v2")
    assert torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1])


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["v1", "v2"])
@pytest.mark.parametrize("P,kc,pb", [
    (131072, 1024, 16),     # the SIFT1M batch (B = 16384, w = 8)
    (131072, 512, 64),      # stage 2 of the large-kc probe (g = 512)
    (5000, 4096, 64),       # kc = MAX_KC, most cells empty
    (3000, 1, 8),           # one cell
    (1048576, 4096, 64),    # several 1024-probe blocks per resident block
])
def test_tile_slots_kernel_exact(dev, P, kc, pb, engine):
    # the fused prep (ranks, counts, tile map, row, inv_row) in one launch,
    # bit-equal to its plain version; a second call equals the first (the
    # grid barrier resets itself); ranks mode at the same shape too
    rng = np.random.RandomState(P + kc + pb)
    cells = np.where(rng.rand(P) < 0.3, rng.randint(0, min(kc, 5), P),
                     rng.randint(0, kc, P)).astype(np.int32)
    if kc > 1:
        cells[cells == 1] = 0                       # an empty cell
    sizes = rng.randint(0, 400, kc).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes[:-1] + 7)]) \
        .astype(np.int32)
    t = [torch.from_numpy(a) for a in (cells, offsets, sizes)]
    kern = cell_rank.KERNELS[engine]
    n0 = kern.launches
    first = cell_rank.tile_slots(*[a.to(dev) for a in t], kc=kc, pb=pb,
                                 engine=engine)
    assert kern.launches == n0 + 1
    second = cell_rank.tile_slots(*[a.to(dev) for a in t], kc=kc, pb=pb,
                                  engine=engine)
    assert kern.launches == n0 + 2
    _finish()
    plain = cell_rank.tile_slots_plain(*t, kc=kc, pb=pb)
    for a, b, c in zip(first, second, plain):
        assert a.dtype == c.dtype and torch.equal(a, b)
        assert torch.equal(a.cpu(), c)
    kr, kn = cell_rank.cell_ranks(t[0].to(dev), kc=kc, engine=engine)
    assert kern.launches == n0 + 3
    pr, pn = cell_rank.cell_ranks_plain(t[0], kc)
    assert torch.equal(kr.cpu(), pr) and torch.equal(kn.cpu(), pn)


@pytest.mark.cuda
def test_tile_slots_kernel_edges(dev):
    # no probes, and probes that fill their tiles exactly: one launch each,
    # bit-equal to the plain version
    for cells, kc, pb in ((np.zeros(0, np.int32), 7, 16),
                          (np.repeat(np.arange(8, dtype=np.int32), 64), 8,
                           64)):
        sizes = np.arange(1, kc + 1, dtype=np.int32)
        offsets = np.cumsum(sizes).astype(np.int32) - sizes
        t = [torch.from_numpy(a) for a in (cells, offsets, sizes)]
        n0 = cell_rank.KERNEL.launches
        got = cell_rank.tile_slots(*[a.to(dev) for a in t], kc=kc, pb=pb)
        assert cell_rank.KERNEL.launches == n0 + 1
        for a, b in zip(got, cell_rank.tile_slots_plain(*t, kc=kc, pb=pb)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cell_ranks_out_of_range_rule(dev):
    # cells outside [0, kc) are counted nowhere and ranked among the
    # earlier equal cells of their own 32-probe warp; the rest as a stable
    # sort ranks them
    kc = 8
    cells = np.random.RandomState(1).randint(-3, kc + 3, 3000) \
        .astype(np.int32)
    pr, pn = cell_rank.cell_ranks_plain(torch.from_numpy(cells), kc)
    want = pr.numpy().copy()
    for p in np.nonzero((cells < 0) | (cells >= kc))[0]:
        want[p] = np.sum(cells[p - p % 32:p] == cells[p])
    for engine in ("v1", "v2"):
        kr, kn = cell_rank.cell_ranks(torch.from_numpy(cells).to(dev),
                                      kc=kc, engine=engine)
        np.testing.assert_array_equal(kr.cpu().numpy(), want)
        assert torch.equal(kn.cpu(), pn)


@pytest.mark.cuda
def test_rank_fit_two_blocks_an_sm(dev):
    # two 1024-thread blocks an SM in both modes at every kc; the tile
    # kernel (the search path's) spills nothing, the ranks-only one at most
    # the one word ptxas keeps there at 32 registers
    for kc in (1, 1024, 4096):
        for tiles in (False, True):
            fit = cell_rank.rank_fit(dev, kc, tiles)
            assert fit["blocks_per_sm"] == 2, fit
            assert fit["spill_bytes"] <= (0 if tiles else 8), fit
            assert fit["max_grid"] == fit["blocks_per_sm"] * fit["sms"]


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [1024, 3000])
@pytest.mark.parametrize("apply_rot", [False, True])
def test_coarse_probe_v2_kernel(dev, kc, apply_rot):
    # kc = 3000: not a 128-multiple, more than one split of the table
    rng = np.random.RandomState(kc + int(apply_rot))
    q = torch.from_numpy(rng.randn(256, 128).astype(np.float32))
    c = torch.from_numpy(rng.randn(kc, 128).astype(np.float32))
    rot = torch.from_numpy(np.linalg.qr(rng.randn(128, 128))[0]
                           .astype(np.float32))
    kw = dict(engine="v2", rot_orthogonal=True)
    n0 = coarse_scan.V2_KERNEL.launches
    kcells, kd, kv, kb = coarse_scan.coarse_probe_vbase(
        q.to(dev), c.to(dev), 8, rot.to(dev), apply_rot, True, **kw)
    assert coarse_scan.V2_KERNEL.launches == n0 + 1
    pcells, pd, pv, pb = coarse_scan.coarse_probe_vbase(
        q, c, 8, rot, apply_rot, True, **kw)
    # the selection is kernel 1's, bit for bit
    v1cells = coarse_scan.coarse_probe_vbase(
        q.to(dev), c.to(dev), 8, rot.to(dev), apply_rot, True,
        engine="v1")[0]
    assert torch.equal(kcells, v1cells)
    same = kcells.cpu() == pcells
    assert same.float().mean() >= 0.999       # near-ties may flip
    torch.testing.assert_close(kd.cpu(), pd, rtol=1e-5, atol=1e-4)
    assert torch.equal(kb, kd + kd)
    if apply_rot:
        torch.testing.assert_close(kv.cpu()[same].float(), pv[same].float(),
                                   rtol=2 ** -7, atol=1e-6)
    else:
        assert torch.equal(kv.cpu()[same], pv[same])


def _qc_case(rng, integer: bool, d: int, pb: int, elem: str, apply_rot: bool,
             device):
    """qc tile inputs (via the route's own prep) of 12 cells, 64 queries x 8
    probes: integer-valued (exact) or random floats."""
    kc, B, w = 12, 64, 8
    caps = np.full(kc, 640)
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])]).astype(np.int32)
    sizes = rng.randint(0, 640, kc).astype(np.int32)
    sizes[:3] = [0, 1, 128]
    rows = -(-(int(caps.sum()) + 256 + 128) // 128) * 128
    cells = rng.randint(0, kc, (B, w)).astype(np.int32)
    ids2d = rng.permutation(rows).astype(np.int32).reshape(-1, 128)
    if integer:
        decoded = rng.randint(-3, 4, (rows, d)).astype(np.float32)
        scale = np.ones(d, np.float32)
        q = rng.randint(-4, 5, (B, d)).astype(np.float32)
        cents = rng.randint(-4, 5, (kc, d)).astype(np.float32)
        rot = np.zeros((d, d), np.float32)
        rot[np.arange(d), rng.permutation(d)] = rng.choice([-1.0, 1.0], d)
    else:
        decoded = rng.randint(-127, 128, (rows, d)).astype(np.float32)
        scale = (0.01 + 0.02 * rng.rand(d)).astype(np.float32)
        cents = rng.randn(kc, d).astype(np.float32)
        q = (cents[rng.randint(0, kc, B)]
             + 0.5 * rng.randn(B, d)).astype(np.float32)
        rot = np.linalg.qr(rng.randn(d, d))[0].astype(np.float32)
    t = {k: torch.from_numpy(v).to(device) for k, v in dict(
        cells=cells, offsets=offsets, sizes=sizes, q=q, cents=cents, rot=rot,
        decoded=decoded, scale=scale, ids2d=ids2d).items()}
    if elem == "bf16":
        sc = t["scale"].to(torch.bfloat16).float()
        dec, scale_t = (t["decoded"] * sc).to(torch.bfloat16), None
    else:
        dec, scale_t = t["decoded"].to(torch.int8), t["scale"]
    prep = dense_scan.qc_tile_inputs(
        t["cells"], t["offsets"], t["sizes"], t["q"], t["cents"],
        t["rot"] if apply_rot else None, d, kc=kc, pb=pb)
    return prep[:7] + (dec, scale_t, t["ids2d"])


@pytest.mark.cuda
@pytest.mark.parametrize("pb,d", [(16, 128), (64, 128), (64, 256)])
@pytest.mark.parametrize("apply_rot", [False, True])
@pytest.mark.parametrize("elem", ["int8", "bf16"])
@pytest.mark.parametrize("integer", [True, False])
def test_grouped_scan_qc_kernel(dev, pb, d, apply_rot, elem, integer):
    rng = np.random.RandomState(pb + d + int(apply_rot))
    args = _qc_case(rng, integer, d, pb, elem, apply_rot, dev)
    kw = dict(pb=pb, nf=128, norm_coef=1.0, base_mult=2.0,
              apply_rot=apply_rot)
    kern = dense_scan.QC_KERNELS[elem]
    T = args[0].shape[0]
    n0 = kern.launches
    kd, kp = dense_scan.grouped_scan_qc(
        *args, **kw, **dense_scan.tile_order(T, pb, dev))
    assert kern.launches == n0 + 1
    pd, pp = dense_scan.grouped_scan_qc_plain(
        *[None if a is None else a.cpu() for a in args], **kw,
        **dense_scan.tile_order(T, pb, "cpu"))
    kd, kp = kd.cpu(), kp.cpu()
    if integer:
        assert torch.equal(kd, pd) and torch.equal(kp, pp)
        return
    fin = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(kd), fin)
    # bf16 products and squares summed in f32 in another order (and the
    # rotated r in another order than the plain matmul's)
    torch.testing.assert_close(kd[fin], pd[fin], rtol=1e-4, atol=1e-3)
    assert (kp == pp).float().mean().item() >= 0.999


def _edge_tiles(rng, integer: bool, elem: str, pb: int, d: int):
    """Hand-placed grouped-scan tiles at the kernel's edges: cells of 1000,
    1, 127, 129, 0 and 300 rows (128-row aligned starts); dead probes (+inf
    base) scattered inside tiles, whole 16-probe m-tiles dead beside live
    ones, an all-dead tile and an empty tile with live probes."""
    sizes = np.array([1000, 1, 127, 129, 0, 300])
    caps = np.maximum(1, -(-sizes // 128)) * 128
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])])
    rows = int(caps.sum()) + 128
    slots = np.arange(pb)
    tiles = [(0, (slots == 1) | (slots == 5) | ((slots >= 16) & (slots < 32))),
             (1, slots < 0), (2, slots == pb - 1), (3, slots == 0),
             (4, slots < 0), (5, slots >= 0), (0, slots < 16),
             (5, slots % 2 == 0)]
    T = len(tiles)
    tstart = np.array([offsets[c] for c, _ in tiles], np.int32)
    tsize = np.array([sizes[c] for c, _ in tiles], np.int32)
    dead = np.concatenate([m for _, m in tiles])
    if integer:
        decoded = rng.randint(-3, 4, (rows, d)).astype(np.int8)
        scale = np.ones(d, np.float32)
        v = rng.randint(-4, 5, (T * pb, d)).astype(np.float32)
        base = rng.randint(0, 100, T * pb).astype(np.float32)
        norms = rng.randint(0, 50, rows).astype(np.float32)
    else:
        decoded = rng.randint(-127, 128, (rows, d)).astype(np.int8)
        scale = (0.01 + 0.02 * rng.rand(d)).astype(np.float32)
        v = rng.randn(T * pb, d).astype(np.float32)
        base = (10 + rng.rand(T * pb)).astype(np.float32)
        norms = (5 + rng.rand(rows)).astype(np.float32)
    base[dead] = np.inf
    dec = torch.from_numpy(decoded)
    sc = torch.from_numpy(scale)
    if elem == "bf16":
        dec = (dec.float() * sc.to(torch.bfloat16).float()).to(torch.bfloat16)
        sc = None
    ids2d = torch.from_numpy(rng.permutation(rows).astype(np.int32)
                             .reshape(-1, 128))
    return [torch.from_numpy(tstart), torch.from_numpy(tsize),
            torch.from_numpy(v).to(torch.bfloat16),
            torch.from_numpy(base).reshape(-1, 1), dec, sc, ids2d,
            torch.from_numpy(norms).reshape(-1, 128)]


_EDGE_VARIANTS = {"ids": {}, "knorm": dict(norms=False),
                  "pos": dict(ids=False, norms=False),
                  "exact": dict(ids=False, norms=False, merge="exact",
                                k_out=10),
                  "extract": dict(norms=False, extract_k=10)}


_EDGE_SHAPES = [(pb, d, nf, variant)
                for pb, d, nf in [(8, 128, 128), (24, 128, 128),
                                  (64, 128, 128), (64, 256, 128),
                                  (16, 128, 512), (16, 128, 1024)]
                for variant in _EDGE_VARIANTS
                if variant != "exact" or nf == 128]   # exact: nf = 128


@pytest.mark.cuda
@pytest.mark.parametrize("pb,d,nf,variant", _EDGE_SHAPES)
@pytest.mark.parametrize("elem", ["int8", "bf16"])
@pytest.mark.parametrize("integer", [True, False])
def test_grouped_scan_kernel_edges(dev, pb, d, nf, variant, elem, integer):
    # the tensor-core scan's edges: partial m-tiles (pb 8, 24), skipped
    # m-tiles beside live ones, two feature blocks (d 256), fold buffers in
    # shared memory (nf 512, 1024: one staged tile), cells of 1, 127, 129,
    # 1000 rows, an empty and an all-dead tile
    kw = dict(_EDGE_VARIANTS[variant])
    rng = np.random.RandomState(pb + d + nf + len(variant))
    args = _edge_tiles(rng, integer, elem, pb, d)
    if not kw.pop("ids", True):
        args[6] = None
    if not kw.pop("norms", True):
        args[7] = None
    call = dict(pb=pb, nf=nf, norm_coef=1.0, **kw)
    kern = dense_scan.GROUPED_KERNELS[variant, elem]
    n0 = kern.launches
    kd, kp = dense_scan.grouped_scan(
        *[None if a is None else a.to(dev) for a in args], **call,
        **dense_scan.tile_order(8, pb, dev))
    assert kern.launches == n0 + 1
    pd, pp = dense_scan.grouped_scan(*args, **call,
                                     **dense_scan.tile_order(8, pb, "cpu"))
    kd, kp = kd.cpu(), kp.cpu()
    width = kd.shape[1]
    dead = torch.isinf(args[3].reshape(-1))
    empty = torch.repeat_interleave(args[1] == 0, pb)
    assert torch.isinf(pd[dead | empty]).all()
    assert (pp[dead | empty] == -1).all()
    assert kd.shape == pd.shape == (8 * pb, width)
    if integer:             # every f32 sum exact: bit for bit
        assert torch.equal(kd, pd) and torch.equal(kp, pp)
    elif variant == "exact":
        _close_topk(kd, kp, pd, pp, 10)
    else:                   # f32 sums in another order
        fin = torch.isfinite(pd)
        assert torch.equal(torch.isfinite(kd), fin)
        torch.testing.assert_close(kd[fin], pd[fin], rtol=1e-5, atol=1e-4)
        assert (kp == pp).float().mean() >= 0.99


def _gather_map(inv_row, n_rows: int):
    """Each row's slot under a slot map (the prep's `row`): the gather
    that reads a tile-order output in probe order."""
    live = torch.nonzero(inv_row < n_rows).reshape(-1)
    row = torch.empty(n_rows, dtype=torch.int64, device=inv_row.device)
    row[inv_row[live]] = live
    return row


def _same_rows(placed, tiled, inv_row, n_rows: int) -> None:
    """The probe-order outputs equal the tile-order ones gathered, bit for
    bit (payloads of every kind, +inf and -1 included)."""
    row = _gather_map(inv_row, n_rows)
    for a, b in zip(placed, tiled):
        assert a.shape == (n_rows,) + b.shape[1:] and a.dtype == b.dtype
        assert torch.equal(a, b[row])


@pytest.mark.cuda
@pytest.mark.parametrize("pb,d,nf,variant", _EDGE_SHAPES)
@pytest.mark.parametrize("elem", ["int8", "bf16"])
def test_grouped_scan_kernel_edges_in_probe_order(dev, pb, d, nf, variant,
                                                  elem):
    """The edge tiles above plus a size-0 tile with no live slot, written by
    a slot map that sends the live probes to a random permutation of the
    rows and drops the dead slots: equal, bit for bit, to the tile-order
    output gathered by each row's slot. That covers an empty cell's tile
    with live slots (+inf / -1 rows), a tile of rows with no live slot
    (scored, nothing written) and a trailing tile (nothing at all)."""
    from ivfadc_tpu_torch.utils import profiling
    kw = dict(_EDGE_VARIANTS[variant])
    rng = np.random.RandomState(pb + d + nf + len(variant))
    args = _edge_tiles(rng, False, elem, pb, d)
    if not kw.pop("ids", True):
        args[6] = None
    if not kw.pop("norms", True):
        args[7] = None
    args[0] = torch.cat([args[0], torch.zeros(1, dtype=torch.int32)])
    args[1] = torch.cat([args[1], torch.zeros(1, dtype=torch.int32)])
    args[2] = torch.cat([args[2], torch.zeros((pb, d), dtype=torch.bfloat16)])
    args[3] = torch.cat([args[3], torch.full((pb, 1), float("inf"))])
    args = [None if a is None else a.to(dev) for a in args]
    T = args[0].shape[0]
    live = torch.isfinite(args[3].reshape(-1))
    n = int(live.sum())
    inv_row = torch.full((T * pb,), n, dtype=torch.int64, device=dev)
    inv_row[live] = torch.from_numpy(rng.permutation(n)).to(dev)
    call = dict(pb=pb, nf=nf, norm_coef=1.0, **kw)
    with profiling.counting() as counts:
        placed = dense_scan.grouped_scan(*args, **call, slot_row=inv_row,
                                         n_rows=n)
    assert counts["scan_probe_order_launches"] == 1
    tiled = dense_scan.grouped_scan(*args, **call,
                                    **dense_scan.tile_order(T, pb, dev))
    _same_rows(placed, tiled, inv_row, n)


# the cells' shapes: cache width, batch, kc (w = 8, 64-probe tiles, nf =
# 128), and the kc > MAX_KC sort prep
_CELL_SHAPES = {"sift_b10240": (128, 10240, 1024),
                "sift_b65536": (128, 65536, 1024),
                "gist_b10240": (1024, 10240, 1024),
                "sort_kc8192": (128, 4096, 8192)}
_CELL_VARIANTS = {"ids": dict(ids=True, norms=True), "knorm": dict(ids=True),
                  "pos8": dict(pos8=True), "pos": {},
                  "exact": dict(merge="exact", k_out=10),
                  "extract": dict(ids=True, extract_k=10),
                  "qc": dict(ids=True)}
# the exact merge and the qc kernel do not fit a block's shared memory at
# d_pad = 1024 (their plans refuse it), and no route takes them there
_CELL_CASES = [(shape, variant, elem) for shape in _CELL_SHAPES
               for variant in _CELL_VARIANTS for elem in ("int8", "bf16")
               if not (shape.startswith("gist") and variant in ("exact",
                                                                "qc"))]


@pytest.fixture(scope="module")
def cell_inputs():
    """Per shape, an index-like layout made on the card: kc 128-row aligned
    cells (kc = 1024: 1-1954 rows, about SIFT1M's 977 on average; kc =
    8192: 0-199), four of them empty and probed; both caches, ids and
    norms; B x 8 probes over uniform cells with v, base, queries and
    centroids. Layouts are shared by shapes of one (d, kc)."""
    made, layouts = {}, {}

    def get(shape):
        if shape in made:
            return made[shape]
        d, B, kc = _CELL_SHAPES[shape]
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(d + kc)
        if (d, kc) not in layouts:
            hi = 1955 if kc <= 1024 else 200
            sizes = torch.randint(1, hi, (kc,), generator=g, device=dev)
            sizes[:4] = 0
            caps = torch.clamp_min((sizes + 127) // 128, 1) * 128
            offsets = torch.cumsum(caps, 0) - caps
            rows = int(caps.sum()) + 128
            dec = torch.randint(-127, 128, (rows, d), generator=g,
                                device=dev, dtype=torch.int8)
            scale = 0.01 + 0.02 * torch.rand(d, generator=g, device=dev)
            layouts[d, kc] = types.SimpleNamespace(
                sizes=sizes.to(torch.int32), offsets=offsets.to(torch.int32),
                caches={"int8": (dec, scale), "bf16": (
                    (dec.float() * scale.to(torch.bfloat16).float())
                    .to(torch.bfloat16), None)},
                ids2d=torch.randperm(rows, generator=g, device=dev)
                .to(torch.int32).reshape(-1, 128),
                norms2d=5 + torch.rand((rows // 128, 128), generator=g,
                                       device=dev),
                cents=torch.randn((kc, d), generator=g, device=dev))
        cells = torch.randint(0, kc, (B, 8), generator=g, device=dev)
        hit = torch.rand((B, 8), generator=g, device=dev) < 0.002
        cells = torch.where(hit, cells % 4, cells).to(torch.int32)
        made[shape] = types.SimpleNamespace(
            lay=layouts[d, kc], d=d, B=B, kc=kc, cells=cells,
            v=torch.randn((B, 8, d), generator=g, device=dev)
            .to(torch.bfloat16),
            base=10 + torch.rand((B, 8), generator=g, device=dev),
            q=torch.randn((B, d), generator=g, device=dev))
        return made[shape]
    return get


@pytest.mark.cuda
@pytest.mark.parametrize("shape,variant,elem", _CELL_CASES)
def test_grouped_scan_probe_order_at_the_cells_shapes(dev, cell_inputs,
                                                      shape, variant, elem):
    """Every grouped variant and cache at the benchmark cells' shapes
    (SIFT1M at B = 10,240 and 65,536, GIST1M's 1,024-lane cache at B =
    10,240) and through the sort prep (kc = 8192): the kernel's probe-order
    rows equal, bit for bit, its tile-order rows gathered by each probe's
    slot, which is what the search returned before the kernel wrote probe
    order; the batch holds an empty cell's tiles with live slots and tiles
    past the last one it needs. The launch counts one probe-order launch,
    the tile-order one none."""
    from ivfadc_tpu_torch.utils import profiling
    x = cell_inputs(shape)
    lay, P, pb = x.lay, x.B * 8, 64
    dec, scale = lay.caches[elem]
    opts = dict(_CELL_VARIANTS[variant])
    ids = lay.ids2d if opts.pop("ids", False) else None
    norms = lay.norms2d if opts.pop("norms", False) else None
    if variant == "qc":
        prep = dense_scan.qc_tile_inputs(x.cells, lay.offsets, lay.sizes,
                                         x.q, lay.cents, None, x.d, kc=x.kc,
                                         pb=pb)
        args, inv_row, scan = prep[:7] + (dec, scale, ids), prep[7], \
            dense_scan.grouped_scan_qc
        kw = dict(pb=pb, nf=128, norm_coef=1.0, base_mult=2.0,
                  apply_rot=False)
    else:
        *tiles, inv_row = dense_scan.place_tiles(
            x.cells, lay.offsets, lay.sizes, x.v, x.base, kc=x.kc, pb=pb)
        args, scan = tuple(tiles) + (dec, scale, ids, norms), \
            dense_scan.grouped_scan
        kw = dict(pb=pb, nf=128, norm_coef=1.0, **opts)
    T = args[0].shape[0]
    live = (inv_row < P).reshape(T, pb)
    assert ((args[1] == 0) & live.any(1)).any()
    assert (~live).all(1).any()
    with profiling.counting() as counts:
        placed = scan(*args, **kw, slot_row=inv_row, n_rows=P)
        tiled = scan(*args, **kw, **dense_scan.tile_order(T, pb, dev))
    assert counts["scan_probe_order_launches"] == 1
    _same_rows(placed, tiled, inv_row, P)
    empty = (x.cells < 4).reshape(-1)
    assert torch.isinf(placed[0][empty]).all()
    assert (placed[1][empty] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("pb", [8, 24])
@pytest.mark.parametrize("elem", ["int8", "bf16"])
@pytest.mark.parametrize("integer", [True, False])
def test_grouped_scan_qc_kernel_partial_m_tiles(dev, pb, elem, integer):
    # the qc kernel at tile sizes that leave a partial 16-probe m-tile
    rng = np.random.RandomState(pb + 3)
    args = _qc_case(rng, integer, 128, pb, elem, False, dev)
    kw = dict(pb=pb, nf=128, norm_coef=1.0, base_mult=2.0, apply_rot=False)
    kern = dense_scan.QC_KERNELS[elem]
    T = args[0].shape[0]
    n0 = kern.launches
    kd, kp = dense_scan.grouped_scan_qc(
        *args, **kw, **dense_scan.tile_order(T, pb, dev))
    assert kern.launches == n0 + 1
    pd, pp = dense_scan.grouped_scan_qc_plain(
        *[None if a is None else a.cpu() for a in args], **kw,
        **dense_scan.tile_order(T, pb, "cpu"))
    kd, kp = kd.cpu(), kp.cpu()
    if integer:
        assert torch.equal(kd, pd) and torch.equal(kp, pp)
        return
    fin = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(kd), fin)
    torch.testing.assert_close(kd[fin], pd[fin], rtol=1e-4, atol=1e-3)
    assert (kp == pp).float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("variant,elem", [("ids", "int8"), ("knorm", "int8"),
                                          ("exact", "int8"),
                                          ("extract", "int8"),
                                          ("ids", "bf16")])
def test_grouped_scan_launch_shape(dev, variant, elem):
    # the main paths' shape (pb 64, nf 128, d 128): staged tiles in turn
    # (int8: two converted tiles; bf16: three ring slots), the
    # fold in registers (shared memory for the exact merge), the block's
    # 512 threads resident
    fit = dense_scan.scan_fit(dense_scan.GROUPED_KERNELS[variant, elem].fn,
                              128, 64, 128, 10)
    assert fit["blocks_per_sm"] >= 1
    assert fit["tile_stages"] == (2 if elem == "int8" else 3)
    assert fit["fold"] == ("shared" if variant == "exact" else "registers")


# The per-probe scan's shapes: cells of every size class (empty, one row,
# under and over one 32-row stage and one 128-row group, many groups),
# fold widths 128-512, cache widths 128 / 256, v narrower than the cache,
# one probe, and far more probes than the persistent grid holds: small
# cells (posting), and 1000-4000-row cells whose groups the fold splits
# over a block's warps, several split probes a block, so the merge slots
# are reused (big).
_PROBE_SIZES = np.array([0, 1, 7, 8, 27, 127, 128, 129, 1000, 4000])
_PROBE_CASES = {
    "nf128_d128": dict(nf=128, d=128, dv=128, P=96),
    "nf256_d128": dict(nf=256, d=128, dv=128, P=96),
    "nf512_d256": dict(nf=512, d=256, dv=256, P=96),
    "nf128_d256": dict(nf=128, d=256, dv=200, P=96),
    "p1": dict(nf=128, d=128, dv=128, P=1),
    "p131072_dv96": dict(nf=128, d=128, dv=96, P=131072, cells="posting"),
    "p4096_big_nf128": dict(nf=128, d=128, dv=128, P=4096, cells="big"),
    "p4096_big_nf512": dict(nf=512, d=128, dv=128, P=4096, cells="big"),
}


def _probe_plain(args, held, kw, dev):
    """probe_scan_plain on the card, on the held probes: v padded to the
    cache's width, the int8 scales rounded to bf16 as the wrapper does."""
    starts, sizes, v, base, decoded, scale = args
    d = decoded.shape[1]
    v = torch.nn.functional.pad(v.reshape(v.shape[0], -1),
                                (0, d - v.shape[-1]))
    sc = None if scale is None else \
        scale.to(torch.bfloat16).to(torch.float32).to(dev)
    return dense_scan.probe_scan_plain(
        starts.reshape(-1)[held].to(dev), sizes.reshape(-1)[held].to(dev),
        base.reshape(-1)[held].to(dev),
        v[held].to(torch.bfloat16).to(dev), decoded.to(dev), sc,
        nf=kw["nf"], norm_coef=kw["norm_coef"], merge=kw["merge"],
        k_out=kw["k_out"])


def _probe_case(case: str, integer: bool, elem: str, seed: int):
    """(args of dense_scan, nf, probes to hold against the plain version):
    8-row-aligned cells, no guard rows past the last one; runs of
    consecutive probes of one cell; two +inf bases."""
    c = _PROBE_CASES[case]
    rng = np.random.RandomState(seed)
    d, dv, P = c["d"], c["dv"], c["P"]
    if c.get("cells") == "posting":          # cells of ~28 rows
        sizes = np.concatenate([_PROBE_SIZES[:5],
                                rng.randint(1, 60, 4091)]).astype(np.int32)
    elif c.get("cells") == "big":
        sizes = np.concatenate([[0, 1000, 4000],
                                rng.randint(1000, 4001, 29)]).astype(np.int32)
    else:
        sizes = _PROBE_SIZES.astype(np.int32)
    caps = (sizes + 7) // 8 * 8
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])]).astype(np.int32)
    rows = int(caps.sum())
    if P == 1:
        cells = np.array([len(sizes) - 1])
    else:
        cells = np.repeat(rng.randint(0, len(sizes), P // 4 + 1), 4)[:P]
        cells[:len(sizes)] = np.arange(len(sizes))    # every size, in turn
        cells[len(sizes):len(sizes) + 3] = len(sizes) - 1
    if integer:
        decoded = rng.randint(-3, 4, (rows, d)).astype(np.int8)
        scale = np.ones(d, np.float32)
        v = rng.randint(-4, 5, (P, 1, dv)).astype(np.float32)
        base = rng.randint(0, 100, (P, 1)).astype(np.float32)
    else:
        decoded = rng.randint(-127, 128, (rows, d)).astype(np.int8)
        scale = (0.01 + 0.02 * rng.rand(d)).astype(np.float32)
        v = rng.randn(P, 1, dv).astype(np.float32)
        base = (10 + rng.rand(P, 1)).astype(np.float32)
    if P > 2:
        base[[1, P // 2]] = np.inf          # padded probes
    args = [torch.from_numpy(a) for a in (
        offsets[cells].reshape(P, 1), sizes[cells].reshape(P, 1), v, base,
        decoded, scale)]
    if elem == "bf16":
        args[4] = (args[4].float() * args[5].to(torch.bfloat16).float()) \
            .to(torch.bfloat16)
        args[5] = None
    held = torch.arange(0, P, 64 if c.get("cells") == "posting" else 1)
    return args, c["nf"], held


def _finish(seconds: float = 60.0):
    """Wait for the card's queued work, failing (not hanging) if a kernel
    has not finished within `seconds`."""
    done = torch.cuda.Event()
    done.record()
    t0 = time.monotonic()
    while not done.query():
        if time.monotonic() - t0 > seconds:
            pytest.fail(f"kernel still running after {seconds} s")
        time.sleep(0.001)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_PROBE_CASES))
@pytest.mark.parametrize("merge", ["fold", "exact"])
@pytest.mark.parametrize("elem", ["int8", "bf16"])
@pytest.mark.parametrize("integer", [True, False])
def test_probe_scan_kernel_shapes(dev, case, merge, elem, integer):
    # the four per-probe variants against their plain version: integer-
    # valued inputs bit for bit, real ones to f32 rounding
    args, nf, held = _probe_case(case, integer, elem, seed=len(case))
    if merge == "exact":
        nf = 128
    kw = dict(k_out=10, chunk=512, norm_coef=1.0, nf=nf, merge=merge)
    kern = dense_scan.PROBE_KERNELS[merge, elem]
    n0 = kern.launches
    kd, kp = dense_scan.dense_scan(
        *[None if a is None else a.to(dev) for a in args], **kw)
    _finish()
    assert kern.launches == n0 + 1
    kd, kp = kd[held.to(dev), 0], kp[held.to(dev), 0]
    pd, pp = _probe_plain(args, held, kw, dev)
    empty = (args[1].reshape(-1)[held] == 0).to(dev)
    assert empty.any() or case == "p1"
    assert torch.isinf(kd[empty]).all() and (kp[empty] == -1).all()
    if integer:
        assert torch.equal(kd, pd) and torch.equal(kp, pp)
    elif merge == "exact":
        _close_topk(kd, kp, pd, pp, 10)
    else:
        fin = torch.isfinite(pd)
        assert torch.equal(torch.isfinite(kd), fin)
        torch.testing.assert_close(kd[fin], pd[fin], rtol=1e-5, atol=1e-3)
        assert (kp == pp).float().mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["fold", "exact"])
@pytest.mark.parametrize("elem", ["int8", "bf16"])
def test_probe_scan_launch_shape(dev, merge, elem):
    # four warps a block, at least two blocks resident per SM, a ring of
    # at least three stages of 32 rows a warp, nothing spilled
    fit = dense_scan.probe_fit(dense_scan.PROBE_KERNELS[merge, elem].fn, 128,
                               128, 10)
    assert fit["threads"] == 128 and fit["blocks_per_sm"] >= 2
    assert fit["ring_stages"] >= 3 and fit["stage_rows"] == 32
    assert fit["grid"] == fit["blocks_per_sm"] * fit["sms"]
    assert fit["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k_out", [1, 10, 128])
@pytest.mark.parametrize("elem", ["int8", "bf16"])
@pytest.mark.parametrize("integer", [True, False])
def test_probe_scan_exact_k_out(dev, k_out, elem, integer):
    # the exact merge at every k_out on cells of up to 71 groups (one warp
    # walks a probe's groups in order) against the sequential merge of
    # the plain version
    rng = np.random.RandomState(k_out)
    sizes = np.array([0, 129, 640, 1000, 8300, 9000], np.int32)
    caps = (sizes + 7) // 8 * 8
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])]).astype(np.int32)
    rows, d, P = int(caps.sum()), 128, 40
    cells = np.repeat(rng.randint(0, len(sizes), P // 2), 2)
    cells[:len(sizes)] = np.arange(len(sizes))
    if integer:
        decoded = rng.randint(-3, 4, (rows, d)).astype(np.int8)
        scale = np.ones(d, np.float32)
        v = rng.randint(-4, 5, (P, 1, d)).astype(np.float32)
        base = rng.randint(0, 100, (P, 1)).astype(np.float32)
    else:
        decoded = rng.randint(-127, 128, (rows, d)).astype(np.int8)
        scale = (0.01 + 0.02 * rng.rand(d)).astype(np.float32)
        v = rng.randn(P, 1, d).astype(np.float32)
        base = (10 + rng.rand(P, 1)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (
        offsets[cells].reshape(P, 1), sizes[cells].reshape(P, 1), v, base,
        decoded, scale)]
    if elem == "bf16":
        args[4] = (args[4].float() * args[5].to(torch.bfloat16).float()) \
            .to(torch.bfloat16)
        args[5] = None
    kw = dict(k_out=k_out, chunk=512, norm_coef=1.0, nf=128, merge="exact")
    kd, kp = dense_scan.dense_scan(
        *[None if a is None else a.to(dev) for a in args], **kw)
    pd, pp = _probe_plain(args, torch.arange(P), kw, dev)
    kd, kp = kd[:, 0], kp[:, 0]
    if integer:
        assert torch.equal(kd, pd) and torch.equal(kp, pp)
    else:
        _close_topk(kd, kp, pd, pp, min(k_out, 10))


def _views_equal_rebuild(idx):
    """The index's cached views (patched in place on the card) equal a
    rebuild of the same host state, bit for bit."""
    fresh = idx.fork()
    fresh.store._invalidate()
    for x in (idx, fresh):
        x.store.device_view()
        x.store.device_view_dense(x.quantizer, x.config.scan_chunk,
                                  cache=x._resolve_cache())
    for name in ("_device", "_device_dense"):
        got, want = getattr(idx.store, name), getattr(fresh.store, name)
        for key, a in want.items():
            if isinstance(a, torch.Tensor):
                assert torch.equal(got[key], a), (name, key)
            elif key in ("ids2d", "norms2d"):
                assert got[key] is None, (name, key)
    return fresh


def _dynamic_index(align: int):
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    data = synthetic_clustered(20000, 64, seed=0)
    idx = IVFADCIndex.build(data, kc=64, m=8, k=16, seed=0, cell_align=align,
                            coarse_maxiter=3, quantization_maxiter=3)
    rng = np.random.RandomState(1)
    q = (data[rng.randint(0, 20000, 512)]
         + 0.05 * rng.randn(512, 64)).astype(np.float32)
    return idx, data, q


@pytest.mark.cuda
@pytest.mark.parametrize("align", [128, 8])
def test_dynamic_views_patched_on_the_card_equal_rebuild(dev, align):
    """push / push_batch (cells by kernel 7) / push_front / delete (single,
    incremental, bulk) / pop / pop_front on the card: after each step the
    in-place patched views equal a rebuild bit for bit, and both scan
    routes (per probe, B=16; grouped, B=512) return what the rebuilt views
    return. 8-row cells move a grown cell's rows in place."""
    idx, data, q = _dynamic_index(align)
    rng = np.random.RandomState(2)
    idx.search_padded(q, 10, w=8)
    idx.store.device_view()
    # points at the smallest cell's centroid: one grow, whose rows fit the
    # guard of an 8-row store's views
    c = int(np.argmin(idx.store.caps))
    crowd = idx.coarse.centroids[c].cpu().numpy() + 0.01 * rng.randn(
        int(idx.store.caps[c]), 64).astype(np.float32)
    n0 = coarse_scan.TOPW_KERNEL.launches
    steps = [lambda: idx.push_batch(crowd),
             lambda: [idx.push(data[i] + 0.01) for i in range(20)],
             lambda: [idx.delete([int(rng.randint(len(idx)))])
                      for _ in range(5)],
             lambda: idx.delete(rng.choice(len(idx), 100, replace=False)),
             lambda: [(idx.pop(), idx.pop_front()) for _ in range(5)],
             lambda: [idx.push_front(data[i] - 0.01) for i in range(3)],
             lambda: idx.delete(rng.choice(len(idx), 3000, replace=False))]
    for step in steps:
        step()
        fresh = _views_equal_rebuild(idx)
        for qq in (q[:16], q):
            for a, b in zip(idx.search_padded(qq, 10, w=8),
                            fresh.search_padded(qq, 10, w=8)):
                np.testing.assert_array_equal(a, b)
    assert coarse_scan.TOPW_KERNEL.launches >= n0 + 1 + 20 + 3
    live = np.sort(idx.store.ids[idx.store.ids >= 0])
    assert np.array_equal(live, np.arange(len(idx)))
    if align == 8:
        assert idx.store.grow_patches > 0


@pytest.mark.cuda
def test_fork_is_isolated_on_the_card(dev):
    """Copy-on-write views on the card: in-place patches on either side of
    a fork leave the other side's view tensors and results unchanged."""
    idx, data, q = _dynamic_index(8)
    rng = np.random.RandomState(3)
    idx.search_padded(q, 10, w=8)

    def snap(x):
        view = x.store.device_view_dense(x.quantizer, x.config.scan_chunk)
        return ({k: v.clone() for k, v in view.items()
                 if isinstance(v, torch.Tensor)},
                x.search_padded(q, 10, w=8), x.search_padded(q[:16], 10, w=8))

    def same(x, s):
        now = snap(x)
        for k, v in s[0].items():
            assert torch.equal(now[0][k], v), k
        for a, b in zip(now[1:], s[1:]):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])

    parent = snap(idx)
    child = idx.fork()
    child.push_batch(idx.coarse.centroids[0].cpu().numpy()
                     + 0.01 * rng.randn(600, 64).astype(np.float32))
    child.delete(list(range(0, 40, 3)))
    child.pop()
    child.search_padded(q, 10, w=8)
    same(idx, parent)
    kid = snap(child)
    idx.push_batch(data[:50] + 0.02)
    idx.delete([5])
    idx.search_padded(q, 10, w=8)
    same(child, kid)
    _views_equal_rebuild(idx)
    _views_equal_rebuild(child)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4096, 3000])
def test_streaming_build_equals_build_on_the_card(dev, rows):
    """build_streaming(chunks, train_data=X) on the card is build(X) bit
    for bit: the store's arrays, the trained parameters and both scan
    routes' results, with chunks aligned to the assignment blocks (4096)
    and not (3000)."""
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    data = synthetic_clustered(20000, 64, seed=0)
    kw = dict(kc=64, m=8, k=16, seed=0, coarse_maxiter=3,
              quantization_maxiter=3, kmeans_block=4096)
    ref = IVFADCIndex.build(data, **kw)
    idx = IVFADCIndex.build_streaming(
        [data[s:s + rows] for s in range(0, len(data), rows)],
        train_data=data, **kw)
    assert idx.device.type == "cuda"
    for key in ("offsets", "caps", "sizes", "codes", "ids"):
        np.testing.assert_array_equal(getattr(idx.store, key),
                                      getattr(ref.store, key), err_msg=key)
    assert torch.equal(idx.coarse.centroids, ref.coarse.centroids)
    assert torch.equal(idx.quantizer.codebooks, ref.quantizer.codebooks)
    q = data[:512] + 0.05
    for b in (16, 512):                    # per probe; grouped
        ri, rd = ref.search_padded(q[:b], 10, w=8)
        si, sd = idx.search_padded(q[:b], 10, w=8)
        np.testing.assert_array_equal(si, ri)
        np.testing.assert_array_equal(sd, rd)


@pytest.mark.cuda
def test_batching_searcher_on_the_card_equals_direct_search(dev):
    """Two dispatch threads serving a cuda index, with mutations through
    the searcher between rounds: every served row equals a direct search
    of the same batch on the index as it then stands (max_batch is one
    request's rows, so a dispatch's batch is the request's)."""
    from ivfadc_tpu_torch import BatchingSearcher
    idx, data, q = _dynamic_index(128)
    rng = np.random.RandomState(5)
    with BatchingSearcher(idx, max_batch=64, max_wait_ms=0,
                          pipeline=2) as s:
        for r in range(4):
            futs = [(b, s.submit(q[b * 64:(b + 1) * 64], 10, w=8))
                    for b in range(8)]
            got = [(b, f.result(timeout=60)) for b, f in futs]
            for b, (ids, dists) in got:
                di, dd = idx.search_padded(q[b * 64:(b + 1) * 64], 10, w=8)
                np.testing.assert_array_equal(ids, di)
                np.testing.assert_array_equal(dists, dd)
            s.push_batch(data[:100] + 0.01 * (r + 1))
            s.delete(sorted(rng.choice(len(idx), 50,
                                       replace=False).tolist()))
        assert s.stats.batches >= 32
    _views_equal_rebuild(idx)


@pytest.mark.cuda
@pytest.mark.parametrize("align", [128, 8])
def test_sharded_view_on_the_card_equals_single_card(dev, align):
    """Four shards of one index on cuda:0: grouped (B=512) and per-probe
    (B=16) batches give the single-card distances bit for bit, ids equal
    but at exact ties, with one coarse probe per search (the shards share
    the card) and the merge on kernel 6; after a push and a delete the
    incremental refresh equals a fresh view bit for bit."""
    from ivfadc_tpu_torch import ShardedIVFADCIndex, make_mesh
    idx, data, q = _dynamic_index(align)
    sidx = ShardedIVFADCIndex(idx, make_mesh(n_shards=4,
                                             devices=["cuda:0"] * 4))
    assert all(v["decoded"].is_cuda and v["ids"].is_cuda
               for v in sidx.views)
    n_probe, n_merge = coarse_scan.KERNEL.launches, topk.INDEX_KERNEL.launches
    sidx.search_padded(q, 10, w=8)
    assert coarse_scan.KERNEL.launches == n_probe + 1
    assert topk.INDEX_KERNEL.launches >= n_merge + 1
    _same_results(sidx, idx, q, ties_ok=True)
    sidx.push(data[0] + 0.01)
    sidx.delete([5, 17])
    assert sidx._last_refresh == "incremental"
    _same_results(sidx, ShardedIVFADCIndex(idx, sidx.mesh), q, ties_ok=False)
    _same_results(sidx, idx, q, ties_ok=True)


@pytest.mark.cuda
def test_sharded_view_across_cards_equals_single_card(dev):
    """Shards on every visible card (needs two or more): make_mesh() (one
    shard a card) and two data groups, each shard on two cards, give the
    single-card distances bit for bit; a push and a delete patch every
    copy of a shard, equal to a fresh view."""
    from ivfadc_tpu_torch import ShardedIVFADCIndex, make_mesh
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    idx, data, q = _dynamic_index(128)
    for mesh in (make_mesh(), make_mesh(n_data=2)):
        sidx = ShardedIVFADCIndex(idx.fork(), mesh)
        cards = {v["decoded"].device for row in sidx._group_views
                 for v in row}
        assert len(cards) == n - n % mesh.shape["data"]
        _same_results(sidx, sidx.index, q, ties_ok=True)
        sidx.push(data[0] + 0.01)
        sidx.delete([5, 17])
        assert sidx._last_refresh == "incremental"
        _same_results(sidx, ShardedIVFADCIndex(sidx.index, mesh), q,
                      ties_ok=False)
        _same_results(sidx, sidx.index, q, ties_ok=True)


def _same_results(a, b, q, ties_ok: bool):
    """Both scan routes (per probe, B=16; grouped, B=512) of two indexes:
    distances bit-equal, ids equal (ties_ok: but at exact ties)."""
    for qq in (q[:16], q):
        ai, ad = a.search_padded(qq, 10, w=8)
        bi, bd = b.search_padded(qq, 10, w=8)
        np.testing.assert_array_equal(ad, bd)
        if not ties_ok:
            np.testing.assert_array_equal(ai, bi)
            continue
        for x, y, d in zip(ai, bi, ad):
            for v in np.unique(d[d < d[-1]]):
                assert set(x[d == v]) == set(y[d == v])


def _distributed_view(mesh_devices):
    """A distributed build of _dynamic_index's points (20,000 x 64, kc=64)
    over a 1 x S mesh of the given devices, and the queries."""
    from ivfadc_tpu_torch import ShardedIVFADCIndex, make_mesh
    _, data, q = _dynamic_index(128)
    view = ShardedIVFADCIndex.build(
        data, make_mesh(n_shards=len(mesh_devices), devices=mesh_devices),
        kc=64, m=8, k=16, seed=0, coarse_maxiter=3, quantization_maxiter=3)
    return view, data, q


@pytest.mark.cuda
def test_distributed_build_on_the_card_equals_consolidated_twin(dev,
                                                                tmp_path):
    """A distributed build over 4 shards of cuda:0: dense views on the
    card, a payload-free base, and both scan routes equal to the plain
    index consolidated from its own directory (distances bit-equal, ids
    but at exact ties)."""
    from ivfadc_tpu_torch.parallel import (consolidate_sharded_index,
                                           save_sharded_index)
    view, data, q = _distributed_view(["cuda:0"] * 4)
    assert view.scan_mode == "dense" and not view.index.store.has_payload
    assert all(v["decoded"].is_cuda and v["ids"].is_cuda
               for v in view.views)
    save_sharded_index(str(tmp_path / "d"), view)
    plain = consolidate_sharded_index(str(tmp_path / "d"))
    assert plain.device.type == "cuda" and len(plain) == len(data)
    _same_results(view, plain, q, ties_ok=True)


@pytest.mark.cuda
def test_shard_dir_roundtrip_on_the_card(dev, tmp_path):
    """save -> load onto the same 4 shards (results bit-equal) and onto 2
    (a reshard: distances bit-equal, ids but at ties); the out-of-core
    consolidation loads on the card equal to the in-memory one."""
    from ivfadc_tpu_torch import IVFADCIndex, make_mesh
    from ivfadc_tpu_torch.parallel import (consolidate_sharded_index,
                                           consolidate_sharded_to_file,
                                           load_sharded_index,
                                           save_sharded_index)
    view, _, q = _distributed_view(["cuda:0"] * 4)
    d = str(tmp_path / "d")
    save_sharded_index(d, view)
    _same_results(view, load_sharded_index(d, view.mesh), q, ties_ok=False)
    _same_results(view, load_sharded_index(
        d, make_mesh(n_shards=2, devices=["cuda:0"] * 2)), q, ties_ok=True)
    consolidate_sharded_to_file(d, str(tmp_path / "f.npz"))
    flat = IVFADCIndex.load(str(tmp_path / "f.npz"))
    mem = consolidate_sharded_index(d)
    for key in ("offsets", "caps", "sizes", "codes", "ids"):
        np.testing.assert_array_equal(getattr(flat.store, key),
                                      getattr(mem.store, key))
    _same_results(flat, mem, q, ties_ok=False)


@pytest.mark.cuda
def test_native_push_batch_regrow_on_the_card(dev, tmp_path):
    """A native push_batch on a fork of a distributed view: the pushes'
    cells by kernel 7, cells outgrowing their capacity (a regrow), then a
    delete; after each, both scan routes equal a fresh view over the
    consolidated state and ids stay 0..n-1; the parent is unchanged."""
    from ivfadc_tpu_torch import ShardedIVFADCIndex
    from ivfadc_tpu_torch.parallel import (consolidate_sharded_index,
                                           save_sharded_index)
    view, data, q = _distributed_view(["cuda:0"] * 4)
    before = view.search_padded(q, 10, w=8)
    fork = view.fork()
    caps = fork._h_caps.copy()
    n7 = coarse_scan.TOPW_KERNEL.launches
    fork.push_batch(np.repeat(data[:4], 400, axis=0) + 0.01)
    assert coarse_scan.TOPW_KERNEL.launches > n7
    assert not np.array_equal(caps, fork._h_caps)
    for step in ("push_batch", "delete"):
        if step == "delete":
            fork.delete(np.arange(0, len(fork.index), 13))
        d = str(tmp_path / step)
        save_sharded_index(d, fork)
        ref = consolidate_sharded_index(d)
        ids = ref.store.ids
        np.testing.assert_array_equal(np.sort(ids[ids >= 0]),
                                      np.arange(len(ref)))
        _same_results(fork, ShardedIVFADCIndex(ref, fork.mesh), q,
                      ties_ok=True)
    after = view.search_padded(q, 10, w=8)
    assert all(np.array_equal(a, b) for a, b in zip(before, after))


_NCCL_WORKER = r'''
import os, sys
sys.path.insert(0, os.environ["IVFADC_ROOT"])
import numpy as np
import torch
from ivfadc_tpu_torch.parallel import (initialize_cluster, make_mesh,
                                       process_info, shutdown_cluster,
                                       ShardedIVFADCIndex)
from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
rank = int(os.environ["RANK_X"])
assert initialize_cluster(os.environ["COORD"], 2, rank, [rank])
assert process_info()["backend"] == "nccl", process_info()
data = synthetic_clustered(20000, 64, seed=0)
view = ShardedIVFADCIndex.build(data, make_mesh(n_shards=2), kc=64, m=8,
                                k=16, seed=0, coarse_maxiter=3,
                                quantization_maxiter=3)
q = np.load(os.environ["QUERIES"])
ids, dists = view.search_padded(q, 10, w=8)
np.savez(os.environ["OUT"] + f"{rank}.npz", ids=ids, dists=dists)
shutdown_cluster()
'''


@pytest.mark.cuda
def test_two_rank_nccl_group_equals_single_process(dev, tmp_path):
    """Two ranks, one card each (NCCL), build over a global 1 x 2 mesh and
    search: both ranks' results bit-equal to a single-process view over
    the same two cards. Needs two or more cards."""
    import os
    import socket
    import subprocess
    import sys
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    view, _, q = _distributed_view(["cuda:0", "cuda:1"])
    ids, dists = view.search_padded(q, 10, w=8)
    np.save(str(tmp_path / "q.npy"), q)
    (tmp_path / "w.py").write_text(_NCCL_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, IVFADC_ROOT=root, COORD=f"127.0.0.1:{port}",
               QUERIES=str(tmp_path / "q.npy"), OUT=str(tmp_path / "r"))
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "w.py")],
                              env=dict(env, RANK_X=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    for r in range(2):
        z = np.load(str(tmp_path / f"r{r}.npz"))
        np.testing.assert_array_equal(z["ids"], ids)
        np.testing.assert_array_equal(z["dists"], dists)


@pytest.mark.cuda
def test_dryrun_entry_and_multichip_on_the_card(dev, capsys):
    """`python -m ivfadc_tpu_torch.dryrun 8` on the card: the LUT entry's
    forward (kernel 7 probes) gives the ids of the same forward on CPU
    copies of its arguments, distances within 1e-5 relative; the dry run
    holds every step over a 2 x 4 mesh (positions repeat the card where
    fewer than 8 are visible) and prints the OK line."""
    from ivfadc_tpu_torch import dryrun
    from ivfadc_tpu_torch.models.coarse import NaiveCoarseQuantizer
    fn, args = dryrun.entry()
    assert args[0].device.type == "cuda"
    n0 = coarse_scan.TOPW_KERNEL.launches
    ids, dists = fn(*args)
    assert coarse_scan.TOPW_KERNEL.launches > n0
    coarse = args[1]
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a
                for a in args]
    cpu_args[1] = NaiveCoarseQuantizer(coarse.centroids.cpu(), coarse.metric)
    ids_c, dists_c = fn(*cpu_args)
    assert torch.equal(ids.cpu(), ids_c)
    np.testing.assert_allclose(dists.cpu().numpy(), dists_c.numpy(),
                               rtol=1e-5, atol=1e-5)
    out = dryrun.dryrun_multichip(8)
    assert out["mesh"] == {"data": 2, "shard": 4} and out["match"] == 1.0
    assert out["devices"] == ("distinct" if torch.cuda.device_count() >= 8
                              else "repeated")
    assert "dryrun_multichip OK: mesh={'data': 2, 'shard': 4}" in \
        capsys.readouterr().out


@pytest.mark.cuda
def test_every_scan_pb_on_the_card(dev, monkeypatch):
    """Every scan_pb the JAX package takes searches on the card: the
    grouped kernels run tiles of tile_height(pb) probes, and a probe's
    fold does not depend on its tile, so ids and distances equal pb =
    64's bit for bit, on the placement route and on the qc route."""
    import dataclasses
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    data = synthetic_clustered(20000, 128, seed=3)
    idx = IVFADCIndex.build(data, kc=64, m=8, k=64, seed=0, device="cuda")
    q = torch.as_tensor(data[:512], device=dev) + 0.05    # 512 * 8 >= 4 * 64
    cfg0 = idx.config
    for vbase in ("place", "qc"):
        monkeypatch.setenv("IVFADC_VBASE", vbase)
        idx.config = cfg0
        want = idx.search_padded(q, 10, w=8)
        kern = dense_scan.QC_KERNELS["int8"] if vbase == "qc" \
            else dense_scan.KERNEL
        for pb in (4, 8, 20, 100, 128, 256):
            idx.config = dataclasses.replace(cfg0, scan_pb=pb)
            n0 = kern.launches
            got = idx.search_padded(q, 10, w=8)
            assert kern.launches == n0 + 1, (vbase, pb)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    idx.config = cfg0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 64])        # grouped, per-probe
def test_every_device_op_of_a_search_has_one_stage(dev, B):
    """Under torch.profiler a SIFT-shaped search (d = 128, m = 8) names
    its stages (utils/profiling.py), replayed from its CUDA graph and
    eager: every device operation's launch, the runtime call with its
    correlation id, lies in exactly one stage span, and the spans put no
    event on the device's timeline."""
    from torch.profiler import ProfilerActivity, profile
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils import profiling
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    data = synthetic_clustered(50000, 128, seed=0)
    idx = IVFADCIndex.build(data, kc=256, m=8, k=256, seed=0,
                            coarse_maxiter=3, quantization_maxiter=3)
    q = torch.as_tensor(data[:B], device=dev) + 0.05
    want = idx.search_padded(q, 10, w=8)
    idx.search_padded(q, 10, w=8)                     # the graph's capture
    # a replay (one `ivfadc.graph` stage), then the eager path of a key's
    # first call (the stages from probe to merge)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = idx.search_padded(q, 10, w=8)
        idx.store.graphs.clear()
        got_eager = idx.search_padded(q, 10, w=8)
        torch.cuda.synchronize()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got_eager[0], want[0])
    ev = prof.events()
    ops = [e for e in ev if getattr(e, "device_type", None)
           == torch.autograd.DeviceType.CUDA]
    assert ops and not any(e.name.startswith("ivfadc.") for e in ops)
    launch = {e.id: e.time_range.start for e in ev
              if e.device_type == torch.autograd.DeviceType.CPU
              and e.name.startswith("cu")}
    stages = [(e.time_range.start, e.time_range.end) for e in ev
              if e.name in profiling.STAGES]
    bad = []
    for e in ops:
        t = launch.get(e.id)
        n = None if t is None else sum(s0 <= t <= s1 for s0, s1 in stages)
        if n != 1:
            bad.append((e.name[:48], e.id, t, n))
    assert not bad, bad
    names = {e.name for e in ev if e.name.startswith("ivfadc.")}
    assert names == {profiling.SEARCH, *profiling.STAGES}


# ------------------------------------------- the dense search's CUDA graphs
def _graph_index(align: int = 0):
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    data = synthetic_clustered(50000, 128, seed=0)
    idx = IVFADCIndex.build(data, kc=256, m=8, k=256, seed=0,
                            cell_align=align, coarse_maxiter=3,
                            quantization_maxiter=3)
    rng = np.random.RandomState(7)
    q = torch.as_tensor(data[rng.randint(0, 50000, 10000)]
                        + 0.05 * rng.randn(10000, 128).astype(np.float32),
                        device="cuda")
    return idx, data, q


def _eager_search(idx, q, k: int = 10, w: int = 8):
    """The eager dense route, called directly: the padded batch through
    `_dense_search` and `finalize`, as `_device_search` runs a key's first
    call."""
    from ivfadc_tpu_torch.models.index import _bucket_batch, _pad_rows
    B = q.shape[0]
    Bp = _bucket_batch(B)
    include_base = (idx.config.score_mode == "reference"
                    or not idx.quant_metric.residual_based)
    plan = idx._dense_plan(Bp, w, False)
    ids, dists, _ = idx._dense_search(_pad_rows(q, Bp), k, w, include_base,
                                      False, plan)
    return ids[:B], idx.quant_metric.finalize(dists)[:B]


def _replays_equal_eager(idx, q, calls: int = 3):
    """`calls` searches of q through `_device_search` (the key's graph,
    captured where it is new) each equal the eager route bit for bit."""
    want = _eager_search(idx, q)
    for _ in range(calls):
        got = idx._device_search(q, 10, 8)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("B", [10000, 64])       # grouped, per probe
def test_graph_replay_equals_the_eager_route(dev, B):
    from ivfadc_tpu_torch.utils import profiling
    idx, _, q = _graph_index()
    q = q[:B]
    with profiling.counting() as counts:
        _replays_equal_eager(idx, q, calls=5)
    assert len(idx.store.graphs) == 1
    assert counts["graph_captures"] == 1 and counts["graph_replays"] == 3


@pytest.mark.cuda
def test_graph_replay_follows_every_mutation(dev, tmp_path):
    """Bit-equal to the eager route after a push_batch within room, a grow
    past room, an incremental and a bulk delete, a fork (both sides) and
    a save and load, at the grouped (B = 10,000) and per-probe (B = 64)
    shapes."""
    from ivfadc_tpu_torch import IVFADCIndex
    idx, data, q = _graph_index()
    rng = np.random.RandomState(8)
    shapes = (q, q[:64])

    def check(x):
        for qq in shapes:
            _replays_equal_eager(x, qq)

    check(idx)
    idx.push_batch(data[:8] + 0.01)                     # within room
    check(idx)
    c = int(np.argmin(idx.store.caps))
    idx.push_batch(idx.coarse.centroids[c].cpu().numpy() + 0.01 * rng.randn(
        int(idx.store.caps[c]), 128).astype(np.float32))  # past room
    check(idx)
    idx.delete(rng.choice(len(idx), 100, replace=False))
    check(idx)
    idx.delete(rng.choice(len(idx), 3000, replace=False))  # bulk
    check(idx)
    child = idx.fork()
    check(child)
    child.push_batch(data[100:140] + 0.02)
    child.delete([1, 2, 3])
    check(child)
    idx.delete([4])
    check(idx)
    check(child)
    path = str(tmp_path / "g.npz")
    idx.save(path)
    check(IVFADCIndex.load(path))


@pytest.mark.cuda
def test_graph_results_survive_the_next_call(dev):
    idx, _, q = _graph_index()
    a, b = q[:5000], q[5000:]
    for _ in range(3):
        idx._device_search(a, 10, 8)
    first = idx._device_search(a, 10, 8)                # replayed
    keep = [t.clone() for t in first]
    second = idx._device_search(b, 10, 8)               # same key
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, keep))
    assert not torch.equal(first[0], second[0])


@pytest.mark.cuda
def test_graph_batching_searcher_equals_serial_answers(dev):
    from ivfadc_tpu_torch import BatchingSearcher
    idx, _, q = _graph_index()
    qh = q.cpu().numpy()
    want = [idx.search_padded(qh[b * 500:(b + 1) * 500], 10, w=8)
            for b in range(8)]
    with BatchingSearcher(idx, max_batch=500, max_wait_ms=0,
                          pipeline=2) as s:
        for _ in range(4):
            futs = [s.submit(qh[b * 500:(b + 1) * 500], 10, w=8)
                    for b in range(8)]
            for f, (wi, wd) in zip(futs, want):
                ids, dists = f.result(timeout=60)
                np.testing.assert_array_equal(ids, wi)
                np.testing.assert_array_equal(dists, wd)
    assert len(idx.store.graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [10000, 64])
def test_graph_counts_equal_the_eager_counts(dev, B):
    """counting() reads the same over replays as over eager calls, with
    one capture for the key and a replay on every later call; the kernels'
    launch counts grow by one a call either way."""
    from ivfadc_tpu_torch.utils import profiling
    idx, _, q = _graph_index()
    q = q[:B]
    kern = dense_scan.KERNEL if B > 64 else dense_scan.PROBE_KERNEL
    n0 = kern.launches
    with profiling.counting() as eager:
        for _ in range(6):
            idx.store.graphs.clear()
            idx._device_search(q, 10, 8)
    assert kern.launches == n0 + 6
    idx.store.graphs.clear()
    with profiling.counting() as replayed:
        for _ in range(6):
            idx._device_search(q, 10, 8)
    assert kern.launches == n0 + 12
    assert replayed["graph_captures"] == 1
    assert replayed["graph_replays"] == replayed["searches"] - 2 == 4
    assert eager["graph_captures"] == eager["graph_replays"] == 0
    for name in profiling.COUNTS:
        if not name.startswith("graph_"):
            assert replayed[name] == eager[name], name


@pytest.mark.cuda
def test_graphs_sharing_a_pool_keep_their_results(dev, monkeypatch):
    """Four shapes, more than the cache holds, share one pool: interleaved
    from two threads, each result equals the eager route's and stays
    unchanged while the other shapes replay."""
    import threading
    from ivfadc_tpu_torch.models import graphs
    monkeypatch.setattr(graphs, "CAP", 3)
    idx, _, q = _graph_index()
    shapes = [q[:64], q[:1000], q[:5000], q]
    want = [_eager_search(idx, x) for x in shapes]
    held, errors = [], []

    def work(order):
        try:
            for i in order:
                got = idx._device_search(shapes[i], 10, 8)
                held.append((i, got))
                assert torch.equal(got[0], want[i][0])
                assert torch.equal(got[1], want[i][1])
        except Exception as e:                     # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=work, args=(o,)) for o in
               ([0, 1, 2, 3] * 6, [3, 2, 1, 0] * 6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    torch.cuda.synchronize()
    for i, (ids, dists) in held:
        assert torch.equal(ids, want[i][0]) and torch.equal(dists, want[i][1])
    pools = {id(g.pool) for g in idx.store.graphs._graphs.values()}
    assert len(idx.store.graphs) == 3 and len(pools) == 1


@pytest.mark.cuda
def test_search_stream_leaves_no_page_locked_memory(dev):
    """search_stream copies its stacked results out pageable: torch's host
    cache holds no more page-locked bytes after a stream of 200,000
    queries than before it. search_padded stages each call's results
    page-locked, and its buffers are reused from call to call."""
    idx, _, q = _graph_index()
    stats = torch.cuda.host_memory_stats
    for _ in range(3):
        idx.search_padded(q, 10, w=8)
    before = stats()["allocated_bytes.current"]
    for _ in range(20):
        idx.search_padded(q, 10, w=8)
    assert stats()["allocated_bytes.current"] == before
    qs = np.tile(q.cpu().numpy(), (20, 1))
    ids, dists = idx.search_stream(qs, 10, w=8, batch=16384)
    assert ids.shape == (200000, 10) and dists.shape == (200000, 10)
    assert stats()["allocated_bytes.current"] == before


# ----------------------------------------- GIST1M's shape: d = 960, m = 16
@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 10240])
def test_coarse_probe_kernel_at_gist_width(dev, B):
    """Kernel 1 at d = 960, kc = 1024, w = 8: a 64-query tile streams in
    feature slabs beside the centroids (whole, it would pass the block's
    shared memory), so the plan takes wide tiles for a batch that fills
    them (at least 64 queries at B = 10,240) and 16-query tiles for a small
    one (`narrow`). On integer-tie tables the cells, v and base equal the
    plain version bit for bit; `counting()` reads one narrow launch at
    B = 16, none at 10,240, and no launch on the large-w selection."""
    from ivfadc_tpu_torch.utils import profiling
    d, kc, w = 960, 1024, 8
    p = coarse_scan.plan(B, d, kc, w, "vbase", dev)
    narrow = B == 16
    assert p["narrow"] == narrow and (p["bq"] == 16) == narrow
    assert narrow or p["bq"] >= 64
    rng = np.random.RandomState(B)
    q, c = (t.to(dev) for t in _tie_table(rng, B, kc, d, dev, w))
    cn = torch.sum(c * c, dim=1)
    eye = torch.eye(d, device=dev)
    n0 = coarse_scan.KERNEL.launches
    with profiling.counting() as counts:
        got = coarse_scan.coarse_vbase(q, c, cn, eye, w, False)
    assert coarse_scan.KERNEL.launches == n0 + 1
    assert counts["probe_narrow_launches"] == int(narrow)
    assert counts["probe_wide_select_launches"] == 0
    want = coarse_scan.coarse_vbase_plain(q, c, cn, eye, w, False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _forced(kind, q, c, cn, w, tq, splits):
    """One coarse kernel launch at a given query tile (16 * tq rows) and
    split of the table, past the plan: (vals, cells[, v[, rn]])."""
    B, d = q.shape
    kc = c.shape[0]
    eye = torch.eye(d, device=q.device)
    hi, lo = coarse_scan.hi_lo_split(c, eye, False)
    part = torch.empty((B, splits, w, 2), dtype=torch.int32,
                       device=q.device) if splits > 1 else None
    tickets = torch.zeros(-(-B // (16 * tq)), dtype=torch.int32,
                          device=q.device) if splits > 1 else None
    plan = (tq, splits, coarse_scan._ptr(part), coarse_scan._ptr(tickets))
    outs = [torch.empty((B, w), device=q.device),
            torch.empty((B, w), dtype=torch.int32, device=q.device)]
    if kind != "topw":
        outs.append(torch.empty((B, w, d), dtype=torch.bfloat16,
                                device=q.device))
    if kind == "vbase":
        outs.append(torch.empty((B, w), device=q.device))
    ptrs = [t.data_ptr() for t in outs]
    stream = coarse_scan._build.stream_ptr(q.device)
    if kind == "topw":
        coarse_scan.TOPW_KERNEL(q.data_ptr(), c.data_ptr(), cn.data_ptr(), B,
                                d, kc, w, *plan, *ptrs, stream)
    elif kind == "vbase":
        coarse_scan.KERNEL(q.data_ptr(), c.data_ptr(), cn.data_ptr(),
                           eye.data_ptr(), B, d, kc, w, 0, *plan, *ptrs,
                           stream)
    else:
        coarse_scan.V2_KERNEL(q.data_ptr(), c.data_ptr(), cn.data_ptr(),
                              eye.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                              B, d, kc, w, 0, *plan, *ptrs, stream)
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("d,kc,w", [(960, 1024, 8), (97, 1024, 8),
                                    (961, 1000, 8), (128, 1000, 8),
                                    (128, 4096, 64), (97, 1000, 33),
                                    (961, 1000, 128)])
def test_coarse_query_tiles_agree_bit_for_bit(dev, d, kc, w, integer):
    """Kernels 7, 1 and 10 on 16- and 64-query tiles, on one split, three
    and one tile a split, give the same bits: the sums run in feature
    order whatever the tile and wherever the query tile lives (streamed for
    64 queries at d = 960 and 961, held whole otherwise), and the selection
    ranks by (score, index). At d = 960, at ragged d (97 and 961: the
    4-byte copies, a partial last slab) and at a kc that is not a multiple
    of 128 (a ragged last tile), on random floats and on `_tie_table`'s
    integer ties, which also equal the plain versions. Past w = 32 the plan
    reports the large-w selection (a warp owns its rows' lists, a split's
    first tile fills them by a sort, the last block merges the others'
    lists through the same offers) and its buffer."""
    B = 333
    rng = np.random.RandomState(d + kc + w)
    if integer:
        q, c = (t.to(dev) for t in _tie_table(rng, B, kc, d, dev, w))
    else:
        q = torch.from_numpy(rng.randn(B, d).astype(np.float32)).to(dev)
        c = torch.from_numpy(rng.randn(kc, d).astype(np.float32)).to(dev)
    cn = torch.sum(c * c, dim=1)
    tiles = -(-kc // 128)
    for kind in ("topw", "vbase", "vbase_v2"):
        p = coarse_scan.plan(B, d, kc, w, kind, dev)
        assert p["wide"] == (w > 32) and (p["cap"] >= 16 or w <= 32), p
        want = _forced(kind, q, c, cn, w, 1, 1)
        for tq in (1, 4):
            for splits in (1, 3, tiles):
                got = _forced(kind, q, c, cn, w, tq, splits)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    (kind, tq, splits)
        if integer and kind == "vbase":
            eye = torch.eye(d, device=dev)
            plain = coarse_scan.coarse_vbase_plain(q, c, cn, eye, w, False)
            assert all(torch.equal(a, b) for a, b in zip(want, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [97, 961])
def test_coarse_inf_query_leaves_its_neighbours_alone(dev, d):
    """A query holding inf makes only its own scores non-finite: at a
    ragged d the last slab of a query row held whole reads the zeros that
    pad it to a whole slab, never the next row's features (inf * 0 would
    be NaN there). On integer ties every other row's vals, cells, v and
    rn equal the plain version's bit for bit, on 16- and 64-query tiles
    and on one and three splits."""
    B, kc, w = 70, 1000, 8
    rng = np.random.RandomState(d)
    q, c = (t.to(dev) for t in _tie_table(rng, B, kc, d, dev, w))
    bad = 6                     # row 5 ends where row 6 starts
    q[bad, :] = float("inf")
    cn = torch.sum(c * c, dim=1)
    keep = torch.arange(B, device=dev) != bad
    eye = torch.eye(d, device=dev)
    plain = coarse_scan.coarse_vbase_plain(q[keep], c, cn, eye, w, False)
    for tq in (1, 4):
        for splits in (1, 3):
            got = _forced("vbase", q, c, cn, w, tq, splits)
            assert all(torch.equal(a[keep], b) for a, b in zip(got, plain)), \
                (tq, splits)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["ids", "knorm"])
@pytest.mark.parametrize("elem", ["int8", "bf16"])
@pytest.mark.parametrize("integer", [True, False])
def test_grouped_scan_one_tile_at_gist_width(dev, variant, elem, integer):
    """Kernel 3 at the GIST cache's d_pad = 1024, pb = 64: two staged bf16
    tiles pass the block's shared memory, so the plan stages one
    (`scan_fit`), and the scores match the plain version as kernel 3's
    other shapes do, over cells of 1 to 1,000 rows, dead probes and an
    empty tile; `counting()` reads one single-tile launch."""
    from ivfadc_tpu_torch.utils import profiling
    pb, d, nf = 64, 1024, 128
    kern = dense_scan.GROUPED_KERNELS[variant, elem]
    assert dense_scan.scan_fit(kern.fn, d, pb, nf, 10)["tiles"] == 1
    args = _edge_tiles(np.random.RandomState(d + len(variant)), integer,
                       elem, pb, d)
    if variant == "knorm":
        args[7] = None
    call = dict(pb=pb, nf=nf, norm_coef=1.0)
    n0 = kern.launches
    with profiling.counting() as counts:
        kd, kp = dense_scan.grouped_scan(
            *[None if a is None else a.to(dev) for a in args], **call,
            **dense_scan.tile_order(8, pb, dev))
    assert kern.launches == n0 + 1
    assert counts["scan_single_tile_launches"] == 1
    assert counts["scan_probe_order_launches"] == 0     # tile order
    pd, pp = dense_scan.grouped_scan(*args, **call,
                                     **dense_scan.tile_order(8, pb, "cpu"))
    kd, kp = kd.cpu(), kp.cpu()
    if integer:             # every f32 sum exact: bit for bit
        assert torch.equal(kd, pd) and torch.equal(kp, pp)
        return
    # f32 sums in another order, over 1,024 features: the partial sums of
    # v . r reach about 100 here, so the orders drift apart by a random
    # walk of sqrt(1024) steps of ulp(100) = 7.6e-6, about 2.4e-4 (at d =
    # 128 kernel 3's cases above keep 1e-4 for a tenth of that)
    fin = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(kd), fin)
    torch.testing.assert_close(kd[fin], pd[fin], rtol=1e-5, atol=5e-4)
    assert (kp == pp).float().mean() >= 0.99


@pytest.mark.cuda
def test_gist_shape_search_on_the_card_equals_the_cpu_route(dev, tmp_path):
    """An index at GIST's widths (d = 960, m = 16, kc = 16, n = 4,000),
    built on the CPU and loaded onto the card, answers a 64-query batch
    (w = 4: the grouped route) as the CPU dense route does: ids equal but
    at near-ties, distances within f32 sums in another order. Each call
    runs one narrow probe (64 queries fill no wider tile) and one
    single-tile scan, on the eager path and on replay, and the counts equal
    between the two."""
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils import profiling
    rng = np.random.RandomState(0)
    centers = rng.randn(64, 960).astype(np.float32)
    data = centers[rng.randint(0, 64, 4000)] \
        + 0.15 * rng.randn(4000, 960).astype(np.float32)
    q = data[rng.randint(0, 4000, 64)] \
        + 0.05 * rng.randn(64, 960).astype(np.float32)
    cpu = IVFADCIndex.build(data, device="cpu", kc=16, m=16, k=256, seed=3,
                            scan_mode="dense", coarse_maxiter=10,
                            quantization_maxiter=10)
    cpu.save(str(tmp_path / "gist.npz"))
    card = IVFADCIndex.load(str(tmp_path / "gist.npz"), device="cuda")
    want = cpu.search_padded(q, 10, w=4)
    with profiling.counting() as eager:
        for _ in range(3):
            card.store.graphs.clear()
            got = card.search_padded(q, 10, w=4)
    assert (got[0] == want[0]).mean() >= 0.99
    # f32 sums in another order (kernel 1's sequential FMAs against the
    # CPU's blocked matmul, kernel 3's wgmma sums): the coarse term expands
    # ||q||^2 - 2 q.c + ||c||^2 with ||q||^2 near 1,000, and sums of 960
    # features drift by about sqrt(960) ulp(1000) = 1.9e-3 whatever the
    # distance
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=6e-3)
    card.store.graphs.clear()
    with profiling.counting() as replayed:
        for _ in range(3):
            again = card.search_padded(q, 10, w=4)
    np.testing.assert_array_equal(again[0], got[0])
    np.testing.assert_array_equal(again[1], got[1])
    assert replayed["graph_captures"] == 1 and replayed["graph_replays"] == 1
    # 64 queries fill no wide tile: the plan keeps 16-query tiles
    assert coarse_scan.plan(64, 960, 16, 4, "vbase", dev)["narrow"]
    assert eager["probe_narrow_launches"] == 3
    assert eager["scan_single_tile_launches"] == 3
    assert eager["probe_wide_select_launches"] == 0
    for name in profiling.COUNTS:
        if not name.startswith("graph_"):
            assert replayed[name] == eager[name], name
