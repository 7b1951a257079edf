"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (Hopper: the kernels are built for
sm_90a) and skips without one. This file imports no JAX, so it also runs
where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""
"""

import numpy as np
import pytest
import torch

from ivfadc_tpu_torch.ops import cell_rank, coarse_scan, dense_scan, topk


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


def _scan_inputs(rng, integer: bool):
    kc, d, B, w, chunk = 8, 128, 16, 4, 256
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
                                      (33, 96, 100, 5), (16, 128, 256, 128)])
def test_coarse_topw_kernel(dev, B, d, kc, w):
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
