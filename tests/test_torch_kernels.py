"""The port's kernel modules against the JAX package's, on the CPU.

Each test feeds the same numpy inputs (from a seed) to an `ivfadc_tpu`
wrapper, which runs its Pallas kernel in interpret mode, and to the
matching `ivfadc_tpu_torch` wrapper, which on CPU tensors runs the
kernel's plain PyTorch version. The CUDA kernels themselves are checked
against those plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ivfadc_tpu.ops import cell_rank as j_rank
from ivfadc_tpu.ops import coarse_scan as j_coarse
from ivfadc_tpu.ops import pallas_scan as j_scan
from ivfadc_tpu.ops import topk as j_topk
from ivfadc_tpu_torch.ops import cell_rank as t_rank
from ivfadc_tpu_torch.ops import coarse_scan as t_coarse
from ivfadc_tpu_torch.ops import dense_scan as t_scan
from ivfadc_tpu_torch.ops import topk as t_topk

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)


def _bf16_as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ----------------------------------------------------------- coarse probe
@pytest.mark.parametrize("apply_rot", [False, True])
@pytest.mark.parametrize("include_base", [False, True])
def test_coarse_probe_vbase_matches_jax(apply_rot, include_base):
    rng = np.random.RandomState(0)
    B, d, kc, w = 64, 128, 128, 8
    q = rng.randn(B, d).astype(np.float32)
    c = rng.randn(kc, d).astype(np.float32)
    rot = np.linalg.qr(rng.randn(d, d))[0].astype(np.float32)
    jc, jd, jv, jb = j_coarse.coarse_probe_vbase(
        jnp.asarray(q), jnp.asarray(c), w, jnp.asarray(rot), apply_rot,
        include_base, interpret=True)
    tc, td, tv, tb = t_coarse.coarse_probe_vbase(
        torch.from_numpy(q), torch.from_numpy(c), w, torch.from_numpy(rot),
        apply_rot, include_base)
    jc, jd, jb = np.asarray(jc), np.asarray(jd), np.asarray(jb)
    tc, td, tb = tc.numpy(), td.numpy(), tb.numpy()
    # f32 scores summed in another order: cells may differ only where two
    # centroids tie to within a few ulps (none do at this seed)
    same = jc == tc
    assert same.mean() >= 0.999
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)
    # v = bf16(-2 r): exact without a rotation; with one the f32 rotation
    # matmul sums in another order, so allow one bf16 ulp (2^-8 relative)
    jv32, tv32 = _bf16_as_f32(jv)[same], tv.float().numpy()[same]
    if apply_rot:
        np.testing.assert_allclose(tv32, jv32, rtol=2 ** -7, atol=1e-6)
    else:
        np.testing.assert_array_equal(tv32, jv32)
    # |r|^2 (+ cdist): f32 sums of 128 terms in another order
    np.testing.assert_allclose(tb[same], jb[same], rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------- cell ranks
@pytest.mark.parametrize("kc", [300, 4096])
def test_cell_ranks_match_jax(kc):
    rng = np.random.RandomState(kc)
    P = 3000
    # skewed cells: a few hot cells plus a uniform tail
    cells = np.where(rng.rand(P) < 0.3, rng.randint(0, 5, P),
                     rng.randint(0, kc, P)).astype(np.int32)
    jr, jn = j_rank.cell_ranks(jnp.asarray(cells), kc=kc, interpret=True)
    tr, tn = t_rank.cell_ranks(torch.from_numpy(cells), kc=kc)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


# ------------------------------------------------------------ grouped scan
def _scan_inputs(rng, integer: bool, chunk: int):
    kc, d, B, w = 8, 128, 16, 4
    caps = np.full(kc, 512)
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])]).astype(np.int32)
    # cell sizes include an empty cell and cells larger than the chunk
    sizes = np.array([0, 5, 128, 130, 300, 511, 1, 257], np.int32)
    rows = int(caps.sum()) + chunk + 128          # guard past the last cell
    rows = -(-rows // 128) * 128
    cells = rng.randint(0, kc, (B, w)).astype(np.int32)
    ids2d = rng.permutation(rows).astype(np.int32).reshape(-1, 128)
    if integer:
        # every product and sum below is an integer < 2^24: exact in f32 in
        # any summation order, so the two packages must agree bit for bit
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
    v = np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    return dict(cells=cells, offsets=offsets, sizes=sizes, v=v, base=base,
                decoded=decoded, scale=scale, ids2d=ids2d,
                norms2d=norms.reshape(-1, 128), kc=kc)


@pytest.mark.parametrize("nf,chunk,pb,integer", [
    (128, 128, 8, True), (128, 128, 16, True), (128, 256, 8, True),
    (128, 256, 16, True), (256, 256, 8, True), (256, 256, 16, True),
    (128, 256, 8, False), (256, 256, 16, False)])
def test_grouped_dense_scan_matches_jax(nf, chunk, pb, integer):
    rng = np.random.RandomState(nf + chunk + pb)
    a = _scan_inputs(rng, integer, chunk)
    kw = dict(kc=a["kc"], k_out=10, chunk=chunk, norm_coef=1.0, pb=pb,
              merge="fold", nf=nf)
    jd, jp = j_scan.grouped_dense_scan(
        jnp.asarray(a["cells"]), jnp.asarray(a["offsets"]),
        jnp.asarray(a["sizes"]), jnp.asarray(a["v"], jnp.bfloat16),
        jnp.asarray(a["base"]), jnp.asarray(a["decoded"]),
        jnp.asarray(a["scale"]), jnp.asarray(a["ids2d"]),
        jnp.asarray(a["norms2d"]), interpret=True, **kw)
    td, tp = t_scan.grouped_dense_scan(
        torch.from_numpy(a["cells"]), torch.from_numpy(a["offsets"]),
        torch.from_numpy(a["sizes"]),
        torch.from_numpy(a["v"]).to(torch.bfloat16),
        torch.from_numpy(a["base"]), torch.from_numpy(a["decoded"]),
        torch.from_numpy(a["scale"]), torch.from_numpy(a["ids2d"]),
        torch.from_numpy(a["norms2d"]), **kw)
    jd, jp, td, tp = np.asarray(jd), np.asarray(jp), td.numpy(), tp.numpy()
    assert td.shape == jd.shape == (16, 4, nf)
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    if integer:
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)
    else:
        # bf16 x bf16 products summed in f32 in another order, and the
        # interpret-mode kernel may keep the dequantized rows above bf16
        # precision: measured differences up to 3e-4 relative on scores of
        # magnitude 1..80, so hold them to 2e-3 (plus 1e-3 near zero)
        fin = np.isfinite(jd)
        np.testing.assert_allclose(td[fin], jd[fin], rtol=2e-3, atol=1e-3)
        assert (tp == jp).mean() >= 0.99


def _run_both(a, norms, **kw):
    """The grouped scan of both packages on inputs `a`; `norms` False
    leaves norms2d out (row norms computed in the kernel)."""
    jd, jp = j_scan.grouped_dense_scan(
        jnp.asarray(a["cells"]), jnp.asarray(a["offsets"]),
        jnp.asarray(a["sizes"]), jnp.asarray(a["v"], jnp.bfloat16),
        jnp.asarray(a["base"]), jnp.asarray(a["decoded"]),
        jnp.asarray(a["scale"]), jnp.asarray(a["ids2d"]),
        jnp.asarray(a["norms2d"]) if norms else None, interpret=True, **kw)
    td, tp = t_scan.grouped_dense_scan(
        torch.from_numpy(a["cells"]), torch.from_numpy(a["offsets"]),
        torch.from_numpy(a["sizes"]),
        torch.from_numpy(a["v"]).to(torch.bfloat16),
        torch.from_numpy(a["base"]), torch.from_numpy(a["decoded"]),
        torch.from_numpy(a["scale"]), torch.from_numpy(a["ids2d"]),
        torch.from_numpy(a["norms2d"]) if norms else None, **kw)
    return np.asarray(jd), np.asarray(jp), td.numpy(), tp.numpy()


def _jnp_in_kernel_norms(a, norm_coef, nf):
    """The JAX kernel's in-kernel-norms branch written out in plain jnp with
    every bf16 rounding explicit (`_grouped_scan_kernel`: rows = int8 * scale
    in bf16; norms = f32 sums of the bf16 product rows * rows; scores = (dot
    + coef * norms) + base; size mask; fold with emitted ids). On the CPU the
    interpret-mode kernel may keep those products above bf16 precision, so
    this is the referee of the rounding rule -> (d (B, w, nf), ids)."""
    f32, bf16 = jnp.float32, jnp.bfloat16
    rows = (jnp.asarray(a["decoded"]).astype(f32)
            * jnp.asarray(a["scale"]).astype(bf16).astype(f32)) \
        .astype(bf16).astype(f32)                           # (rows, d)
    norms = jnp.sum((rows * rows).astype(bf16).astype(f32), axis=1)
    dots = jnp.einsum("bwd,rd->bwr", jnp.asarray(a["v"]), rows,
                      precision="highest")
    s = np.asarray((dots + np.float32(norm_coef) * norms)
                   + jnp.asarray(a["base"])[:, :, None])
    ids = a["ids2d"].reshape(-1)
    B, w = a["cells"].shape
    out_d = np.full((B, w, nf), np.inf, np.float32)
    out_p = np.full((B, w, nf), -1, np.int32)
    lane = np.arange(128)
    for b in range(B):
        for j in range(w):
            start = a["offsets"][a["cells"][b, j]]
            size = a["sizes"][a["cells"][b, j]]
            for G in range(-(-size // 128)):
                pos = G * 128 + lane
                sub = np.where(pos < size, s[b, j, start + pos], np.inf)
                bank = slice((G % (nf // 128)) * 128,
                             (G % (nf // 128) + 1) * 128)
                upd = sub < out_d[b, j, bank]
                out_d[b, j, bank] = np.where(upd, sub, out_d[b, j, bank])
                out_p[b, j, bank] = np.where(upd, ids[start + pos],
                                             out_p[b, j, bank])
    return out_d, out_p


@pytest.mark.parametrize("nf,chunk,pb,kind,norm_coef", [
    (128, 128, 8, "integer", 1.0), (128, 256, 16, "integer", 1.0),
    (256, 256, 8, "integer", 1.0), (128, 512, 64, "integer", 1.0),
    (128, 256, 8, "integer", 0.0), (128, 256, 8, "pow2", 1.0),
    (128, 512, 64, "pow2", 1.0), (256, 256, 16, "pow2", 0.0),
    (128, 256, 8, "float", 1.0), (128, 512, 64, "float", 1.0)])
def test_grouped_dense_scan_in_kernel_norms_matches_jax(nf, chunk, pb, kind,
                                                        norm_coef):
    # norms2d=None: the row norms come from the dequantized bf16 rows in the
    # kernel (f32 sum of bf16-rounded squares), added before the base
    rng = np.random.RandomState(nf + chunk + pb + 1)
    a = _scan_inputs(rng, kind == "integer", chunk)
    if kind == "pow2":
        # power-of-two scales: the dequantized rows are exact in bf16 in
        # both packages; |row| <= 15/8 keeps the squares' sum small
        a["decoded"] = rng.randint(-15, 16, a["decoded"].shape) \
            .astype(np.int8)
        a["scale"] = np.full(128, 0.125, np.float32)
    kw = dict(kc=a["kc"], k_out=10, chunk=chunk, norm_coef=norm_coef, pb=pb,
              merge="fold", nf=nf)
    jd, jp, td, tp = _run_both(a, False, **kw)
    assert td.shape == jd.shape == (16, 4, nf)
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    fin = np.isfinite(jd)
    if kind == "integer":
        # rows in [-3, 3] with scale 1: squares <= 9 are exact in bf16, every
        # sum an integer < 2^24: bit for bit
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)
    elif kind == "pow2":
        # identical rows, and squares (<= 225/64) that are exact in bf16:
        # only the f32 summation order differs
        np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-4)
        assert (tp == jp).mean() >= 0.999
    else:
        # random scales: the interpret-mode kernel keeps the dequantized
        # rows and their squares above bf16 precision on the CPU (measured:
        # 8.8e-4 relative, 0.25 on scores up to 424), so the JAX kernel
        # holds the port only to 2e-3 of the largest score here; the bf16
        # rule itself is held below, at f32 rounding
        tol = 2e-3 * np.abs(jd[fin]).max()
        np.testing.assert_allclose(td[fin], jd[fin], rtol=0, atol=tol)
        assert (tp == jp).mean() >= 0.98
    # the rounding rule itself, against the kernel's formula in plain jnp
    # with explicit bf16 roundings: the same values summed in f32 in
    # another order (exact on integer-valued rows)
    rd, rp = _jnp_in_kernel_norms(a, norm_coef, nf)
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(rd))
    if kind == "integer":
        np.testing.assert_array_equal(td, rd)
        np.testing.assert_array_equal(tp, rp)
    else:
        np.testing.assert_allclose(td[fin], rd[fin], rtol=1e-5, atol=1e-3)
        assert (tp == rp).mean() >= 0.999


def test_in_kernel_norms_differ_from_cached_norms():
    # rows up to 127 with scale 1: 127^2 = 16129 rounds to 16128 in bf16, so
    # the in-kernel norms (bf16-rounded squares, the TPU kernel's `rows *
    # rows` in bf16) fall off the cached f32 norms. The interpret-mode JAX
    # kernel keeps the squares in f32 on the CPU, so there the two variants
    # coincide and only the port shows the difference
    rng = np.random.RandomState(9)
    a = _scan_inputs(rng, True, 256)
    a["decoded"] = rng.randint(-127, 128, a["decoded"].shape).astype(np.int8)
    rows = a["decoded"].astype(np.float32)
    a["norms2d"] = (rows * rows).sum(1).reshape(-1, 128)
    kw = dict(kc=a["kc"], k_out=10, chunk=256, norm_coef=1.0, pb=8,
              merge="fold", nf=128)
    cached = _run_both(a, True, **kw)
    kernel = _run_both(a, False, **kw)
    np.testing.assert_array_equal(cached[2], cached[0])     # port == JAX
    fin = np.isfinite(cached[0])
    assert (kernel[2][fin] != cached[2][fin]).mean() > 0.5
    # the variants differ by the squares' rounding alone: under 2^-9 of
    # the norm
    np.testing.assert_allclose(kernel[2][fin], cached[2][fin], rtol=2e-3)
    # and equal, bit for bit, the kernel's formula with explicit bf16
    # squares (integer-valued: every rounded square and every sum is exact)
    rd, rp = _jnp_in_kernel_norms(a, 1.0, 128)
    np.testing.assert_array_equal(kernel[2], rd)
    np.testing.assert_array_equal(kernel[3], rp)


# ----------------------------------------------------------------- top-k
@pytest.mark.parametrize("N", [256, 1024])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_topk_lastdim_payload_matches_jax(N, k):
    rng = np.random.RandomState(N + k)
    B = 64
    x = rng.randint(0, 50, (B, N)).astype(np.float32)       # many ties
    # +inf tails: some rows keep fewer than k finite entries
    tail = rng.randint(0, N, B)
    tail[:8] = N - 3
    x[np.arange(N)[None, :] >= tail[:, None]] = np.inf
    p = rng.randint(0, 1 << 20, (B, N)).astype(np.int32)
    jv, jp = j_topk.topk_lastdim_payload(jnp.asarray(x), jnp.asarray(p), k,
                                         interpret=True)
    tv, tp = t_topk.topk_lastdim_payload(torch.from_numpy(x),
                                         torch.from_numpy(p), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _edge_rows(N: int):
    """(8, N) f32 rows of the kinds the top-k contract names: +0 then -0
    tied at the minimum, -0 then +0, -inf entries, all +inf, fewer than k
    entries below +inf, all equal, descending, and zeros of both signs
    among ties."""
    rng = np.random.RandomState(N)
    x = rng.randint(1, 50, (8, N)).astype(np.float32)
    x[0, 5], x[0, 9] = 0.0, -0.0
    x[1, 3], x[1, 5] = -0.0, 0.0
    x[2, [4, 17, N - 1]] = -np.inf
    x[3] = np.inf
    x[4] = np.inf
    x[4, [2, N - 2]] = (3.0, -1.0)
    x[5] = 7.0
    x[6] = np.arange(N, 0, -1, dtype=np.float32)
    x[7, rng.rand(N) < 0.3] = 0.0
    x[7, rng.rand(N) < 0.3] = -0.0
    return x


@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_topk_signed_zeros_and_edge_rows_match_jax(k, payload):
    """Indices and payloads equal the JAX kernels' (interpret mode), values
    equal as floats; the port's values are the winners' own bits (JAX
    writes the row's min, whose sign on a +-0 tie follows XLA's reduction
    order: ROADMAP C.14), and +inf places carry index 0."""
    N = 256                   # a multiple of 128 and B = 8: the Pallas path
    x = _edge_rows(N)
    B = x.shape[0]
    if payload:
        p = (np.arange(N)[None, :] + 1000 * np.arange(B)[:, None]) \
            .astype(np.int32)
        jv, jp = j_topk.topk_lastdim_payload(jnp.asarray(x), jnp.asarray(p),
                                             k, interpret=True)
        tv, tp = t_topk.topk_lastdim_payload(torch.from_numpy(x),
                                             torch.from_numpy(p), k)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        idx = tp.numpy() - 1000 * np.arange(B)[:, None]
    else:
        jv, ji = j_topk.topk_lastdim(jnp.asarray(x), k, interpret=True)
        tv, ti = t_topk.topk_lastdim(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        idx = ti.numpy()
    tv = tv.numpy()
    np.testing.assert_array_equal(tv, np.asarray(jv))
    own = np.take_along_axis(x, idx, axis=1)
    fin = np.isfinite(tv) | (tv < 0)
    np.testing.assert_array_equal(tv[fin].view(np.int32),
                                  own[fin].view(np.int32))
    assert np.all(tv[~fin] == np.inf) and np.all(idx[~fin] == 0)
    # the rows whose zero ties decide the winners' signs
    if k >= 2:
        assert tv[0, 0].view(np.int32) == 0 and idx[0, 0] == 5
        assert tv[0, 1].view(np.int32) == np.float32(-0.0).view(np.int32)
        assert tv[1, 0].view(np.int32) == np.float32(-0.0).view(np.int32)
    assert np.all(idx[3] == 0)
