"""The JAX package's opt-in engines in the port, against the JAX package.

IVFADC_RANK_ENGINE=v2 (cell ranks), IVFADC_COARSE_ENGINE=v2 (the fused
coarse probe with a bf16 hi/lo row recovery), IVFADC_VBASE=qc (the grouped
scan deriving v and base in its kernel) and IVFADC_MERGE_TOPK=approx, each
at its module and through the index routes, alone and all together. The
same numpy inputs (from a seed) go through both packages; the JAX package
runs its Pallas kernels in interpret mode, the port its kernels' plain
versions. The CUDA kernels are held to those plain versions, and each
engine's route to the default route, on the card (tests/test_torch_cuda.py
and tests/test_torch_cuda_routes.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ivfadc_tpu import IVFADCIndex as JaxIndex
from ivfadc_tpu.ops import cell_rank as j_rank
from ivfadc_tpu.ops import coarse_scan as j_coarse
from ivfadc_tpu.ops import pallas_scan as j_scan
from ivfadc_tpu_torch import load_ivfadc_index
from ivfadc_tpu_torch.convert import from_reference
from ivfadc_tpu_torch.models import index as t_index
from ivfadc_tpu_torch.ops import cell_rank as t_rank
from ivfadc_tpu_torch.ops import coarse_scan as t_coarse
from ivfadc_tpu_torch.ops import dense_scan as t_scan
from ivfadc_tpu_torch.utils.datasets import synthetic_clustered

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)


def _bf16_as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------ rank engine
@pytest.mark.parametrize("kc", [300, 4096])
def test_cell_ranks_v2_match_jax_v2(kc):
    rng = np.random.RandomState(kc + 1)
    P = 3000
    # skewed cells: a few hot cells plus a uniform tail
    cells = np.where(rng.rand(P) < 0.3, rng.randint(0, 5, P),
                     rng.randint(0, kc, P)).astype(np.int32)
    jr, jn = j_rank.cell_ranks(jnp.asarray(cells), kc=kc, interpret=True,
                               engine="v2")
    tr, tn = t_rank.cell_ranks(torch.from_numpy(cells), kc=kc, engine="v2")
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # one function, two engines: v1's bits
    vr, vn = t_rank.cell_ranks(torch.from_numpy(cells), kc=kc, engine="v1")
    assert torch.equal(tr, vr) and torch.equal(tn, vn)


def test_cell_ranks_engine_default_and_unknown():
    cells = torch.tensor([3, 1, 3, 0], dtype=torch.int32)
    assert t_rank._DEFAULT_ENGINE in ("v1", "v2")
    r, n = t_rank.cell_ranks(cells, kc=4)
    assert r.tolist() == [0, 0, 1, 0] and n.tolist() == [1, 1, 0, 2]
    with pytest.raises(ValueError, match="rank engine"):
        t_rank.cell_ranks(cells, kc=4, engine="v3")


# ---------------------------------------------------------- coarse engine
def _random_orthogonal(d, rng):
    return np.linalg.qr(rng.randn(d, d))[0].astype(np.float32)


@pytest.mark.parametrize("apply_rot", [False, True])
@pytest.mark.parametrize("include_base", [False, True])
def test_coarse_probe_v2_matches_jax_v2(apply_rot, include_base):
    rng = np.random.RandomState(0)
    # kc = 256 at d = 128: inside JAX's v2 budget (it runs the kernel)
    B, d, kc, w = 64, 128, 256, 8
    q = rng.randn(B, d).astype(np.float32)
    c = rng.randn(kc, d).astype(np.float32)
    rot = _random_orthogonal(d, rng)
    jc, jd, jv, jb = j_coarse.coarse_probe_vbase(
        jnp.asarray(q), jnp.asarray(c), w, jnp.asarray(rot), apply_rot,
        include_base, interpret=True, engine="v2", rot_orthogonal=True)
    tc, td, tv, tb = t_coarse.coarse_probe_vbase(
        torch.from_numpy(q), torch.from_numpy(c), w, torch.from_numpy(rot),
        apply_rot, include_base, engine="v2", rot_orthogonal=True)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)
    # v = bf16(-2 (rotq - (hi + lo))): the same f32 arithmetic without a
    # rotation; with one, q R and C R are f32 sums in another order (the
    # port forms C R in float64), so one bf16 ulp (2^-8 relative)
    jv32, tv32 = _bf16_as_f32(jv), tv.float().numpy()
    if apply_rot:
        np.testing.assert_allclose(tv32, jv32, rtol=2 ** -7, atol=1e-5)
    else:
        np.testing.assert_array_equal(tv32, jv32)
    # base = 2 cdist or cdist from the scores
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-4)


def test_coarse_probe_v2_undeclared_rotation_falls_back():
    # without rot_orthogonal=True a rotated v2 request runs v1: the same
    # bits, the |r|^2 base included (here the rotation is no isometry)
    rng = np.random.RandomState(5)
    B, d, kc, w = 16, 128, 128, 2
    c = torch.from_numpy(rng.randn(kc, d).astype(np.float32))
    q = torch.from_numpy(rng.randn(B, d).astype(np.float32))
    rot = torch.from_numpy(_random_orthogonal(d, rng) * 1.5)
    a = t_coarse.coarse_probe_vbase(q, c, w, rot, True, False, engine="v2")
    b = t_coarse.coarse_probe_vbase(q, c, w, rot, True, False, engine="v1")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ja = j_coarse.coarse_probe_vbase(jnp.asarray(q.numpy()),
                                     jnp.asarray(c.numpy()), w,
                                     jnp.asarray(rot.numpy()), True, False,
                                     interpret=True, engine="v2")
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(ja[0]))
    np.testing.assert_allclose(a[3].numpy(), np.asarray(ja[3]), rtol=1e-4)
    with pytest.raises(ValueError, match="coarse engine"):
        t_coarse.coarse_probe_vbase(q, c, w, rot, False, False, engine="v3")


def test_coarse_probe_v2_exact_rows():
    # q equal to a centroid: hi + lo rebuilds the row to ~2^-17 relative,
    # so the winning probe's v and base are (near) zero, as in JAX
    rng = np.random.RandomState(1)
    c = torch.from_numpy((3.0 * rng.randn(128, 128)).astype(np.float32))
    cells, _, v, base = t_coarse.coarse_probe_vbase(
        c[:8], c, 1, torch.eye(128), False, False, engine="v2")
    assert cells[:, 0].tolist() == list(range(8))
    assert v.float().abs().max().item() < 1e-3 * c.abs().max().item()
    assert base.abs().max().item() < 1e-2


# -------------------------------------------------------------- qc scan
def _qc_inputs(rng, kind: str, elem: str, apply_rot: bool):
    """Inputs of the qc scan: 8 cells of 512 slots (an empty cell, cells
    larger than one 128-row group), 16 queries x 4 probes, d = 128."""
    kc, d, B, w = 8, 128, 16, 4
    caps = np.full(kc, 512)
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])]).astype(np.int32)
    sizes = np.array([0, 5, 128, 130, 300, 511, 1, 257], np.int32)
    rows = int(caps.sum()) + 512 + 128            # guard past the last cell
    rows = -(-rows // 128) * 128
    cells = rng.randint(0, kc, (B, w)).astype(np.int32)
    ids2d = rng.permutation(rows).astype(np.int32).reshape(-1, 128)
    if kind == "integer":
        # every product and sum is an integer < 2^24, exact in f32 in any
        # order; the rotation is a signed permutation (orthogonal, exact)
        decoded = rng.randint(-3, 4, (rows, d)).astype(np.int8)
        scale = np.ones(d, np.float32)
        q = rng.randint(-4, 5, (B, d)).astype(np.float32)
        cents = rng.randint(-4, 5, (kc, d)).astype(np.float32)
        rot = np.zeros((d, d), np.float32)
        rot[np.arange(d), rng.permutation(d)] = rng.choice([-1.0, 1.0], d)
    else:
        decoded = rng.randint(-127, 128, (rows, d)).astype(np.int8)
        scale = (0.01 + 0.02 * rng.rand(d)).astype(np.float32)
        cents = rng.randn(kc, d).astype(np.float32)
        q = (cents[rng.randint(0, kc, B)]
             + 0.5 * rng.randn(B, d)).astype(np.float32)
        rot = _random_orthogonal(d, rng)
    if elem == "bf16":
        # the same rows as a bf16 cache: bf16(int8 * bf16(scale))
        sc = _bf16_as_f32(jnp.asarray(scale, jnp.bfloat16))
        decoded = _bf16_as_f32(jnp.asarray(decoded.astype(np.float32) * sc,
                                           jnp.bfloat16))
        scale = None
    return dict(cells=cells, offsets=offsets, sizes=sizes, q=q, cents=cents,
                rot=rot if apply_rot else None, decoded=decoded, scale=scale,
                ids2d=ids2d, kc=kc)


def _qc_both(a, *, pb, base_mult, apply_rot, nf=128, chunk=256):
    kw = dict(kc=a["kc"], chunk=chunk, norm_coef=1.0, pb=pb, nf=nf,
              apply_rot=apply_rot, base_mult=base_mult)
    bf16 = a["scale"] is None
    jd, jp = j_scan.grouped_dense_scan_qc(
        jnp.asarray(a["cells"]), jnp.asarray(a["offsets"]),
        jnp.asarray(a["sizes"]), jnp.asarray(a["q"]),
        jnp.asarray(a["cents"]),
        None if a["rot"] is None else jnp.asarray(a["rot"]),
        jnp.asarray(a["decoded"], jnp.bfloat16 if bf16 else jnp.int8),
        None if bf16 else jnp.asarray(a["scale"]), jnp.asarray(a["ids2d"]),
        interpret=True, **kw)
    td, tp = t_scan.grouped_dense_scan_qc(
        torch.from_numpy(a["cells"]), torch.from_numpy(a["offsets"]),
        torch.from_numpy(a["sizes"]), torch.from_numpy(a["q"]),
        torch.from_numpy(a["cents"]),
        None if a["rot"] is None else torch.from_numpy(a["rot"]),
        torch.from_numpy(a["decoded"]).to(torch.bfloat16 if bf16
                                          else torch.int8),
        None if bf16 else torch.from_numpy(a["scale"]),
        torch.from_numpy(a["ids2d"]), **kw)
    return np.asarray(jd), np.asarray(jp), td.numpy(), tp.numpy()


@pytest.mark.parametrize("base_mult", [1.0, 2.0])
@pytest.mark.parametrize("apply_rot", [False, True])
@pytest.mark.parametrize("elem", ["int8", "bf16"])
def test_qc_scan_integer_valued_is_exact(elem, apply_rot, base_mult):
    rng = np.random.RandomState(7 + int(apply_rot) + 3 * int(base_mult))
    a = _qc_inputs(rng, "integer", elem, apply_rot)
    jd, jp, td, tp = _qc_both(a, pb=8, base_mult=base_mult,
                              apply_rot=apply_rot)
    assert td.shape == jd.shape == (16, 4, 128)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("pb,nf", [(16, 128), (8, 256)])
@pytest.mark.parametrize("apply_rot", [False, True])
@pytest.mark.parametrize("elem", ["int8", "bf16"])
def test_qc_scan_random_floats(elem, apply_rot, pb, nf):
    rng = np.random.RandomState(11 + pb + int(apply_rot))
    a = _qc_inputs(rng, "float", elem, apply_rot)
    jd, jp, td, tp = _qc_both(a, pb=pb, base_mult=2.0, apply_rot=apply_rot,
                              nf=nf)
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    # bf16 products summed in f32 in another order, and the interpret-mode
    # kernel may keep the dequantized rows and their squares above bf16
    # precision (C.6): scores to 1e-3 relative, ids on >= 97% of lanes
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-3, atol=1e-3)
    assert (tp == jp).mean() >= 0.97


def test_qc_prologue_matches_placed_tiles():
    # the qc scan is the in-kernel-norms scan over the tiles the placement
    # route would build from v = -2 (q - c), base = 2 |q - c|^2
    rng = np.random.RandomState(3)
    a = _qc_inputs(rng, "integer", "int8", False)
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in a.items()}
    r = t["q"][:, None, :] - t["cents"][t["cells"].long()]
    qd, qp = t_scan.grouped_dense_scan_qc(
        t["cells"], t["offsets"], t["sizes"], t["q"], t["cents"], None,
        t["decoded"], t["scale"], t["ids2d"], kc=8, chunk=256, pb=16)
    gd, gp = t_scan.grouped_dense_scan(
        t["cells"], t["offsets"], t["sizes"], (-2.0 * r).to(torch.bfloat16),
        2.0 * torch.sum(r * r, dim=-1), t["decoded"], t["scale"],
        t["ids2d"], None, kc=8, k_out=10, chunk=256, pb=16, merge="fold")
    assert torch.equal(qd, gd) and torch.equal(qp, gp)


# -------------------------------------------------------- index routes
N, D, KC, K, W = 3000, 128, 64, 10, 8

_KNOBS = {
    "qc": {"IVFADC_VBASE": "qc"},
    "coarse_v2": {"IVFADC_COARSE_ENGINE": "v2"},
    "rank_v2": {"IVFADC_RANK_ENGINE": "v2"},
    "approx": {"IVFADC_MERGE_TOPK": "approx"},
    "all": {"IVFADC_VBASE": "qc", "IVFADC_COARSE_ENGINE": "v2",
            "IVFADC_RANK_ENGINE": "v2", "IVFADC_MERGE_TOPK": "approx",
            "IVFADC_MERGE_RECALL": "0.9"},
}


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


def _agreement(ti, td, ji, jd, *, ids_min, rtol, atol=1e-4):
    assert ti.shape == ji.shape and ti.dtype == ji.dtype == np.int32
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    same = ti == ji
    assert same.mean() >= ids_min, same.mean()
    fin = same & np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=rtol, atol=atol)


def _tie_agreement(ti, td, ji, jd, *, ids_min, rtol, atol=1e-4):
    """As `_agreement`, for a merge whose ties fall another way: JAX's
    approx_min_k (exact off the TPU: a full sort) keeps other ids among
    equal distances than the payload top-k kernel, and points with one PQ
    code in one cell tie exactly. Sorted distances agree place by place;
    an id counts when the other result holds it or when its distance ties
    the other result's k-th."""
    assert ti.shape == ji.shape and ti.dtype == ji.dtype == np.int32
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=rtol, atol=atol)
    hits = [np.isin(a, b) | (np.abs(da - db[-1]) <= 1e-4 * abs(db[-1]))
            for a, da, b, db in zip(ti, td, ji, jd)]
    assert np.mean(hits) >= ids_min, np.mean(hits)


class _Spy:
    """Records the calls of one function of a module (both packages)."""

    def __init__(self, monkeypatch, module, name):
        self.calls = []
        real = getattr(module, name)

        def spy(*args, **kw):
            self.calls.append(kw)
            return real(*args, **kw)

        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("B", [8, 64])       # per-probe and grouped scans
@pytest.mark.parametrize("knob", list(_KNOBS))
def test_index_engine_routes_match_jax(jax_index, queries, knob, B,
                                       monkeypatch):
    for var, val in _KNOBS[knob].items():
        monkeypatch.setenv(var, val)
    jqc = _Spy(monkeypatch, j_scan, "grouped_dense_scan_qc")
    tqc = _Spy(monkeypatch, t_scan, "grouped_dense_scan_qc")
    tv = from_reference(jax_index, "cpu")
    ji, jd = jax_index.search_padded(queries[:B], K, w=W)
    ti, td = tv.search_padded(queries[:B], K, w=W)
    # the qc gate admits the grouped batch only (B*w >= 4*kc), in both
    qc = "IVFADC_VBASE" in _KNOBS[knob] and B * W >= 4 * KC
    assert len(jqc.calls) == len(tqc.calls) == int(qc)
    # every knob moves the arithmetic by bf16 roundings at most: in-kernel
    # bf16 squares (qc; the interpret-mode kernel may keep them in f32,
    # C.6), hi/lo rows (coarse v2; JAX runs its unfused probe at kc = 64):
    # ids on >= 97% of slots, distances to 1e-3 relative. Under approx the
    # JAX merge orders ties another way (tie-aware)
    if "IVFADC_MERGE_TOPK" in _KNOBS[knob] and B * W >= 4 * KC:
        _tie_agreement(ti, td, ji, jd, ids_min=0.97, rtol=1e-3)
    else:
        _agreement(ti, td, ji, jd, ids_min=0.97, rtol=1e-3)
    if knob in ("rank_v2", "approx"):
        # one function either way: the port's default route, bit for bit
        for var in _KNOBS[knob]:
            monkeypatch.delenv(var)
        di, dd = tv.search_padded(queries[:B], K, w=W)
        np.testing.assert_array_equal(ti, di)
        np.testing.assert_array_equal(td, dd)


def test_engine_knobs_reach_the_kernels(jax_index, queries, monkeypatch):
    # rank v2 reaches the counting prep, coarse v2 the fused probe, approx
    # the merge, per search call and without rebuilding anything
    seen = {}
    real_rank, real_probe = t_scan.tile_slots, t_index.coarse_probe_vbase

    def rank_spy(*args, **kw):
        seen["rank"] = kw.get("engine")
        return real_rank(*args, **kw)

    def probe_spy(*args, **kw):
        seen["probe"] = kw.get("engine")
        return real_probe(*args, **kw)

    monkeypatch.setattr(t_scan, "tile_slots", rank_spy)
    monkeypatch.setattr(t_index, "coarse_probe_vbase", probe_spy)
    tv = from_reference(jax_index, "cpu")
    tv.search_padded(queries, K, w=W)
    assert seen == {"rank": "v1", "probe": "v1"}
    monkeypatch.setenv("IVFADC_RANK_ENGINE", "v2")
    monkeypatch.setenv("IVFADC_COARSE_ENGINE", "v2")
    tv.search_padded(queries, K, w=W)
    assert seen == {"rank": "v2", "probe": "v2"}
    monkeypatch.setenv("IVFADC_MERGE_TOPK", "approx")
    monkeypatch.setenv("IVFADC_MERGE_RECALL", "0.8")
    assert t_index._env_merge_topk() == "approx:0.8"
    monkeypatch.setenv("IVFADC_VBASE", "quick")
    with pytest.raises(ValueError, match="IVFADC_VBASE"):
        tv.search_padded(queries, K, w=W)
    monkeypatch.setenv("IVFADC_VBASE", "place")
    monkeypatch.setenv("IVFADC_MERGE_TOPK", "heap")
    with pytest.raises(ValueError, match="IVFADC_MERGE_TOPK"):
        tv.search_padded(queries, K, w=W)


@pytest.mark.parametrize("case", ["euclidean", "small_batch",
                                  "inner_product", "pure_score"])
def test_qc_gate_takes_the_jax_route(jax_index, queries, case, monkeypatch):
    # the qc gate, letter for letter: euclidean metrics, B*w < 4*kc and
    # inner-product scores fall through to the placement route in both
    # packages; the "pure" score takes qc with base_mult 1 in both
    monkeypatch.setenv("IVFADC_VBASE", "qc")
    changes, B = {}, 64
    if case == "euclidean":
        changes = dict(coarse_metric="euclidean",
                       quantization_metric="euclidean")
    elif case == "small_batch":
        B = 16                                    # 128 < 4 * kc = 256
    elif case == "inner_product":
        changes = dict(quantization_metric="inner_product")
    else:
        changes = dict(score_mode="pure")
    jv = _jax_variant(jax_index, **changes)
    tv = from_reference(jv, "cpu")
    jqc = _Spy(monkeypatch, j_scan, "grouped_dense_scan_qc")
    tqc = _Spy(monkeypatch, t_scan, "grouped_dense_scan_qc")
    ji, jd = jv.search_padded(queries[:B], K, w=W)
    ti, td = tv.search_padded(queries[:B], K, w=W)
    qc = case == "pure_score"
    assert len(jqc.calls) == len(tqc.calls) == int(qc)
    if qc:
        assert jqc.calls[0]["base_mult"] == tqc.calls[0]["base_mult"] == 1.0
    _agreement(ti, td, ji, jd, ids_min=0.95, rtol=2e-3, atol=0.05)


def _jax_variant(index, **changes):
    from ivfadc_tpu.models.coarse import NaiveCoarseQuantizer as JaxCoarse
    from ivfadc_tpu.ops.metrics import get_metric as j_get_metric
    coarse = index.coarse
    if "coarse_metric" in changes:
        coarse = JaxCoarse(index.coarse.centroids,
                           j_get_metric(changes["coarse_metric"]))
    return JaxIndex(dataclasses.replace(index.config, **changes), coarse,
                    index.quantizer, index.store, index.data_dtype, index.dim)


def test_opq_file_under_every_engine(tmp_path, monkeypatch):
    # a JAX-built OPQ index through a format-v1 file: the qc route rotates
    # bf16(r) in its kernel, coarse v2 rotates q once and the table's rows
    # come pre-rotated
    data = synthetic_clustered(2048, D, seed=2)
    rng = np.random.RandomState(4)
    q = (data[rng.randint(0, 2048, 64)]
         + 0.05 * rng.randn(64, D)).astype(np.float32)
    jidx = JaxIndex.build(data, kc=64, m=8, k=16, seed=0, scan_mode="dense",
                          quantization_method="opq", opq_iters=1)
    path = str(tmp_path / "opq.npz")
    jidx.save(path)
    tidx = load_ivfadc_index(path, device="cpu")
    for var, val in _KNOBS["all"].items():
        monkeypatch.setenv(var, val)
    tqc = _Spy(monkeypatch, t_scan, "grouped_dense_scan_qc")
    ji, jd = jidx.search_padded(q, K, w=W)
    ti, td = tidx.search_padded(q, K, w=W)
    assert len(tqc.calls) == 1 and tqc.calls[0]["apply_rot"]
    _tie_agreement(ti, td, ji, jd, ids_min=0.97, rtol=1e-3)
