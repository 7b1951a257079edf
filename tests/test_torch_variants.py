"""The scan kernels' remaining variants against the JAX package, on the CPU.

Position payloads (pos8 / int32, 8-row aligned cells), the bf16 decoded
cache, the exact merge and in-kernel extraction, first kernel by kernel
(the JAX wrappers run their Pallas kernels in interpret mode, the port's
wrappers their plain versions on CPU tensors), then through whole indexes
carried across from the JAX package, by attribute access and through
format-v1 files.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ivfadc_tpu import IVFADCIndex as JaxIndex
from ivfadc_tpu.models import coarse as j_coarse
from ivfadc_tpu.ops import pallas_scan as j_scan
from ivfadc_tpu.ops.metrics import get_metric as j_metric
from ivfadc_tpu_torch import load_ivfadc_index
from ivfadc_tpu_torch.convert import from_reference
from ivfadc_tpu_torch.models import coarse as t_coarse
from ivfadc_tpu_torch.models import index as t_index
from ivfadc_tpu_torch.ops import cell_rank as t_rank
from ivfadc_tpu_torch.ops import dense_scan as t_scan
from ivfadc_tpu_torch.ops.metrics import get_metric as t_metric
from ivfadc_tpu_torch.utils.datasets import synthetic_clustered

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)


# ------------------------------------------------------------------ inputs
def _inputs(rng, kind: str, *, align: int = 128, big: bool = False,
            kc: int = 8, B: int = 16, w: int = 4):
    """Scan inputs: cells with an empty one and sizes that are no
    128-multiple, starts `align`-aligned. `big` adds a cell of 126 blocks
    and one row whose last row (block 126) is its only zero row, so it
    wins its lane on integer-valued rows. kind: "integer" (every product
    and sum exact in f32: bit-exact in any order), "pow2" (power-of-two
    scales: rows exact in bf16) or "float"."""
    d = 128
    sizes = np.array([0, 5, 128, 130, 300, 511, 1, 257][:kc], np.int32)
    if big:
        sizes[5] = 126 * 128 + 1
    caps = ((sizes + align) // align) * align
    offsets = np.concatenate([[align], align + np.cumsum(caps[:-1])]) \
        .astype(np.int32)
    rows = -(-(int(offsets[-1] + caps[-1]) + 1024 + 128) // 128) * 128
    cells = rng.randint(0, kc, (B, w)).astype(np.int32)
    cells[0, :2] = (0, 5)                         # the empty and the big cell
    if kind == "integer":
        decoded = rng.randint(-3, 4, (rows, d)).astype(np.int8)
        scale = np.ones(d, np.float32)
        v = rng.randint(-4, 5, (B, w, d)).astype(np.float32)
        base = rng.randint(0, 100, (B, w)).astype(np.float32)
        if big:
            decoded[offsets[5]:offsets[5] + sizes[5] - 1] = 3
            decoded[offsets[5] + sizes[5] - 1] = 0
    else:
        decoded = rng.randint(-127, 128, (rows, d)).astype(np.int8)
        scale = (2.0 ** -rng.randint(5, 8, d) if kind == "pow2"
                 else 0.01 + 0.02 * rng.rand(d)).astype(np.float32)
        v = rng.randn(B, w, d).astype(np.float32)
        base = (10 + rng.rand(B, w)).astype(np.float32)
    base[1, 0] = np.inf                           # a padded probe
    v = np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    ids2d = rng.permutation(rows).astype(np.int32).reshape(-1, 128)
    norms = rng.randint(0, 50, rows).astype(np.float32)
    return dict(cells=cells, offsets=offsets, sizes=sizes, v=v, base=base,
                decoded=decoded, scale=scale, ids2d=ids2d,
                norms2d=norms.reshape(-1, 128), kc=kc)


def _as_bf16_cache(a):
    """The same rows as a bf16 cache: bf16(int8 * bf16(scale)), no scale."""
    sc = np.asarray(jnp.asarray(a["scale"]).astype(jnp.bfloat16)
                    .astype(jnp.float32))
    rows = np.asarray(jnp.asarray(a["decoded"].astype(np.float32) * sc)
                      .astype(jnp.bfloat16).astype(jnp.float32))
    return dict(a, decoded=rows, scale=None)


def _grouped_both(a, ids=True, norms=False, bf16=False, **kw):
    """`grouped_dense_scan` of both packages on inputs `a`."""
    if bf16:
        jdec = jnp.asarray(a["decoded"], jnp.bfloat16)
        tdec = torch.from_numpy(a["decoded"]).to(torch.bfloat16)
    else:
        jdec, tdec = jnp.asarray(a["decoded"]), torch.from_numpy(a["decoded"])
    sc = a["scale"]
    jd, jp = j_scan.grouped_dense_scan(
        jnp.asarray(a["cells"]), jnp.asarray(a["offsets"]),
        jnp.asarray(a["sizes"]), jnp.asarray(a["v"], jnp.bfloat16),
        jnp.asarray(a["base"]), jdec, None if sc is None else jnp.asarray(sc),
        jnp.asarray(a["ids2d"]) if ids else None,
        jnp.asarray(a["norms2d"]) if norms else None, interpret=True, **kw)
    td, tp = t_scan.grouped_dense_scan(
        torch.from_numpy(a["cells"]), torch.from_numpy(a["offsets"]),
        torch.from_numpy(a["sizes"]),
        torch.from_numpy(a["v"]).to(torch.bfloat16),
        torch.from_numpy(a["base"]), tdec,
        None if sc is None else torch.from_numpy(sc),
        torch.from_numpy(a["ids2d"]) if ids else None,
        torch.from_numpy(a["norms2d"]) if norms else None, **kw)
    return np.asarray(jd), np.asarray(jp), td.numpy(), tp.numpy()


def _probe_both(a, bf16=False, **kw):
    """`dense_scan` of both packages on the probes of inputs `a`."""
    st, sz = a["offsets"][a["cells"]], a["sizes"][a["cells"]]
    sc = a["scale"]
    jd, jp = j_scan.dense_scan(
        jnp.asarray(st), jnp.asarray(sz), jnp.asarray(a["v"]),
        jnp.asarray(a["base"]),
        jnp.asarray(a["decoded"], jnp.bfloat16 if bf16 else None),
        None if sc is None else jnp.asarray(sc), interpret=True, **kw)
    dec = torch.from_numpy(a["decoded"])
    td, tp = t_scan.dense_scan(
        torch.from_numpy(st), torch.from_numpy(sz), torch.from_numpy(a["v"]),
        torch.from_numpy(a["base"]), dec.to(torch.bfloat16) if bf16 else dec,
        None if sc is None else torch.from_numpy(sc), **kw)
    return np.asarray(jd), np.asarray(jp), td.numpy(), tp.numpy()


def _assert_exact_merge(jd, jp, td, tp, k, *, tol=None):
    """Exact-merge buffers: per probe the sorted k smallest distances are
    equal (or within `tol`), and every (distance, slot) pair strictly below
    the k-th distance is in both buffers: only which slots hold a tied k-th
    distance may differ (the TPU merges per DMA chunk, the port per 128-row
    group)."""
    jd, jp = jd.reshape(-1, jd.shape[-1]), jp.reshape(-1, jp.shape[-1])
    td, tp = td.reshape(-1, td.shape[-1]), tp.reshape(-1, tp.shape[-1])
    js, ts = np.sort(jd, axis=1)[:, :k], np.sort(td, axis=1)[:, :k]
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    fin = np.isfinite(js)
    if tol is None:
        np.testing.assert_array_equal(ts, js)
    else:
        np.testing.assert_allclose(ts[fin], js[fin], **tol)
    agree = []
    for r in range(jd.shape[0]):
        kth = js[r, -1]
        if tol is not None and np.isfinite(kth):   # clear of near-ties
            kth = kth - 1e-3 * abs(kth)
        a = set(jp[r][jd[r] < kth].tolist())
        b = set(tp[r][td[r] < kth].tolist())
        if tol is None:
            assert a == b, r
        elif a:
            agree.append(len(a & b) / len(a))
    if agree:
        assert np.mean(agree) >= 0.99


# ------------------------------------------------------ position payloads
@pytest.mark.parametrize("pb,pos8,dtype", [(32, True, np.int8),
                                           (16, True, np.int32),
                                           (64, False, np.int32)])
@pytest.mark.parametrize("kind", ["integer", "pow2"])
def test_position_payloads_match_jax(pb, pos8, dtype, kind):
    # 8-row aligned cells, no ids2d: block-index payloads, int8 only from
    # pb = 32 on; in-kernel norms
    a = _inputs(np.random.RandomState(pb), kind, align=8, big=True)
    jd, jp, td, tp = _grouped_both(a, ids=False, kc=a["kc"], k_out=10,
                                   chunk=1024, norm_coef=1.0, pb=pb,
                                   merge="fold", nf=128, pos8=pos8)
    assert tp.dtype == jp.dtype == dtype and td.shape == (16, 4, 128)
    assert np.isinf(td[0, 0]).all() and (tp[0, 0] == -1).all()
    assert np.isinf(td[1, 0]).all() and (tp[1, 0] == -1).all()
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    if kind == "integer":
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)
        assert (tp[0, 1] == 126).any()            # the big cell's last block
    else:
        # identical rows; squares and sums in another order (ROADMAP C.6)
        fin = np.isfinite(jd)
        tol = 2e-3 * np.abs(jd[fin]).max()
        np.testing.assert_allclose(td[fin], jd[fin], rtol=0, atol=tol)
        assert (tp == jp).mean() >= 0.98


# --------------------------------------------------------------- bf16 cache
@pytest.mark.parametrize("variant", ["ids", "knorm", "pos", "exact",
                                     "extract"])
def test_bf16_cache_grouped_variants_match_jax(variant):
    a = _as_bf16_cache(_inputs(np.random.RandomState(len(variant)),
                               "integer", align=8 if variant == "pos"
                               else 128))
    kw = dict(kc=a["kc"], k_out=10, chunk=256, norm_coef=1.0, pb=16,
              merge="exact" if variant == "exact" else "fold", nf=128)
    if variant == "extract":
        kw["extract_k"] = 10
    jd, jp, td, tp = _grouped_both(
        a, ids=variant in ("ids", "knorm", "extract"),
        norms=variant == "ids", bf16=True, **kw)
    assert td.shape == jd.shape
    if variant == "exact":
        _assert_exact_merge(jd, jp, td, tp, 10)
    else:
        # integer-valued bf16 rows: bit for bit
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("kind", ["integer", "float"])
def test_bf16_cache_cached_norms_random(kind):
    # the bf16 rows are exact in both packages: with cached norms only the
    # order of the f32 dot sums differs
    a = _as_bf16_cache(_inputs(np.random.RandomState(3), kind))
    jd, jp, td, tp = _grouped_both(a, ids=True, norms=True, bf16=True,
                                   kc=a["kc"], k_out=10, chunk=256,
                                   norm_coef=1.0, pb=8, merge="fold", nf=256)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-4)
    assert (tp == jp).mean() >= 0.999


@pytest.mark.parametrize("merge", ["fold", "exact"])
def test_bf16_cache_dense_scan_matches_jax(merge):
    a = _as_bf16_cache(_inputs(np.random.RandomState(4), "integer", B=8))
    jd, jp, td, tp = _probe_both(a, bf16=True, k_out=10, chunk=256,
                                 norm_coef=1.0, merge=merge, nf=128)
    if merge == "exact":
        _assert_exact_merge(jd, jp, td, tp, 10)
    else:
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)


# -------------------------------------------------------------- exact merge
@pytest.mark.parametrize("pb,k_out", [(8, 10), (64, 10), (16, 128)])
@pytest.mark.parametrize("kind", ["integer", "float"])
def test_exact_merge_grouped_matches_jax(pb, k_out, kind):
    # the buffer holds each probe's true top-k_out distances in both
    # packages; slots at a tied k-th distance may differ
    a = _inputs(np.random.RandomState(pb + k_out), kind)
    jd, jp, td, tp = _grouped_both(a, ids=False, kc=a["kc"], k_out=k_out,
                                   chunk=256, norm_coef=1.0, pb=pb,
                                   merge="exact", nf=128)
    assert tp.dtype == np.int32 and td.shape == (16, 4, 128)
    assert np.isinf(td[0, 0]).all() and (tp[0, 0] == -1).all()
    tol = None if kind == "integer" else dict(rtol=0, atol=2e-3 * np.abs(
        jd[np.isfinite(jd)]).max())
    _assert_exact_merge(jd, jp, td, tp, k_out, tol=tol)
    # every kept slot lies in the probe's cell
    st = a["offsets"][a["cells"]][..., None]
    sz = a["sizes"][a["cells"]][..., None]
    kept = tp >= 0
    assert ((tp >= st) & (tp < st + sz))[kept].all()


@pytest.mark.parametrize("kind", ["integer", "float"])
def test_exact_merge_dense_scan_matches_jax(kind):
    a = _inputs(np.random.RandomState(6), kind, B=8)
    jd, jp, td, tp = _probe_both(a, k_out=10, chunk=256, norm_coef=1.0,
                                 merge="exact", nf=128)
    tol = None if kind == "integer" else dict(rtol=0, atol=2e-3 * np.abs(
        jd[np.isfinite(jd)]).max())
    _assert_exact_merge(jd, jp, td, tp, 10, tol=tol)


# --------------------------------------------------------------- extraction
@pytest.mark.parametrize("nf,chunk,pb,k", [(128, 128, 8, 10),
                                           (256, 256, 16, 10),
                                           (128, 128, 8, 64)])
def test_extraction_matches_jax(nf, chunk, pb, k):
    # integer-valued rows: the port's extraction equals the JAX kernel's
    # bit for bit, and equals the per-probe top-k of its own buffered fold
    a = _inputs(np.random.RandomState(nf + k), "integer")
    kw = dict(kc=a["kc"], k_out=k, chunk=chunk, norm_coef=1.0, pb=pb,
              merge="fold", nf=nf)
    jd, jp, td, tp = _grouped_both(a, extract_k=k, **kw)
    assert td.shape == (16, 4, k) and tp.dtype == np.int32
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tp, jp)
    _, _, bd, bp = _grouped_both(a, **kw)         # buffered, in-kernel norms
    for bi in range(16):
        for wi in range(4):
            order = np.argsort(bd[bi, wi], kind="stable")[:k]
            np.testing.assert_array_equal(td[bi, wi], bd[bi, wi][order])
            fin = np.isfinite(td[bi, wi])
            np.testing.assert_array_equal(tp[bi, wi][fin],
                                          bp[bi, wi][order][fin])
            assert (tp[bi, wi][~fin] == -1).all()


# -------------------------------------------------- sort-based tile prep
@pytest.mark.parametrize("with_ids", [True, False])
def test_sort_prep_matches_jax_at_kc_8192(with_ids):
    # kc > 4096: both packages rank the probes by one sort; a few hundred
    # probes keep T_max (bounded by P) small
    rng = np.random.RandomState(8)
    kc, d, B, w = 8192, 128, 40, 8
    align = 128 if with_ids else 8
    sizes = rng.randint(0, 40, kc).astype(np.int32)
    caps = ((sizes + align) // align) * align
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])]).astype(np.int32)
    rows = -(-(int(offsets[-1] + caps[-1]) + 1024 + 128) // 128) * 128
    cells = np.where(rng.rand(B, w) < 0.5, rng.randint(0, 6, (B, w)),
                     rng.randint(0, kc, (B, w))).astype(np.int32)
    a = dict(cells=cells, offsets=offsets, sizes=sizes,
             v=rng.randint(-4, 5, (B, w, d)).astype(np.float32),
             base=rng.randint(0, 100, (B, w)).astype(np.float32),
             decoded=rng.randint(-3, 4, (rows, d)).astype(np.int8),
             scale=np.ones(d, np.float32),
             ids2d=rng.permutation(rows).astype(np.int32).reshape(-1, 128),
             norms2d=rng.randint(0, 50, rows).astype(np.float32)
             .reshape(-1, 128))
    jd, jp, td, tp = _grouped_both(a, ids=with_ids, norms=with_ids, kc=kc,
                                   k_out=10, chunk=128, norm_coef=1.0, pb=16,
                                   merge="fold", nf=128)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("kc", [300, 4096])
def test_sort_and_counting_ranks_place_the_same_tiles(kc, monkeypatch):
    rng = np.random.RandomState(kc)
    B, w, d = 64, 8, 128
    cells = torch.from_numpy(np.where(
        rng.rand(B, w) < 0.3, rng.randint(0, 5, (B, w)),
        rng.randint(0, kc, (B, w))).astype(np.int32))
    sizes = torch.from_numpy(rng.randint(0, 300, kc).astype(np.int32))
    offsets = torch.cumsum(((sizes + 128) // 128) * 128, 0).to(torch.int32)
    v = torch.from_numpy(rng.randn(B, w, d).astype(np.float32))
    base = torch.from_numpy(rng.rand(B, w).astype(np.float32))
    by_count = t_scan.place_tiles(cells, offsets, sizes, v, base, kc=kc,
                                  pb=16)
    monkeypatch.setattr(t_scan, "MAX_KC", 0)      # every kc: the sort
    by_sort = t_scan.place_tiles(cells, offsets, sizes, v, base, kc=kc,
                                 pb=16)
    for x, y in zip(by_count, by_sort):
        assert torch.equal(x, y)
    flat = cells.reshape(-1)
    for x, y in zip(t_scan.sort_ranks(flat, kc),
                    t_rank.cell_ranks(flat, kc=kc)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- indexes
N, D, KC, K, W = 3000, 128, 64, 10, 8


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


@pytest.fixture(scope="module")
def jax_index8(data):
    """8-row cells: no ids2d, position payloads on the grouped scan."""
    return JaxIndex.build(data, kc=KC, m=8, k=16, seed=0, scan_mode="dense",
                          cell_align=8)


def _jax_variant(index, **changes):
    return JaxIndex(dataclasses.replace(index.config, **changes),
                    index.coarse, index.quantizer, index.store,
                    index.data_dtype, index.dim)


def _agreement(ti, td, ji, jd, *, ids_min, rtol, atol=1e-4):
    assert ti.shape == ji.shape and ti.dtype == ji.dtype == np.int32
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    same = ti == ji
    assert same.mean() >= ids_min, same.mean()
    fin = same & np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=rtol, atol=atol)
    assert (np.diff(td, axis=1) >= 0).all()


_ROUTES = {
    # name: (config changes, IVFADC_EXTRACT)
    "bf16": (dict(scan_cache="bf16"), False),
    "exact": (dict(scan_merge="exact"), False),
    "bf16_exact": (dict(scan_cache="bf16", scan_merge="exact"), False),
    "extract": ({}, True),
}


@pytest.mark.parametrize("route", list(_ROUTES))
@pytest.mark.parametrize("B", [8, 64])      # per-probe and grouped scans
def test_index_variant_routes_match_jax(jax_index, queries, route, B,
                                        monkeypatch):
    changes, extract = _ROUTES[route]
    if extract:                  # read at every search, by both packages
        monkeypatch.setenv("IVFADC_EXTRACT", "1")
        monkeypatch.delenv("IVFADC_NO_EXTRACT", raising=False)
    jv = _jax_variant(jax_index, **changes)
    tv = from_reference(jv, "cpu")
    ji, jd = jv.search_padded(queries[:B], K, w=W)
    ti, td = tv.search_padded(queries[:B], K, w=W)
    # the interpret-mode kernels may keep in-kernel bf16 squares in f32
    # (ROADMAP C.6): ids agree on >= 97 % of slots, distances (~1e2) to
    # 1e-3 relative where they do
    _agreement(ti, td, ji, jd, ids_min=0.97, rtol=1e-3)


@pytest.mark.parametrize("pb", [64, 16])     # pos8 (int8) and int32 blocks
@pytest.mark.parametrize("B", [8, 64])
def test_eight_row_cells_match_jax(jax_index8, queries, pb, B):
    jv = _jax_variant(jax_index8, scan_pb=pb)
    tv = from_reference(jv, "cpu")
    assert tv.store.align == 8
    assert tv.store.device_view_dense(tv.quantizer, 1024)["ids2d"] is None
    ji, jd = jv.search_padded(queries[:B], K, w=W)
    ti, td = tv.search_padded(queries[:B], K, w=W)
    _agreement(ti, td, ji, jd, ids_min=0.97, rtol=1e-3)


@pytest.mark.parametrize("which,changes", [
    ("jax_index", dict(scan_cache="bf16")),
    ("jax_index", dict(scan_merge="exact")),
    ("jax_index8", {})])
def test_variant_files_load_in_port(tmp_path, request, queries, which,
                                    changes):
    jv = _jax_variant(request.getfixturevalue(which), **changes)
    path = str(tmp_path / "variant.npz")
    jv.save(path)
    tv = load_ivfadc_index(path, device="cpu")
    for key, val in changes.items():
        assert getattr(tv.config, key) == val
    ji, jd = jv.search_padded(queries, K, w=W)
    ti, td = tv.search_padded(queries, K, w=W)
    _agreement(ti, td, ji, jd, ids_min=0.97, rtol=1e-3)


def test_bf16_view_bit_identical_and_rebuilt(jax_index):
    tv = from_reference(jax_index, "cpu")
    chunk = jax_index.config.scan_chunk
    jb = jax_index.store.device_view_dense(jax_index.quantizer, chunk,
                                           cache="bf16")
    i8 = tv.store.device_view_dense(tv.quantizer, chunk, cache="int8")
    tb = tv.store.device_view_dense(tv.quantizer, chunk, cache="bf16")
    assert tb["cache"] == "bf16" and tb["scale"] is None
    assert tb["decoded"].dtype == torch.bfloat16
    assert i8["decoded"].dtype == torch.int8
    np.testing.assert_array_equal(
        tb["decoded"].float().numpy(),
        np.asarray(jb["decoded"].astype(jnp.float32)))
    for key in ("ids2d", "norms2d", "offsets", "sizes", "ids"):
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]),
                                      err_msg=key)


def test_entry_points_default_to_the_card(jax_index, tmp_path):
    # build, load, load_ivfadc_index and from_reference all place the index
    # on "cuda" unless told otherwise: without a card, asking for none fails
    import inspect
    from ivfadc_tpu_torch import IVFADCIndex
    for fn in (IVFADCIndex.build, IVFADCIndex.load, load_ivfadc_index,
               from_reference):
        assert inspect.signature(fn).parameters["device"].default in (
            None, "cuda"), fn
    if torch.cuda.is_available():
        return
    path = str(tmp_path / "i.npz")
    jax_index.save(path)
    for call in (lambda: from_reference(jax_index),
                 lambda: load_ivfadc_index(path),
                 lambda: IVFADCIndex.build(np.zeros((64, 8), np.float32),
                                           kc=2, m=2, k=4)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()


@pytest.mark.parametrize("extract,no_extract,expect", [
    ("1", None, True), ("1", "0", True), ("1", "", True), ("1", "1", False),
    ("0", None, False), (None, None, False)])
def test_extract_env_read_as_in_jax(monkeypatch, extract, no_extract,
                                    expect):
    from ivfadc_tpu.models import index as j_index
    for var, val in (("IVFADC_EXTRACT", extract),
                     ("IVFADC_NO_EXTRACT", no_extract)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    assert t_index._env_extract() is j_index._env_extract() is expect


def test_two_level_stage2_extraction_matches_jax(monkeypatch):
    # the scan stage 2 with in-kernel extraction (w = 32, 2 w <= 128):
    # integer-valued centroids make it exact, and it equals the buffered
    # route's cells
    monkeypatch.setattr(j_coarse.TwoLevelCoarseQuantizer, "_GATHER_MAX", 64)
    monkeypatch.setattr(t_coarse.TwoLevelCoarseQuantizer, "_GATHER_MAX", 64)
    rng = np.random.RandomState(3)
    cents = rng.randint(-16, 17, (512, 32)).astype(np.float32)
    cents[0] = 127.0                     # the column maxima: scale 1
    assign = rng.randint(0, 23, 512)
    width = int(np.bincount(assign, minlength=23).max())
    members = np.full((23, width), -1, np.int32)
    for gi in range(23):
        ids = np.nonzero(assign == gi)[0]
        members[gi, :len(ids)] = ids
    centers = np.stack([cents[assign == gi].mean(0)
                        for gi in range(23)]).astype(np.float32)
    q = rng.randint(-8, 9, (64, 32)).astype(np.float32)
    jq = j_coarse.TwoLevelCoarseQuantizer.create(
        cents, centers, members, j_metric("sqeuclidean"), 8)
    tq = t_coarse.TwoLevelCoarseQuantizer.create(
        cents, centers, members, t_metric("sqeuclidean"), 8)
    jc, jd = jq.search(jnp.asarray(q), 32, extract=True)
    tc, td = tq.search(torch.from_numpy(q), 32, extract=True)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    bc, bd = tq.search(torch.from_numpy(q), 32)
    np.testing.assert_array_equal(td.numpy(), bd.numpy())
    np.testing.assert_array_equal(tc.numpy(), bc.numpy())
