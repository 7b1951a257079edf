"""The port's out-of-core build (`IVFADCIndex.build_streaming` /
`build_from_files`) against the JAX package's, on the CPU.

  * pass 1's reservoir sample is NumPy in both packages: the training
    arrays must be equal bit for bit (captured by replacing each module's
    `_train_components` for the call, which stops the build there);
  * pass 2 given the same trained components (JAX's, carried across):
    every point in the same cell with the same code, but for points whose
    two nearest centroids (or codewords) tie within 1e-6 relative (the
    packages order the distance arithmetic differently), which are counted;
  * `build_streaming(chunks, train_data=X)` equals `build(X)` bit for bit
    (store and searches): one training, one cell arithmetic
    (`ops.kmeans.assign_blocks`), one CSR builder;
  * the reservoir path's recall within 0.08 of the full build's (the JAX
    package's own bound, tests/test_streaming_build.py);
  * the error cases raise what the JAX package raises.
"""

import numpy as np
import pytest
import torch

import ivfadc_tpu.models.index as jax_index_mod
import ivfadc_tpu_torch.models.index as port_index_mod
from ivfadc_tpu import IVFADCIndex as JaxIndex
from ivfadc_tpu_torch import IVFADCIndex
from ivfadc_tpu_torch.convert import from_reference
from ivfadc_tpu_torch.ops.kmeans import KMeansResult
from ivfadc_tpu_torch.utils.evaluation import brute_force_topk, recall_at_r

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)

CFG = dict(kc=32, k=64, m=4, seed=3, coarse_maxiter=8,
           quantization_maxiter=8)


def _clustered(n, d, seed=0, nc=16):
    rng = np.random.RandomState(seed)
    centers = rng.randn(nc, d).astype(np.float32) * 3
    return (centers[rng.randint(0, nc, n)]
            + rng.randn(n, d).astype(np.float32) * 0.3)


def _chunks(data, rows):
    return [data[i:i + rows] for i in range(0, len(data), rows)]


class _Stop(Exception):
    """Raised by the captured `_train_components` to end a build there."""


def _capture_train(monkeypatch, module, pos):
    """Replace module._train_components by one that records its training
    array (positional argument `pos`) and stops the build."""
    seen = []

    def capture(*args, **kwargs):
        seen.append(np.asarray(args[pos]))
        raise _Stop

    monkeypatch.setattr(module, "_train_components", capture)
    return seen


@pytest.mark.parametrize("case", [
    dict(rows=700, train_sample=1024),     # reservoir: most chunks replace
    dict(rows=1, train_sample=300),        # one draw a chunk
    dict(rows=1000, train_sample=5000),    # the sample holds the stream
    dict(rows=700, train_data=True),       # pass 1 skipped
])
def test_training_sample_equals_jax(monkeypatch, case):
    data = _clustered(3000 if case["rows"] > 1 else 900, 24, seed=1)
    kw = dict(CFG, kc=8, k=16)
    extra = {}
    if case.get("train_data"):
        extra["train_data"] = data[::2]
    else:
        extra["train_sample"] = case["train_sample"]
    jax_seen = _capture_train(monkeypatch, jax_index_mod, 2)
    port_seen = _capture_train(monkeypatch, port_index_mod, 0)
    with pytest.raises(_Stop):
        JaxIndex.build_streaming(_chunks(data, case["rows"]), **extra, **kw)
    with pytest.raises(_Stop):
        IVFADCIndex.build_streaming(_chunks(data, case["rows"]),
                                    device="cpu", **extra, **kw)
    (j,), (t,) = jax_seen, port_seen
    assert j.dtype == t.dtype == np.float32 and j.shape == t.shape
    np.testing.assert_array_equal(t, j)
    if not case.get("train_data"):
        assert len(t) == min(len(data), case["train_sample"])


def _per_point(store, n):
    """(cell, code row) of every id 0..n-1 from a store's host arrays."""
    offsets, caps = np.asarray(store.offsets), np.asarray(store.caps)
    ids, codes = np.asarray(store.ids), np.asarray(store.codes)
    cell_of_slot = np.full(len(ids), -1, np.int64)
    for c in range(len(offsets)):
        cell_of_slot[offsets[c]:offsets[c] + caps[c]] = c
    live = np.nonzero(ids >= 0)[0]
    cell = np.full(n, -1, np.int64)
    code = np.zeros((n, codes.shape[1]), codes.dtype)
    cell[ids[live]] = cell_of_slot[live]
    code[ids[live]] = codes[live]
    return cell, code


def _rel_tie(a, b):
    return abs(a - b) <= 1e-6 * max(abs(a), abs(b))


def test_pass2_equals_jax_given_its_components(monkeypatch):
    data = _clustered(3000, 24, seed=1)
    j = JaxIndex.build_streaming(_chunks(data, 700), train_sample=1024,
                                 **CFG)
    ref = from_reference(j, "cpu")

    def jax_components(xd, config, cmetric, qmetric, timer):
        return KMeansResult(ref.coarse.centroids, None), None, ref.quantizer

    monkeypatch.setattr(port_index_mod, "_train_components", jax_components)
    t = IVFADCIndex.build_streaming(_chunks(data, 700), train_sample=1024,
                                    device="cpu", **CFG)
    n = len(data)
    jc, jcode = _per_point(j.store, n)
    tc, tcode = _per_point(t.store, n)
    assert (jc >= 0).all() and (tc >= 0).all()
    x = data.astype(np.float64)
    cents = np.asarray(j.coarse.centroids, np.float64)
    cb = np.asarray(j.quantizer.codebooks, np.float64)     # (m, k, dsub)
    m, _, dsub = cb.shape
    cell_ties = code_ties = 0
    for i in np.nonzero(jc != tc)[0]:
        da = ((x[i] - cents[jc[i]]) ** 2).sum()
        db = ((x[i] - cents[tc[i]]) ** 2).sum()
        assert _rel_tie(da, db), (i, jc[i], tc[i], da, db)
        cell_ties += 1
    same_cell = jc == tc
    for i, s in zip(*np.nonzero((jcode != tcode) & same_cell[:, None])):
        r = (x[i] - cents[jc[i]])[s * dsub:(s + 1) * dsub]
        da = ((r - cb[s, jcode[i, s]]) ** 2).sum()
        db = ((r - cb[s, tcode[i, s]]) ** 2).sum()
        assert _rel_tie(da, db), (i, s, da, db)
        code_ties += 1
    # ties found here: none at this data (counted, so a change shows)
    assert cell_ties + code_ties <= 3, (cell_ties, code_ties)
    if cell_ties == 0:
        for key in ("offsets", "caps", "sizes", "ids"):
            np.testing.assert_array_equal(getattr(t.store, key),
                                          np.asarray(getattr(j.store, key)),
                                          err_msg=key)
    if cell_ties + code_ties == 0:
        np.testing.assert_array_equal(t.store.codes, np.asarray(j.store.codes))


@pytest.mark.parametrize("rows,coarse", [(700, "naive"), (1, "naive"),
                                         (512, "hnsw")])
def test_streaming_with_train_data_equals_build(rows, coarse):
    n = 3000 if rows > 1 else 600
    data = _clustered(n, 24, seed=1)
    kw = dict(CFG, scan_mode="dense", coarse_quantizer=coarse)
    ref = IVFADCIndex.build(data, device="cpu", **kw)
    idx = IVFADCIndex.build_streaming(_chunks(data, rows), train_data=data,
                                      device="cpu", **kw)
    for key in ("offsets", "caps", "sizes", "codes", "ids"):
        np.testing.assert_array_equal(getattr(idx.store, key),
                                      getattr(ref.store, key), err_msg=key)
    assert torch.equal(idx.coarse.centroids, ref.coarse.centroids)
    assert torch.equal(idx.quantizer.codebooks, ref.quantizer.codebooks)
    assert idx.data_dtype == ref.data_dtype and len(idx) == n
    q = data[:64] + 0.01
    for w in (2, 16):          # the per-probe and the grouped route
        ri, rd = ref.search_padded(q, 10, w=w)
        si, sd = idx.search_padded(q, 10, w=w)
        np.testing.assert_array_equal(si, ri)
        np.testing.assert_array_equal(sd, rd)
    assert {"encode", "build_lists", "coarse_kmeans"} <= set(
        idx.build_timings)


def test_streaming_reservoir_recall_matches_full_build():
    data = _clustered(4000, 16, seed=2)
    kw = dict(kc=16, k=32, m=4, seed=0, coarse_maxiter=10,
              quantization_maxiter=10, device="cpu")
    full = IVFADCIndex.build(data, **kw)
    idx = IVFADCIndex.build_streaming(_chunks(data, 900), train_sample=1024,
                                      **kw)
    assert len(idx) == 4000 and "sample" in idx.build_timings
    q = data[:128]
    _, gt = brute_force_topk(data, q, 10)
    r_full = recall_at_r(full.search_padded(q, 10, w=8)[0], gt, 10)
    r_strm = recall_at_r(idx.search_padded(q, 10, w=8)[0], gt, 10)
    assert r_strm >= r_full - 0.08, (r_strm, r_full)


def _no_training(*args, **kwargs):
    raise AssertionError("training ran before the capacity check")


_ERROR_CASES = {
    "one_shot_generator": (
        lambda d: dict(chunks=(c for c in _chunks(d(1200, 8, 3), 300)),
                       kc=4, k=16, m=2, train_sample=256),
        "re-iterable"),
    "mismatched_dims": (
        lambda d: dict(chunks=[np.zeros((100, 8), np.float32),
                               np.zeros((100, 9), np.float32)],
                       kc=4, k=16, m=2),
        "dim"),
    "non_2d_chunk_on_pass2": (
        lambda d: dict(chunks=[d(600, 8, 20)[:300], d(600, 8, 20)[300]],
                       train_data=d(600, 8, 20), kc=4, k=16, m=2,
                       coarse_maxiter=3, quantization_maxiter=3),
        "2-D"),
    "kc_above_train_sample": (
        lambda d: dict(chunks=_chunks(d(800, 8, 21), 200), kc=64, k=16, m=2,
                       train_sample=32),
        "kc=64.*train_sample"),
    "capacity_before_training": (
        lambda d: dict(chunks=_chunks(d(300, 8, 22), 100), kc=4, k=16, m=2,
                       index_dtype="uint8", train_sample=128),
        "bits"),
}


@pytest.mark.parametrize("case", sorted(_ERROR_CASES))
def test_streaming_errors_equal_jax(monkeypatch, case):
    make, match = _ERROR_CASES[case]

    def data(n, d, seed):
        return _clustered(n, d, seed=seed)

    if case == "capacity_before_training":
        monkeypatch.setattr(jax_index_mod, "_train_components", _no_training)
        monkeypatch.setattr(port_index_mod, "_train_components",
                            _no_training)
    kw = make(data)
    with pytest.raises(AssertionError, match=match):
        JaxIndex.build_streaming(kw.pop("chunks"), **kw)
    kw = make(data)
    with pytest.raises(AssertionError, match=match):
        IVFADCIndex.build_streaming(kw.pop("chunks"), device="cpu", **kw)
