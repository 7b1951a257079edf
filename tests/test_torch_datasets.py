"""The port's TEXMEX readers, chunked reader and samplers against the JAX
package's, on files the tests write (`tests/test_datasets.py`'s writers):
both are NumPy, so every array must be equal bit for bit. Then
`build_from_files` end to end on the CPU, and the device generator's
shape, dtype and determinism (its bits are torch's, not NumPy's)."""

import numpy as np
import pytest
import torch

import ivfadc_tpu.utils.datasets as jd
import ivfadc_tpu_torch.utils.datasets as td
from ivfadc_tpu_torch import IVFADCIndex
from tests.test_datasets import write_bvecs, write_fvecs, write_ivecs

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt,max_rows", [
    ("fvecs", None), ("fvecs", 3), ("fvecs", 99), ("bvecs", None),
    ("bvecs", 5), ("ivecs", None), ("fvecs_empty", None),
])
def test_readers_equal_jax(tmp_path, fmt, max_rows):
    rng = np.random.RandomState(0)
    p = str(tmp_path / f"x.{fmt[:5]}")
    if fmt == "fvecs":
        write_fvecs(p, rng.randn(57, 13).astype(np.float32))
    elif fmt == "bvecs":
        write_bvecs(p, rng.randint(0, 256, (31, 128)).astype(np.uint8))
    elif fmt == "ivecs":
        write_ivecs(p, rng.randint(0, 10 ** 6, (17, 100)).astype(np.int32))
    else:
        open(p, "wb").close()
    reader = fmt[:5]
    if reader == "ivecs":
        _same(td.read_ivecs(p), jd.read_ivecs(p))
    else:
        _same(getattr(td, f"read_{reader}")(p, max_rows=max_rows),
              getattr(jd, f"read_{reader}")(p, max_rows=max_rows))


def _chunked(mod, paths, **kw):
    ch = mod.VecsChunks(paths, **kw)
    parts = list(ch)
    return ch, (np.concatenate(parts) if parts else np.empty((0, 0)))


def test_vecs_chunks_equal_jax(tmp_path):
    rng = np.random.RandomState(5)
    pa, pb, pe = (str(tmp_path / n) for n in ("a.fvecs", "b.fvecs",
                                              "e.fvecs"))
    write_fvecs(pa, rng.randn(300, 6).astype(np.float32))
    write_fvecs(pb, rng.randn(450, 6).astype(np.float32))
    open(pe, "wb").close()
    pbv = str(tmp_path / "c.bvecs")
    write_bvecs(pbv, rng.randint(0, 256, (700, 16)).astype(np.uint8))
    for paths, kw in (([pa, pe, pb], dict(chunk_rows=128, max_rows=500)),
                      ([pa, pb], dict(chunk_rows=1000)),
                      (pbv, dict(chunk_rows=200)),
                      (pe, dict(chunk_rows=64))):
        jc, jrows = _chunked(jd, paths, **kw)
        tc, trows = _chunked(td, paths, **kw)
        assert (len(tc), tc.dim) == (len(jc), jc.dim)
        _same(trows, jrows)
        _same(np.concatenate(list(tc)) if len(tc) else trows, trows)
    # a generator of paths is materialized once
    _same(_chunked(td, iter([pa]), chunk_rows=64)[1],
          _chunked(jd, iter([pa]), chunk_rows=64)[1])
    pd7 = str(tmp_path / "d7.fvecs")
    write_fvecs(pd7, rng.randn(10, 7).astype(np.float32))
    for bad, match in (([], "no input files"), ([pa, pd7], "dim"),
                       ([str(tmp_path / "x.npy")], "expected")):
        for mod in (jd, td):
            with pytest.raises(ValueError, match=match):
                mod.VecsChunks(iter(bad))
    with pytest.raises(ValueError, match="chunk_rows"):
        td.VecsChunks(pa, chunk_rows=0)


def test_load_or_synthesize_equal_jax(tmp_path):
    write_fvecs(str(tmp_path / "sift_base.fvecs"),
                np.random.RandomState(3).randn(20, 8).astype(np.float32))
    for name in ("sift_base", "gist_base"):
        _same(td.load_or_synthesize(name, 12, 8, data_dir=str(tmp_path)),
              jd.load_or_synthesize(name, 12, 8, data_dir=str(tmp_path)))


@pytest.mark.parametrize("n,size", [(100, 100), (100, 150), (1000, 700),
                                    (10 ** 6, 5000), (10, 3)])
def test_sample_indices_equal_jax(n, size):
    got = td.sample_indices(4, n, size)
    _same(got, jd.sample_indices(4, n, size))
    assert len(np.unique(got)) == min(n, size) and got.max() < n


def test_synthetic_clustered_device_shape_and_determinism():
    a = td.synthetic_clustered_device(500, 12, n_clusters=8, seed=3,
                                      device="cpu")
    b = td.synthetic_clustered_device(500, 12, n_clusters=8, seed=3,
                                      device="cpu")
    c = td.synthetic_clustered_device(500, 12, n_clusters=8, seed=4,
                                      device="cpu")
    assert a.shape == (500, 12) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_build_from_files_end_to_end(tmp_path):
    rng = np.random.RandomState(9)
    centers = rng.randn(16, 16).astype(np.float32) * 3
    data = (centers[rng.randint(0, 16, 2000)]
            + rng.randn(2000, 16).astype(np.float32) * 0.3)
    p = str(tmp_path / "base.fvecs")
    write_fvecs(p, data)
    idx = IVFADCIndex.build_from_files(p, chunk_rows=512, kc=16, k=32, m=4,
                                       seed=0, coarse_maxiter=8,
                                       quantization_maxiter=8,
                                       train_sample=1500, device="cpu")
    assert len(idx) == 2000 and idx.data_dtype == np.float32
    ids, _ = idx.search(data[42], 5, w=4)
    assert ids[0] == 42
    # dynamic ops and persistence on a streamed-in index
    idx.push(data[0])
    assert len(idx) == 2001
    sp = str(tmp_path / "idx.npz")
    idx.save(sp)
    assert len(IVFADCIndex.load(sp, device="cpu")) == 2001
    # with the streamed rows as train_data: the in-memory build, bit for bit
    kw = dict(kc=16, k=32, m=4, seed=0, coarse_maxiter=8,
              quantization_maxiter=8, device="cpu")
    a = IVFADCIndex.build_from_files(p, chunk_rows=300, max_rows=1200,
                                     train_data=data[:1200], **kw)
    b = IVFADCIndex.build(data[:1200], **kw)
    np.testing.assert_array_equal(a.store.codes, b.store.codes)
    np.testing.assert_array_equal(a.store.ids, b.store.ids)
