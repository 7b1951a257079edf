"""The port's search entry point and multi-chip dry run
(`ivfadc_tpu_torch/dryrun.py`) against the JAX package's
(`__graft_entry__.py`), on the CPU.

  * `entry()`: the JAX entry's example arguments, carried across as numpy
    arrays, go through the port's forward and through `jax.jit(fn)`.
  * `dryrun_multichip(8, device="cpu")` on 8 repeated CPU positions of a
    (data=2, shard=4) mesh: as it ships (the asserts hold, the OK line
    prints), and step by step against a JAX child (`_jax_child` of
    tests/test_torch_distributed.py: the JAX package's sharded programs
    never run in a pytest worker, ROADMAP C.2) that runs the JAX dry
    run's same sequence on 8 virtual devices. For that comparison both
    packages' training returns the same integer components (the
    `_integer_pair` recipe: integer centroids, half-integer codewords and
    63.5) and the points are integer-valued, so every score is exact and
    each step's results must agree bit for bit; the train step's codes,
    computed against the non-integer new centres, may differ only at a
    tie of two codewords within 1e-6 relative.
  * Without CUDA the dry run raises unless device="cpu" is given.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from ivfadc_tpu_torch import dryrun
from ivfadc_tpu_torch.models.coarse import NaiveCoarseQuantizer
from ivfadc_tpu_torch.ops.metrics import get_metric
from tests.test_torch_distributed import _jax_child

torch.set_num_threads(2)

KC, M, K = 16, 4, 16
STEPS = ("sharded_search", "single_search", "build_search", "native_live",
         "popped", "native_search", "reload_search", "refreshed_search",
         "stream_search", "wide_search", "wide_search_after")


# ------------------------------------------------------------------- entry
def test_entry_equals_jax():
    """The same tiny index's arrays through both forwards: ids equal,
    distances within 1e-5 relative (the ADC tables' f32 sums run in
    another order)."""
    import jax
    import __graft_entry__ as graft
    fn, args = graft.entry()
    want_ids, want_d = (np.asarray(x) for x in jax.jit(fn)(*args))
    queries, coarse, codebooks, rotation, *view = args
    forward, port_args = dryrun.entry("cpu")
    assert len(port_args) == len(args)
    got_ids, got_d = forward(
        torch.as_tensor(np.array(queries)),
        NaiveCoarseQuantizer(torch.as_tensor(np.array(coarse.centroids)),
                             get_metric(coarse.metric.name)),
        torch.as_tensor(np.array(codebooks)),
        torch.as_tensor(np.array(rotation)),
        *(torch.as_tensor(np.array(a)) for a in view))
    assert got_ids.shape == (64, 10) == want_ids.shape
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ the shipped dry run
def test_dryrun_on_cpu_positions(capsys):
    """The dry run as it ships, on 8 CPU positions: every assert holds,
    the mesh is 2 x 4, and it prints the JAX dry run's OK line."""
    out = dryrun.dryrun_multichip(8, device="cpu")
    assert out["mesh"] == {"data": 2, "shard": 4}
    assert out["devices"] == "repeated" and out["match"] == 1.0
    assert out["reload_shards"] == 2
    assert out["train_step"][2].shape == (512, M)
    assert out["wide_search"][0].dtype == np.uint64
    assert os.environ.get("IVFADC_DEVICE_ID_CAP") is None
    printed = capsys.readouterr().out
    assert "cpu repeated" in printed
    assert "dryrun_multichip OK: mesh={'data': 2, 'shard': 4}" in printed


def test_no_cpu_fallback(monkeypatch):
    """Without a visible CUDA device every entry point raises unless the
    caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (dryrun.entry, dryrun.tiny_index,
                 lambda: dryrun.dryrun_multichip(8),
                 lambda: dryrun.main(["8"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ------------------------------------------------- step by step against JAX
def _points() -> np.ndarray:
    """The dry run's tiny points, rounded to integers."""
    rng = np.random.RandomState(0)
    centers = rng.randn(KC, 32).astype(np.float32) * 4
    return np.round(np.concatenate(
        [c + rng.randn(512 // KC, 32).astype(np.float32)
         for c in centers])).astype(np.float32)


def _components():
    """(integer centroids: KC of the points, codebooks (M, K, 8): halves in
    [-7.5, 7.5] and 63.5, which is never the nearest)."""
    data = _points()
    cents = data[np.random.RandomState(1).choice(len(data), KC,
                                                 replace=False)]
    cb = np.random.RandomState(2).randint(-15, 16, (M, K, 8)) / 2
    cb[:, -1, :] = 63.5
    return cents, cb.astype(np.float32)


def _assign(x: np.ndarray, cents: np.ndarray):
    """(assignments (n,) i32, residuals) of integer points to integer
    centroids: exact distances, the first nearest on a tie."""
    dist = ((x[:, None, :].astype(np.float64) - cents[None]) ** 2).sum(-1)
    a = np.argmin(dist, axis=1).astype(np.int32)
    return a, (x - cents[a]).astype(np.float32)


def _jax_dryrun():
    """In a child: the JAX dry run's sequence (`__graft_entry__.
    dryrun_multichip`) on the integer points with the integer components,
    on a 2 x 4 mesh of virtual devices; each step's results, and the
    single index as a saved file."""
    import jax
    import jax.numpy as jnp
    import ivfadc_tpu.models.index as jax_index_mod
    import ivfadc_tpu.ops.pq as jax_pq
    import ivfadc_tpu.parallel.distributed as jax_dist
    from ivfadc_tpu import IVFADCIndex as JaxIndex
    from ivfadc_tpu import save_ivfadc_index
    from ivfadc_tpu.ops.kmeans import KMeansResult
    from ivfadc_tpu.ops.metrics import SQEUCLIDEAN
    from ivfadc_tpu.parallel.distributed import train_step
    from ivfadc_tpu.parallel.mesh import make_mesh
    from ivfadc_tpu.parallel.persistence import (load_sharded_index,
                                                 save_sharded_index)
    from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex

    cents, cb = _components()
    quant = jax_pq.ProductQuantizer(jnp.asarray(cb), jnp.eye(32), "pq")
    jax_dist.distributed_kmeans = lambda *a, **kw: (jnp.asarray(cents), None)
    jax_pq.train_quantizer = lambda *a, **kw: quant

    def trained(_k1, _k2, xd, *a, **kw):
        assign, resid = _assign(np.asarray(xd), cents)
        return (KMeansResult(jnp.asarray(cents), jnp.asarray(assign)),
                jnp.asarray(resid), quant)

    jax_index_mod._train_components = trained

    devices = jax.devices()[:8]
    mesh = make_mesh(n_shards=4, n_data=2, devices=devices)
    data = _points()
    n, d = data.shape
    idx = JaxIndex.build(data, kc=KC, k=K, m=M, seed=0, coarse_maxiter=8,
                         quantization_maxiter=8)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "tiny.npz")
        save_ivfadc_index(path, idx)
        with open(path, "rb") as f:
            out["index_file"] = f.read()
    new_c, assign, codes = train_step(
        jnp.asarray(idx.coarse.centroids), idx.quantizer.codebooks,
        jnp.asarray(data), jnp.ones(n, jnp.float32), mesh=mesh,
        metric=SQEUCLIDEAN, m=M)
    out["train_step"] = tuple(np.asarray(x) for x in (new_c, assign, codes))

    sidx = ShardedIVFADCIndex(idx, mesh)
    out["sharded_search"] = sidx.search_padded(data[:16], k=5, w=4)
    out["single_search"] = idx.search_padded(data[:16], 5, w=4)
    kw = dict(kc=KC, k=K, m=M, seed=0, coarse_maxiter=6,
              quantization_maxiter=6)
    didx = ShardedIVFADCIndex.build(data, mesh, **kw)
    out["build_search"] = didx.search_padded(data[:16], k=5, w=4)
    didx.push_batch(data[:8] + 0.01)
    didx.delete([0, 5, n + 3])
    live = np.asarray(didx.arrays["ids"])
    out["native_live"] = np.sort(live[live >= 0])
    out["popped"] = didx.pop()
    out["native_search"] = didx.search_padded(data[:8], k=5, w=4)
    with tempfile.TemporaryDirectory() as td:
        save_sharded_index(td, didx)
        ridx = load_sharded_index(
            td, make_mesh(n_shards=2, n_data=1, devices=devices[:2]))
        out["reload_search"] = ridx.search_padded(data[:8], k=5, w=4)
    sidx.push_batch(data[:4] + 0.02)
    sidx.refresh()
    out["refreshed_search"] = sidx.search_padded(data[:8], k=5, w=4)
    stream = ShardedIVFADCIndex.build_streaming(
        [data[i:i + 128] for i in range(0, n, 128)], mesh, **kw)
    out["stream_search"] = stream.search_padded(data[:8], k=5, w=4)
    os.environ["IVFADC_DEVICE_ID_CAP"] = "256"
    widx = ShardedIVFADCIndex.build(data, mesh, index_dtype="uint64", **kw)
    out["wide_search"] = widx.search_padded(data[:8], k=5, w=4)
    widx.push_batch(data[:4] + 0.01)
    widx.delete([1, 7])
    out["wide_search_after"] = widx.search_padded(data[:8], k=5, w=4)
    return out


def _patch_port(monkeypatch, index, data):
    """The port's dry run on the given single index and points, its
    builds trained to the integer components."""
    import ivfadc_tpu_torch.models.index as port_index_mod
    from ivfadc_tpu_torch.ops import pq as pq_ops
    from ivfadc_tpu_torch.ops.kmeans import KMeansResult
    from ivfadc_tpu_torch.parallel import distributed as port_dist
    cents_np, cb = _components()
    cents = torch.as_tensor(cents_np)
    quant = pq_ops.ProductQuantizer(torch.as_tensor(cb), torch.eye(32), "pq")

    def trained(xd, *a, **kw):
        assign, resid = _assign(xd.cpu().numpy(), cents_np)
        return (KMeansResult(cents, torch.as_tensor(assign)),
                torch.as_tensor(resid), quant)

    monkeypatch.setattr(port_dist, "distributed_kmeans",
                        lambda *a, **kw: (cents, None))
    monkeypatch.setattr(pq_ops, "train_quantizer", lambda *a, **kw: quant)
    monkeypatch.setattr(port_index_mod, "_train_components", trained)
    monkeypatch.setattr(dryrun, "tiny_index",
                        lambda device="cuda", **kw: (data, index))


def _code_ties(x, centers, assign, codebooks, rows) -> bool:
    """Every differing row's two codes tie within 1e-6 relative in some
    subspace."""
    resid = (x - centers[assign]).astype(np.float64)
    dsub = codebooks.shape[2]
    for i, (a, b) in rows:
        for j in np.nonzero(a != b)[0]:
            r = resid[i, j * dsub:(j + 1) * dsub]
            da = ((r - codebooks[j, a[j]]) ** 2).sum()
            db = ((r - codebooks[j, b[j]]) ** 2).sum()
            if abs(da - db) > 1e-6 * max(da, db):
                return False
    return True


def test_dryrun_steps_equal_jax(monkeypatch, tmp_path):
    want = _jax_child("dryrun", __name__)
    path = tmp_path / "tiny.npz"
    path.write_bytes(want["index_file"])
    from ivfadc_tpu_torch import IVFADCIndex
    index = IVFADCIndex.load(str(path), device="cpu")
    data = _points()
    _patch_port(monkeypatch, index, data)
    got = dryrun.dryrun_multichip(8, device="cpu")
    assert got["mesh"] == {"data": 2, "shard": 4} and got["match"] == 1.0
    # the train step: assignments and new centres bit-equal; codes equal
    # but at a tie of two codewords
    (tc, ta, tcodes), (jc, ja, jcodes) = got["train_step"], want["train_step"]
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tc, jc)
    diff = np.nonzero((tcodes != jcodes).any(axis=1))[0]
    assert _code_ties(data, jc, ja, index.quantizer.codebooks.numpy(),
                      [(i, (tcodes[i], jcodes[i])) for i in diff])
    for step in STEPS:
        g, w = got[step], want[step]
        assert isinstance(g, tuple) == isinstance(w, tuple), step
        for a, b in zip(*((g, w) if isinstance(g, tuple) else ((g,), (w,)))):
            assert a.dtype == b.dtype, step
            np.testing.assert_array_equal(a, b, err_msg=step)
