"""The port's request-coalescing front end (`ivfadc_tpu_torch.serving`),
the non-sharded cases of tests/test_serving.py on a CPU port index (the
dense route through the kernels' plain versions), the store's safety for
concurrent readers right after a mutation, and one cross-package case:
one file served by both packages' `BatchingSearcher`s, on the
integer-valued pair of tests/test_torch_dynamic.py, whose scores are
exact, so both give the same ids and distances.

Every `.result()`, `join()` and `wait()` has a timeout, and every searcher
is closed by a `with` block or a `finally`.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ivfadc_tpu import IVFADCIndex as JaxIndex
from ivfadc_tpu.serving import BatchingSearcher as JaxSearcher
from ivfadc_tpu_torch import BatchingSearcher, IVFADCIndex
from ivfadc_tpu_torch.convert import from_reference
from tests.conftest import build_random_index
from tests.test_torch_dynamic import _integer_pair

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)

T = 30                                  # seconds any single wait may take


@pytest.fixture(scope="module")
def data():
    return np.random.RandomState(0).rand(400, 10).astype(np.float32)


def _index(data):
    """A fresh port index on the CPU (the JAX fixture's parameters),
    searched by the dense route."""
    t = from_reference(build_random_index(data), "cpu")
    t.config = dataclasses.replace(t.config, scan_mode="dense")
    return t


def _join(threads):
    for t in threads:
        t.join(timeout=T)
        assert not t.is_alive(), t.name


def test_results_match_direct_search(data):
    idx = _index(data)
    with BatchingSearcher(idx, max_batch=64, max_wait_ms=5) as s:
        futs = [s.submit(data[i], 5, w=4) for i in range(32)]
        got = [f.result(timeout=T) for f in futs]
    ids_d, dists_d = idx.search_padded(data[:32], 5, w=4)
    for i, (gi, gd) in enumerate(got):
        np.testing.assert_array_equal(gi, ids_d[i])
        np.testing.assert_array_equal(gd, dists_d[i])


def test_requests_coalesce_into_shared_dispatches(data):
    idx = _index(data)
    with BatchingSearcher(idx, max_batch=256, max_wait_ms=200) as s:
        futs = [s.submit(data[i], 3, w=2) for i in range(64)]
        for f in futs:
            f.result(timeout=T)
        assert s.stats.queries == 64
        assert s.stats.batches <= 4, s.stats.batches


def test_mixed_k_w_groups_resolve_independently(data):
    idx = _index(data)
    with BatchingSearcher(idx, max_batch=32, max_wait_ms=5) as s:
        f1 = s.submit(data[0], 3, w=1)
        f2 = s.submit(data[1], 7, w=4)
        f3 = s.submit(data[2], 3, w=1)
        (i1, _), (i2, _), (i3, _) = (f.result(timeout=T)
                                     for f in (f1, f2, f3))
    assert i1.shape == (3,) and i3.shape == (3,) and i2.shape == (7,)
    np.testing.assert_array_equal(i2, idx.search_padded(data[1:2], 7,
                                                        w=4)[0][0])


def test_array_submissions_and_max_batch_splitting(data):
    idx = _index(data)
    # max_batch=8 sends the 3 x 6-row submissions to >= 3 dispatches, and
    # a submitted array is never split
    with BatchingSearcher(idx, max_batch=8, max_wait_ms=1) as s:
        futs = [s.submit(data[j * 6:(j + 1) * 6], 4, w=3) for j in range(3)]
        got = [f.result(timeout=T) for f in futs]
        assert s.stats.batches >= 3
    ids_d, _ = idx.search_padded(data[:18], 4, w=3)
    for j, (gi, _) in enumerate(got):
        assert gi.shape == (6, 4)
        np.testing.assert_array_equal(gi, ids_d[j * 6:(j + 1) * 6])


def test_submit_validation_and_closed_searcher(data):
    idx = _index(data)
    s = BatchingSearcher(idx, max_wait_ms=1)
    try:
        with pytest.raises(AssertionError):
            s.submit(np.zeros(3, np.float32), 5)      # wrong dim
    finally:
        s.close()
    with pytest.raises(RuntimeError):
        s.submit(data[0], 5)
    for bad in (dict(max_batch=0), dict(max_wait_ms=-1), dict(pipeline=0)):
        with pytest.raises(ValueError):
            BatchingSearcher(idx, **bad)


def test_dispatch_exception_propagates_to_futures(data):
    idx = _index(data)
    with BatchingSearcher(idx, max_wait_ms=1) as s:
        fut = s.submit(data[0], 0, w=1)           # k=0: the search asserts
        with pytest.raises(AssertionError, match="k has to be"):
            fut.result(timeout=T)
        # the pool thread goes on serving
        assert s.submit(data[0], 3, w=1).result(timeout=T)[0].shape == (3,)


def test_close_without_drain_fails_pending(data):
    idx = _index(data)
    s = BatchingSearcher(idx, max_batch=4096, max_wait_ms=60_000)
    futs = [s.submit(data[i], 3, w=1) for i in range(4)]
    s.close(drain=False)
    failed = sum(1 for f in futs
                 if isinstance(f.exception(timeout=5), RuntimeError))
    # the flusher may have raced a dispatch in before close(); every future
    # must still be resolved one way or the other
    assert failed == 4 or all(f.done() for f in futs)


def test_searches_do_not_stall_during_slow_mutation(data):
    """While a mutation holds the live index, searches keep dispatching
    against the pre-mutation snapshot; after mutate() returns they see the
    new epoch."""
    idx = _index(data)
    n0 = len(idx)
    with BatchingSearcher(idx, max_batch=32, max_wait_ms=1) as s:
        s.submit(data[0], 5, w=4).result(timeout=T)
        entered, release, mut_done = (threading.Event() for _ in range(3))

        def slow_push(ix):
            entered.set()
            assert release.wait(timeout=T)
            ix.push(data[0] * 1.01)

        t = threading.Thread(target=lambda: (s.mutate(slow_push),
                                             mut_done.set()))
        t.start()
        try:
            assert entered.wait(timeout=T)
            lat = []
            for i in range(5):
                t0 = time.perf_counter()
                ids, _ = s.submit(data[i], 5, w=4).result(timeout=10)
                lat.append(time.perf_counter() - t0)
                assert ids.shape == (5,) and not (ids == n0).any()
            assert not mut_done.is_set()
        finally:
            release.set()
            _join([t])
        assert mut_done.is_set()
        ids, _ = s.submit(data[0] * 1.01, 5, w=8).result(timeout=T)
        assert (ids == n0).any()
    assert len(idx) == n0 + 1
    assert max(lat) < 5.0


def test_search_inside_mutate_does_not_deadlock(data):
    idx = _index(data)
    seen = {}
    with BatchingSearcher(idx, max_batch=8, max_wait_ms=1) as s:
        s.submit(data[0], 3, w=2).result(timeout=T)

        def fn(ix):
            seen["ids"] = s.submit(data[1], 3, w=2).result(timeout=T)[0]
            ix.push(data[1] * 1.02)

        s.mutate(fn)
    assert seen["ids"].shape == (3,) and len(idx) == 401


def test_stop_the_world_fallback_without_fork(data):
    """An index without fork(): dispatches wait while the mutation runs,
    and resolve against the mutated index afterwards."""
    idx = _index(data)

    class NoFork:
        dim = idx.dim

        def search_padded(self, q, k, w):
            return idx.search_padded(q, k, w)

    with BatchingSearcher(NoFork(), max_batch=4, max_wait_ms=1) as s:
        entered, release = threading.Event(), threading.Event()

        def slow(_):
            entered.set()
            assert release.wait(timeout=T)
            idx.push(data[3] * 1.03)

        t = threading.Thread(target=s.mutate, args=(slow,))
        t.start()
        try:
            assert entered.wait(timeout=T)
            fut = s.submit(data[3] * 1.03, 5, w=8)
            time.sleep(0.05)
            assert not fut.done()            # held behind the mutation
        finally:
            release.set()
            _join([t])
        assert (fut.result(timeout=T)[0] == 400).any()


def test_concurrent_mutations_race_submits(data):
    """submit() threads racing push_batch / delete / push / pop through
    the searcher: every future resolves, and the served index ends equal
    to a twin that took the same mutations serially."""
    rng = np.random.RandomState(7)
    idx, twin = _index(data), _index(data)
    extra = rng.rand(6, 10).astype(np.float32)
    stop = threading.Event()
    errors = []
    with BatchingSearcher(idx, max_batch=16, max_wait_ms=1) as s:
        def searcher_thread(seed):
            r = np.random.RandomState(seed)
            while not stop.is_set():
                try:
                    ids, dists = s.submit(data[r.randint(len(data))], 5,
                                          w=4).result(timeout=T)
                    assert ids.shape == (5,)
                    assert np.isfinite(dists[ids >= 0]).all()
                except Exception as e:     # noqa: BLE001 - reported below
                    errors.append(e)
                    return

        threads = [threading.Thread(target=searcher_thread, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        try:
            for _ in range(5):
                s.push_batch(extra)
                s.delete(sorted(rng.choice(len(data), 3,
                                           replace=False).tolist()))
                s.push(extra[0] * 1.01)
                assert s.pop().shape == (10,)
        finally:
            stop.set()
            _join(threads)
    assert not errors, errors
    rng2 = np.random.RandomState(7)
    extra2 = rng2.rand(6, 10).astype(np.float32)
    for _ in range(5):
        twin.push_batch(extra2)
        twin.delete(sorted(rng2.choice(len(data), 3, replace=False).tolist()))
        twin.push(extra2[0] * 1.01)
        twin.pop()
    assert len(idx) == len(twin)
    np.testing.assert_array_equal(idx.store.sizes, twin.store.sizes)
    qi, qd = idx.search_padded(data[:16], 5, w=4)
    ti, td = twin.search_padded(data[:16], 5, w=4)
    np.testing.assert_array_equal(qi, ti)
    np.testing.assert_array_equal(qd, td)


def _fresh(idx):
    """The same host state with views built afresh."""
    f = idx.fork()
    f.store._invalidate()
    return f


@pytest.mark.parametrize("coarse", ["naive", "hnsw"])
def test_concurrent_readers_after_mutation_see_the_patches(data, coarse):
    """Several threads search at once right after a mutation: the first
    to reach the views queues the pending patches, the others must search
    after them (the store's lock), so every result equals a fresh view's."""
    idx = from_reference(build_random_index(data, coarse_quantizer=coarse),
                         "cpu")
    idx.config = dataclasses.replace(idx.config, scan_mode="dense")
    rng = np.random.RandomState(3)
    q = data[:24] + 0.01
    idx.search_padded(q, 5, w=4)                    # build the views
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for r in range(6):
            idx.push_batch(rng.rand(40, 10).astype(np.float32))
            idx.delete(sorted(rng.choice(len(idx), 30,
                                         replace=False).tolist()))
            want = _fresh(idx).search_padded(q, 5, w=4)
            barrier = threading.Barrier(6, timeout=T)
            got = [None] * 6

            def reader(i):
                barrier.wait()
                got[i] = idx.search_padded(q, 5, w=4)

            threads = [threading.Thread(target=reader, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
            _join(threads)
            for g in got:
                np.testing.assert_array_equal(g[0], want[0], err_msg=str(r))
                np.testing.assert_array_equal(g[1], want[1], err_msg=str(r))
    finally:
        sys.setswitchinterval(old)


def test_same_file_served_by_both_packages(tmp_path, random_data):
    j, _ = _integer_pair(random_data)
    path = str(tmp_path / "pair.npz")
    j.save(path)
    jl, tl = JaxIndex.load(path), IVFADCIndex.load(path, device="cpu")
    assert tl.config.scan_mode == "dense"
    q = np.random.RandomState(5).randint(0, 17, (32, 10)).astype(np.float32)
    out = {}
    for name, cls, ix in (("jax", JaxSearcher, jl),
                          ("port", BatchingSearcher, tl)):
        # one 32-query dispatch: flushed when max_batch queries wait
        with cls(ix, max_batch=32, max_wait_ms=60_000) as s:
            futs = [s.submit(row, 5, w=6) for row in q]
            out[name] = [f.result(timeout=120) for f in futs]
            assert s.stats.batches == 1
    for (ji, jdist), (ti, tdist) in zip(out["jax"], out["port"]):
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_array_equal(tdist, np.asarray(jdist))
