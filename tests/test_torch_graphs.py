"""The dense search's CUDA graphs (ivfadc_tpu_torch/models/graphs.py) on
the CPU: the engagement rule, the store's drops, the cache's bound and the
counters. The graph path itself is rehearsed with a stand-in capture whose
replay reruns the captured function into the same output tensors; the
card tests (tests/test_torch_cuda.py -k graph) hold the real replay to the
eager path bit for bit.

Tiny CPU indexes: the dense routes run the kernels' plain versions.
"""

import threading

import numpy as np
import pytest
import torch

from ivfadc_tpu_torch import BatchingSearcher, IVFADCIndex
from ivfadc_tpu_torch.models import graphs
from ivfadc_tpu_torch.utils import profiling

# the suite runs several workers on a few cores: keep torch's pool small
torch.set_num_threads(2)

KC, W, K = 16, 4, 5
T = 30                                  # seconds any single wait may take


@pytest.fixture(scope="module")
def data():
    return np.random.RandomState(0).rand(3000, 16).astype(np.float32)


def _build(data, **kw):
    kw = dict(dict(kc=KC, m=4, k=16, scan_mode="dense", coarse_maxiter=3,
                   quantization_maxiter=3), **kw)
    return IVFADCIndex.build(data, device="cpu", **kw)


@pytest.fixture
def index(data):
    return _build(data)


def _seed(idx):
    """A sentinel entry in the store's graph cache."""
    idx.store.graphs._graphs[("sentinel",)] = graphs._Graph((), graphs._Pool())
    assert len(idx.store.graphs) == 1


class _StandIn:
    """A captured graph's stand-in: replay reruns the function on the
    static query buffer into the outputs the capture returned."""

    def __init__(self, body, q):
        self.body, self.q = body, q

    def replay(self):
        with profiling.uncounted():
            for out, new in zip(self.outs, self.body(self.q)):
                out.copy_(new)


def _stand_in_capture(body, q, pool):
    g = _StandIn(body, q)
    with profiling.uncounted():
        g.outs = tuple(torch.full_like(o, -7) for o in body(q))
    return g, g.outs, [], pool if pool is not None else object()


@pytest.fixture
def on_cpu(monkeypatch):
    """Graphs engage on the CPU, through the stand-in capture."""
    monkeypatch.setattr(graphs, "stream_key", lambda dev: (str(dev), 0))
    monkeypatch.setattr(graphs, "_capture", _stand_in_capture)


def _eager(idx, q, monkeypatch):
    """The eager path's results, the graph cache left as it is."""
    with monkeypatch.context() as m:
        m.setattr(graphs, "stream_key", lambda dev: None)
        return idx._device_search(q, K, W)


# ------------------------------------------------------------ engagement
@pytest.mark.parametrize("mode", ["dense", "lut"])
def test_cpu_and_lut_searches_run_eager(data, mode):
    idx = _build(data, scan_mode=mode)
    q = data[:50] + 0.01
    assert graphs.stream_key(idx.device) is None
    with profiling.counting() as counts:
        for _ in range(4):
            idx.search_padded(q, K, W)
    assert len(idx.store.graphs) == 0 and not idx.store.graphs._seen
    assert counts["graph_captures"] == counts["graph_replays"] == 0
    assert counts["searches"] == 4


def test_lut_route_runs_eager_where_graphs_engage(data, on_cpu):
    idx = _build(data, scan_mode="lut")
    for _ in range(3):
        idx.search_padded(data[:50], K, W)
    # k > 128 leaves the dense route for the LUT engine as well
    dense = _build(data)
    for _ in range(3):
        dense.search_padded(data[:50], 129, W)
    assert len(idx.store.graphs) == len(dense.store.graphs) == 0


# ----------------------------------------------------------- store drops
def test_invalidate_drops_the_graphs(index):
    _seed(index)
    index.store._invalidate()
    assert len(index.store.graphs) == 0


def test_bulk_delete_drops_the_graphs(index, data):
    index.search_padded(data[:50], K, W)
    _seed(index)
    index.delete(range(0, 2100))                        # > 2048: bulk path
    assert len(index.store.graphs) == 0


def test_fork_copy_on_write_drops_the_graphs(index, data):
    index.search_padded(data[:50], K, W)               # views built
    child = index.fork()
    assert len(child.store.graphs) == 0
    _seed(index)
    _seed(child)
    child.push(data[0] + 0.01)
    child.search_padded(data[:50], K, W)               # the child clones
    assert len(child.store.graphs) == 0
    assert len(index.store.graphs) == 1                # the parent's stay
    index.delete([3])
    index.search_padded(data[:50], K, W)               # the parent clones
    assert len(index.store.graphs) == 0


def test_drop_plans_drops_the_graphs(index):
    _seed(index)
    index._drop_plans()
    assert len(index.store.graphs) == 0


def test_grow_past_room_drops_the_graphs(index, data):
    index.search_padded(data[:50], K, W)
    _seed(index)
    c = int(np.argmin(index.store.caps))
    cent = index.coarse.centroids[c].numpy()
    crowd = cent + 1e-3 * np.random.RandomState(1).randn(
        int(index.store.caps[c]), 16).astype(np.float32)
    index.push_batch(crowd)
    index.search_padded(data[:50], K, W)
    assert len(index.store.graphs) == 0


def test_in_place_patches_keep_the_graphs(index, data):
    index.search_padded(data[:50], K, W)
    _seed(index)
    index.push(data[1] + 0.01)                         # within room
    index.delete([7])                                  # patched in place
    index.search_padded(data[:50], K, W)
    assert len(index.store.graphs) == 1


# --------------------------------------------------------- cache bound
def _unit_cache(monkeypatch, cap: int):
    """A SearchGraphs at `cap` graphs -> (cache, run(key) over a toy body,
    the captures made so far (a one-item list))."""
    monkeypatch.setattr(graphs, "CAP", cap)
    captures = [0]

    def capture(body, q, pool):
        captures[0] += 1
        return _stand_in_capture(body, q, pool)

    monkeypatch.setattr(graphs, "_capture", capture)
    cache = graphs.SearchGraphs()
    q = torch.ones((2, 4))

    def body(sq):
        return sq * 2, sq + 1

    def run(key):
        out = cache.run((key, "dev0"), q, 8, body)
        if out is not None:
            assert torch.equal(out[0], q * 2) and torch.equal(out[1], q + 1)
        return out

    return cache, run, captures


def test_cache_stays_at_its_cap_dropping_the_least_recent(on_cpu,
                                                          monkeypatch):
    cache, run, _ = _unit_cache(monkeypatch, 3)
    for key in "abcd":
        assert run(key) is None                        # first call: eager
    for key in "abc":
        assert run(key) is not None                    # second: captured
    assert [k for k, _ in cache._graphs] == ["a", "b", "c"]
    run("a")                                           # a is the most recent
    run("d")
    assert [k for k, _ in cache._graphs] == ["c", "a", "d"]
    assert len(cache) == 3
    cache.clear()
    assert len(cache) == 0 and run("a") is None


def test_a_dropped_key_runs_eager_until_it_is_hot_again(on_cpu,
                                                        monkeypatch):
    """A key dropped for room owes twice the eager calls it made before its
    last capture; those calls run eager, and the one after captures."""
    cache, run, captures = _unit_cache(monkeypatch, 1)
    run("a")
    run("a")                                           # captured (need 1)
    run("b")
    run("b")                                           # captured: a dropped
    assert [k for k, _ in cache._graphs] == ["b"] and captures[0] == 2
    assert [run("a") for _ in range(2)] == [None, None]
    assert run("a") is not None and captures[0] == 3   # b dropped
    assert [run("b") for _ in range(2)] == [None, None]
    assert run("b") is not None and captures[0] == 4   # a dropped again
    assert [run("a") for _ in range(4)] == [None] * 4
    assert run("a") is not None and captures[0] == 5


@pytest.mark.parametrize("keys", [5, 12])
def test_keys_past_the_cap_keep_captures_bounded(on_cpu, monkeypatch, keys):
    """Traffic that rotates more keys than the cap: an LRU that captured a
    key on each of its misses would capture on every call (1,600 here);
    the backoff captures a key about log2(its calls) times."""
    cache, run, captures = _unit_cache(monkeypatch, 4)
    calls = 1600
    for i in range(calls):
        run(str(i % keys))
    assert len(cache) == 4
    per_key = calls // keys
    assert captures[0] <= keys * (per_key.bit_length() + 1)
    assert captures[0] < calls // 8


def test_keys_past_the_remembered_run_eager(on_cpu, monkeypatch):
    """More keys in rotation than the cache remembers: each call is a
    first call, so none captures."""
    cache, run, captures = _unit_cache(monkeypatch, 4)
    for i in range(4 * (graphs._SEEN_CAP + 1)):
        assert run(str(i % (graphs._SEEN_CAP + 1))) is None
    assert captures[0] == 0 and len(cache) == 0


def test_graphs_of_a_stream_share_one_pool(on_cpu, monkeypatch):
    cache, run, _ = _unit_cache(monkeypatch, 4)
    for key in "abab":
        run(key)
    out = cache.run(("c", "dev1"), torch.ones((2, 4)), 8,
                    lambda sq: (sq, sq))
    assert out is None                                 # another stream
    a, b = (cache._graphs[(k, "dev0")] for k in "ab")
    assert a.pool is b.pool and a.pool.anchor is a.graph
    assert b.pool.handle is not None and len(cache._pools) == 1
    cache.clear()
    assert not cache._pools


# ------------------------------------------------------ graph path (CPU)
@pytest.mark.parametrize("B", [50, 3])                 # grouped, per probe
def test_replay_equals_the_eager_path(index, data, on_cpu, monkeypatch, B):
    q = torch.as_tensor(data[:B] + 0.01)
    want = _eager(index, q, monkeypatch)
    got = [index._device_search(q, K, W) for _ in range(4)]
    assert len(index.store.graphs) == 1
    for ids, dists in got:
        assert torch.equal(ids, want[0]) and torch.equal(dists, want[1])


def test_padding_rows_hold_zeros(index, data, on_cpu, monkeypatch):
    """Smaller batches in the same bucket after a larger one: the rows past
    each are zeros again, as the eager padding makes them."""
    big = torch.as_tensor(data[:60])                   # bucket 64
    index._device_search(big, K, W)
    index._device_search(big, K, W)                    # captured
    (g,) = index.store.graphs._graphs.values()
    for lo, hi in ((200, 240), (300, 345), (400, 433)):
        q = torch.as_tensor(data[lo:hi])
        got = index._device_search(q, K, W)
        assert g.rows == q.shape[0]
        assert torch.count_nonzero(g.q[g.rows:]) == 0
        for a, b in zip(got, _eager(index, q, monkeypatch)):
            assert torch.equal(a, b)
    assert len(index.store.graphs) == 1


def test_host_results_survive_the_next_call(index, data, on_cpu):
    q1, q2 = data[:50], data[50:100]
    index.search_padded(q1, K, W)
    first = index.search_padded(q1, K, W)              # captured
    keep = [a.copy() for a in first]
    second = index.search_padded(q2, K, W)             # replayed
    (g,) = index.store.graphs._graphs.values()
    for a, b, out in zip(first, keep, g.outs):
        np.testing.assert_array_equal(a, b)
        assert not np.shares_memory(a, out.numpy())
    assert not np.array_equal(first[0], second[0])


def test_results_of_a_call_survive_the_next(index, data, on_cpu):
    q1, q2 = torch.as_tensor(data[:50]), torch.as_tensor(data[50:100])
    index._device_search(q1, K, W)
    first = index._device_search(q1, K, W)             # captured
    keep = [t.clone() for t in first]
    second = index._device_search(q2, K, W)            # replayed
    for a, b in zip(first, keep):
        assert torch.equal(a, b)
    assert not torch.equal(first[0], second[0])


@pytest.mark.parametrize("opts,env,B", [
    ({}, {}, 50), ({}, {}, 3), ({"scan_gather_win": 2048}, {}, 3),
    ({}, {"IVFADC_VBASE": "qc"}, 50)])
def test_counting_equals_the_eager_path(data, on_cpu, monkeypatch, opts,
                                        env, B):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    idx = _build(data, **opts)
    q = data[:B] + 0.01
    with profiling.counting() as eager, monkeypatch.context() as m:
        m.setattr(graphs, "stream_key", lambda dev: None)
        for _ in range(5):
            idx.search_padded(q, K, W)
    with profiling.counting() as replayed:
        for _ in range(5):
            idx.search_padded(q, K, W)
    assert eager["graph_captures"] == eager["graph_replays"] == 0
    assert replayed["graph_captures"] == 1
    assert replayed["graph_replays"] == 5 - 2
    for name in profiling.COUNTS:
        if not name.startswith("graph_"):
            assert replayed[name] == eager[name], name


def test_batching_searcher_answers_equal_serial_answers(index, data,
                                                        on_cpu):
    q = data[:256] + 0.01
    want = [index.search_padded(q[b * 32:(b + 1) * 32], K, w=W)
            for b in range(8)]
    with BatchingSearcher(index, max_batch=32, max_wait_ms=0,
                          pipeline=2) as s:
        for _ in range(3):
            futs = [s.submit(q[b * 32:(b + 1) * 32], K, w=W)
                    for b in range(8)]
            for (ids, dists), (wi, wd) in zip(
                    [f.result(timeout=T) for f in futs], want):
                np.testing.assert_array_equal(ids, wi)
                np.testing.assert_array_equal(dists, wd)
    assert len(index.store.graphs) == 1


def test_threads_share_one_capture(index, data, on_cpu, monkeypatch):
    q = torch.as_tensor(data[:50])
    want = _eager(index, q, monkeypatch)
    index._device_search(q, K, W)                      # first call: eager
    out, errors = [], []

    def work():
        try:
            for _ in range(5):
                out.append(index._device_search(q, K, W))
        except Exception as e:                         # noqa: BLE001
            errors.append(e)

    with profiling.counting() as counts:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
            assert not t.is_alive()
    assert not errors and len(out) == 20
    assert counts["graph_captures"] == 1 and counts["graph_replays"] == 19
    for ids, dists in out:
        assert torch.equal(ids, want[0]) and torch.equal(dists, want[1])
