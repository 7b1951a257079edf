"""A live index on the port: the small delete's batched swap-removes and
deferred renumbering against the per-id algorithm it replaced (kept here
as a frozen copy, `_frozen_delete`) and against the JAX package's store,
round after round of pushes and deletes; the views patched in place, no
captured search dropped; the mutation path's spans and counters.

After every round the three stores must hold the same offsets, caps,
sizes, codes and ids (dead regions included), answer `find` and
`cell_entries` alike, and log the same cells and renumberings; the port's
patched views must equal a rebuild bit for bit.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ivfadc_tpu_torch import IVFADCIndex
from ivfadc_tpu_torch.convert import from_reference
from ivfadc_tpu_torch.models import graphs
from ivfadc_tpu_torch.ops import pq as pq_ops
from ivfadc_tpu_torch.utils import profiling
from tests.conftest import build_random_index
from tests.test_torch_dynamic import _assert_same_state, _assert_views_rebuild
from tests.test_torch_graphs import _stand_in_capture

# the suite runs several workers on a few cores: keep torch's pool small
torch.set_num_threads(2)

N, D, KC = 20_000, 16, 64
ROUNDS, BATCH = 30, 256


def _frozen_delete(self, dels):
    """The small delete as it was before the batched one: a swap-remove a
    hit (cells ascending, slots descending within a cell), then the
    survivors renumbered by rank over every host slot."""
    self._materialize_for_mutation()
    dels = np.unique(np.asarray(dels, np.int64))
    ids = self.ids
    hit = np.isin(ids, dels) & (ids >= 0)
    hit_slots = np.nonzero(hit)[0]
    if hit_slots.size != dels.size:
        missing = np.setdiff1d(dels, ids[hit_slots])
        raise KeyError(f"ids not in index: {missing[:10].tolist()}")
    cells = self._slots_to_cells(hit_slots)
    for cell in np.unique(cells):
        for slot in np.sort(hit_slots[cells == cell])[::-1]:
            cur = ids[slot]
            if cur >= 0:
                pos = np.searchsorted(dels, cur)
                if pos < dels.size and dels[pos] == cur:
                    self.remove_slot(int(cell), int(slot))
    live = ids >= 0
    ids[live] -= np.searchsorted(dels, ids[live])
    self._slot_of = None
    self._dev_rank_shift(dels)
    self._log_op(("rank", dels.copy()))
    return int(dels.size)


def _frozen(t):
    """A copy of the port index `t` whose small deletes run the frozen
    per-id algorithm."""
    f = t.fork()
    f.store.delete_ids_incremental = types.MethodType(_frozen_delete,
                                                      f.store)
    return f


def _triple(align):
    """(JAX index, port index with its views built, frozen port copy) over
    N clustered points at KC cells."""
    rng = np.random.RandomState(align)
    centers = rng.randn(KC // 2, D)
    data = (centers[rng.randint(0, KC // 2, N)]
            + 0.3 * rng.randn(N, D)).astype(np.float32)
    j = build_random_index(data, kc=KC, k=16, m=4, cell_align=align,
                           coarse_maxiter=5, quantization_maxiter=5)
    t = from_reference(j, "cpu")
    f = _frozen(t)
    for x in (t, f):
        x.search_padded(data[:64], 5, w=4)          # the views to patch
        x.store.device_view()
    return j, t, f, data, rng


def _encoded(t, points):
    """(cells, code rows) of `points` as the port's push_batch makes them:
    the JAX store appends these, so both packages hold the same rows."""
    x = torch.as_tensor(points, dtype=torch.float32)
    cells = t.coarse.search(x, 1)[0][:, 0].to(torch.int64)
    codes = pq_ops.encode(t.quantizer, x - t.coarse.centroids[cells],
                          metric=t.quant_metric)
    return cells.numpy(), codes.numpy().astype(t.store.code_dtype)


def _push(j, t, f, points):
    cells, codes = _encoded(t, points)
    j.store.append_batch(cells, codes, len(j))
    t.push_batch(points)
    f.push_batch(points)


def _assert_same_held(j, t):
    """`_assert_same_state` without reading the port's `ids`, which would
    run its pending renumbering: its ids as the conversion reads them."""
    js, ts = j.store, t.store
    for key in ("offsets", "caps", "sizes", "codes"):
        np.testing.assert_array_equal(getattr(ts, key),
                                      np.asarray(getattr(js, key)), key)
    np.testing.assert_array_equal(ts._current_ids(ts._host_ids()),
                                  np.asarray(js.ids))
    assert (len(t), ts.total_cap, ts.window) == (len(j), js.total_cap,
                                                 js.window)
    n = len(j)
    for ext in np.random.RandomState(n).choice(n, 20, replace=False):
        assert ts.find(int(ext)) == js.find(int(ext))
    for cell in (0, j.config.kc // 2, j.config.kc - 1):
        for a, b in zip(js.cell_entries(cell), ts.cell_entries(cell)):
            np.testing.assert_array_equal(b, a)


def _assert_same_three(j, t, f, logs, pending=False):
    """The three stores' state and logs; `pending`: the port's pending
    renumbering stays pending."""
    if pending:
        _assert_same_held(j, t)
    else:
        _assert_same_state(j, t)
    _assert_same_state(j, f)
    drained = [log.drain() for log in logs]
    for d in drained[1:]:
        assert d["cells"] == drained[0]["cells"]
        assert d["overflow"] == drained[0]["overflow"]
        assert [(op[0], np.asarray(op[1]).tolist()) for op in d["ops"]] == \
            [(op[0], np.asarray(op[1]).tolist()) for op in drained[0]["ops"]]


@pytest.mark.parametrize("align", [128, 8])
def test_rounds_of_pushes_and_deletes_match_frozen_and_jax(align):
    """30 rounds of a push_batch of 256 and a delete of 256 uniform ids:
    the batched delete leaves the frozen path's state and the JAX store's
    after every round, and its patched views equal a rebuild."""
    j, t, f, data, rng = _triple(align)
    logs = [x.store.attach_mutation_log() for x in (j, t, f)]
    multi = 0
    for _ in range(ROUNDS):
        _push(j, t, f, data[rng.randint(0, N, BATCH)]
              + 0.05 * rng.randn(BATCH, D).astype(np.float32))
        dels = rng.choice(len(t), BATCH, replace=False)
        cells = t.store._slots_to_cells(
            [t.store.find(int(i))[1] for i in dels])
        multi = max(multi, int(np.bincount(cells).max()))
        for x in (j, t, f):
            x.delete(dels)
        _assert_same_three(j, t, f, logs, pending=True)
        _assert_views_rebuild(t)
    # the rounds met cells with many holes (a hole may then take a row an
    # earlier swap moved), and the host renumbering waited across rounds
    # (a view rebuilt after a grow reads the ids, which runs it)
    assert multi >= 6
    assert t.store._gone.size >= 2 * BATCH
    _assert_same_state(j, t)
    assert t.store._gone is None
    np.testing.assert_array_equal(t.search_padded(data[:64], 5, w=4)[0],
                                  f.search_padded(data[:64], 5, w=4)[0])


def test_deletes_of_tails_whole_cells_and_fresh_pushes():
    """One delete that takes a cell's last rows, every row of another cell,
    ids pushed in the same round and ids pushed earlier, then more rounds
    on the pending renumbering, a save of the state, and a renumbering
    forced by the bound on the pending ids."""
    j, t, f, data, rng = _triple(128)
    logs = [x.store.attach_mutation_log() for x in (j, t, f)]
    for step in range(3):
        n0 = len(t)
        _push(j, t, f, data[rng.randint(0, N, BATCH)])
        st = t.store
        sizes = np.asarray(st.sizes)
        big, small = int(np.argmax(sizes)), int(np.argmin(sizes[sizes > 0]))
        small = int(np.flatnonzero(sizes > 0)[small])
        tail = st.cell_entries(big)[0][-3:]
        whole = st.cell_entries(small)[0]
        fresh = n0 + rng.choice(BATCH, 20, replace=False)
        older = rng.choice(n0, 30, replace=False)
        dels = np.unique(np.concatenate([tail, whole, fresh, older]))
        for x in (j, t, f):
            x.delete(dels)
        assert t.store.sizes[small] == 0
        _assert_same_three(j, t, f, logs)
        _assert_views_rebuild(t)
    # two more deletes: find, cell_entries and the flush read the pending
    # renumbering
    for _ in range(2):
        dels = rng.choice(len(t), BATCH, replace=False)
        for x in (j, t, f):
            x.delete(dels)
    assert t.store._gone is not None
    for ext in rng.choice(len(t), 50, replace=False):
        assert t.store.find(int(ext)) == j.store.find(int(ext))
    with pytest.raises(KeyError):
        t.delete([3, len(t)])
    with pytest.raises(KeyError):
        t.store.find(len(t))
    for cell in range(KC):
        for a, b in zip(j.store.cell_entries(cell),
                        t.store.cell_entries(cell)):
            np.testing.assert_array_equal(b, a)
    t.search_padded(data[:64], 5, w=4)                # the flush
    assert t.store._gone is not None
    _assert_views_rebuild(t)
    saved = {key: np.asarray(getattr(t.store, key)).copy()
             for key in ("codes", "ids")}
    assert t.store._gone is None                   # `ids` made them current
    np.testing.assert_array_equal(saved["ids"], np.asarray(j.store.ids))
    np.testing.assert_array_equal(saved["codes"], np.asarray(j.store.codes))
    # deletes of 2,048 ids until the pending ids pass their bound (a
    # quarter of the slots), where the host ids are renumbered at once
    bound = t.store.total_cap // 4
    pending = 0
    while pending <= bound:
        dels = rng.choice(len(t), 2048, replace=False)
        for x in (j, t, f):
            x.delete(dels)
        pending += 2048
        gone = t.store._gone
        assert (gone is None) == (pending > bound), (pending, bound)
        assert gone is None or gone.size == pending
    _assert_same_three(j, t, f, logs)
    _assert_views_rebuild(t)


@pytest.fixture
def on_cpu(monkeypatch):
    """Graphs engage on the CPU, through the stand-in capture of
    tests/test_torch_graphs.py."""
    monkeypatch.setattr(graphs, "stream_key", lambda dev: (str(dev), 0))
    monkeypatch.setattr(graphs, "_capture", _stand_in_capture)


def _small_index():
    data = np.random.RandomState(0).rand(3000, 16).astype(np.float32)
    return IVFADCIndex.build(data, device="cpu", kc=16, m=4, k=16,
                             scan_mode="dense", coarse_maxiter=3,
                             quantization_maxiter=3), data


def test_a_pair_drops_no_graph_and_the_next_search_replays(on_cpu):
    """A push_batch and a delete between captured searches: the views are
    patched in place (the same tensors), no graph is dropped and no view
    rebuilt, and the next search replays its graph with the eager path's
    results on the same state."""
    idx, data = _small_index()
    q = data[:50] + 0.01
    for _ in range(3):                              # eager, capture, replay
        idx.search_padded(q, 5, 4)
    views = [v for v in (idx.store._device, idx.store._device_dense)
             if v is not None]
    tensors = {(i, k): v for i, view in enumerate(views)
               for k, v in view.items() if isinstance(v, torch.Tensor)}
    with profiling.counting() as counts:
        idx.push_batch(data[100:164] + 0.02)
        idx.delete(np.random.RandomState(1).choice(len(idx), 64,
                                                   replace=False))
        got = idx.search_padded(q, 5, 4)
    assert counts["graph_drops"] == counts["view_rebuilds"] == 0
    assert counts["graph_captures"] == 0 and counts["graph_replays"] == 1
    assert counts["pushed_rows"] == counts["deleted_rows"] == 64
    assert counts["flushed_slots"] > 0
    for (i, k), v in tensors.items():
        assert views[i][k] is v, k
    eager = idx.fork()
    eager.store.graphs.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "stream_key", lambda dev: None)
        want = eager.search_padded(q, 5, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _mutation_spans(prof):
    return [e.name for e in prof.events()
            if e.name in ("ivfadc.push", "ivfadc.delete", "ivfadc.flush")]


def test_each_mutation_opens_its_span_under_a_profiler():
    idx, data = _small_index()
    idx.search_padded(data[:50], 5, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.push(data[0] + 0.01)
        idx.push_front(data[1] + 0.01)
        idx.push_batch(data[2:10] + 0.01)
        idx.delete([5])
        idx.delete([6, 7, 8])
        idx.pop()
        idx.pop_front()
        idx.search_padded(data[:50], 5, 4)        # the flush
        idx.search_padded(data[:50], 5, 4)        # nothing to flush
    assert _mutation_spans(prof) == ["ivfadc.push"] * 3 + \
        ["ivfadc.delete"] * 4 + ["ivfadc.flush"]
    # the flush lies inside the search's set-up
    ev = {e.name: e for e in prof.events()
          if e.name in ("ivfadc.flush", "ivfadc.setup")}
    setups = [e for e in prof.events() if e.name == "ivfadc.setup"]
    flush = ev["ivfadc.flush"].time_range
    assert any(s.time_range.start <= flush.start
               and flush.end <= s.time_range.end for s in setups)


def test_each_mutation_counter_counts_inside_counting():
    idx, data = _small_index()
    idx.search_padded(data[:50], 5, 4)
    with profiling.counting() as counts:
        idx.push(data[0] + 0.01)
        idx.push_batch(data[2:12] + 0.01)
        idx.delete([6, 7, 8])
        idx.pop()
        dirty = len(idx.store._dirty_slots)
        idx.search_padded(data[:50], 5, 4)
    assert counts["pushed_rows"] == 11 and counts["deleted_rows"] == 4
    assert counts["flushed_slots"] == dirty >= 11
    assert counts["view_rebuilds"] == counts["graph_drops"] == 0
    assert counts["cell_grows"] == 0
    # a crowd into the smallest cell grows it past its view's room, a bulk
    # delete rebuilds the views; a store with a captured search drops it
    with profiling.counting() as counts:
        c = int(np.argmin(idx.store.caps))
        cent = idx.coarse.centroids[c].numpy()
        idx.push_batch(cent + 1e-3 * np.random.RandomState(1).randn(
            int(idx.store.caps[c]), 16).astype(np.float32))
        idx.search_padded(data[:50], 5, 4)
        idx.store.graphs._graphs[("sentinel",)] = graphs._Graph(
            (), graphs._Pool())
        idx.delete(range(0, 2100))                  # > 2048: bulk path
    assert counts["cell_grows"] >= 1
    assert counts["view_rebuilds"] >= 2
    assert counts["graph_drops"] == 1
    assert counts["deleted_rows"] == 2100
    # outside a counting() block the counters count nothing
    assert profiling.tally() is None
