"""The search path's stage spans and counters (utils/profiling.py): off
without a profiler and outside `counting()`, in order under a profiler,
and the counts against `probe_stats` and each route's loop bounds.

Tiny CPU indexes: the dense routes run the kernels' plain versions.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ivfadc_tpu_torch import IVFADCIndex
from ivfadc_tpu_torch.ops.dense_scan import tile_height
from ivfadc_tpu_torch.utils import profiling

# the suite runs several workers on a few cores: keep torch's pool small
torch.set_num_threads(2)

KC, W, K = 16, 4, 5
# route -> (scan_mode, queries a call, index options, environment)
ROUTES = {
    "grouped": ("dense", 50, {}, {}),          # 64 x 4 probes >= 4 * kc
    "per_probe": ("dense", 3, {}, {}),         # 8 x 4 probes < 4 * kc
    "gathered": ("dense", 3, {"scan_gather_win": 2048}, {}),
    "qc": ("dense", 50, {}, {"IVFADC_VBASE": "qc"}),
    "lut": ("lut", 50, {}, {}),
}
STAGES = ["setup", "probe", "tileprep", "scan", "merge", "to_host"]


@pytest.fixture(scope="module")
def data():
    return np.random.RandomState(0).rand(3000, 16).astype(np.float32)


@pytest.fixture(scope="module")
def indexes(data):
    built = {}

    def get(route):
        mode, _, opts, _ = ROUTES[route]
        key = (mode, tuple(sorted(opts.items())))
        if key not in built:
            built[key] = IVFADCIndex.build(
                data, device="cpu", kc=KC, m=4, k=16, scan_mode=mode,
                coarse_maxiter=3, quantization_maxiter=3, **opts)
        return built[key]
    return get


def _setup(route, indexes, data, monkeypatch):
    _, B, _, env = ROUTES[route]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    return indexes(route), data[:B] + 0.01


def _raise(*a, **k):
    raise AssertionError("called on the search path")


@pytest.mark.parametrize("route", ["grouped", "per_probe", "lut"])
def test_no_profiler_no_counting_no_spans_no_counters(route, indexes, data,
                                                      monkeypatch):
    idx, q = _setup(route, indexes, data, monkeypatch)
    want = idx.search_padded(q, K, W)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(profiling, "_Span", _raise)
    monkeypatch.setattr(profiling, "_Tally", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    got = idx.search_padded(q, K, W)
    idx.search(q[0], K, W)
    idx.search_stream(q, K, W, batch=16)
    assert all(np.array_equal(a, b) for a, b in zip(want, got))
    assert profiling.tally() is None
    assert profiling.span("ivfadc.scan") is profiling.span("ivfadc.probe")


def _spans(prof):
    ev = [e for e in prof.events() if e.name.startswith("ivfadc.")]
    return sorted(((e.time_range.start, e.time_range.end,
                    e.name[len("ivfadc."):]) for e in ev))


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_search_emits_its_stages_in_order(route, indexes, data,
                                              monkeypatch):
    idx, q = _setup(route, indexes, data, monkeypatch)
    want = idx.search_padded(q, K, W)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = idx.search_padded(q, K, W)
    assert all(np.array_equal(a, b) for a, b in zip(want, got))
    spans = _spans(prof)
    search = [s for s in spans if s[2] == "search"]
    assert len(search) == 1
    stages = [s for s in spans if s[2] != "search"]
    assert all(search[0][0] <= s0 and s1 <= search[0][1]
               for s0, s1, _ in stages)
    # stages do not overlap: each ends before the next starts
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))
    order = [n for i, (_, _, n) in enumerate(stages)
             if i == 0 or stages[i - 1][2] != n]
    expect = [s for s in STAGES if route != "lut" or s != "tileprep"]
    assert order == expect


def test_search_and_search_stream_spans(indexes, data):
    idx = indexes("lut")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.search(data[0], K, W)
        idx.search_stream(data[:40], K, W, batch=16)
    names = [n for _, _, n in _spans(prof)]
    assert names.count("search") == 2
    assert names.count("setup") == 1 + 3          # one a batch
    assert names[-2:] == ["merge", "to_host"]


def test_a_stage_inside_a_stage_records_nothing():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("ivfadc.search"):
            with profiling.span("ivfadc.probe"):
                with profiling.span("ivfadc.scan"):
                    torch.ones(4).sum()
            with profiling.span("ivfadc.scan"):
                pass
    assert [n for _, _, n in _spans(prof)] == ["search", "probe", "scan"]


def _padded_cells(idx, q):
    Bp = 64 if q.shape[0] > 8 else 8
    qp = np.zeros((Bp, q.shape[1]), np.float32)
    qp[:q.shape[0]] = q
    cells, _ = idx.coarse.search(torch.from_numpy(qp), W)
    return cells.numpy().astype(np.int64), Bp


def _scan_pairs(route, idx, q):
    """Each route's (probe slot, row) pairs, by hand from the padded
    batch's cells."""
    cells, Bp = _padded_cells(idx, q)
    sizes = np.asarray(idx.store.sizes, np.int64)
    if route in ("grouped", "qc"):
        h = tile_height(idx.config.scan_pb)
        n = np.bincount(cells.reshape(-1), minlength=KC)
        return int(((n + h - 1) // h * h * sizes).sum())
    if route == "per_probe":
        return int(sizes[cells].sum())
    if route == "gathered":
        win, _ = idx._gather_plan()
        return Bp * W * win
    return Bp * W * idx.store.window


def _cache_bytes(route, idx, q):
    """Each route's streamed decoded-cache bytes, by hand: the rows its
    tiles, probes or gathered windows read times the int8 cache's 128
    lanes (d = 16 padded); the LUT route reads codes, not the cache."""
    if route == "lut":
        return 0
    if route in ("grouped", "qc"):
        cells, _ = _padded_cells(idx, q)
        h = tile_height(idx.config.scan_pb)
        n = np.bincount(cells.reshape(-1), minlength=KC)
        sizes = np.asarray(idx.store.sizes, np.int64)
        return int(((n + h - 1) // h * sizes).sum()) * 128
    return _scan_pairs(route, idx, q) * 128


@pytest.mark.parametrize("route", list(ROUTES))
def test_counting_matches_probe_stats_and_loop_bounds(route, indexes, data,
                                                      monkeypatch):
    idx, q = _setup(route, indexes, data, monkeypatch)
    B = q.shape[0]
    want = idx.search_padded(q, K, W)
    with profiling.counting() as counts:
        assert counts == {}
        got = idx.search_padded(q, K, W)
    assert all(np.array_equal(a, b) for a, b in zip(want, got))
    st = profiling.probe_stats(idx, q, W)
    _, Bp = _padded_cells(idx, q)
    assert counts == {
        "searches": 1, "queries": B, "padded_queries": Bp, "probes": B * W,
        "postings_probed": round(st["scanned_postings_per_query"] * B),
        "scan_pairs": _scan_pairs(route, idx, q),
        "graph_captures": 0, "graph_replays": 0,
        "scan_cache_bytes": _cache_bytes(route, idx, q),
        # the plain versions launch no kernel
        "probe_narrow_launches": 0, "scan_single_tile_launches": 0,
        "scan_probe_order_launches": 0, "tileprep_sort_launches": 0,
        "probe_wide_select_launches": 0,
        # a search mutates nothing
        "pushed_rows": 0, "deleted_rows": 0, "flushed_slots": 0,
        "view_rebuilds": 0, "graph_drops": 0, "cell_grows": 0}
    assert counts["scan_pairs"] >= counts["postings_probed"]
    # outside the block nothing is counted
    before = dict(counts)
    idx.search_padded(q, K, W)
    assert counts == before and profiling.tally() is None


@pytest.mark.parametrize("route,sort", [("grouped", False),
                                        ("grouped", True),
                                        ("per_probe", True)])
def test_sort_prep_counts_once_a_grouped_search_and_nests_its_span(
        route, sort, indexes, data, monkeypatch):
    """`tileprep_sort_launches` reads 1 a grouped search whose tile prep
    sorts (kc > MAX_KC, here MAX_KC lowered below the index's kc) and 0
    where the counting prep serves it or no tiles are made; the sort's span
    `ivfadc.tileprep.sort` lies inside an `ivfadc.tileprep` span."""
    from ivfadc_tpu_torch.ops import dense_scan
    if sort:
        monkeypatch.setattr(dense_scan, "MAX_KC", KC - 1)
    idx, q = _setup(route, indexes, data, monkeypatch)
    with profiling.counting() as counts:
        idx.search_padded(q, K, W)
    sorted_prep = int(route == "grouped" and sort)
    assert counts["tileprep_sort_launches"] == sorted_prep
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.search_padded(q, K, W)
    spans = _spans(prof)
    inner = [s for s in spans if s[2] == "tileprep.sort"]
    assert len(inner) == sorted_prep
    for s0, s1, _ in inner:
        assert any(t0 <= s0 and s1 <= t1 for t0, t1, n in spans
                   if n == "tileprep")


def test_counting_sums_over_searches_and_does_not_nest(indexes, data):
    idx = indexes("lut")
    with profiling.counting() as one:
        idx.search_padded(data[:50], K, W)
    with profiling.counting() as three:
        for _ in range(3):
            idx.search_padded(data[:50], K, W)
        with pytest.raises(RuntimeError):
            with profiling.counting():
                pass
    assert three == {key: 3 * v for key, v in one.items()}
