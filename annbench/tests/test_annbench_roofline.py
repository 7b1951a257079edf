"""The roofline counts and the trace reduction at tiny shapes, against
hand arithmetic."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from annbench import harness, roofline, trace
from annbench.reference import ivfadc as ref
from annbench.window import Window


def test_least_time_is_the_larger_bound():
    # 3.35e9 bytes take 1 ms; 989e9 bf16 operations take 1 ms
    assert roofline.least_s(3.35e9, 0, "bf16") == pytest.approx(1e-3)
    assert roofline.least_s(0, 989e9, "bf16") == pytest.approx(1e-3)
    assert roofline.least_s(3.35e9, 2 * 1979e9, "int8") == \
        pytest.approx(2e-3)
    assert roofline.share(3.35e9, 0, "bf16", 4e-3) == pytest.approx(25.0)
    assert roofline.share(1, 1, "bf16", 0.0) is None


def test_work_of_each_layer_by_hand():
    # 3 queries, d=4, 5 centroids: 4*4*(3+5) bytes, 2*4*15 operations
    assert roofline.probe_work(3, 4, 15, 5) == (128.0, 120.0)
    # 7 postings of m=8 codes and 4-byte ids; 20 pairs at d=4
    assert roofline.scan_work(4, 8, 4, 20, 7) == (84.0, 160.0)
    assert roofline.merge_work(3, 10) == (240.0, 0.0)


def test_work_counts_from_the_reference_probe():
    # centroids on a line; each query probes its 2 nearest cells
    cen = torch.tensor([[0.0, 0], [10, 0], [20, 0], [30, 0]])
    trained = ref.Trained(cen, torch.zeros((1, 2, 2)))
    assign = torch.tensor([0, 0, 0, 1, 1, 2, 3, 3, 3, 3])
    lists = ref.Lists(ref.Stored(assign, torch.zeros((10, 1),
                                                     dtype=torch.long)), 4)
    q = torch.tensor([[1.0, 0], [29, 0], [21, 0]])
    cfg = {"index": {"m": 8, "index_dtype": "uint32"}}
    traffic = {"w": 2, "k": 3}
    win = Window(attempted=3, failed=0, completed=3, elapsed_s=1.0,
                 sent=[(np.arange(3), 5)])
    work = harness.work_counts(q, trained, lists, cfg, traffic, win)
    # cells: q0 {0, 1} 3+2 rows, q1 {3, 2} 4+1, q2 {2, 3} 1+4 -> 15 pairs;
    # the batch probes all 4 cells: 10 postings of 12 bytes
    assert work["scan"] == (5 * 120.0, 5 * 2 * 2 * 15.0)
    # naive probe: 3 x 4 pairs; queries and 4 centroids read once
    assert work["probe"] == (5 * 4 * 2 * (3 + 4.0), 5 * 2 * 2 * 12.0)
    assert work["merge"] == (5 * 8 * 3 * 3.0, 0.0)


def _event(name, start, end, device):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_trace_reduction_by_hand():
    ev = [
        _event(trace.SEARCH_SPAN, 0, 100, False),
        _event(trace.SEARCH_SPAN, 0, 100, True),        # the annotation
        _event("coarse_vbase_kernel", 10, 20, True),
        _event("topk_kernel<false>", 20, 30, True),      # nth 1: probe
        _event("aten::copy_", 30, 60, False),
        _event("index_kernel", 40, 45, True),            # before the scan
        _event("probe_scan_kernel", 50, 70, True),
        _event("gather_kernel", 70, 75, True),           # after the scan
        _event("topk_kernel<false>", 75, 80, True),      # nth 2: merge
    ]
    prof = SimpleNamespace(events=lambda: ev)
    rules = {"rules": [
        {"match": "coarse_", "layer": "probe"},
        {"match": "topk_kernel<false>", "nth": [1], "layer": "probe"},
        {"match": "topk_kernel", "layer": "merge"},
        {"match": "probe_scan_kernel", "layer": "scan"},
        {"match": "gather|index", "after": "probe_scan_kernel",
         "layer": "merge"},
        {"match": "gather|index", "layer": "tileprep"}]}
    t = trace.read(prof, 200e-6, rules)
    assert t.device_ops == 6 and t.searches == 1
    # busy: [10, 30] + [40, 45] + [50, 80] = 55 us; gaps 30-40 and 45-50
    assert t.busy_s == pytest.approx(55e-6)
    assert t.layer_s == pytest.approx({"probe": 20e-6, "tileprep": 5e-6,
                                       "scan": 20e-6, "merge": 10e-6})
    assert dict(t.idle_gaps) == pytest.approx({"aten::copy_": 15e-6})
