"""The stage reduction (`stages.read`) at a synthetic trace, against hand
arithmetic, and the program's host spans leaving `trace.read`'s device
numbers as they were."""

from types import SimpleNamespace

import pytest

from annbench import stages, trace


def _event(name, start, end, device, cid=0):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, id=cid, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


SPANS = [
    _event("ivfadc.search", 0, 100, False),
    _event("ivfadc.setup", 2, 10, False),
    _event("ivfadc.probe", 10, 30, False),
    _event("ivfadc.scan", 30, 60, False),
    _event("ivfadc.merge", 60, 80, False),
    _event("ivfadc.to_host", 80, 100, False),
]
OTHERS = [
    _event(trace.SEARCH_SPAN, 0, 200, False),
    _event(trace.SEARCH_SPAN, 20, 170, True),       # the annotation
    _event("aten::copy_", 81, 99.5, False),
    # launches, each carrying its device op's correlation id
    _event("cudaLaunchKernel", 12, 13, False, 1),    # in probe
    _event("cudaLaunchKernel", 32, 33, False, 2),    # in scan
    _event("cudaLaunchKernel", 62, 63, False, 3),    # in merge
    _event("cudaMemcpyAsync", 82, 99, False, 4),     # in to_host
    _event("cudaLaunchKernel", 150, 151, False, 5),  # between calls
    _event("coarse_vbase_kernel", 20, 40, True, 1),
    _event("grouped_scan_kernel", 45, 70, True, 2),
    _event("topk_kernel", 75, 78, True, 3),
    _event("Memcpy DtoH", 90, 95, True, 4),
    _event("elementwise_kernel", 160, 170, True, 5),
    _event("elementwise_kernel", 180, 181, True, 9),  # no launch seen
]


def test_stages_by_hand():
    s = stages.read(SimpleNamespace(events=lambda: SPANS + OTHERS))
    assert s.span_s == pytest.approx({"probe": 20e-6, "scan": 25e-6,
                                      "merge": 3e-6, "to_host": 5e-6})
    assert s.outside_s == pytest.approx(11e-6) and s.unmatched_ops == 1
    assert s.searches == 1 and s.issue_s == pytest.approx(80e-6)
    # device busy [20, 70] less [40, 45], [75, 78], [90, 95], [160, 170],
    # [180, 181]: gaps in scan 5, merge 5, to_host 12, outside 65 + 10
    assert s.idle_s == pytest.approx(97e-6)
    assert s.idle_in_program_s == pytest.approx(22e-6)
    assert dict(s.idle_by_stage) == pytest.approx(
        {"outside": 75e-6, "to_host": 12e-6, "scan": 5e-6, "merge": 5e-6})


def test_host_spans_leave_the_device_numbers_as_they_were():
    rules = {"rules": [{"match": "coarse_", "layer": "probe"},
                       {"match": "grouped_scan", "layer": "scan"}]}
    without = trace.read(SimpleNamespace(events=lambda: OTHERS), 1e-3,
                         rules)
    t = trace.read(SimpleNamespace(events=lambda: SPANS + OTHERS), 1e-3,
                   rules)
    assert (t.device_ops, t.busy_s, t.layer_s, t.searches) == (
        without.device_ops, without.busy_s, without.layer_s,
        without.searches)
    assert t.device_ops == 6 and t.busy_s == pytest.approx(64e-6)
    # only the idle gaps' names change: Python inside a stage is named
    assert dict(without.idle_gaps) == pytest.approx(
        {"host outside torch ops": 85e-6, "cudaMemcpyAsync": 12e-6})
    assert dict(t.idle_gaps) == pytest.approx(
        {"host outside torch ops": 75e-6, "cudaMemcpyAsync": 12e-6,
         "ivfadc.scan": 5e-6, "ivfadc.merge": 5e-6})
