"""A run's last line keeps to the contract's schema, with the compared
numbers last (tiny cells on the CPU)."""

import json

import pytest

from annbench import harness, specs
from annbench_tiny import CELLS, tiny


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema(tiny_run, cell, traced):
    result, lines = tiny_run(cell, trace=traced)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    section = "per_layer" if traced else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in specs.cell_metrics(cell, section)}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and allowed[name] == m["unit"]
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"] and "build_s" in line["metrics"]
    limits = harness.load(cell, tiny(cell))[3]["limits"]
    assert set(line["checks"]) == set(limits)
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["limit"] == limits[name]
    # standard error ends with the same numbers, one a line
    assert lines[-len(limits):] == [
        f"check {n} {line['checks'][n]['value']!r} limit {limits[n]!r}"
        for n in limits]
