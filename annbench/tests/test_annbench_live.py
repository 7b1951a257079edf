"""The live SIFT1M cell (`sift1m.mutate`): its files keep the SIFT1M
deployment and the cell's rate, a run by name through the harness at the
tiny size (with the mutation driver's tiny push and delete sizes) comes out
correct, untraced and traced, and the cell's two mutation metrics read
what they should."""

import math
import time

import numpy as np
import pytest

from annbench import harness, specs, trace
from annbench.window import Window
from annbench_tiny import mutating

CELL = "sift1m.mutate"
NEW = ("mutate_device_ms_per_pair.mutate", "mutate_roofline.mutate")
# the accepted per-layer metrics of sift1m.batch's layers that read here too
SHARED = {"device_ms_per_search.batch", "device_idle_share.batch",
          "store_resident_gib", "probe_roofline.batch",
          "tileprep_ms_per_search.batch", "scan_roofline.batch",
          "merge_roofline.batch", "build_kmeans_s", "build_pq_s"}


def _run(traced):
    ov = mutating(CELL)
    if traced:
        # a traced window long enough for pairs after the warm-up's even
        # where the suite's workers share a few cores (a search can then
        # take most of a second under the profiler)
        ov["traffic"] = {**ov["traffic"], "trace_seconds": 3.0}
    return harness.run(CELL, 2 ** 34 + 29, 3.0 if traced else 0.5, traced,
                       t_start=time.perf_counter(), device="cpu",
                       overrides=ov)


def test_cell_files_keep_the_sift1m_deployment_and_the_rate():
    cell, cfg, traffic, check = harness.load(CELL)
    base_cell, base_cfg, base_traffic, base_check = harness.load(
        "sift1m.batch")
    assert cell["chips"] == 1 and cfg["reduced"] == []
    assert cfg["data"] == base_cfg["data"]
    assert cfg["index"] == base_cfg["index"]
    assert cfg["layers"] == base_cfg["layers"]
    assert check == base_check
    assert traffic["driver"] == "mutate"
    assert {k: traffic[k] for k in base_traffic if k not in ("driver",
                                                               "why")} == \
        {k: v for k, v in base_traffic.items() if k not in ("driver", "why")}
    assert (traffic["push"], traffic["delete"], traffic["every_s"]) == \
        (1024, 1024, 0.1)
    bench = specs.benchmark()
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and m["moves"] == "qps"
            assert m["source"] == "device_trace"
    assert {m["name"] for m in specs.cell_metrics(CELL, "per_layer")} == \
        set(NEW) | SHARED


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_by_name_and_is_correct(traced, monkeypatch):
    """The run is correct; in the traced run, the CPU's torch operations
    stand in for device operations (no card here), so the two mutation
    metrics have something to read: each reads a finite value, and the
    roofline share at most 100 %."""
    if traced:
        monkeypatch.setattr(trace, "_is_device",
                            lambda e: e.name.startswith("aten::"))
    result, lines = _run(traced)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0
    assert result["checks"]["lost_rows"]["value"] == 0
    line = [ln for ln in lines if ln.startswith("mutations:")]
    assert line and int(line[0].split()[1]) >= 2, lines
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    if traced:
        assert set(NEW) <= set(metrics), metrics
        assert all(math.isfinite(metrics[k]) and metrics[k] > 0 for k in NEW)
        assert metrics["mutate_roofline.mutate"] <= 100.0
    else:
        assert {"qps", "build_s", "setup_s"} <= set(metrics)


def _run_record(mutate_s, deletes):
    cfg = specs.config(specs.cell(CELL)["config"])
    tr = trace.Trace(window_s=1.0, busy_s=0.5, device_ops=10, layer_s={},
                     searches=5, mutate_s=mutate_s)
    log = [("push", 0, 1024), ("delete", np.arange(3))] * deletes
    win = Window(attempted=1, failed=0, completed=1, elapsed_s=1.0,
                 mutations=log)
    return harness.Run(cell={}, config=cfg,
                       traffic=specs.traffic(specs.cell(CELL)["traffic"]),
                       setup_s=0.0, build_s=0.0, build_timings={},
                       resident_bytes=0, peak_bytes=0, window=win, trace=tr)


def test_readers_count_pairs_after_the_warm_up():
    run = _run_record(0.0006, deletes=3)
    assert specs.metric(NEW[0]).read(run) == pytest.approx(0.3)
    # least time a pair: n = 1M ids read and written (8 MB) plus the push's
    # points, centroids, codebooks and rows, against its 2*d*(k'+k*)
    # operations a point at the f32 rate
    mod = specs.metric(NEW[1])
    nbytes, ops = mod.pair_work(run.config, run.traffic)
    assert nbytes == 8e6 + 4 * 128 * (1024 + 1024 + 256) + 1024 * 12
    assert ops == 2 * 128 * (1024 + 256) * 1024
    least = max(nbytes / 3.35e12, ops / 67e12)
    assert mod.read(run) == pytest.approx(100 * least / 0.3e-3)
    # the warm-up's pair alone, or no trace: nothing to read
    warm_only = _run_record(0.0006, deletes=1)
    assert all(specs.metric(n).read(warm_only) is None for n in NEW)
    run.trace = None
    assert all(specs.metric(n).read(run) is None for n in NEW)
