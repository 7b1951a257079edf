"""The GIST1M cell's run at its published widths (d = 960, m = 16), cut in
scale only to fit a CPU test: the harness, the reference and the traced
run's work counts take the shape."""

import time

import pytest

from annbench import harness

# the data keeps d = 960 and the index m = 16; scale, k* and the
# iterations are cut as annbench_tiny cuts the SIFT cells, with its
# training limits
TINY = {"data": {"n": 6000},
        "index": {"kc": 32, "k": 64, "kmeanspp_sample": 0,
                  "coarse_maxiter": 8, "quantization_maxiter": 8},
        "traffic": {"batch": 200, "pool": 200, "trace_seconds": 0.5,
                    "keep_per_search": 8},
        "check": {"answers": 150,
                  "limits": {"kmeans_gap": 0.06, "pq_gap": 0.08,
                             "kmeans_lloyd_gain": 0.01,
                             "pq_lloyd_gain": 0.02}}}


@pytest.mark.parametrize("traced", [False, True])
def test_gist_cell_runs_at_its_widths(traced):
    cell, cfg, traffic, _ = harness.load("gist1m.batch", TINY)
    assert (cfg["data"]["d"], cfg["index"]["m"]) == (960, 16)
    assert cell["chips"] == 1 and traffic["w"] == 8
    result, _ = harness.run("gist1m.batch", 2 ** 33 + 17, 0.5, traced,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=TINY)
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["lost_rows"]["value"] == 0
    if traced:
        assert {"build_kmeans_s", "build_pq_s"} <= set(result["metrics"])
    else:
        assert {"qps", "build_s", "setup_s"} <= set(result["metrics"])
