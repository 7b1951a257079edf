"""The fine-coarse SIFT1M cell (k' = 8192, w = 64, k = 100) run through the
harness on the CPU, cut in scale only: kc stays past MAX_KC, so the dense
route (the kernels' plain versions, `scan_mode` "dense" where the CPU would
take the LUT engine) prepares its tiles by the sort, and w and k stay the
cell's. n is the smallest that holds them: at about 2 points a cell, 64 probed
cells hold about 128 >= k. The training faults fail it."""

import time

import pytest

from annbench import harness
from ivfadc_tpu_torch.ops.cell_rank import MAX_KC
from ivfadc_tpu_torch.utils import profiling

CELL = "sift1m.ivf8192"
KC = MAX_KC + 1
# d and m as annbench_tiny cuts the SIFT cells (a width here only sets the
# CPU's time); the training limits are this size's own: at about 2 points a
# cell k-means converges within the 8 iterations (the program's
# kmeans_lloyd_gain reads 1.9e-13, pq_lloyd_gain 2.7e-3, the gaps 7.8e-3
# and 9.3e-3), while one coarse Lloyd iteration reads kmeans_lloyd_gain
# 7.2e-3 and one PQ iteration pq_gap 0.128, pq_lloyd_gain 0.047
TINY = {"data": {"n": 2 * MAX_KC, "d": 16},
        "index": {"kc": KC, "m": 4, "k": 32, "kmeanspp_sample": 0,
                  "coarse_maxiter": 8, "quantization_maxiter": 8,
                  "scan_mode": "dense"},
        "traffic": {"batch": 300, "pool": 300, "trace_seconds": 0.5,
                    "keep_per_search": 8},
        "check": {"answers": 150,
                  "limits": {"kmeans_gap": 0.06, "pq_gap": 0.08,
                             "kmeans_lloyd_gain": 1e-3,
                             "pq_lloyd_gain": 0.02}}}


def _run(traced=False):
    with profiling.counting() as counts:
        result, _ = harness.run(CELL, 2 ** 33 + 17, 0.5, traced,
                                t_start=time.perf_counter(), device="cpu",
                                overrides=TINY)
    return result, counts


def test_cell_files_keep_the_source_shape():
    cell, cfg, traffic, check = harness.load(CELL)
    assert cell["chips"] == 1 and cfg["reduced"] == []
    assert (cfg["data"]["n"], cfg["data"]["d"]) == (1_000_000, 128)
    assert (cfg["index"]["kc"], cfg["index"]["m"]) == (8192, 16)
    assert cfg["index"]["kc"] > MAX_KC
    assert (traffic["batch"], traffic["w"], traffic["k"]) == (10000, 64, 100)
    # B*w >= 4*kc: the grouped scan, its tiles from the sort
    assert traffic["batch"] * traffic["w"] >= 4 * cfg["index"]["kc"]
    assert check["answers"] == 2000 and cfg["layers"] == "ivf_sortprep"


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_through_the_sort_prep(traced):
    _, cfg, traffic, _ = harness.load(CELL, TINY)
    assert cfg["index"]["kc"] > MAX_KC
    assert traffic["batch"] * traffic["w"] >= 4 * cfg["index"]["kc"]
    result, counts = _run(traced)
    assert result["correct"] is True and result["failed"] == 0, \
        result["checks"]
    assert result["checks"]["lost_rows"]["value"] == 0
    assert result["checks"]["bad_answers"]["value"] == 0
    # every search (the warm-up's 3 and the window's) sorted its probes
    assert counts["tileprep_sort_launches"] == counts["searches"] >= 4
    if traced:
        assert {"build_kmeans_s", "build_pq_s"} <= set(result["metrics"])
    else:
        assert {"qps", "build_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("stage", ["kmeans", "pq"])
def test_training_fault_is_not_correct(monkeypatch, stage):
    from test_annbench_faults import _one_lloyd
    _one_lloyd(monkeypatch, stage)
    result, _ = _run()
    assert result["correct"] is False, result["checks"]
