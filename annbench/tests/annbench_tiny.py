"""Tiny overrides of each cell for the benchmark's CPU tests: a whole
run fits in a test (the program's CPU path, LUT scan)."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("sift1m.batch", "sift1m.batch64k")


def tiny(cell: str) -> dict:
    """Overrides that shrink a cell to a few seconds on the CPU. At this
    size k-means lands in other local minima from seed to seed (the
    reference's own training, trained again, reads `kmeans_gap` up to
    0.035 against itself; 2e-4 at the cells' size), so the training
    numbers take limits of this size's own: the program's readings here
    reach 0.016, 0.034, 0.0032 and 0.0053, one Lloyd iteration's 0.11,
    0.15, 0.045 and 0.068."""
    return {"data": {"n": 6000, "d": 16},
            "index": {"kc": 32, "m": 4, "k": 32, "kmeanspp_sample": 0,
                      "coarse_maxiter": 8, "quantization_maxiter": 8},
            "traffic": {"batch": 200, "pool": 200, "trace_seconds": 0.5,
                        "keep_per_search": 8},
            "check": {"answers": 150,
                      "limits": {"kmeans_gap": 0.06, "pq_gap": 0.08,
                                 "kmeans_lloyd_gain": 0.01,
                                 "pq_lloyd_gain": 0.02}}}


def mutating(cell: str) -> dict:
    """`tiny(cell)` driven by the mutation driver: a push of 64 points and
    a delete of 64 ids every 0.05 s over the 6,000 points, about 10 pairs
    in a 0.5 s window on an idle CPU; the warm-up's pair in any case."""
    ov = tiny(cell)
    ov["traffic"] = {**ov["traffic"], "driver": "mutate", "push": 64,
                     "delete": 64, "every_s": 0.05}
    return ov
