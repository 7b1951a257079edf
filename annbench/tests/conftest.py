"""Fixtures of the benchmark's CPU tests."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from annbench_tiny import ROOT, tiny  # noqa: E402

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def tiny_run():
    """tiny_run(cell, trace=False, hooks=None) -> (result, lines)."""
    import time

    from annbench import harness

    def go(cell, trace=False, hooks=None, seed=987654321987):
        return harness.run(cell, seed, 0.5, trace,
                           t_start=time.perf_counter(), device="cpu",
                           overrides=tiny(cell), hooks=hooks)
    return go
