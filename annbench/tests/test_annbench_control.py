"""The comparison fails its controls: the reference put in the program's
place one precision step below what the configuration states (bf16 for
float32, int4 tables for int8), and the reference's training with the
configuration's iteration counts broken (one Lloyd iteration of the
coarse k-means or of the PQ subspaces', or none), each read beyond at
least one limit, while the program reads within every one (tiny cells
on the CPU)."""

import pytest

from annbench import control, harness
from annbench.reference import compare
from annbench_tiny import CELLS, tiny


@pytest.mark.parametrize("cell", CELLS)
def test_controls_fail_program_passes(cell):
    limits = harness.load(cell, tiny(cell))[3]["limits"]
    got = dict(control.readings(cell, 424242, 0.5, True, device="cpu",
                                overrides=tiny(cell)))
    assert compare.judge(got["program"], limits), got["program"]
    for who in ["control"] + [f"fault:{f}" for f in control.FAULTS]:
        held = {k: v for k, v in limits.items() if k in got[who]}
        assert held and not compare.judge(got[who], held), (who, got[who])
