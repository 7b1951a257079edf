"""The comparison fails its controls: the reference put in the program's
place one precision step below what the configuration states (bf16 for
float32, int4 tables for int8), and the reference's training with the
configuration's iteration counts broken (one Lloyd iteration of the
coarse k-means or of the PQ subspaces', or none), each read beyond at
least one limit, while the program reads within every one (tiny cells
on the CPU); also where the window mutates the index, the control
answering each query at its answer's version."""

import pytest

from annbench import control, harness
from annbench.reference import compare
from annbench_tiny import CELLS, mutating, tiny


@pytest.mark.parametrize("cell", CELLS)
def test_controls_fail_program_passes(cell):
    limits = harness.load(cell, tiny(cell))[3]["limits"]
    got = dict(control.readings(cell, 424242, 0.5, True, device="cpu",
                                overrides=tiny(cell)))
    assert compare.judge(got["program"], limits), got["program"]
    for who in ["control"] + [f"fault:{f}" for f in control.FAULTS]:
        held = {k: v for k, v in limits.items() if k in got[who]}
        assert held and not compare.judge(got[who], held), (who, got[who])


@pytest.mark.parametrize("cell", CELLS)
def test_controls_fail_program_passes_under_mutation(cell):
    limits = harness.load(cell, mutating(cell))[3]["limits"]
    got = dict(control.readings(cell, 434343, 0.5, True, device="cpu",
                                overrides=mutating(cell)))
    assert compare.judge(got["program"], limits), got["program"]
    for who in ["control"] + [f"fault:{f}" for f in control.FAULTS]:
        held = {k: v for k, v in limits.items() if k in got[who]}
        assert held and not compare.judge(got[who], held), (who, got[who])
    # the control's own answers name live positions: nothing lost, no
    # id out of range at its version
    assert got["control"]["lost_rows"] == 0
    assert got["control"]["bad_answers"] == 0
