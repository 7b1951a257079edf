"""The cells that mutate nothing read what they read before the
comparison followed a mutating index: the same inputs (digests of
`make_inputs` frozen here) and the same comparison numbers, held to a
frozen copy of the comparison as it stood (`frozen_judge.py`), on a
sound run and under two of the timed path's faults (tiny cells on the
CPU)."""

import hashlib

import numpy as np
import pytest
import torch

import frozen_judge
from annbench import datagen, harness, specs
from annbench_tiny import CELLS, tiny
from test_annbench_faults import FAULTS
from test_annbench_gist import TINY as GIST_TINY

SEED = 987654321987

DIGESTS = {
    "sift1m.batch": (
        tiny("sift1m.batch"), SEED,
        "17cccbfe6089ed6397d9a89c3a928f0b2672b0624f5cae63b72389ed6132e392",
        "3461e49881e43a25f30bac12d6be8157bf53549668d0f23a34961b62cfd06139"),
    "gist1m.batch": (
        GIST_TINY, 2 ** 33 + 17,
        "8b8b937934ad26678312f59305139676734554c654ad3899b0e760c0437a833b",
        "bb6e0e7113f4165a3ff86d18eb714a847fcd1639c8e6f7ae0c52c02ab196a1d1"),
}


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("cell", sorted(DIGESTS))
def test_inputs_are_unmoved(cell):
    overrides, seed, base_sha, query_sha = DIGESTS[cell]
    _, cfg, traffic, _ = harness.load(cell, overrides)
    base, queries = datagen.make_inputs(cfg, traffic, seed, "cpu")
    assert (_sha(base), _sha(queries)) == (base_sha, query_sha)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["none", "codes_unwritten",
                                   "altered_answer"])
def test_comparison_numbers_are_unmoved(cell, fault):
    dev = torch.device("cpu")
    _, cfg, traffic, check = harness.load(cell, tiny(cell))
    index, queries, qh, n, _, _ = harness.build(cfg, traffic, SEED, dev)
    if fault != "none":
        FAULTS[fault](index)
    ctx = harness.Ctx(index, queries, qh, traffic, SEED, cfg["data"])
    drv = specs.driver(traffic["driver"])
    drv.warm(ctx)
    win = drv.run(ctx, 0.3)
    assert not win.mutations and {a[3] for a in win.answers} == {0}
    trained = harness.trained_of(index)
    given, held = harness.stored_of(index, n, dev)
    old_given, old_held = frozen_judge.stored_of(index, n, dev)
    assert torch.equal(given.assign, old_given.assign)
    assert torch.equal(given.codes, old_given.codes)
    assert np.array_equal(held, old_held)
    new = harness.judge(cfg, traffic, check, SEED, dev, queries, trained,
                        given, held, win, True)
    old_win = harness.Window(
        attempted=win.attempted, failed=win.failed, completed=win.completed,
        elapsed_s=win.elapsed_s, searches=win.searches,
        answers=[a[:3] for a in win.answers],
        sent=[s[:2] for s in win.sent])
    old = frozen_judge.judge(cfg, traffic, check, SEED, dev, queries,
                             trained, old_given, old_held, old_win, True)
    assert new[0] == old[0]              # every number, bit for bit
    assert new[2] == old[2]              # the traced run's work counts
