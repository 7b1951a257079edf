"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: the build's state left unchanged
(codes never written), half of each batch left out (its rows answered
with the other half's), an answer altered where it is produced, and the
training stopped after one Lloyd iteration (the coarse k-means's, or
the PQ subspaces'). One card, so no exchange between chips to leave out.
The harness's look for a card is skipped: the program runs on the CPU
at a tiny size."""

import numpy as np
import pytest

from annbench_tiny import CELLS


def _codes_unwritten(index):
    view = index.store
    view._codes_h = np.zeros_like(np.asarray(view.codes))
    view._codes_dev = None
    view._invalidate()


def _half_batch(index):
    search = index.search_padded

    def half(points, k, w=1):
        n = len(points)
        h = max(1, n // 2)
        ids, dists = search(points[:h], k, w)
        reps = -(-n // h)
        return np.tile(ids, (reps, 1))[:n], np.tile(dists, (reps, 1))[:n]
    index.search_padded = half


def _altered(index):
    search = index.search_padded

    def alter(points, k, w=1):
        ids, dists = search(points, k, w)
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 1) % len(index)
        return ids, dists
    index.search_padded = alter


FAULTS = {"codes_unwritten": _codes_unwritten, "half_batch": _half_batch,
          "altered_answer": _altered}


def _one_lloyd(monkeypatch, stage):
    """The program's coarse k-means or PQ training held to one Lloyd
    iteration, whatever the configuration asks."""
    from ivfadc_tpu_torch.models import index as index_mod
    from ivfadc_tpu_torch.ops import pq as pq_ops
    owner, name = {"kmeans": (index_mod, "kmeans"),
                   "pq": (pq_ops, "train_quantizer")}[stage]
    real = getattr(owner, name)

    def once(*a, **kw):
        return real(*a, **{**kw, "maxiter": 1})
    monkeypatch.setattr(owner, name, once)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny_run, cell, fault):
    result, _ = tiny_run(cell, hooks={"after_build": FAULTS[fault]})
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("stage", ["kmeans", "pq"])
def test_training_fault_is_not_correct(tiny_run, monkeypatch, cell, stage):
    _one_lloyd(monkeypatch, stage)
    result, _ = tiny_run(cell)
    assert result["correct"] is False, result["checks"]
