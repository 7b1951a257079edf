"""A run whose window mutates the index (the mutation driver, tiny cells on
the CPU): the real program comes out correct, and each mutation fault,
put in underneath as `test_annbench_faults.py` puts in its faults, comes
out not correct. The position table that the comparison replays from the
log agrees with `IVFADCIndex`'s own renumbering, and a traced window's
mutations go to no search's layers."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from annbench import harness, trace
from annbench.reference.replay import Replay
from annbench_tiny import CELLS, mutating


def _run(cell, traced=False, hooks=None):
    return harness.run(cell, 987654321987, 0.5, traced,
                       t_start=time.perf_counter(), device="cpu",
                       overrides=mutating(cell), hooks=hooks)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_mutating_run_is_correct(cell, traced):
    result, lines = _run(cell, traced)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0
    assert result["checks"]["lost_rows"]["value"] == 0
    # the warm-up's pair at least (how many the window adds depends on
    # the CPU's speed), every answer judged after it
    line = [ln for ln in lines if ln.startswith("mutations:")]
    assert line and int(line[0].split()[1]) >= 2, lines
    assert int(line[0].split()[-1].split("..")[0]) >= 2, lines


def _push_stores_nothing(index):
    index.push_batch = lambda points: None


def _delete_ignored(index):
    index.delete = lambda ids: None


def _delete_without_renumbering(index):
    store = index.store

    def delete(ids):
        for i in np.unique(np.asarray(ids, np.int64)):
            try:
                cell, slot = store.find(int(i))
            except KeyError:          # a position the renumbering left out
                continue
            store.remove_slot(cell, slot)
    index.delete = delete


def _push_in_a_wrong_cell(index):
    from ivfadc_tpu_torch.ops import pq as pq_ops

    def push_batch(points):
        x = torch.as_tensor(np.asarray(points, np.float32),
                            device=index.device)
        cells = index.coarse.search(x, 1)[0][:, 0].to(torch.int64)
        cells = (cells + 1) % index.config.kc
        codes = pq_ops.encode(index.quantizer,
                              x - index.coarse.centroids[cells],
                              metric=index.quant_metric)
        index.store.append_batch(
            cells.cpu().numpy(),
            codes.cpu().numpy().astype(index.store.code_dtype), len(index))
    index.push_batch = push_batch


FAULTS = {"push_stores_nothing": _push_stores_nothing,
          "delete_ignored": _delete_ignored,
          "delete_without_renumbering": _delete_without_renumbering,
          "push_in_a_wrong_cell": _push_in_a_wrong_cell}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_mutation_fault_is_not_correct(fault):
    result, _ = _run(CELLS[0], hooks={"after_build": FAULTS[fault]})
    assert result["correct"] is False, result["checks"]


def _by_position(index):
    """(cell, codes) of each position the index holds."""
    given, _ = harness.stored_of(index, len(index), "cpu")
    return np.concatenate([given.assign.numpy()[:, None],
                           given.codes.numpy()], 1)


def test_replay_follows_the_index_renumbering():
    from ivfadc_tpu_torch import IVFADCIndex

    g = torch.Generator().manual_seed(7)
    base = torch.randn((3000, 16), generator=g)
    pushed = torch.randn((300, 16), generator=g)
    index = IVFADCIndex.build(base, device="cpu", kc=16, m=8, k=256,
                              coarse_maxiter=4, quantization_maxiter=4,
                              kmeanspp_sample=0, seed=3)
    n = len(index)
    sig = np.zeros((n + len(pushed), 9), np.int64)
    sig[:n] = _by_position(index)
    # a hand-written log: pushes, a one-id delete (swap and shift), small
    # deletes (the incremental path), one past 2,048 ids (the bulk path)
    log = [("push", 0, 100), ("delete", [3]),
           ("delete", [0, 7, 2999, 3050, 3098, 1500]),
           ("push", 100, 200), ("delete", [5, 5, 3200, 1]),
           ("delete", list(range(100, 2200))), ("push", 300, 0)]
    for v, m in enumerate(log, 1):
        if m[0] == "push":
            first, count = m[1], m[2]
            index.push_batch(pushed[first:first + count])
            sig[n + first:n + first + count] = \
                _by_position(index)[len(index) - count:]
        else:
            index.delete(m[1])
        r = Replay(n, log).advance(v)
        assert len(index) == r.table.size
        assert (_by_position(index) == sig[r.table]).all(), m
        assert r.live.sum() == r.table.size and r.strays == 0
    r = Replay(n, log).at_end()
    assert (r.positions(r.table) == np.arange(r.table.size)).all()
    assert (r.points(np.array([-1, r.table.size])) == -1).all()


def _event(name, start, end, device, cid=0):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, id=cid, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_trace_keeps_mutations_apart():
    ev = [
        _event(trace.SEARCH_SPAN, 0, 100, False),
        _event(trace.MUTATE_SPAN, 100, 150, False),
        _event(trace.MUTATE_SPAN, 100, 150, True),       # the annotation
        _event(trace.SEARCH_SPAN, 150, 250, False),
        _event("cudaLaunchKernel", 10, 11, False, 1),
        _event("cudaMemcpyAsync", 110, 111, False, 2),   # in the mutation
        _event("cudaLaunchKernel", 120, 121, False, 3),  # in the mutation
        _event("cudaLaunchKernel", 160, 161, False, 4),
        _event("coarse_vbase_kernel", 20, 40, True, 1),
        _event("Memcpy HtoD", 112, 115, True, 2),
        # launched in the mutation, run once the next search began
        _event("elementwise_kernel", 145, 155, True, 3),
        _event("coarse_vbase_kernel", 170, 190, True, 4),
        _event("index_kernel", 195, 200, True, 9),        # no launch seen
        _event("index_kernel", 130, 132, True, 8),        # no launch seen
    ]
    prof = SimpleNamespace(events=lambda: ev)
    rules = {"rules": [{"match": "coarse_", "layer": "probe"},
                       {"match": "index", "layer": "tileprep"}]}
    t = trace.read(prof, 300e-6, rules)
    assert t.searches == 2 and t.device_ops == 6
    assert t.mutate_s == pytest.approx(15e-6)
    assert t.layer_s == pytest.approx({"probe": 40e-6, "tileprep": 5e-6})
    # busy counts every device operation
    assert t.busy_s == pytest.approx(20e-6 + 3e-6 + 10e-6 + 20e-6 + 5e-6
                                     + 2e-6)
