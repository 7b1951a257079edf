"""Every `scan_pb` the JAX package takes, searched by the port.

The grouped kernels run tiles of `ops.dense_scan.tile_height(pb)` =
min(round_up(pb, 8), 64) probes, and the config keeps the value it was
given. A probe's fold buffer does not depend on which probes share its
tile, so the port's results at any pb are the JAX package's at the same
pb.

One JAX index on integer-valued data (`_integer_pair` of
tests/test_torch_dynamic.py: integer centroids and queries, half-integer
codewords, an int8 scale of 1/2) is saved at each pb and loaded by the
port on the CPU. Every score is then exact, so no accumulation order can
move a distance: ids and distances must equal the JAX package's bit for
bit on the grouped route (B*w >= 4*kc), the per-probe route, a sharded
view of two shards and the qc route (IVFADC_VBASE=qc), at every pb,
pb < 8 included. (On inexact data the JAX package's own distances at
pb < 8 differ from its pb >= 8 ones in the last bits: XLA's CPU dot
accumulates a product of fewer than 8 rows in another order. ROADMAP
C.26.) A save from the port writes the config's pb back unchanged.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from ivfadc_tpu import IVFADCIndex as JaxIndex
from ivfadc_tpu import save_ivfadc_index as jax_save
from ivfadc_tpu_torch import IVFADCIndex
from ivfadc_tpu_torch.ops.dense_scan import tile_height
from ivfadc_tpu_torch.parallel import ShardedIVFADCIndex, make_mesh
from tests.test_torch_dynamic import NROWS, _integer_pair

torch.set_num_threads(2)

PBS = [4, 8, 20, 64, 100, 128, 256]
W = 8


@pytest.fixture(scope="module")
def integer_index(random_data):
    """The JAX index (kc = 100) and integer-valued queries: 64 for the
    grouped route (64 * 8 >= 4 * 100), 8 for the per-probe route."""
    j, _ = _integer_pair(random_data)
    q = np.random.RandomState(2).randint(0, 17, (64, NROWS)) \
        .astype(np.float32)
    return j, q


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_tile_height():
    assert [tile_height(pb) for pb in PBS] == [8, 8, 24, 64, 64, 64, 64]
    with pytest.raises(ValueError):
        tile_height(0)


@pytest.mark.parametrize("pb", PBS)
def test_scan_pb_equals_jax(integer_index, tmp_path, monkeypatch, pb):
    j0, q = integer_index
    j = JaxIndex(dataclasses.replace(j0.config, scan_pb=pb), j0.coarse,
                 j0.quantizer, j0.store, j0.data_dtype, j0.dim)
    path = str(tmp_path / "jax.npz")
    jax_save(path, j)
    t = IVFADCIndex.load(path, device="cpu")
    assert t.config.scan_pb == pb
    assert len(q) * W >= 4 * t.config.kc > 8 * W
    grouped = j.search_padded(q, 10, w=W)
    _assert_same(t.search_padded(q, 10, w=W), grouped)
    _assert_same(t.search_padded(q[:8], 10, w=W),
                 j.search_padded(q[:8], 10, w=W))
    # two shards: each one's batch still takes the grouped route
    view = ShardedIVFADCIndex(
        t, make_mesh(n_shards=2, devices=[torch.device("cpu")] * 2))
    _assert_same(view.search_padded(q, 10, w=W), grouped)
    monkeypatch.setenv("IVFADC_VBASE", "qc")
    assert t._qc_ok(len(q), W, t.store.device_view_dense(
        t.quantizer, t.config.scan_chunk), "fold", False)
    _assert_same(t.search_padded(q, 10, w=W), j.search_padded(q, 10, w=W))
    monkeypatch.delenv("IVFADC_VBASE")
    # the port's save keeps the configured pb
    out = str(tmp_path / "port.npz")
    t.save(out)
    with np.load(out) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
    assert meta["config"]["scan_pb"] == pb
    assert IVFADCIndex.load(out, device="cpu").config == t.config
