"""The grouped scan's slot map: each live slot's row lands at its probe's
index (probe order), and the result equals the tile-order output gathered
by each probe's slot, for every variant and both caches, through the
counting and the sort-based tile prep. The plain versions run here; the
card holds the kernels to the same contract (`test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

from ivfadc_tpu_torch.ops import dense_scan as t_scan

KC, B, W, D, PB, NF, K_OUT = 48, 24, 4, 64, 16, 128, 10

_VARIANTS = {"ids": dict(ids=True, norms=True),
             "knorm": dict(ids=True),
             "pos8": dict(pos8=True),
             "pos": {},
             "exact": dict(merge="exact", k_out=K_OUT),
             "extract": dict(ids=True, extract_k=K_OUT),
             "qc": dict(ids=True)}


def _case(seed: int, elem: str):
    """An index-like layout of KC 128-row aligned cells, sizes 0-300 with
    empty cells among the probed ones, and B x W probes over a few hot
    cells and random ones."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(0, 300, KC).astype(np.int32)
    sizes[[3, 17]] = 0
    caps = np.maximum(1, -(-sizes // 128)) * 128
    offsets = np.concatenate([[0], np.cumsum(caps[:-1])]).astype(np.int32)
    rows = int(caps.sum()) + 128
    cells = np.where(rng.rand(B, W) < 0.4, rng.randint(0, 4, (B, W)),
                     rng.randint(0, KC, (B, W))).astype(np.int32)
    cells[0, 0] = cells[5, 2] = 3             # a probed empty cell
    dec = torch.from_numpy(rng.randint(-127, 128, (rows, D)).astype(np.int8))
    scale = torch.from_numpy((0.01 + 0.02 * rng.rand(D)).astype(np.float32))
    if elem == "bf16":
        dec = (dec.float() * scale.to(torch.bfloat16).float()) \
            .to(torch.bfloat16)
        scale = None
    return dict(
        cells=torch.from_numpy(cells), offsets=torch.from_numpy(offsets),
        sizes=torch.from_numpy(sizes), dec=dec, scale=scale,
        ids2d=torch.from_numpy(rng.permutation(rows).astype(np.int32)
                               .reshape(-1, 128)),
        norms2d=torch.from_numpy((5 + rng.rand(rows)).astype(np.float32)
                                 .reshape(-1, 128)),
        v=torch.from_numpy(rng.randn(B, W, D).astype(np.float32))
        .to(torch.bfloat16),
        base=torch.from_numpy((10 + rng.rand(B, W)).astype(np.float32)),
        q=torch.from_numpy(rng.randn(B, D).astype(np.float32)),
        cents=torch.from_numpy(rng.randn(KC, D).astype(np.float32)))


def _scan_call(c, variant: str):
    """(scan function, its tile arguments, options, slot map) of one
    variant over case `c`."""
    opts = dict(_VARIANTS[variant])
    ids = c["ids2d"] if opts.pop("ids", False) else None
    norms = c["norms2d"] if opts.pop("norms", False) else None
    if variant == "qc":
        prep = t_scan.qc_tile_inputs(c["cells"], c["offsets"], c["sizes"],
                                     c["q"], c["cents"], None, D, kc=KC,
                                     pb=PB)
        args = prep[:7] + (c["dec"], c["scale"], ids)
        kw = dict(pb=PB, nf=NF, norm_coef=1.0, base_mult=2.0,
                  apply_rot=False)
        return t_scan.grouped_scan_qc, args, kw, prep[7]
    *tiles, inv_row = t_scan.place_tiles(c["cells"], c["offsets"],
                                         c["sizes"], c["v"], c["base"],
                                         kc=KC, pb=PB)
    args = tuple(tiles) + (c["dec"], c["scale"], ids, norms)
    return t_scan.grouped_scan, args, dict(pb=PB, nf=NF, norm_coef=1.0,
                                           **opts), inv_row


@pytest.mark.parametrize("prep", ["count", "sort"])
@pytest.mark.parametrize("elem", ["int8", "bf16"])
@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_probe_order_equals_the_tile_order_rows_gathered(variant, elem, prep,
                                                         monkeypatch):
    if prep == "sort":
        monkeypatch.setattr(t_scan, "MAX_KC", 0)    # every kc: the sort
    c = _case(len(variant) + 7 * (elem == "bf16"), elem)
    scan, args, kw, inv_row = _scan_call(c, variant)
    P = B * W
    T = args[0].shape[0]
    slots = inv_row.reshape(T, PB)
    live = slots < P
    # the edges: an empty cell's tile with live slots, and tiles past the
    # last one the batch needs, which hold no live slot
    assert ((args[1] == 0) & live.any(1)).any()
    assert (~live).all(1).any()
    # every probe owns exactly one live slot
    assert torch.equal(torch.sort(inv_row[inv_row < P]).values,
                       torch.arange(P))
    _, _, _, row, _ = t_scan._tile_slots(c["cells"], c["offsets"],
                                         c["sizes"], kc=KC, pb=PB,
                                         rank_engine=None)
    tiled = scan(*args, **t_scan.tile_order(T, PB, "cpu"), **kw)
    placed = scan(*args, slot_row=inv_row, n_rows=P, **kw)
    width = K_OUT if variant == "extract" else NF
    assert placed[1].dtype == (torch.int8 if variant == "pos8"
                               else torch.int32)
    for got, want in zip(placed, tiled):
        assert want.shape == (T * PB, width) and got.shape == (P, width)
        assert torch.equal(got, want[row])
    empty = (c["cells"] == 3).reshape(-1)
    assert torch.isinf(placed[0][empty]).all()
    assert (placed[1][empty] == -1).all()


@pytest.mark.parametrize("route,prep", [("placed", "count"),
                                        ("placed", "sort"), ("qc", "count")])
def test_grouped_dense_scan_returns_the_gathered_rows(route, prep,
                                                      monkeypatch):
    # the wrappers return the kernels' probe-order rows as they are: what
    # the tile-order rows read through the prep's `row` (each probe's
    # slot); the qc route takes the counting prep only
    if prep == "sort":
        monkeypatch.setattr(t_scan, "MAX_KC", 0)
    c = _case(3, "int8")
    scan, args, kw, _ = _scan_call(c, "qc" if route == "qc" else "ids")
    _, _, _, row, _ = t_scan._tile_slots(c["cells"], c["offsets"],
                                         c["sizes"], kc=KC, pb=PB,
                                         rank_engine=None)
    tiled = scan(*args, **t_scan.tile_order(args[0].shape[0], PB, "cpu"),
                 **kw)
    if route == "qc":
        got = t_scan.grouped_dense_scan_qc(
            c["cells"], c["offsets"], c["sizes"], c["q"], c["cents"], None,
            c["dec"], c["scale"], c["ids2d"], kc=KC, chunk=256, pb=PB,
            nf=NF)
    else:
        got = t_scan.grouped_dense_scan(
            c["cells"], c["offsets"], c["sizes"], c["v"], c["base"],
            c["dec"], c["scale"], c["ids2d"], c["norms2d"], kc=KC,
            k_out=K_OUT, chunk=256, pb=PB, nf=NF)
    for a, b in zip(got, tiled):
        assert torch.equal(a, b[row].reshape(B, W, NF))


def test_grouped_scan_checks_its_slot_map():
    c = _case(5, "int8")
    scan, args, kw, inv_row = _scan_call(c, "ids")
    with pytest.raises(ValueError, match="slot map"):
        scan(*args, slot_row=inv_row[:-1], n_rows=B * W, **kw)
    with pytest.raises(ValueError, match="slot map"):
        scan(*args, slot_row=inv_row, n_rows=-1, **kw)
