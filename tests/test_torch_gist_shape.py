"""The port at GIST1M's shape (d = 960, PQ m = 16: 60-dimension subspaces,
the int8 cache padded to 1,024 lanes) against the benchmark's plain
reference (`annbench/reference/`), on the CPU.

The index is built by the port; the reference works everything out again
from the port's trained tables (each point's cell and codes, the exact
probe, IVFADC.jl's estimator in float64), as the benchmark's comparison
does on the card. The dense route runs the kernels' plain versions here;
tests/test_torch_cuda.py holds the kernels to those at this shape.
"""

import dataclasses

import numpy as np
import pytest
import torch

from annbench import harness
from annbench.reference import compare
from annbench.reference import ivfadc as ref
from ivfadc_tpu_torch import IVFADCIndex
from ivfadc_tpu_torch.models.inverted import _row_norms
from ivfadc_tpu_torch.ops import coarse_scan
from ivfadc_tpu_torch.ops.dense_scan import grouped_rows
from ivfadc_tpu_torch.utils import profiling

# the suite runs several workers on a few cores: keep torch's pool small
torch.set_num_threads(2)

N, D, M, KC, B, K, W = 4000, 960, 16, 16, 64, 10, 4
D_PAD = 1024

# The probe: the port's cells equal the reference's exact top-w, and its
# coarse distances lie within COARSE_ERR of the float64 ones, over each
# query's w-th: float32 sums of 960 products read 3e-7-5e-7 here, the
# same from bf16 inputs 3.8e-4-4.8e-4 (four seeds), so a bf16 probe fails
# it (`test_gist_shape_tolerances_fail_one_step_below`) where its cells
# happen to agree.
COARSE_ERR = 1e-5
# dist_err (compare.answer_numbers: a returned distance against the
# reference's float64 estimator of that id, over the k-th best) of the
# dense route: it scores from the int8 cache (each entry within half of
# its column's step, max |codeword| / 127) with bf16 query residuals
# (2^-9 relative), and the coarse term in float32; both seeds below read
# 0.0033-0.0035 here. The same route over an int4 cache (7 levels a
# column) reads 0.075-0.078.
DENSE_DIST_ERR = 0.01
# the LUT route scores float32 tables of the exact codewords: its readings
# are 1e-5-3e-5 (float32 sums of 16 table entries and the coarse term)
LUT_DIST_ERR = 1e-4
# miss_share (returned ids scored beyond the reference's k-th best): the
# dense route's rounding reorders near-ties at the k-th place, 0.056-0.059
# of the ids here; over an int4 cache 0.42-0.44
DENSE_MISS_SHARE = 0.15


def _data(seed: int):
    g = torch.Generator().manual_seed(seed)
    centers = torch.randn(64, D, generator=g)
    x = centers[torch.randint(0, 64, (N,), generator=g)] \
        + 0.15 * torch.randn(N, D, generator=g)
    q = x[torch.randint(0, N, (B,), generator=g)] \
        + 0.05 * torch.randn(B, D, generator=g)
    return x, q


@pytest.fixture(scope="module", params=[0, 1])
def gist(request):
    """(index, base points, queries, the reference's own build and lists
    from the index's trained tables)."""
    x, q = _data(request.param)
    idx = IVFADCIndex.build(x, device="cpu", kc=KC, m=M, k=256,
                            coarse_quantizer="naive", seed=3,
                            scan_mode="dense", coarse_maxiter=10,
                            quantization_maxiter=10)
    trained = harness.trained_of(idx)
    own = ref.build(x, trained, ref.EXACT)
    return idx, x, q, trained, own, ref.Lists(own, KC)


def _numbers(idx, q, trained, own, lists, ids=None, dists=None):
    if ids is None:
        ids, dists = idx.search_padded(q, K, W)
    given, _ = harness.stored_of(idx, N, "cpu")
    return compare.answer_numbers(q, np.asarray(ids, np.int64),
                                  np.asarray(dists, np.float64), trained,
                                  given, own, lists, K, W)


def _coarse_err(cdists, q, trained):
    """Widest gap of coarse distances (B, W) from the exact float64 ones
    of the same cells, over each query's w-th."""
    _, want = ref.probe(q, trained, W, ref.EXACT)
    return float(((cdists.double() - want).abs() / want[:, -1:]).max())


def _view(idx):
    return idx.store.device_view_dense(idx.quantizer, idx.config.scan_chunk)


def test_gist_shape_store_and_cache_layout(gist):
    idx, x, _, trained, own, _ = gist
    assert idx.quantizer.codebooks.shape == (M, 256, D // M)      # dsub 60
    given, held = harness.stored_of(idx, N, "cpu")
    assert compare.lost_rows(given, held, N) == 0
    # the build is the reference's from the same tables: nearest centroid,
    # nearest codewords, point by point
    assert compare.build_numbers(x, trained, given, own) == dict(
        assign_gap=0.0, code_gap=0.0)
    view = _view(idx)
    assert view["decoded"].shape[1] == D_PAD
    assert view["decoded"].dtype == torch.int8
    assert (view["decoded"][:, D:] == 0).all()
    assert torch.equal(view["scale"][D:], torch.ones(D_PAD - D))


@pytest.mark.parametrize("route", ["dense", "lut"])
def test_gist_shape_answers_match_the_reference(gist, route):
    idx, _, q, trained, own, lists = gist
    cfg = idx.config
    idx.config = dataclasses.replace(cfg, scan_mode=route)
    try:
        if route == "dense":         # kernel 1's plain version, as searched
            cells, cdists = coarse_scan.coarse_probe_vbase(
                q, idx.coarse.centroids, W, idx.quantizer.rotation, False,
                True)[:2]
        else:
            cells, cdists = idx.coarse.search(q, W)
        want, _ = ref.probe(q, trained, W, ref.EXACT)
        assert torch.equal(cells.to(torch.int64), want)
        assert _coarse_err(cdists, q, trained) <= COARSE_ERR
        got = _numbers(idx, q, trained, own, lists)
    finally:
        idx.config = cfg
    assert got["bad_answers"] == 0 and got["probe_gap"] == 0
    if route == "dense":
        assert got["dist_err"] <= DENSE_DIST_ERR, got
        assert got["miss_share"] <= DENSE_MISS_SHARE, got
    else:
        assert got["dist_err"] <= LUT_DIST_ERR, got
        assert got["miss_share"] == 0, got


def test_gist_shape_tolerances_fail_one_step_below(gist):
    """The limits above fail the dense route one step below its stated
    precisions: its cache requantized to int4 levels, and the coarse
    distances from bf16 inputs (the reference's control probe)."""
    idx, _, q, trained, own, lists = gist
    view = _view(idx)
    keep = {key: view[key] for key in ("decoded", "scale", "norms2d")}
    step = 127 / 7
    try:
        view["decoded"] = torch.round(keep["decoded"].float() / step).to(
            torch.int8)
        view["scale"] = keep["scale"] * step
        view["norms2d"] = _row_norms(view["decoded"], view["scale"]) \
            .reshape(keep["norms2d"].shape)
        int4 = _numbers(idx, q, trained, own, lists)
    finally:
        view.update(keep)
    assert int4["dist_err"] > 3 * DENSE_DIST_ERR, int4
    assert int4["miss_share"] > DENSE_MISS_SHARE, int4
    _, low = ref.probe(q, trained, W, ref.CONTROL)
    assert _coarse_err(low, q, trained) > 10 * COARSE_ERR


def test_gist_shape_pad_lanes_never_score(gist):
    """The cache's 64 pad lanes (960 -> 1,024) enter no score: holding
    garbage there, the dense route returns the same ids and distances bit
    for bit (the query residuals are zero-padded; the cached row norms
    were taken when the lanes held zeros)."""
    idx, _, q, _, _, _ = gist
    want = idx.search_padded(q, K, W)
    view = _view(idx)
    keep = view["decoded"]
    noisy = keep.clone()
    g = torch.Generator().manual_seed(5)
    noisy[:, D:] = torch.randint(-127, 128, (noisy.shape[0], D_PAD - D),
                                 generator=g, dtype=torch.int8)
    try:
        view["decoded"] = noisy
        got = idx.search_padded(q, K, W)
    finally:
        view["decoded"] = keep
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_gist_shape_counters_read_their_formulas(gist):
    """`counting()` on the CPU dense route at this shape: the streamed
    cache bytes are the grouped scan's rows times 1,024 int8 lanes; the
    three launch counts read 0, since the plain versions launch nothing."""
    idx, _, q, _, _, _ = gist
    with profiling.counting() as counts:
        idx.search_padded(q, K, W)
    cells = coarse_scan.coarse_probe_vbase(
        q, idx.coarse.centroids, W, idx.quantizer.rotation, False, True)[0]
    sizes = _view(idx)["sizes"]
    rows = int(grouped_rows(cells, sizes, kc=KC, pb=idx.config.scan_pb))
    assert B * W >= 4 * KC                     # the grouped route
    assert counts["scan_cache_bytes"] == rows * D_PAD
    assert counts["probe_narrow_launches"] == 0
    assert counts["scan_single_tile_launches"] == 0
    assert counts["probe_wide_select_launches"] == 0
