"""Every search route of the port on the card, at the shapes users run.

The launch table (`test_route_launches`) drives each route once with the
kernels' launch counters read before and after: the kernels a route must
launch (how many times, where a search's count is fixed), and those it
must leave idle. Each case then holds the route's
results to the same route on the CPU (the kernels' plain versions), to the
card's default route or to the NumPy oracle of the reference algorithm
(`benchmarks/oracle.py`). The other tests hold each kernel against its
plain version on the SIFT1M and two-level paths' own inputs at their
shapes, and what has no route of its own: recall parity with the oracle,
save and load, `autotune` and `memory_stats`, the two-level index's
arrays and mutations, and two ranks of one process group on one card.

The routes run on five indexes, each built once a module:
  sift       SIFT1M's shape (n = 1M, d = 128, kc = 1024, m = 8, k = 256)
  inner      200,000 of its points scored by inner product (kc = 256): the
             unfused probe
  opq        200,000 of its points under OPQ (kc = 1024, m = 8)
  sift8k     SIFT1M's points under the fine coarse quantizer of the
             `sift1m.ivf8192` cell (kc = 8192, m = 16), searched at its w =
             64 and k = 100: past MAX_KC = 4096 the grouped scan's tiles
             come from the sort-based prep
  two_level  the large-kc configuration (coarse_quantizer="hnsw", d = 96,
             m = 16) at kc = 2^15 over 262,144 points (8 a cell): the
             smallest power of two that takes the kernels of kc = 2^18:
             past kc = 16,384 cells are 8 rows (no id or norm stream: stage
             2 and the posting scan square rows in the kernel, and a grouped
             batch writes pos8 block payloads), past MAX_KC = 4096 the
             posting scan's tiles come from the sort-based prep, and the
             two-level stage 2 scans groups through the grouped kernel

Every test needs an NVIDIA GPU (Hopper: the kernels are built for sm_90a)
and skips without one. This file imports no JAX, so it also runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_cuda*.py -q --noconftest -o addopts=""
"""

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from ivfadc_tpu_torch.ops import cell_rank, coarse_scan, dense_scan, topk

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)

N, D, KC, M, KQ = 1_000_000, 128, 1024, 8, 256
TOPK, W, BATCH = 10, 8, 16384
BATCH_QC = 8192                     # the qc gate admits it at d = 128
N_SEARCH, N_ORACLE = 1000, 500
N_PUSH = 262_144                    # the mutated index's push_batch
B_SMALL = 256                       # B * w < 4 * kc: the per-probe scan
N2, KC2 = 200_000, 256              # the inner-product and OPQ indexes
N3, D3, KC3, M3, W3 = 262_144, 96, 1 << 15, 16, 32
NQ3 = 1024                          # B * w < 4 * kc: the per-probe scan
NQ3_BIG = 4096                      # B * w = 4 * kc: the grouped scan
KC8, M8, W8, K8 = 8192, 16, 64, 100  # the sift1m.ivf8192 cell's index
ROUTE_TIMEOUT_S = 600                # a route that hangs the card fails

# the launch counters by the kernel's name, one entry point each
KERNELS = {
    "coarse_probe": coarse_scan.KERNEL,
    "coarse_topw": coarse_scan.TOPW_KERNEL,
    "coarse_probe_v2": coarse_scan.V2_KERNEL,
    "cell_rank": cell_rank.KERNEL,
    "cell_rank_v2": cell_rank.KERNEL_V2,
    "grouped_scan": dense_scan.KERNEL,
    "grouped_scan_knorm": dense_scan.NORMS_KERNEL,
    "grouped_scan_pos8": dense_scan.GROUPED_KERNELS["pos8", "int8"],
    "grouped_scan_bf16": dense_scan.GROUPED_KERNELS["ids", "bf16"],
    "grouped_scan_knorm_bf16": dense_scan.GROUPED_KERNELS["knorm", "bf16"],
    "grouped_scan_exact": dense_scan.GROUPED_KERNELS["exact", "int8"],
    "grouped_scan_extract": dense_scan.GROUPED_KERNELS["extract", "int8"],
    "grouped_scan_qc": dense_scan.QC_KERNELS["int8"],
    "grouped_scan_qc_bf16": dense_scan.QC_KERNELS["bf16"],
    "probe_scan": dense_scan.PROBE_KERNEL,
    "probe_scan_bf16": dense_scan.PROBE_KERNELS["fold", "bf16"],
    "probe_scan_exact": dense_scan.PROBE_KERNELS["exact", "int8"],
    "topk_payload": topk.KERNEL,
    "topk_index": topk.INDEX_KERNEL,
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# ------------------------------------------------------------------ helpers
def _launches() -> dict:
    return {name: kern.launches for name, kern in KERNELS.items()}


@contextlib.contextmanager
def _env(**values):
    with pytest.MonkeyPatch.context() as mp:
        for key, val in values.items():
            mp.setenv(key, val)
        yield


@contextlib.contextmanager
def _norms_off(index):
    """IVFADC_NORMS=off for the block. The variable is read when the dense
    view is built (as in the JAX package), so the view is dropped before
    and after."""
    index.store._invalidate()
    try:
        with _env(IVFADC_NORMS="off"):
            yield
    finally:
        index.store._invalidate()


def _variant(index, **changes):
    """The index under another configuration, over the same components."""
    from ivfadc_tpu_torch import IVFADCIndex
    return IVFADCIndex(dataclasses.replace(index.config, **changes),
                       index.coarse, index.quantizer, index.store,
                       index.data_dtype, index.dim)


def _sane(ids, dists, rows: int, n: int):
    assert ids.shape == dists.shape == (rows, ids.shape[1])
    assert np.isfinite(dists).all() and (ids >= 0).all() and (ids < n).all()
    assert (np.diff(dists, axis=1) >= 0).all()


def _batches(index, q, b: int, k: int = TOPK, w: int = W):
    """q searched in batches of b rows, stacked."""
    return tuple(map(np.concatenate, zip(*[
        index.search_padded(q[s:s + b], k, w=w)
        for s in range(0, q.shape[0], b)])))


def _overlap(a, b) -> float:
    return float(np.mean([len(set(x) & set(y)) / a.shape[1]
                          for x, y in zip(a, b)]))


def _tie_overlap(ids_a, d_a, ids_b, d_b) -> float:
    """Top-k overlap of result a with result b that also counts an id of a
    whose distance ties b's k-th distance (to 1e-4 relative): points with
    one PQ code in one cell score alike, and two routes may keep different
    ones of them at the k-th place."""
    hits = []
    for ia, da, ib, db in zip(ids_a, d_a, ids_b, d_b):
        tied = np.abs(da - db[-1]) <= 1e-4 * abs(db[-1])
        hits.append((np.isin(ia, ib) | tied).mean())
    return float(np.mean(hits))


def _ties_only(ids_a, d_a, ids_b, d_b):
    """Bit-equal distances, and ids that differ only among exactly tied
    distances: every distance below a row's last holds the same set of ids
    in both."""
    np.testing.assert_array_equal(d_a, d_b)
    for ia, da, ib in zip(ids_a, d_a, ids_b):
        for val in np.unique(da[da < da[-1]]):
            assert set(ia[da == val]) == set(ib[da == val]), val


def _close_scan(kern, plain, min_agree: float = 0.999, rtol: float = 1e-5):
    """A scan kernel's (scores, payloads) against its plain version's on
    real data: the same +inf pattern, scores to `rtol` relative (bf16
    products summed in f32 in another order; scores ~1e2), payloads equal
    on >= min_agree."""
    (kd, kp), (pd, pp) = kern, plain
    fin = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(kd), fin)
    torch.testing.assert_close(kd[fin], pd[fin], rtol=rtol, atol=1e-3)
    assert (kp == pp).float().mean().item() >= min_agree


def _oracle(index):
    from benchmarks.oracle import ReferenceOracle
    return ReferenceOracle(
        index.coarse.centroids.cpu().numpy(),
        index.quantizer.codebooks.cpu().numpy(),
        *zip(*[index.store.cell_entries(c) for c in range(index.config.kc)]))


def _oracle_search(index, q):
    """The oracle's top-10 of q on the index's own arrays, padded with -1 /
    +inf -> (ids, dists)."""
    o_ids, o_dists = _oracle(index).search_batch(q.cpu().numpy(), TOPK, W)
    ids = np.full((len(o_ids), TOPK), -1, np.int64)
    dists = np.full((len(o_ids), TOPK), np.inf, np.float32)
    for i, (row_i, row_d) in enumerate(zip(o_ids, o_dists)):
        ids[i, :len(row_i)] = row_i
        dists[i, :len(row_d)] = row_d
    return ids, dists


def _recall(ids, gt) -> float:
    from ivfadc_tpu_torch.utils.evaluation import recall_at_r
    return recall_at_r(ids, gt, TOPK)


def _ref(s, name: str):
    """A result that other routes are held to, computed once a module."""
    if name not in s.refs:
        s.refs[name] = s.ref_fns[name](s)
    return s.refs[name]


# ----------------------------------------------------------------- indexes
def _on_cpu(index):
    """The card's index saved, then loaded on the CPU, whose dense route
    runs the kernels' plain versions ("auto" is the LUT engine there)."""
    import tempfile
    from ivfadc_tpu_torch import IVFADCIndex
    with tempfile.TemporaryDirectory() as tmp:
        index.save(os.path.join(tmp, "index.npz"))
        on_cpu = IVFADCIndex.load(os.path.join(tmp, "index.npz"),
                                  device="cpu")
    on_cpu.config = dataclasses.replace(on_cpu.config, scan_mode="dense")
    return on_cpu


def _sift_refs():
    def norms_off(s):
        with _norms_off(s.index):
            return s.index.search_padded(s.qs, TOPK, w=W)

    def fold1024(s):
        # a 1024-lane fold loses almost no neighbour to lane collisions
        wide = _variant(s.index, scan_fold_lanes=1024, scan_pb=16)
        with _norms_off(s.index):
            grouped = wide.search_padded(s.qs, TOPK, w=W)
        return grouped, _batches(wide, s.qs, B_SMALL)

    def cpu(s):
        return _on_cpu(s.index).search_padded(s.qs.cpu(), TOPK, w=W)

    return dict(
        grouped=lambda s: s.index.search_padded(s.qs, TOPK, w=W),
        small=lambda s: _batches(s.index, s.qs, B_SMALL),
        norms_off=norms_off, fold1024=fold1024, cpu=cpu,
        b8192=lambda s: s.index.search_padded(s.queries[:BATCH_QC], TOPK,
                                              w=W),
        b16384=lambda s: s.index.search_padded(s.queries[:BATCH], TOPK, w=W))


@pytest.fixture(scope="module")
def sift(dev):
    """The SIFT1M-shape index on the card, 4 x 16,384 queries near its
    points, the first 1,000 (`qs`) with their exact top-10 and the oracle's
    top-10 of the first 500."""
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    from ivfadc_tpu_torch.utils.evaluation import brute_force_topk
    base = torch.as_tensor(synthetic_clustered(N, D, seed=0), device=dev)
    index = IVFADCIndex.build(base, kc=KC, k=KQ, m=M, seed=0,
                              kmeanspp_sample=65536, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    qidx = torch.randint(0, N, (4 * BATCH,), generator=g, device=dev)
    queries = base[qidx] + 0.05 * torch.randn((4 * BATCH, D), generator=g,
                                              device=dev)
    qs = queries[:N_SEARCH]
    _, gt = brute_force_topk(base, qs, TOPK)
    o_ids, o_dists = _oracle_search(index, qs[:N_ORACLE])
    return types.SimpleNamespace(
        index=index, base=base, queries=queries, qs=qs, gt=gt, o_ids=o_ids,
        o_dists=o_dists, recall_oracle=_recall(o_ids, gt[:N_ORACLE]),
        refs={}, ref_fns=_sift_refs())


@pytest.fixture(scope="module")
def inner(sift):
    """An index over the first 200,000 SIFT1M-shape points scored by inner
    product, with 4,096 queries and their exact inner-product top-10."""
    from ivfadc_tpu_torch import IVFADCIndex
    index = IVFADCIndex.build(sift.base[:N2], kc=KC2, k=KQ, m=M, seed=0,
                              kmeanspp_sample=65536,
                              quantization_metric="inner_product",
                              device=sift.base.device)
    q = sift.queries[:4096]
    gt = torch.topk(q @ sift.base[:N2].T, TOPK, dim=1)[1].cpu().numpy()
    return types.SimpleNamespace(
        index=index, q=q, gt=gt, refs={}, ref_fns=dict(
            lut=lambda s: _variant(s.index, scan_mode="lut").search_padded(
                s.q, TOPK, w=W)))


@pytest.fixture(scope="module")
def opq(sift):
    """An OPQ index over the first 200,000 SIFT1M-shape points and 4,096
    queries near them."""
    from ivfadc_tpu_torch import IVFADCIndex
    dev = sift.base.device
    data = sift.base[:N2]
    index = IVFADCIndex.build(data, kc=KC, k=KQ, m=M, seed=0,
                              kmeanspp_sample=65536,
                              quantization_method="opq", device=dev)
    g = torch.Generator(device=dev).manual_seed(14)
    q = data[torch.randint(0, N2, (4096,), generator=g, device=dev)] \
        + 0.05 * torch.randn((4096, D), generator=g, device=dev)
    return types.SimpleNamespace(index=index, q=q)


@pytest.fixture(scope="module")
def two_level(dev):
    """The large-kc two-level index, 1,024 queries near its points (`q`,
    with their exact top-10) and 4,096 (`q_big`, q first)."""
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.models.coarse import NaiveCoarseQuantizer
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    from ivfadc_tpu_torch.utils.evaluation import brute_force_topk
    base = torch.as_tensor(synthetic_clustered(N3, D3, seed=0), device=dev)
    index = IVFADCIndex.build(base, kc=KC3, k=KQ, m=M3, seed=0,
                              coarse_quantizer="hnsw",
                              kmeanspp_sample=65536, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    qidx = torch.randint(0, N3, (NQ3_BIG,), generator=g, device=dev)
    q_big = base[qidx] + 0.05 * torch.randn((NQ3_BIG, D3), generator=g,
                                            device=dev)
    q = q_big[:NQ3]
    _, gt = brute_force_topk(base, q, TOPK)
    naive = IVFADCIndex(
        dataclasses.replace(index.config, coarse_quantizer="naive"),
        NaiveCoarseQuantizer(index.coarse.centroids, index.coarse.metric),
        index.quantizer, index.store, index.data_dtype, index.dim)
    return types.SimpleNamespace(
        index=index, base=base, q=q, q_big=q_big, gt=gt, naive=naive,
        refs={}, ref_fns=dict(
            default=lambda s: s.index.search_padded(s.q, TOPK, w=W3),
            cells=lambda s: s.index.coarse.search(s.q, W3)))


@pytest.fixture(scope="module")
def sift8k(dev):
    """SIFT1M's shape under the `sift1m.ivf8192` cell's index (kc = 8192,
    m = 16) and 1,000 queries near its points."""
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    base = torch.as_tensor(synthetic_clustered(N, D, seed=0), device=dev)
    index = IVFADCIndex.build(base, kc=KC8, k=KQ, m=M8, seed=0,
                              kmeanspp_sample=65536, device=dev)
    g = torch.Generator(device=dev).manual_seed(8)
    q = base[torch.randint(0, N, (N_SEARCH,), generator=g, device=dev)] \
        + 0.05 * torch.randn((N_SEARCH, D), generator=g, device=dev)
    return types.SimpleNamespace(index=index, q=q)


# --------------------------------------------------------- the launch table
@contextlib.contextmanager
def _counted():
    """The kernels' launch counts of the block, filled in as it ends, its
    grouped-scan launches that wrote probe-order rows, its sort-based tile
    preps and its coarse launches on the large-w selection
    (`profiling.counting()`'s `scan_probe_order_launches`,
    `tileprep_sort_launches`, `probe_wide_select_launches`)."""
    from ivfadc_tpu_torch.utils import profiling
    before, counts = _launches(), {}
    with profiling.counting() as plans:
        yield counts
    counts.update({k: n - before[k] for k, n in _launches().items()})
    for name in ("scan_probe_order_launches", "tileprep_sort_launches",
                 "probe_wide_select_launches"):
        counts[name] = plans[name]


def _within(seconds: float, fn):
    """fn() on a worker thread; a search that has not returned within
    `seconds` fails its test instead of holding the suite."""
    import concurrent.futures
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return pool.submit(fn).result(timeout=seconds)
    finally:
        pool.shutdown(wait=False)


# Each route runs its search under `_counted()`, checks its results and
# returns the counts.
def _grouped(s):
    with _counted() as counts:
        ids, dists = s.index.search_padded(s.qs, TOPK, w=W)
    _sane(ids, dists, N_SEARCH, N)
    # against the same index loaded on the CPU: f32 sums in another order
    # may swap near-ties
    c_ids, c_dists = _ref(s, "cpu")
    same = ids == c_ids
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(dists[same], c_dists[same], rtol=1e-5,
                               atol=1e-3)
    return counts


def _small_batch(s):
    idx, qs = s.index, s.qs
    with _counted() as counts:                  # 8 searches
        one_i, one_d = idx.search(qs[0], TOPK, w=W)
        small = {b: idx.search_padded(qs[:b], TOPK, w=W)
                 for b in (8, 64, B_SMALL)}
        s_ids, s_dists = _batches(idx, qs, B_SMALL)
    assert one_i.dtype == np.dtype(idx.config.index_dtype)
    assert one_i.shape == one_d.shape == (TOPK,)
    assert (np.diff(one_d) >= 0).all()
    np.testing.assert_array_equal(
        one_i, idx.search(qs[0].cpu().numpy(), TOPK, w=W)[0])
    for b, (bi, bd) in small.items():
        _sane(bi, bd, b, N)
    np.testing.assert_array_equal(one_i, small[8][0][0])
    ids = _ref(s, "grouped")[0]
    assert abs(_recall(s_ids, s.gt) - _recall(ids, s.gt)) <= 0.01
    assert _overlap(s_ids, ids) >= 0.95
    return counts


def _norms_off_route(s):
    with _counted() as counts, _norms_off(s.index):
        got = s.index.search_padded(s.qs, TOPK, w=W)
    s.refs["norms_off"] = got
    ids = _ref(s, "grouped")[0]
    # bf16-rounded squares against the cached f32 norms: near-ties may swap
    assert _overlap(got[0], ids) >= 0.99
    assert abs(_recall(got[0], s.gt) - _recall(ids, s.gt)) <= 0.01
    return counts


def _near_oracle(s, ids):
    r = _recall(ids[:N_ORACLE], s.gt[:N_ORACLE])
    assert abs(r - s.recall_oracle) <= 0.01, (r, s.recall_oracle)


def _bf16(s):
    bidx = _variant(s.index, scan_cache="bf16")
    with _counted() as counts:
        b_ids = bidx.search_padded(s.qs, TOPK, w=W)[0]
        b_small = _batches(bidx, s.qs, B_SMALL)[0]
        with _norms_off(s.index):
            bidx.search_padded(s.qs, TOPK, w=W)
    for got, ref in ((b_ids, "grouped"), (b_small, "small")):
        _near_oracle(s, got)
        assert _overlap(got, _ref(s, ref)[0]) >= 0.9
    return counts


def _exact(s):
    eidx = _variant(s.index, scan_merge="exact")
    with _counted() as counts:
        with _norms_off(s.index):          # the fold route it is held to
            e_ids, e_dists = eidx.search_padded(s.qs, TOPK, w=W)
        e_small, e_sd = _batches(eidx, s.qs, B_SMALL)
    # the exact top-k can only be closer than the fold's of the same
    # arithmetic (in-kernel norms); the default 128-lane fold loses
    # neighbours that collide in a lane (cells of ~1000 rows: 8 rows a
    # lane), a 1024-lane fold almost none
    n_ids, n_dists = _ref(s, "norms_off")
    s_ids, s_dists = _ref(s, "small")
    assert (e_dists <= n_dists + 1e-4).all()
    assert (e_sd <= s_dists + 1e-4).all()
    wide, wide_small = _ref(s, "fold1024")
    for got, fold, fold1024 in (((e_ids, e_dists), (n_ids, n_dists), wide),
                                ((e_small, e_sd), (s_ids, s_dists),
                                 wide_small)):
        _near_oracle(s, got[0])
        assert _tie_overlap(*got, *fold1024) >= 0.99
        assert _tie_overlap(*got, *fold) >= 0.95
    return counts


def _extract(s):
    with _counted() as counts, _env(IVFADC_EXTRACT="1"):
        got = s.index.search_padded(s.qs, TOPK, w=W)
    # extraction scores with the row norms computed in the kernel: the
    # IVFADC_NORMS=off route's distances bit for bit
    _ties_only(*got, *_ref(s, "norms_off"))
    return counts


def _engine(name: str, bf16: bool = False, **env):
    """A B=8192 batch through the opt-in engines `env`: recall@10 within
    0.01 of the oracle's; rank v2 bit-equal to the default route (one
    function of the same cells), the others' top-10 overlap with it
    >= 0.99."""
    def route(s):
        idx = _variant(s.index, scan_cache="bf16") if bf16 else s.index
        with _counted() as counts, _env(**env):
            ids, dists = idx.search_padded(s.queries[:BATCH_QC], TOPK, w=W)
        _sane(ids, dists, BATCH_QC, N)
        want = _ref(s, "b8192")
        if name == "rank_v2":
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(dists, want[1])
            return counts
        _near_oracle(s, ids)
        if not bf16:
            assert _overlap(ids, want[0]) >= 0.99
        return counts
    return route


def _qc_gate_fails(s):
    # 16,384 queries are 8 MiB at d = 128, past the qc gate's 6 MiB: the
    # placement route with kernel 3
    with _counted() as counts, _env(IVFADC_VBASE="qc"):
        got = s.index.search_padded(s.queries[:BATCH], TOPK, w=W)
    want = _ref(s, "b16384")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    return counts


def _lut(s):
    lut = _variant(s.index, scan_mode="lut")
    with _counted() as counts:
        l_ids, l_dists = lut.search_padded(s.qs[:B_SMALL], TOPK, w=W)
        w_ids, w_dists = s.index.search_padded(s.qs[:64], 200, w=W)  # k > 128
    assert (np.diff(l_dists, axis=1) >= 0).all() and (l_ids >= 0).all()
    # both are the exact algorithm in f32, so the sorted distances agree;
    # the oracle (argpartition) and the port (lowest candidate first) may
    # keep different ids among EQUAL scores at the k-th place
    np.testing.assert_allclose(l_dists, s.o_dists[:B_SMALL], rtol=1e-4,
                               atol=1e-3)
    assert _tie_overlap(l_ids, l_dists, s.o_ids[:B_SMALL],
                        s.o_dists[:B_SMALL]) >= 0.99
    assert w_ids.shape == (64, 200) and (np.diff(w_dists, axis=1) >= 0).all()
    for row in w_ids:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    # the same batch at k = 10 (same shapes, so bit-equal scores): the
    # kernel's tie order and the stable sort's agree
    np.testing.assert_array_equal(
        w_ids[:, :TOPK], lut.search_padded(s.qs[:64], TOPK, w=W)[0])
    return counts


def _unfused(grouped: bool):
    """The inner-product index: the exact top-w probe (kernel 7), then the
    grouped scan with no norm term (4,096 queries) or the per-probe scan
    (16 batches of 16); recall@10 within 0.01 of the LUT route's on the
    same queries."""
    def route(s):
        with _counted() as counts:
            if grouped:
                ids, dists = s.index.search_padded(s.q, TOPK, w=W)
            else:
                ids, dists = _batches(s.index, s.q[:256], 16)
        _sane(ids, dists, ids.shape[0], N2)
        lut = _ref(s, "lut")[0][:ids.shape[0]]
        gt = s.gt[:ids.shape[0]]
        assert abs(_recall(ids, gt) - _recall(lut, gt)) <= 0.01
        return counts
    return route


def _opq_route(s):
    rot = s.index.quantizer.rotation.double()
    eye = torch.eye(D, dtype=torch.float64, device=rot.device)
    assert s.index.quantizer.method == "opq"
    assert float((rot @ rot.T - eye).abs().max()) <= 1e-4
    assert s.q.shape[0] * W >= 4 * KC
    with _counted() as counts:
        ids, dists = s.index.search_padded(s.q, TOPK, w=W)
    _sane(ids, dists, s.q.shape[0], N2)
    l_ids = _variant(s.index, scan_mode="lut").search_padded(s.q, TOPK,
                                                             w=W)[0]
    # C.11's bound for the default fold
    assert _overlap(ids, l_ids) >= 0.95
    return counts


def _sharded(n_data: int, grouped: bool):
    """A view of 4 shards (x n_data groups) of the SIFT1M index on one
    card: each data group probes once (its shards share the card), scans
    once a shard, and merges on kernel 6; the per-probe route ranks each
    shard on kernel 6 too. Distances bit-equal to the single card's."""
    def route(s):
        from ivfadc_tpu_torch import ShardedIVFADCIndex, make_mesh
        dev = s.base.device
        view = ShardedIVFADCIndex(s.index, make_mesh(
            n_shards=4, n_data=n_data, devices=[dev] * (4 * n_data)))
        q = s.queries[:BATCH] if grouped \
            else s.queries[BATCH:BATCH + B_SMALL]
        with _counted() as counts:
            got = view.search_padded(q, TOPK, w=W)
        _ties_only(*got, *s.index.search_padded(q, TOPK, w=W))
        return counts
    return route


def _sort_prep(s):
    """The `sift1m.ivf8192` cell's search, B*w = 64,000 >= 4*kc: the
    grouped scan's tiles from one sort past MAX_KC, kernel 1's top-64,
    kernel 4's top-100 over 64 x 128 candidates a row; held to the same
    index's CPU route."""
    assert s.index.config.kc > cell_rank.MAX_KC
    assert N_SEARCH * W8 >= 4 * KC8
    with _counted() as counts:
        ids, dists = _within(ROUTE_TIMEOUT_S, lambda: s.index.search_padded(
            s.q, K8, w=W8))
    _sane(ids, dists, N_SEARCH, N)
    # f32 sums in another order may swap near-ties, which 100 ranks a row
    # meet often: each rank's distance agrees, the ids up to ties at the
    # k-th
    c_ids, c_dists = _on_cpu(s.index).search_padded(s.q.cpu(), K8, w=W8)
    np.testing.assert_allclose(dists, c_dists, rtol=1e-5, atol=1e-3)
    assert _tie_overlap(ids, dists, c_ids, c_dists) >= 0.999
    # the key's second call captures the route, sort included, as a CUDA
    # graph and the third replays it: both give the eager call's results,
    # and each counts its sort and its probe on the large-w selection
    from ivfadc_tpu_torch.utils import profiling
    with profiling.counting() as graphed:
        again = [_within(ROUTE_TIMEOUT_S, lambda: s.index.search_padded(
            s.q, K8, w=W8)) for _ in range(2)]
    assert graphed["graph_captures"] == graphed["graph_replays"] == 1
    assert graphed["tileprep_sort_launches"] == 2
    assert graphed["probe_wide_select_launches"] == 2
    for got in again:
        np.testing.assert_array_equal(got[0], ids)
        np.testing.assert_array_equal(got[1], dists)
    return counts


def _two_level_route(s):
    with _counted() as counts:
        ids, dists = s.index.search_padded(s.q, TOPK, w=W3)
    s.refs["default"] = (ids, dists)
    _sane(ids, dists, NQ3, N3)
    lut = _variant(s.index, scan_mode="lut")
    assert _overlap(ids[:512], lut.search_padded(s.q[:512], TOPK,
                                                 w=W3)[0]) >= 0.95
    one_i, one_d = s.index.search(s.q[0], TOPK, w=W3)
    assert one_i.shape == one_d.shape == (TOPK,)
    assert (np.diff(one_d) >= 0).all()
    assert len(set(one_i.tolist()) & set(ids[0].tolist())) >= TOPK - 1
    return counts


def _two_level_naive(s):
    with _counted() as counts:
        ex_cells, _ = s.naive.coarse.search(s.q, W3)          # kernel 7
        n_ids, _ = s.naive.search_padded(s.q, TOPK, w=W3)     # kernel 1
    # the two-level probe finds most of the exact top-w cells, and loses
    # little recall to the naive probe over the same cells
    tl_cells = _ref(s, "cells")[0]
    hit = (tl_cells[:, :, None] == ex_cells[:, None, :]).any(dim=2)
    assert hit.float().mean().item() >= 0.8
    ids = _ref(s, "default")[0]
    assert _recall(ids, s.gt) >= _recall(n_ids, s.gt) - 0.02
    return counts


def _two_level_rank_v2(s):
    with _counted() as counts, _env(IVFADC_RANK_ENGINE="v2"):
        got = s.index.search_padded(s.q, TOPK, w=W3)
    want = _ref(s, "default")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    return counts


def _two_level_extract(s):
    with _counted() as counts, _env(IVFADC_EXTRACT="1"):
        got = s.index.search_padded(s.q, TOPK, w=W3)
    # stage 2's in-kernel extraction keeps the buffered route's cells but at
    # exact ties
    cells, dists = s.index.coarse.search(s.q, W3, extract=True)
    _ties_only(cells.cpu().numpy(), dists.cpu().numpy(),
               *(t.cpu().numpy() for t in _ref(s, "cells")))
    _ties_only(*got, *_ref(s, "default"))
    return counts


def _two_level_grouped(s):
    assert NQ3_BIG * W3 >= 4 * KC3 > NQ3 * W3
    with _counted() as counts:
        g_ids, g_dists = s.index.search_padded(s.q_big, TOPK, w=W3)
    _sane(g_ids, g_dists, NQ3_BIG, N3)
    p_ids, p_dists = _batches(s.index, s.q_big, NQ3, w=W3)
    assert _tie_overlap(g_ids, g_dists, p_ids, p_dists) >= 0.999
    same = g_ids == p_ids
    assert np.abs(g_dists - p_dists)[same].max() <= 1e-3
    assert abs(_recall(g_ids[:NQ3], s.gt)
               - _recall(_ref(s, "default")[0], s.gt)) <= 0.005
    return counts


def _two_level_sharded(s):
    from ivfadc_tpu_torch import ShardedIVFADCIndex, make_mesh
    dev = s.base.device
    view = ShardedIVFADCIndex(s.index, make_mesh(n_shards=2,
                                                 devices=[dev] * 2))
    with _counted() as counts:
        got = view.search_padded(s.q, TOPK, w=W3)
    _ties_only(*got, *_ref(s, "default"))
    return counts


def _each(count, names) -> dict:
    return dict.fromkeys(names, count)


_GROUPED = ["coarse_probe", "cell_rank", "grouped_scan", "topk_payload"]
_PER_PROBE = ["coarse_probe", "probe_scan", "topk_index"]
_TWO_LEVEL = ["topk_index", "cell_rank", "grouped_scan_knorm", "topk_payload",
              "probe_scan"]
_QC, _V2C, _V2R = (dict(IVFADC_VBASE="qc"), dict(IVFADC_COARSE_ENGINE="v2"),
                   dict(IVFADC_RANK_ENGINE="v2"))


def _sharded_counts(g: int, grouped: bool) -> dict:
    """The exact launches of a search of 4 shards x g data groups."""
    if grouped:
        return dict(coarse_probe=g, cell_rank=4 * g, grouped_scan=4 * g,
                    topk_payload=4 * g, topk_index=g)
    return dict(coarse_probe=g, probe_scan=4 * g, topk_index=5 * g)


# route -> (index fixture, run, kernels launched: name -> launches, None
# where the count is not pinned; kernels idle)
ROUTES = {
    "grouped": ("sift", _grouped,
                _each(1, _GROUPED + ["scan_probe_order_launches"]),
                ["probe_scan", "topk_index", "coarse_topw",
                 "grouped_scan_knorm", "probe_wide_select_launches"]),
    "small_batch": ("sift", _small_batch, _each(8, _PER_PROBE),
                    ["cell_rank", "grouped_scan", "topk_payload",
                     "coarse_topw", "grouped_scan_knorm"]),
    "norms_off": ("sift", _norms_off_route,
                  _each(1, ["coarse_probe", "cell_rank", "grouped_scan_knorm",
                            "topk_payload"]),
                  ["grouped_scan", "probe_scan", "topk_index"]),
    "bf16_cache": ("sift", _bf16,
                   dict(grouped_scan_bf16=1, probe_scan_bf16=4,
                        grouped_scan_knorm_bf16=1),
                   ["grouped_scan", "probe_scan", "grouped_scan_knorm"]),
    "exact_merge": ("sift", _exact,
                    dict(grouped_scan_exact=1, probe_scan_exact=4,
                         topk_index=None),
                    ["grouped_scan", "probe_scan", "grouped_scan_knorm",
                     "topk_payload"]),
    "extract": ("sift", _extract,
                _each(1, ["grouped_scan_extract", "topk_payload"]),
                ["grouped_scan", "grouped_scan_knorm"]),
    "rank_v2": ("sift", _engine("rank_v2", **_V2R),
                _each(1, ["coarse_probe", "cell_rank_v2", "grouped_scan",
                          "topk_payload"]),
                ["cell_rank", "grouped_scan_qc", "coarse_probe_v2"]),
    "coarse_v2": ("sift", _engine("coarse_v2", **_V2C),
                  _each(1, ["coarse_probe_v2", "cell_rank", "grouped_scan",
                            "topk_payload"]),
                  ["coarse_probe", "grouped_scan_qc", "cell_rank_v2"]),
    "vbase_qc": ("sift", _engine("qc", **_QC),
                 _each(1, ["coarse_probe", "cell_rank", "grouped_scan_qc",
                           "topk_payload"]),
                 ["grouped_scan", "grouped_scan_knorm", "coarse_probe_v2",
                  "cell_rank_v2"]),
    "all_engines": ("sift", _engine("all", **_QC, **_V2C, **_V2R),
                    _each(1, ["coarse_probe_v2", "cell_rank_v2",
                              "grouped_scan_qc", "topk_payload"]),
                    ["coarse_probe", "cell_rank", "grouped_scan",
                     "grouped_scan_knorm"]),
    "vbase_qc_bf16": ("sift", _engine("qc_bf16", bf16=True, **_QC),
                      _each(1, ["coarse_probe", "cell_rank",
                                "grouped_scan_qc_bf16", "topk_payload"]),
                      ["grouped_scan_qc", "grouped_scan_bf16",
                       "grouped_scan_knorm_bf16"]),
    "vbase_qc_gate_fails": ("sift", _qc_gate_fails, _each(1, _GROUPED),
                            ["grouped_scan_qc"]),
    "lut": ("sift", _lut, _each(None, ["coarse_topw", "topk_payload"]),
            ["coarse_probe", "cell_rank", "grouped_scan", "probe_scan"]),
    "unfused_per_probe": ("inner", _unfused(grouped=False),
                          _each(16, ["coarse_topw", "probe_scan",
                                     "topk_index"]),
                          ["coarse_probe", "cell_rank", "grouped_scan",
                           "topk_payload"]),
    "unfused_grouped": ("inner", _unfused(grouped=True),
                        _each(1, ["coarse_topw", "cell_rank",
                                  "grouped_scan_knorm", "topk_payload"]),
                        ["coarse_probe", "grouped_scan"]),
    "opq": ("opq", _opq_route, _each(1, _GROUPED),
            ["coarse_topw", "probe_scan"]),
    # past MAX_KC the tiles come from the sort: the counting kernel idles;
    # w = 64 probes on the large-w selection
    "sort_prep_kc8192": ("sift8k", _sort_prep,
                         _each(1, ["coarse_probe", "grouped_scan",
                                   "topk_payload", "tileprep_sort_launches",
                                   "scan_probe_order_launches",
                                   "probe_wide_select_launches"]),
                         ["cell_rank", "cell_rank_v2", "probe_scan",
                          "topk_index", "grouped_scan_knorm"]),
    "sharded_1x4_grouped": ("sift", _sharded(1, True),
                            _sharded_counts(1, True), ["probe_scan"]),
    "sharded_1x4_per_probe": ("sift", _sharded(1, False),
                              _sharded_counts(1, False),
                              ["cell_rank", "grouped_scan", "topk_payload"]),
    "sharded_2x4_grouped": ("sift", _sharded(2, True),
                            _sharded_counts(2, True), ["probe_scan"]),
    "sharded_2x4_per_probe": ("sift", _sharded(2, False),
                              _sharded_counts(2, False),
                              ["cell_rank", "grouped_scan", "topk_payload"]),
    # stage 1 and the final merge on kernel 6; stage 2 prepares its tiles in
    # one launch of the counting kernel
    "two_level_stage2": ("two_level", _two_level_route,
                         dict(topk_index=2, cell_rank=1, grouped_scan_knorm=1,
                              topk_payload=1, probe_scan=1),
                         ["coarse_probe", "grouped_scan", "coarse_topw"]),
    "two_level_naive_coarse": ("two_level", _two_level_naive,
                               _each(1, ["coarse_topw", "coarse_probe",
                                         "probe_scan", "topk_index"]),
                               ["cell_rank", "grouped_scan",
                                "grouped_scan_knorm", "topk_payload"]),
    "two_level_rank_v2": ("two_level", _two_level_rank_v2,
                          _each(1, ["cell_rank_v2", "grouped_scan_knorm"]),
                          ["cell_rank"]),
    "two_level_extract": ("two_level", _two_level_extract,
                          _each(1, ["grouped_scan_extract", "probe_scan"]),
                          ["grouped_scan_knorm"]),
    # pos8 block payloads; the posting scan's tiles from the sort (past
    # MAX_KC), so the counting kernel runs once, for stage 2
    "two_level_grouped_pos8": ("two_level", _two_level_grouped,
                               dict(grouped_scan_pos8=1, grouped_scan_knorm=1,
                                    cell_rank=1, topk_payload=None,
                                    topk_index=None),
                               ["probe_scan", "grouped_scan", "coarse_probe",
                                "coarse_topw"]),
    # stage 1 once, each shard's posting scan and merge, the shards' merge
    "two_level_sharded": ("two_level", _two_level_sharded,
                          dict(topk_index=4, cell_rank=1,
                               grouped_scan_knorm=1, topk_payload=1,
                               probe_scan=2),
                          ["grouped_scan", "coarse_probe"]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_route_launches(dev, request, route):
    fixture, run, launched, idle = ROUTES[route]
    counts = run(request.getfixturevalue(fixture))
    for name, n in launched.items():
        assert (counts[name] > 0 if n is None else counts[name] == n), \
            (route, name, counts)
    assert not [k for k in idle if counts[k]], (route, counts)
    # every grouped-scan launch of a search writes its rows in probe order
    grouped = sum(n for k, n in counts.items() if k.startswith("grouped_"))
    assert counts["scan_probe_order_launches"] == grouped, (route, counts)


# ------------------------------------------------------- the SIFT1M index
@pytest.mark.cuda
@pytest.mark.parametrize("state", ["built", "mutated"])
def test_recall_matches_the_oracle(sift, state):
    """recall@10 of the card's default route within 0.01 of the NumPy
    oracle's on the same arrays: on the built index, and on a fork taken
    through every dynamic op (a push_batch that grows cells, single pushes
    and deletes, an incremental and a bulk delete, pops from both ends and
    front pushes), against the exact top-10 of its own contents; the
    parent's results stay as they were."""
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    from ivfadc_tpu_torch.utils.evaluation import brute_force_topk
    if state == "built":
        _near_oracle(sift, _ref(sift, "grouped")[0])
        return
    dev, index = sift.base.device, sift.index
    before = _ref(sift, "b16384")
    new = torch.as_tensor(synthetic_clustered(N_PUSH, D, seed=7), device=dev)
    extra = torch.as_tensor(synthetic_clustered(210, D, seed=8), device=dev)
    pool = torch.cat([sift.base, new, extra])
    tokens = np.arange(N + N_PUSH, dtype=np.int64)     # id -> row of pool
    rng = np.random.RandomState(11)
    fork = index.fork()
    caps = fork.store.caps.copy()
    fork.push_batch(new)
    assert (fork.store.caps != caps).any()
    for i in range(100):
        fork.push(extra[i].cpu().numpy())
    tokens = np.concatenate([tokens, N + N_PUSH + np.arange(100)])
    for _ in range(100):
        target = int(rng.randint(len(fork)))
        fork.delete([target])
        tokens = np.delete(tokens, target)
    for count in (2048, 10000):                        # incremental, bulk
        dels = rng.choice(len(fork), count, replace=False)
        fork.delete(dels)
        tokens = np.delete(tokens, dels)
    for _ in range(100):
        fork.pop()
        fork.pop_front()
    tokens = tokens[100:-100]
    for i in range(10):
        fork.push_front(extra[200 + i].cpu().numpy())
    tokens = np.concatenate([N + N_PUSH + 200 + np.arange(10)[::-1],
                             tokens])
    assert len(fork) == len(tokens)
    contents = pool[torch.as_tensor(tokens, device=dev)]
    g = torch.Generator(device=dev).manual_seed(12)
    pick = torch.randint(0, len(tokens), (N_ORACLE,), generator=g,
                         device=dev)
    q = contents[pick] + 0.05 * torch.randn((N_ORACLE, D), generator=g,
                                            device=dev)
    ids, _ = fork.search_padded(q, TOPK, w=W)
    _, gt = brute_force_topk(contents, q, TOPK)
    o_ids, _ = _oracle_search(fork, q)
    assert abs(_recall(ids, gt) - _recall(o_ids, gt)) <= 0.01
    after = index.search_padded(sift.queries[:BATCH], TOPK, w=W)
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])


@pytest.mark.cuda
def test_live_pair_patches_the_views_in_place(sift):
    """The `sift1m.mutate` cell's pair on a fork of the SIFT1M-shape index:
    after a first pair (the fork's first writes clone the views it shares)
    and warm searches (eager, captured, replayed), a push_batch of 1,024
    points and a delete of 1,024 ids patch the views in place (the same
    tensors), rebuild no view, drop no graph, and the next search replays
    its graph; a cold rebuild of the views equals the patched ones bit for
    bit, and its eager search the replayed results."""
    from ivfadc_tpu_torch.utils import profiling
    dev, B = sift.base.device, 10000
    g = torch.Generator(device=dev).manual_seed(14)
    new = sift.base[torch.randint(0, N, (2 * 1024,), generator=g,
                                  device=dev)]
    new = new + 0.05 * torch.randn(new.shape, generator=g, device=dev)
    rng = np.random.RandomState(15)
    fork = sift.index.fork()
    q = sift.queries[:B]

    def pair(i):
        fork.push_batch(new[i * 1024:(i + 1) * 1024])
        fork.delete(rng.choice(len(fork), 1024, replace=False))

    pair(0)
    for _ in range(3):
        fork.search_padded(q, TOPK, w=W)
    st = fork.store
    views = {name: getattr(st, name) for name in ("_device", "_device_dense")
             if getattr(st, name) is not None}
    assert "_device_dense" in views
    held = {(name, key): t for name, view in views.items()
            for key, t in view.items() if isinstance(t, torch.Tensor)}
    with profiling.counting() as counts:
        pair(1)
        got = fork.search_padded(q, TOPK, w=W)
    assert counts["pushed_rows"] == counts["deleted_rows"] == 1024
    assert counts["flushed_slots"] >= 1024
    assert counts["view_rebuilds"] == counts["graph_drops"] == 0
    assert counts["cell_grows"] == 0
    assert counts["graph_captures"] == 0 and counts["graph_replays"] == 1
    for (name, key), t in held.items():
        assert getattr(st, name)[key] is t, (name, key)
    cold = fork.fork()
    cold.store._invalidate()
    rebuilt = dict(
        _device=cold.store.device_view(),
        _device_dense=cold.store.device_view_dense(
            cold.quantizer, cold.config.scan_chunk,
            cache=cold._resolve_cache()))
    for (name, key), t in held.items():
        assert torch.equal(rebuilt[name][key], t), (name, key)
    want = cold.search_padded(q, TOPK, w=W)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.cuda
def test_save_and_load_keep_the_results(sift, tmp_path):
    """An index saved on the card loads on the card with the same results
    bit for bit, and on the CPU with the same arrays (the grouped route's
    launch case holds the CPU route's results)."""
    from ivfadc_tpu_torch import IVFADCIndex
    path = str(tmp_path / "index.npz")
    sift.index.save(path)
    loaded = IVFADCIndex.load(path, device=sift.base.device)
    for name, q in (("grouped", sift.qs), ("small", sift.qs[:B_SMALL])):
        got = loaded.search_padded(q, TOPK, w=W)
        want = _ref(sift, name)
        np.testing.assert_array_equal(got[0], want[0][:q.shape[0]])
        np.testing.assert_array_equal(got[1], want[1][:q.shape[0]])
    on_cpu = IVFADCIndex.load(path, device="cpu")
    for key in ("offsets", "caps", "sizes", "codes", "ids"):
        np.testing.assert_array_equal(getattr(on_cpu.store, key),
                                      getattr(sift.index.store, key))
    assert torch.equal(on_cpu.coarse.centroids,
                       sift.index.coarse.centroids.cpu())
    assert torch.equal(on_cpu.quantizer.codebooks,
                       sift.index.quantizer.codebooks.cpu())


@pytest.mark.cuda
def test_autotune_and_memory_stats_on_the_card(sift):
    """autotune on a B=16384 batch over the JAX package's default
    candidates (pb 16/32/64/128 x chunk 512/1024/2048): 12 timed rows, none
    an error (pb = 128 runs 64-row tiles), the best one applied, and every
    candidate's ids and distances bit-equal to the default config's, as
    are pb = 4 / 20 / 100 / 256's; then memory_stats' scan-cache bytes
    equal the dense view's own tensors'."""
    index, q = sift.index, sift.queries[:BATCH]
    cfg0 = index.config
    want = index.search_padded(q, TOPK, w=W)
    out = index.autotune(q, k=TOPK, w=W)
    try:
        rows = out["results"]
        assert len(rows) == 12 and not [r for r in rows if "error" in r]
        best = out["best"]
        assert out["applied"] and best is not None
        assert (index.config.scan_pb, index.config.scan_chunk) == \
            (best["pb"], best["chunk"])
        pbs = [dict(scan_pb=r["pb"], scan_chunk=r["chunk"]) for r in rows]
        for change in pbs + [dict(scan_pb=pb) for pb in (4, 20, 100, 256)]:
            index.config = dataclasses.replace(cfg0, **change)
            index._drop_plans()
            got = index.search_padded(q, TOPK, w=W)
            np.testing.assert_array_equal(got[0], want[0], err_msg=change)
            np.testing.assert_array_equal(got[1], want[1], err_msg=change)
    finally:
        index.config = cfg0
        index._drop_plans()
    stats = index.memory_stats()
    view = index.store._device_dense
    assert stats["device_scan_cache_bytes"] == (
        view["decoded"].numel() * view["decoded"].element_size()
        + view["ids2d"].numel() * 4)


def _bit_equal(kern, plain):
    assert torch.equal(kern[0], plain[0]) and torch.equal(kern[1], plain[1])


def _exact_topk(kern, plain, k: int):
    """Exact-merge buffers against the plain version's on real data: per
    probe the sorted k smallest distances agree (1e-5 relative: another
    f32 summation order) and their payloads are equal on >= 99.9 % of the
    places whose distance ties no neighbour (within 1e-3)."""
    kd, kp = (a.reshape(-1, a.shape[-1]) for a in kern)
    pd, pp = (a.reshape(-1, a.shape[-1]) for a in plain)
    ks, ki = torch.sort(kd, dim=1)
    ps, pi = torch.sort(pd, dim=1)
    ks, ps = ks[:, :k], ps[:, :k]
    fin = torch.isfinite(ps)
    assert torch.equal(torch.isfinite(ks), fin)
    torch.testing.assert_close(ks[fin], ps[fin], rtol=1e-5, atol=1e-3)
    gap = torch.diff(ps, dim=1).abs() <= 1e-3
    tied = torch.zeros_like(fin)
    tied[:, 1:] |= gap
    tied[:, :-1] |= gap
    same = torch.gather(kp, 1, ki[:, :k]) == torch.gather(pp, 1, pi[:, :k])
    assert same[fin & ~tied].float().mean().item() >= 0.999


def _ranks_equal(cells, offsets, sizes, kc: int, pb: int):
    """Kernels 2 and 11 on one path's cells: the fused tile prep, twice in
    a row (the grid barrier resets itself), and the ranks, bit-equal to
    their plain versions."""
    want = cell_rank.tile_slots_plain(cells, offsets, sizes, kc=kc, pb=pb)
    ranks = cell_rank.cell_ranks_plain(cells, kc)
    for engine in ("v1", "v2"):
        for _ in range(2):
            got = cell_rank.tile_slots(cells, offsets, sizes, kc=kc, pb=pb,
                                       engine=engine)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), engine
        _bit_equal(cell_rank.cell_ranks(cells, kc=kc, engine=engine), ranks)


def _sift_inputs(s, b: int):
    """The SIFT1M index's arrays and b of its queries, probed as the main
    path probes them."""
    idx = s.index
    q = s.queries[:b]
    c32 = idx.coarse.centroids
    eye = torch.eye(D, device=q.device)
    cells, _, v, base = coarse_scan.coarse_probe_vbase(q, c32, W, eye, False,
                                                       True)
    view = idx.store.device_view_dense(idx.quantizer, idx.config.scan_chunk)
    return types.SimpleNamespace(
        q=q, c32=c32, cn=torch.sum(c32 * c32, dim=1), eye=eye, cells=cells,
        v=v, base=base, view=view, pb=dense_scan.tile_height(
            idx.config.scan_pb), nf=idx.config.scan_fold_lanes,
        bview=idx.store.device_view_dense(idx.quantizer,
                                          idx.config.scan_chunk,
                                          cache="bf16"))


def _kernels_probe(s):
    """Kernels 1 and 10 (unrotated and under a random orthogonal rotation)
    at B = 16,384, under the plan that batch picks; 2 and 11 on the probe's
    cells."""
    x = _sift_inputs(s, BATCH)
    q, c32, cn, eye = x.q, x.c32, x.cn, x.eye
    # 1: scores are f32 sums in another order than cuBLAS's, so cells may
    # differ where two centroids tie to a few ulps; where equal, v =
    # bf16(-2(q - c)) is exact and ||q - c||^2 agrees to 1e-5 relative
    kv = coarse_scan.coarse_vbase(q, c32, cn, eye, W, False)
    pv = coarse_scan.coarse_vbase_plain(q, c32, cn, eye, W, False)
    same = kv[1] == pv[1]
    assert same.float().mean().item() >= 0.999
    assert torch.equal(kv[2][same], pv[2][same])
    torch.testing.assert_close(kv[3][same], pv[3][same], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(kv[0], pv[0], rtol=1e-5, atol=1e-3)
    # 10: kernel 1's cells bit for bit; v within one bf16 ulp of the plain
    # version's under the rotation, bit-equal without it (where the cells
    # agree); base = 2 cdist, the wrapper's formula
    g = torch.Generator().manual_seed(11)
    rot_r = torch.linalg.qr(torch.randn(D, D, generator=g))[0].to(q.device)
    for rot, apply_rot in ((eye, False), (rot_r, True)):
        hi, lo = coarse_scan.hi_lo_split(c32, rot, apply_rot)
        k10 = coarse_scan.coarse_vbase_v2(q, c32, cn, rot, hi, lo, W,
                                          apply_rot)
        p10 = coarse_scan.coarse_vbase_v2_plain(q, c32, cn, rot, hi, lo, W,
                                                apply_rot)
        assert torch.equal(k10[1], coarse_scan.coarse_vbase(
            q, c32, cn, rot, W, apply_rot)[1])
        same = k10[1] == p10[1]
        assert same.float().mean().item() >= 0.999
        torch.testing.assert_close(k10[0], p10[0], rtol=1e-5, atol=1e-3)
        if apply_rot:
            torch.testing.assert_close(k10[2][same].float(),
                                       p10[2][same].float(), rtol=2 ** -7,
                                       atol=1e-6)
        else:
            assert torch.equal(k10[2][same], p10[2][same])
        cells_w, cd_w, _, base_w = coarse_scan.coarse_probe_vbase(
            q, c32, W, rot, apply_rot, True, engine="v2", rot_orthogonal=True)
        assert torch.equal(cells_w, k10[1])
        assert torch.equal(base_w, cd_w + cd_w)
        del k10, p10, hi, lo
    _ranks_equal(kv[1].reshape(-1), x.view["offsets"], x.view["sizes"], KC,
                 x.pb)


def _kernels_grouped(s):
    """Kernels 3, 8a-8e and 4 on the B = 16,384 batch's own tiles (cells of
    about 1,000 rows), written in probe order as the search writes them:
    real inputs against the plain versions, and integer-valued ones (every
    f32 sum exact) bit for bit."""
    x = _sift_inputs(s, BATCH)
    view, bview, pb, nf = x.view, x.bview, x.pb, x.nf
    dev = x.q.device
    tstart, tsize, v_t, b_t, inv_row = dense_scan.place_tiles(
        x.cells, view["offsets"], view["sizes"], x.v, x.base, kc=KC, pb=pb)
    order = dict(slot_row=inv_row, n_rows=BATCH * W)
    real = (tstart, tsize, v_t, b_t, view["decoded"], view["scale"],
            view["ids2d"], view["norms2d"])
    g = torch.Generator(device=dev).manual_seed(7)
    dec_i = torch.randint(-3, 4, view["decoded"].shape, generator=g,
                          device=dev).to(torch.int8)
    v_i = torch.randint(-4, 5, v_t.shape, generator=g, device=dev) \
        .to(torch.bfloat16)
    b_i = torch.where(torch.isfinite(b_t), torch.randint(
        0, 100, b_t.shape, generator=g, device=dev).float(), float("inf"))
    n_i = torch.randint(0, 50, view["norms2d"].shape, generator=g,
                        device=dev).float()
    ints = (tstart, tsize, v_i, b_i, dec_i, torch.ones(D, device=dev),
            view["ids2d"], n_i)
    b_real = (tstart, tsize, v_t, b_t, bview["decoded"], None,
              bview["ids2d"], bview["norms2d"])
    b_ints = (tstart, tsize, v_i, b_i, dec_i.to(torch.bfloat16), None,
              view["ids2d"], n_i)
    kw = dict(pb=pb, nf=nf, norm_coef=1.0, **order)
    # (real inputs, integer inputs, options): 3, 8a, 8e, 8c, 8c with the
    # norms in the kernel
    for args, int_args, extra in (
            (real, ints, {}),
            (real[:7] + (None,), ints[:7] + (None,), {}),
            (real[:7] + (None,), ints[:7] + (None,), dict(extract_k=TOPK)),
            (b_real, b_ints, {}),
            (b_real[:7] + (None,), b_ints[:7] + (None,), {})):
        _close_scan(dense_scan.grouped_scan(*args, **kw, **extra),
                    dense_scan.grouped_scan_plain(*args, **kw, **extra))
        _bit_equal(dense_scan.grouped_scan(*int_args, **kw, **extra),
                   dense_scan.grouped_scan_plain(*int_args, **kw, **extra))
    # 8b without the id stream (pos8 block payloads), integer-valued
    pos = ints[:6] + (None, None)
    k8b = dense_scan.grouped_scan(*pos, **kw, pos8=True)
    assert k8b[1].dtype == torch.int8
    _bit_equal(k8b, dense_scan.grouped_scan_plain(*pos, **kw, pos8=True))
    # 8d: the exact merge (in-kernel norms, slot payloads)
    ekw = dict(pb=pb, nf=128, norm_coef=1.0, merge="exact", k_out=TOPK,
               **order)
    ex = real[:6] + (None, None)
    _exact_topk(dense_scan.grouped_scan(*ex, **ekw),
                dense_scan.grouped_scan_plain(*ex, **ekw), TOPK)
    _bit_equal(dense_scan.grouped_scan(*pos, **ekw),
               dense_scan.grouped_scan_plain(*pos, **ekw))
    # 4 on kernel 3's candidates (ties and +inf included): exact
    kd, kp = dense_scan.grouped_scan(*real, **kw)
    flat_d = kd.reshape(BATCH, W * nf)
    flat_p = kp.reshape(BATCH, W * nf)
    _bit_equal(topk.topk_lastdim_payload(flat_d, flat_p, TOPK),
               topk.topk_lastdim_payload_plain(flat_d, flat_p, TOPK))


def _kernels_small(s):
    """Kernels 7, 5 (with and without the norm term), 8d and 8c per probe
    and 6 on the small-batch path's own inputs at B = 256 (2,048 probes):
    real inputs against the plain versions, integer-valued ones bit for
    bit."""
    x = _sift_inputs(s, B_SMALL)
    q, c32, cn, view, nf = x.q, x.c32, x.cn, x.view, x.nf
    dev = q.device
    # 7: cells may differ from the plain version's only at few-ulp ties, and
    # equal the fused probe's, whose score code it shares
    kcells, kd = coarse_scan.coarse_topw(q, c32, W)
    pvals, pcells = coarse_scan.coarse_topw_plain(q, c32, cn, W)
    assert (kcells == pcells).float().mean().item() >= 0.999
    torch.testing.assert_close(kd, torch.clamp_min(
        pvals + torch.sum(q * q, dim=1, keepdim=True), 0.0), rtol=1e-5,
        atol=1e-3)
    assert torch.equal(kcells, x.cells)
    # 5, 8d and 8c on the path's own probes
    P = B_SMALL * W
    cells64 = x.cells.to(torch.int64)
    starts, sizes = view["offsets"][cells64], view["sizes"][cells64]
    chunk = s.index.config.scan_chunk
    g = torch.Generator(device=dev).manual_seed(11)
    dec_i = torch.randint(-3, 4, view["decoded"].shape, generator=g,
                          device=dev).to(torch.int8)
    v_i = torch.randint(-4, 5, x.v.shape, generator=g, device=dev).float()
    b_i = torch.randint(0, 100, x.base.shape, generator=g,
                        device=dev).float()
    ones = torch.ones(D, device=dev)
    scale16 = view["scale"].to(torch.bfloat16).to(torch.float32)

    def pair(v, base, dec, scale, plain_scale, nf, coef=1.0, merge="fold"):
        """(kernel, plain version) of one per-probe scan, (P, nf) each."""
        k = dense_scan.dense_scan(starts, sizes, v, base, dec, scale,
                                  k_out=TOPK, chunk=chunk, nf=nf,
                                  norm_coef=coef, merge=merge)
        p = dense_scan.probe_scan_plain(
            starts.reshape(P), sizes.reshape(P), base.reshape(P),
            v.reshape(P, D), dec, plain_scale, nf=nf, norm_coef=coef,
            merge=merge, k_out=TOPK)
        return (k[0].reshape(P, nf), k[1].reshape(P, nf)), p

    # bf16 products and squares summed in f32 in another order than the
    # plain version's matmul and sum; scores are ~1e2
    k5, p5 = pair(x.v, x.base, view["decoded"], view["scale"], scale16, nf)
    _close_scan(k5, p5)
    for coef in (1.0, 0.0):
        _bit_equal(*pair(v_i, b_i, dec_i, ones, ones, nf, coef))
    _exact_topk(*pair(x.v, x.base, view["decoded"], view["scale"], scale16,
                      128, merge="exact"), TOPK)
    _bit_equal(*pair(v_i, b_i, dec_i, ones, ones, 128, merge="exact"))
    _close_scan(*pair(x.v, x.base, x.bview["decoded"], None, None, nf))
    _bit_equal(*pair(v_i, b_i, dec_i.to(torch.bfloat16), None, None, nf))
    # 6 on kernel 5's candidate rows (ties and +inf included): exact
    flat_d = k5[0].reshape(B_SMALL, W * nf)
    _bit_equal(topk.topk_lastdim(flat_d, TOPK),
               topk.topk_lastdim_plain(flat_d, TOPK))


def _kernels_qc(s):
    """Kernel 9 on every tile of a B = 8,192 batch: the int8 cache
    unrotated and under a random orthogonal rotation, the bf16 cache
    unrotated; integer-valued inputs (a permutation for the rotation) bit
    for bit."""
    x = _sift_inputs(s, BATCH_QC)
    dev = x.q.device
    g = torch.Generator().manual_seed(11)
    rot_r = torch.linalg.qr(torch.randn(D, D, generator=g))[0].to(dev)
    for vw, int8, rot in ((x.view, True, None), (x.view, True, rot_r),
                          (x.bview, False, None)):
        apply_rot = rot is not None
        prep = dense_scan.qc_tile_inputs(
            x.cells, vw["offsets"], vw["sizes"], x.q, x.c32, rot, D, kc=KC,
            pb=x.pb)
        args = prep[:7] + (vw["decoded"], vw["scale"], vw["ids2d"])
        kw = dict(pb=x.pb, nf=x.nf, norm_coef=1.0, base_mult=2.0,
                  apply_rot=apply_rot, slot_row=prep[7],
                  n_rows=BATCH_QC * W)
        # under the rotation the kernel sums r R in another order than the
        # plain matmul, and bf16(-2 r R) may round the other way: one bf16
        # ulp of one v element moves a score by 2^-8 of its term
        _close_scan(dense_scan.grouped_scan_qc(*args, **kw),
                    dense_scan.grouped_scan_qc_plain(*args, **kw),
                    min_agree=0.999 if apply_rot else 0.99999,
                    rtol=1e-4 if apply_rot else 1e-5)
        gi = torch.Generator(device=dev).manual_seed(17)
        dec_i = torch.randint(-3, 4, vw["decoded"].shape, generator=gi,
                              device=dev)
        q_i = torch.randint(-4, 5, args[4].shape, generator=gi,
                            device=dev).float()
        c_i = torch.randint(-4, 5, args[5].shape, generator=gi,
                            device=dev).float()
        rot_i = torch.zeros((D, D), device=dev)
        rot_i[torch.arange(D, device=dev),
              torch.randperm(D, generator=g).to(dev)] = 1
        int_args = args[:4] + (
            q_i, c_i, rot_i.to(torch.bfloat16),
            dec_i.to(torch.int8 if int8 else torch.bfloat16),
            torch.ones(D, device=dev) if int8 else None, args[9])
        _bit_equal(dense_scan.grouped_scan_qc(*int_args, **kw),
                   dense_scan.grouped_scan_qc_plain(*int_args, **kw))


_SIFT_KERNELS = {"probe_b16384": _kernels_probe,
                 "grouped_b16384": _kernels_grouped,
                 "small_b256": _kernels_small, "qc_b8192": _kernels_qc}


@pytest.mark.cuda
@pytest.mark.parametrize("part", list(_SIFT_KERNELS))
def test_sift_kernels_equal_their_plain_versions(sift, part):
    """Every kernel of the SIFT1M path against its plain version at the
    main path's shapes, on the index's own arrays and probes (scores to
    1e-5 relative, payloads equal on >= 99.9 %), and on integer-valued
    inputs at the same tiles and probes bit for bit."""
    _SIFT_KERNELS[part](sift)


# ------------------------------------------------- the two-level index
@pytest.mark.cuda
def test_two_level_index_on_the_card(two_level):
    """The large-kc build: two-level coarse, 8-row cells whose dense view
    holds no id or norm stream; stage 2's distances against the true ones
    and against its own int8 / bf16 decomposition in f32; save and load
    keep the arrays and the results."""
    import tempfile
    from ivfadc_tpu_torch import IVFADCIndex
    index, q = two_level.index, two_level.q
    cq = index.coarse
    assert len(index) == N3 and cq.kind == "two_level"
    assert index.store.align == 8 and KC3 > cell_rank.MAX_KC
    assert int(index.store.caps.max()) <= 127 * 128
    view = index.store.device_view_dense(index.quantizer,
                                         index.config.scan_chunk)
    assert view["ids2d"] is None and view["norms2d"] is None
    tl_cells, tl_d = _ref(two_level, "cells")
    cent = cq.centroids[tl_cells.to(torch.int64)]
    true_d = torch.sum((q[:, None, :] - cent) ** 2, dim=-1)
    # |q|^2 - 2 q.c + |c|^2 over an int8 table with bf16 products: the error
    # scales with the terms, not with the distance (on clustered data a
    # query lies close to its cells), so the bound is taken against the
    # terms' magnitude (0.0017 of them read at kc = 2^18)
    mag = torch.sum(q * q, dim=1)[:, None] + torch.sum(cent ** 2, dim=-1)
    assert ((tl_d - true_d).abs() / mag).max().item() <= 3e-3
    # and tightly against the scan's own decomposition evaluated in f32:
    # |q|^2 + bf16(-2q).row + sum bf16(row^2), row = bf16(int8 *
    # bf16(scale)) at the returned cell's slot
    flat_perm = cq.perm2d.reshape(-1)
    live = torch.nonzero(flat_perm >= 0).reshape(-1)
    slot = torch.empty(KC3, dtype=torch.int64, device=q.device)
    slot[flat_perm[live].to(torch.int64)] = live
    sc16 = cq.cent_scale.to(torch.bfloat16).to(torch.float32)
    rows = (cq.cent_scan[slot[tl_cells.to(torch.int64)]].to(torch.float32)
            * sc16).to(torch.bfloat16).to(torch.float32)
    vq = torch.nn.functional.pad((-2.0 * q).to(torch.bfloat16).float(),
                                 (0, rows.shape[-1] - D3))
    dec_d = (torch.sum(vq[:, None, :] * rows, dim=-1)
             + torch.sum((rows * rows).to(torch.bfloat16).float(), dim=-1)
             + torch.sum(q * q, dim=1)[:, None])
    torch.testing.assert_close(tl_d, dec_d, rtol=1e-5, atol=1e-3)
    with tempfile.TemporaryDirectory() as tmp:
        index.save(os.path.join(tmp, "two_level.npz"))
        loaded = IVFADCIndex.load(os.path.join(tmp, "two_level.npz"),
                                  device=q.device)
    assert loaded.coarse.kind == "two_level"
    assert torch.equal(loaded.coarse.cent_scan, cq.cent_scan)
    assert torch.equal(loaded.coarse.perm2d, cq.perm2d)
    got = loaded.search_padded(q, TOPK, w=W3)
    want = _ref(two_level, "default")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.cuda
def test_two_level_kernels_equal_their_plain_versions(two_level):
    """The large-kc path's kernels against their plain versions on its own
    inputs: kernel 6 at stage 1; the fused tile prep (2 and 11, twice in a
    row) and the ranks on stage 2's group ids; 8a and 8e on stage 2's
    tiles; kernel 4 at stage 2's merge; kernel 5 on the posting probes (8
    rows a cell at any 8-row start; the plain version on every 16th) and
    kernel 6 at the final merge; kernels 7 and 1 over the whole centroid
    table (their integer ties at this shape are a case of
    `test_coarse_kernels_integer_ties_bit_equal`); 8b on a grouped batch's
    tiles (every 128th). Integer-valued inputs bit for bit."""
    from ivfadc_tpu_torch.models.index import _dense_probe
    index, q = two_level.index, two_level.q
    dev = q.device
    cq = index.coarse
    g, gp = cq.group_centers.shape[0], cq.n_probe_groups
    # 6 at stage 1: (NQ3, g), k = gp
    gdist = cq.metric.pairwise(q, cq.group_centers)
    kv, gids = topk.topk_lastdim(gdist, gp)
    _bit_equal((kv, gids), topk.topk_lastdim_plain(gdist, gp))
    # 2 and 11 on stage 2's group ids and the groups' slot ranges
    _ranks_equal(gids.reshape(-1).to(torch.int32), cq.csr_offsets,
                 cq.csr_sizes, g, 64)
    # 8a on stage 2's own tiles
    d_pad = cq.cent_scan.shape[1]
    pb, nf = 64, 128
    v = torch.nn.functional.pad(
        (-2.0 * q)[:, None, :].expand(NQ3, gp, D3), (0, d_pad - D3))
    qbase = torch.sum(q * q, dim=1)[:, None].expand(NQ3, gp)
    tstart, tsize, v_t, b_t, inv_row = dense_scan.place_tiles(
        gids, cq.csr_offsets, cq.csr_sizes, v, qbase, kc=g, pb=pb)
    args = (tstart, tsize, v_t, b_t, cq.cent_scan, cq.cent_scale, cq.perm2d,
            None)
    kw = dict(pb=pb, nf=nf, norm_coef=1.0, slot_row=inv_row,
              n_rows=NQ3 * gp)
    kd, kp = dense_scan.grouped_scan(*args, **kw)
    _close_scan((kd, kp), dense_scan.grouped_scan_plain(*args, **kw))
    gi = torch.Generator(device=dev).manual_seed(13)
    dec_i = torch.randint(-3, 4, cq.cent_scan.shape, generator=gi,
                          device=dev).to(torch.int8)
    v_i = torch.randint(-4, 5, v_t.shape, generator=gi, device=dev) \
        .to(torch.bfloat16)
    b_i = torch.where(torch.isfinite(b_t), torch.randint(
        0, 100, b_t.shape, generator=gi, device=dev).float(), float("inf"))
    int_args = (tstart, tsize, v_i, b_i, dec_i, torch.ones(d_pad, device=dev),
                cq.perm2d, None)
    for extra in ({}, dict(extract_k=W3)):          # 8a, 8e
        _bit_equal(dense_scan.grouped_scan(*int_args, **kw, **extra),
                   dense_scan.grouped_scan_plain(*int_args, **kw, **extra))
    _close_scan(dense_scan.grouped_scan(*args, **kw, extract_k=W3),
                dense_scan.grouped_scan_plain(*args, **kw, extract_k=W3))
    # 4 at stage 2's merge: (NQ3, gp * nf), k = W3
    flat_d = kd.reshape(NQ3, gp * nf)
    flat_p = kp.reshape(NQ3, gp * nf)
    _bit_equal(topk.topk_lastdim_payload(flat_d, flat_p, W3),
               topk.topk_lastdim_payload_plain(flat_d, flat_p, W3))
    del flat_d, flat_p, kd, kp, v_t, b_t, v_i, b_i, dec_i, v
    # 5 on the posting scan's own probes, the plain version on every 16th
    view = index.store.device_view_dense(index.quantizer,
                                         index.config.scan_chunk)
    include = index.config.score_mode == "reference"
    cells, v_q, base_q, _ = _dense_probe(
        cq, index.quantizer.rotation, q, w=W3, metric=index.quant_metric,
        include_base=include, apply_rot=False, residual_based=True)
    cells64 = cells.to(torch.int64)
    P, nfp = NQ3 * W3, index.config.scan_fold_lanes
    starts, sizes = view["offsets"][cells64], view["sizes"][cells64]
    ksd, ksp = dense_scan.dense_scan(
        starts, sizes, v_q, base_q, view["decoded"], view["scale"],
        k_out=TOPK, chunk=index.config.scan_chunk, nf=nfp, norm_coef=1.0)
    sub = torch.arange(0, P, 16, device=dev)
    d_dec = view["decoded"].shape[1]
    psd, psp = dense_scan.probe_scan_plain(
        starts.reshape(P)[sub], sizes.reshape(P)[sub],
        base_q.reshape(P)[sub], torch.nn.functional.pad(
            v_q.reshape(P, -1)[sub], (0, d_dec - D3)), view["decoded"],
        view["scale"].to(torch.bfloat16).to(torch.float32), nf=nfp,
        norm_coef=1.0)
    _close_scan((ksd.reshape(P, nfp)[sub], ksp.reshape(P, nfp)[sub]),
                (psd, psp))
    # 6 at the final merge: (NQ3, W3 * nf), k = TOPK
    fd = ksd.reshape(NQ3, W3 * nfp)
    _bit_equal(topk.topk_lastdim(fd, TOPK), topk.topk_lastdim_plain(fd, TOPK))
    del fd, ksd, ksp, v_q
    # 7 and 1 over the whole centroid table, split over blocks, each with a
    # running top-w; the plain versions on the first 256 queries. Cells may
    # differ only at few-ulp ties
    c32 = cq.centroids
    cn = torch.sum(c32 * c32, dim=1)
    q256, eye = q[:256], torch.eye(D3, device=dev)
    kcells, kdist = coarse_scan.coarse_topw(q256, c32, W3)
    pvals, pcells = coarse_scan.coarse_topw_plain(q256, c32, cn, W3)
    assert (kcells == pcells).float().mean().item() >= 0.999
    torch.testing.assert_close(kdist, torch.clamp_min(
        pvals + torch.sum(q256 * q256, dim=1, keepdim=True), 0.0),
        rtol=1e-5, atol=1e-3)
    k1 = coarse_scan.coarse_vbase(q256, c32, cn, eye, W3, False)
    p1 = coarse_scan.coarse_vbase_plain(q256, c32, cn, eye, W3, False)
    assert torch.equal(k1[1], kcells)
    same = k1[1] == p1[1]
    assert torch.equal(k1[2][same], p1[2][same])
    torch.testing.assert_close(k1[3][same], p1[3][same], rtol=1e-5,
                               atol=1e-3)
    torch.testing.assert_close(k1[0], p1[0], rtol=1e-5, atol=1e-3)
    # 8b on the grouped batch's own tiles, in probe order as the search
    # writes them (every probe's row); the plain version on every 128th
    # tile and the last, in tile order, held to its live slots' probes
    cells_b, v_b, base_b, _ = _dense_probe(
        cq, index.quantizer.rotation, two_level.q_big, w=W3,
        metric=index.quant_metric, include_base=include, apply_rot=False,
        residual_based=True)
    pbp = dense_scan.tile_height(index.config.scan_pb)
    tstart, tsize, v_t, b_t, inv_row = dense_scan.place_tiles(
        cells_b, view["offsets"], view["sizes"],
        torch.nn.functional.pad(v_b, (0, d_dec - D3)), base_b, kc=KC3,
        pb=pbp)
    T, P_big = tstart.shape[0], NQ3_BIG * W3
    pkw = dict(pb=pbp, nf=nfp, norm_coef=1.0, pos8=True)
    kd, kp = dense_scan.grouped_scan(tstart, tsize, v_t, b_t,
                                     view["decoded"], view["scale"], None,
                                     None, slot_row=inv_row, n_rows=P_big,
                                     **pkw)
    assert kp.dtype == torch.int8 and kd.shape == (P_big, nfp)
    sub = torch.unique(torch.cat([torch.arange(0, T, 128, device=dev),
                                  torch.tensor([T - 1], device=dev)]))
    pd, pp = dense_scan.grouped_scan_plain(
        tstart[sub], tsize[sub],
        v_t.reshape(T, pbp, d_dec)[sub].reshape(-1, d_dec),
        b_t.reshape(T, pbp, 1)[sub].reshape(-1, 1), view["decoded"],
        view["scale"], None, None,
        **dense_scan.tile_order(sub.shape[0], pbp, dev), **pkw)
    slots = inv_row.reshape(T, pbp)[sub].reshape(-1)
    live = slots < P_big
    _close_scan((kd[slots[live]], kp[slots[live]]), (pd[live], pp[live]))


@pytest.mark.cuda
def test_two_level_mutations_on_the_card(two_level):
    """On a fork of the large-kc index (8-row cells, no norm stream):
    push_batch, whose grown cells move their rows inside the views, and an
    incremental delete, each held to views built afresh and a search bit
    for bit (stage 2's kernels assign the pushed points' cells); then the
    gathered engine on the same batch, its top-10 overlap with the
    per-probe route >= 0.99."""
    from test_torch_cuda import _views_equal_rebuild
    from ivfadc_tpu_torch.ops.gather_scan import plan_gather
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    q = two_level.q
    fork = two_level.index.fork()
    fork.search_padded(q, TOPK, w=W3)
    fork.store.device_view()
    st = fork.store
    patches, caps = st.grow_patches, st.caps.copy()
    before = _launches()
    fork.push_batch(synthetic_clustered(N3 // 32, D3, seed=9))
    assert (st.caps != caps).any() and st.grow_patches > patches
    rng = np.random.RandomState(13)
    for step in ("push_batch", "delete"):
        if step == "delete":
            fork.delete(rng.choice(len(fork), 2048, replace=False))
        fresh = _views_equal_rebuild(fork)
        got = fork.search_padded(q, TOPK, w=W3)
        want = fresh.search_padded(q, TOPK, w=W3)
        np.testing.assert_array_equal(got[0], want[0], err_msg=step)
        np.testing.assert_array_equal(got[1], want[1], err_msg=step)
        ids = st.ids
        np.testing.assert_array_equal(np.sort(ids[ids >= 0]),
                                      np.arange(len(fork)))
    ran = {k for k, n in _launches().items() if n > before[k]}
    assert set(_TWO_LEVEL) <= ran, ran
    # a window of 32 rows, or of the p95 cell capacity where 32 leaves the
    # plan off
    limit = 32 if plan_gather(st.caps, 32)[0] \
        else -(-int(np.percentile(st.caps, 95)) // 8) * 8
    gathered = _variant(fork, scan_gather_win=limit)
    assert gathered._gather_plan()[0] > 0
    g_ids, g_d = gathered.search_padded(q, TOPK, w=W3)
    assert np.isfinite(g_d).all() and (np.diff(g_d, axis=1) >= 0).all()
    assert _overlap(g_ids, fork.search_padded(q, TOPK, w=W3)[0]) >= 0.99


# --------------------------------------- two ranks of one group on one card
_GLOO_WORKER = r'''
import os, sys
sys.path.insert(0, os.environ["IVFADC_ROOT"])
import numpy as np
from ivfadc_tpu_torch.parallel import (initialize_cluster, load_sharded_index,
                                       make_mesh, process_info,
                                       save_sharded_index, shutdown_cluster,
                                       ShardedIVFADCIndex)
from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
rank, phase = int(os.environ["RANK_X"]), os.environ["PHASE"]
assert initialize_cluster(os.environ["COORD"], 2, rank, [0, 0])
info = process_info()
assert info["backend"] == "gloo" and info["global_device_count"] == 4, info
mesh = make_mesh(n_shards=4)
if phase == "build":
    view = ShardedIVFADCIndex.build(
        synthetic_clustered(20000, 64, seed=0), mesh, kc=64, m=8, k=16,
        seed=0, coarse_maxiter=3, quantization_maxiter=3)
else:
    view = load_sharded_index(os.environ["DIR"], mesh)
held = [v for v in view.views if v is not None]
assert len(held) == 2 and all(v["ids"].is_cuda for v in held)
ids, dists = view.search_padded(np.load(os.environ["QUERIES"]), 10, w=8)
if phase == "build":
    save_sharded_index(os.environ["DIR"], view)
np.savez(os.environ["OUT"] + f"{phase}{rank}.npz", ids=ids, dists=dists)
shutdown_cluster()
'''


@pytest.mark.cuda
def test_two_ranks_on_one_card_equal_single_process(dev, tmp_path):
    """Two ranks of one process group on cuda:0 (gloo: NCCL refuses two
    ranks on one card), two shards each of a global 1 x 4 mesh: they build,
    search and save their shard files; a fresh group loads the directory
    and searches again. Every rank's results equal a single-process view
    over four shards of the card bit for bit."""
    from ivfadc_tpu_torch import ShardedIVFADCIndex, make_mesh
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    data = synthetic_clustered(20000, 64, seed=0)
    rng = np.random.RandomState(1)
    q = (data[rng.randint(0, 20000, 512)]
         + 0.05 * rng.randn(512, 64)).astype(np.float32)
    view = ShardedIVFADCIndex.build(
        data, make_mesh(n_shards=4, devices=["cuda:0"] * 4), kc=64, m=8,
        k=16, seed=0, coarse_maxiter=3, quantization_maxiter=3)
    ids, dists = view.search_padded(q, TOPK, w=W)
    np.save(str(tmp_path / "q.npy"), q)
    (tmp_path / "w.py").write_text(_GLOO_WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for phase in ("build", "load"):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, IVFADC_ROOT=root, COORD=f"127.0.0.1:{port}",
                   QUERIES=str(tmp_path / "q.npy"), OUT=str(tmp_path / "r"),
                   DIR=str(tmp_path / "dir"), PHASE=phase)
        procs = [subprocess.Popen([sys.executable, str(tmp_path / "w.py")],
                                  env=dict(env, RANK_X=str(r)),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, o in zip(procs, outs):
            assert p.returncode == 0, o[-4000:]
        for r in range(2):
            z = np.load(str(tmp_path / f"r{phase}{r}.npz"))
            np.testing.assert_array_equal(z["ids"], ids)
            np.testing.assert_array_equal(z["dists"], dists)
