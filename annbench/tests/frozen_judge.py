"""A frozen copy of the comparison as it stood before it followed a
mutating index: `harness.stored_of`, `work_counts` and `judge`,
`compare.build_numbers`, `answer_numbers` and `lost_rows`, and
`ivfadc.search`, which that change rewrote. The functions it left as they
were are imported. `test_annbench_unmoved.py` holds the live comparison
to this copy on runs that mutate nothing."""

import time
from typing import Dict

import numpy as np
import torch

from annbench import datagen, harness, roofline
from annbench.reference import compare
from annbench.reference import ivfadc as ref
from annbench.reference import train
from annbench.window import Window


def stored_of(index, n: int, dev):
    """The build under test as the store holds it: each point's cell and
    codes, and every id held (for `lost_rows`)."""
    st = index.store
    sizes = np.asarray(st.sizes, np.int64)
    offsets = np.asarray(st.offsets, np.int64)
    slots = np.repeat(offsets - np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                      sizes) + np.arange(int(sizes.sum()))
    held = np.asarray(st.ids)[slots]
    cells = np.repeat(np.arange(sizes.size), sizes)
    codes = np.asarray(st.codes)[slots].astype(np.int64)
    ok = (held >= 0) & (held < n)
    a = np.zeros(n, np.int64)
    c = np.zeros((n, codes.shape[1]), np.int64)
    a[held[ok]] = cells[ok]
    c[held[ok]] = codes[ok]
    return ref.Stored(torch.as_tensor(a, device=dev),
                      torch.as_tensor(c, device=dev)), held


def work_counts(queries: torch.Tensor, trained: ref.Trained,
                lists: ref.Lists, cfg: dict, traffic: dict,
                win: Window) -> Dict[str, tuple]:
    """(bytes, ops) of the probe, the scan and the merge over the window's
    sent work, counted from the problem (roofline.py)."""
    d = queries.shape[1]
    idx_cfg = cfg["index"]
    m = idx_cfg["m"]
    id_bytes = {"uint32": 4, "uint64": 8, "uint16": 2}[
        idx_cfg.get("index_dtype", "uint32")]
    w, k = traffic["w"], traffic["k"]
    cells, _ = ref.probe(queries, trained, w, ref.EXACT)
    cells = cells.cpu().numpy()
    sizes = lists.sizes
    scan_pairs = sizes[cells].sum(1)
    kc = trained.centroids.shape[0]
    out = {"probe": [0.0, 0.0], "scan": [0.0, 0.0], "merge": [0.0, 0.0]}
    for idx, reps in win.sent:
        pb, po = roofline.probe_work(idx.size, d, idx.size * kc, kc)
        sb, so = roofline.scan_work(d, m, id_bytes,
                                    int(scan_pairs[idx].sum()),
                                    int(sizes[np.unique(cells[idx])].sum()))
        mb, mo = roofline.merge_work(idx.size, k)
        for key, (b, o) in (("probe", (pb, po)), ("scan", (sb, so)),
                            ("merge", (mb, mo))):
            out[key][0] += reps * b
            out[key][1] += reps * o
    return {key: tuple(v) for key, v in out.items()}


def judge(cfg, traffic, check, seed, dev, queries, trained, given, held,
          win, use_trace):
    """The comparison (reference/compare.py): the program's training
    against the reference's own, its build, and a sample of the window's
    answers drawn from the seed; in a traced run also the work counts."""
    lines = []
    base = datagen.clustered(cfg["data"]["n"], cfg["data"]["d"],
                             cfg["data"]["n_clusters"], cfg["data"]["noise"],
                             seed, dev)
    n = base.shape[0]
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        mine = train.train(base, cfg["index"],
                           harness.train_generator(seed, dev))
        numbers = compare.train_numbers(base, trained, mine)
        del mine
        own = ref.build(base, trained, ref.EXACT)
        numbers["lost_rows"] = lost_rows(given, held, n)
        numbers.update(build_numbers(base, trained, given, own))
        kc = trained.centroids.shape[0]
        lists = ref.Lists(own, kc)
        rng = np.random.default_rng(
            datagen.sub_seed(seed, datagen.STREAM_SAMPLE) + 1)
        pick = rng.choice(len(win.answers),
                          min(check["answers"], len(win.answers)),
                          replace=False) if win.answers else []
        sample = [win.answers[i] for i in sorted(pick)]
        if sample:
            q = queries[torch.as_tensor([a[0] for a in sample],
                                        device=dev)]
            ids = np.stack([np.asarray(a[1], np.int64) for a in sample])
            dists = np.stack([np.asarray(a[2], np.float64) for a in sample])
            numbers.update(answer_numbers(
                q, ids, dists, trained, given, own, lists, traffic["k"],
                traffic["w"]))
            nn = ref.brute_force_nn(q, base).cpu().numpy()
            hit = (ids[:, :10] == nn[:, None]).any(1)
            lines.append(f"recall@10 {float(hit.mean())!r} (nearest point "
                         f"among the first 10 ids, {len(sample)} sampled "
                         f"answers)")
        del base
        work = work_counts(queries, trained, lists, cfg, traffic, win) \
            if use_trace else {}
        lines.append(f"reference {time.perf_counter() - t0:.3f} s over "
                     f"{n} points and {len(sample)} answers of "
                     f"{len(win.answers)} kept")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return numbers, lines, work


def build_numbers(x: torch.Tensor, trained: ref.Trained,
                  given: ref.Stored, own: ref.Stored) -> Dict[str, float]:
    """assign_gap and code_gap of the build under test (`given`) against
    the reference's own build (`own`), over every point, in blocks."""
    a_gap = c_gap = 0.0
    cen = trained.centroids.double()
    d = x.shape[1]
    for s in range(0, x.shape[0], 65536):
        xb = x[s:s + 65536].double()
        ag, ao = given.assign[s:s + 65536], own.assign[s:s + 65536]
        dg = ((xb - cen[ag]) ** 2).sum(1)
        do = ((xb - cen[ao]) ** 2).sum(1)
        a_gap = max(a_gap, compare._rel_gap(dg, do))
        # the codes the reference gives the residual to the GIVEN cell
        r = xb - cen[ag]
        best = ref.encode(x[s:s + 65536], ag, trained, ref.EXACT)
        eg = ((r - ref.decode(given.codes[s:s + 65536],
                              trained.codebooks, d)) ** 2).sum(1)
        eb = ((r - ref.decode(best, trained.codebooks, d)) ** 2).sum(1)
        c_gap = max(c_gap, compare._rel_gap(eg, eb))
    return dict(assign_gap=a_gap, code_gap=c_gap)


def answer_numbers(q: torch.Tensor, ids: np.ndarray, dists: np.ndarray,
                   trained: ref.Trained, given: ref.Stored,
                   own: ref.Stored, lists: ref.Lists, k: int, w: int
                   ) -> Dict[str, float]:
    """probe_gap, dist_err, rank_gap and bad_answers of answers (ids,
    dists) (S, k) to queries q (S, d)."""
    n = given.assign.shape[0]
    cells, cdist = ref.probe(q, trained, w, ref.EXACT)
    best_ids, best = search(q, cells, cdist, own, lists, trained, k,
                                ref.EXACT)
    cells_h = cells.cpu().numpy()
    dw = cdist[:, -1].cpu().numpy()
    probe_gap = dist_err = rank_gap = 0.0
    bad = misses = 0
    cen = trained.centroids.double()
    for i in range(q.shape[0]):
        row = ids[i]
        ok = (row >= 0) & (row < n)
        _, first = np.unique(row, return_index=True)
        dup = np.ones(k, bool)
        dup[first] = False
        full = np.isfinite(best[i]).all()
        if full:
            bad += int((~ok).sum() + (dup & ok).sum())
        kth = max(best[i][np.isfinite(best[i])].max(initial=0.0), 1e-12)
        got = row[ok]
        if got.size == 0:
            continue
        rows = torch.as_tensor(got, device=q.device)
        s = ref.score(q[i], rows, given, trained).cpu().numpy()
        dist_err = max(dist_err, float(
            np.abs(dists[i][ok].astype(np.float64) - s).max() / kth))
        # a returned id misses when its exact score lies beyond the k-th
        # best by more than float64 rounding
        misses += int((s > kth * (1 + 1e-9)).sum()) + (k - got.size)
        gs = np.sort(s)
        bi = best[i][:gs.size]
        fin = np.isfinite(bi)
        if fin.any():
            rank_gap = max(rank_gap, float(
                np.clip(gs[fin] - bi[fin], 0, None).max() / kth))
        gcell = given.assign[rows]
        outside = ~np.isin(gcell.cpu().numpy(), cells_h[i])
        if outside.any():
            dc = ((q[i].double()[None, :] - cen[gcell[torch.as_tensor(
                outside, device=q.device)]]) ** 2).sum(1).cpu().numpy()
            probe_gap = max(probe_gap, float(
                np.clip(dc - dw[i], 0, None).max() / max(dw[i], 1e-12)))
    return dict(probe_gap=probe_gap, dist_err=dist_err, rank_gap=rank_gap,
                miss_share=misses / max(1, k * q.shape[0]),
                bad_answers=float(bad))


def lost_rows(given: ref.Stored, held_ids: np.ndarray, n: int) -> float:
    """Points 0..n-1 not held exactly once, plus ids held that are no
    point: `held_ids` lists every id the store holds."""
    counts = np.bincount(held_ids[(held_ids >= 0) & (held_ids < n)],
                         minlength=n)
    extra = int(((held_ids < 0) | (held_ids >= n)).sum())
    return float((counts != 1).sum() + extra)


def search(q: torch.Tensor, cells: torch.Tensor, cdist: torch.Tensor,
           stored: ref.Stored, lists: ref.Lists, trained: ref.Trained,
           k: int, prec: str):
    """Scan the probed cells and keep the k best -> (ids (B, k) int64, -1
    padded; scores (B, k), +inf padded): float64 scores, ties by id (the
    exact path, the only one the comparison takes)."""
    assert prec == ref.EXACT
    B, d = q.shape
    ids = np.full((B, k), -1, np.int64)
    out = np.full((B, k), np.inf)
    cells_h = cells.cpu().numpy()
    for i in range(B):
        rows_h = lists.rows(cells_h[i])
        if rows_h.size == 0:
            continue
        rows = torch.as_tensor(rows_h, device=q.device)
        s = ref.score(q[i], rows, stored, trained)
        order = np.lexsort((rows_h, s.cpu().numpy()))[:k]
        ids[i, :order.size] = rows_h[order]
        out[i, :order.size] = s.cpu().numpy()[order]
    return ids, out
