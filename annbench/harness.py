"""One run of one cell: inputs from the seed, the build, the warm-up, the
measured window, then the comparison that decides `correct`.

The program is used only through its public API: `IVFADCIndex.build`,
`search_padded`, `build_timings`, and the index's trained tables and
store, which the comparison reads after the window.
No `IVFADC_*` variable is set, so every cell runs the default routes.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from annbench import datagen, roofline, specs, trace
from annbench.reference import compare
from annbench.reference import ivfadc as ref
from annbench.reference import train
from annbench.window import Window


@dataclass
class Ctx:
    """What a driver drives."""
    index: object
    queries: torch.Tensor            # (pool, d) on the device
    queries_host: np.ndarray         # the same, float32 on the host
    traffic: dict
    seed: int


@dataclass
class Run:
    """What the metric readers read."""
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    build_s: float
    build_timings: Dict[str, float]
    resident_bytes: int
    peak_bytes: int
    window: Window
    trace: Optional[trace.Trace] = None
    work: Dict[str, tuple] = field(default_factory=dict)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free_memory(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _memory(dev, what: str) -> int:
    if dev.type != "cuda":
        return 0
    return int(getattr(torch.cuda, what)(dev))


def trained_of(index) -> ref.Trained:
    """Copies of the program's trained tables."""
    return ref.Trained(
        centroids=index.coarse.centroids.detach().float().clone(),
        codebooks=index.quantizer.codebooks.detach().float().clone())


def train_generator(seed: int, dev, stream: int = datagen.STREAM_TRAIN
                    ) -> torch.Generator:
    """The generator of the reference's own training in a run of `seed`."""
    g = torch.Generator(device=dev)
    g.manual_seed(datagen.sub_seed(seed, stream))
    return g


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


def load(cell_name: str, overrides: Optional[dict] = None):
    """(cell, config, traffic, check) of a cell; `overrides` ({"data",
    "index", "traffic", "check"} dicts) are merged over the files."""
    ov = overrides or {}
    cell = specs.cell(cell_name)
    cfg = specs.config(cell["config"])
    cfg = {**cfg, "data": {**cfg["data"], **ov.get("data", {})},
           "index": {**cfg["index"], **ov.get("index", {})}}
    traffic = {**specs.traffic(cell["traffic"]), **ov.get("traffic", {})}
    check = {**cell["check"], **ov.get("check", {})}
    check["limits"] = {**cell["check"]["limits"],
                       **ov.get("check", {}).get("limits", {})}
    return cell, cfg, traffic, check


def build(cfg: dict, traffic: dict, seed: int, dev):
    """Inputs from the seed and the index over them; the base points are
    freed before it returns. -> (index, queries, queries on the host, n,
    build seconds, build phases)."""
    from ivfadc_tpu_torch import IVFADCIndex

    base, queries = datagen.make_inputs(cfg, traffic, seed, dev)
    queries_host = queries.cpu().numpy()
    n = base.shape[0]
    kw = dict(cfg["index"])
    kw["seed"] = datagen.sub_seed(seed, datagen.STREAM_CONFIG) % (1 << 31)
    _sync(dev)
    t0 = time.perf_counter()
    index = IVFADCIndex.build(base, device=dev, **kw)
    _sync(dev)
    build_s = time.perf_counter() - t0
    timings = dict(index.build_timings)
    del base
    free_memory(dev)
    return index, queries, queries_host, n, build_s, timings


def run(cell_name: str, seed: int, seconds: float, use_trace: bool, *,
        t_start: float, device=None, overrides: Optional[dict] = None,
        hooks: Optional[dict] = None):
    """One run -> (result line dict, lines for standard error). `device`
    None means the card. `overrides` ({"data", "index", "traffic",
    "check"} dicts merged over the files) and `hooks` ({"after_build":
    f(index)}, which the tests use to break the timed path) exist for the
    CPU tests."""
    hooks = hooks or {}
    cell, cfg, traffic, check = load(cell_name, overrides)
    dev = torch.device(device or "cuda")
    drv = specs.driver(traffic["driver"])
    index, queries, queries_host, n, build_s, timings = build(
        cfg, traffic, seed, dev)
    if "after_build" in hooks:
        hooks["after_build"](index)
    ctx = Ctx(index, queries, queries_host, traffic, seed)
    drv.warm(ctx)
    _sync(dev)
    resident = _memory(dev, "memory_allocated") - \
        queries.numel() * queries.element_size()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # what set-up made stays alive through the window: frozen, the
    # collector's full passes in the window do not walk it again
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    tr = None
    if use_trace:
        def span():
            return torch.profiler.record_function(trace.SEARCH_SPAN)

        with trace.profiled() as h:
            win = drv.run(ctx, min(seconds, traffic["trace_seconds"]), span)
        layer_map = specs.layer_map(cfg["layers"])
        tr = trace.read(h.prof, h.wall_s, layer_map)
        info = [f"trace: {tr.searches} searches, {tr.device_ops} device ops, "
                f"layers {tr.layer_s!r}"]
        info += [f"trace: second search's ops: "
                 + " | ".join(k[:48] for k in tr.first_search)]
    else:
        info = []
        win = drv.run(ctx, seconds)
    _sync(dev)
    peak = _memory(dev, "max_memory_allocated")
    gc.unfreeze()

    # ---- after the window: the program's results, then its state freed
    trained = trained_of(index)
    given, held = stored_of(index, n, dev)
    del ctx, index
    free_memory(dev)
    info += window_lines(win)
    numbers, lines, work = judge(cfg, traffic, check, seed, dev, queries,
                                 trained, given, held, win, use_trace)
    limits = check["limits"]
    correct = (compare.judge(numbers, limits) and win.failed == 0
               and win.completed > 0 and bool(win.answers))
    rec = Run(cell=cell, config=cfg, traffic=traffic, setup_s=setup_s,
              build_s=build_s, build_timings=timings,
              resident_bytes=resident, peak_bytes=peak, window=win,
              trace=tr, work=work)
    section = "per_layer" if use_trace else "end_to_end"
    metrics = {}
    for m in specs.cell_metrics(cell_name, section):
        value = specs.metric(m["name"]).read(rec)
        if value is not None and np.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics,
              "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in tr.top_ops],
            "idle_gaps": [[k, v] for k, v in tr.idle_gaps]}
    result["checks"] = {name: {"value": numbers.get(name, float("nan")),
                               "limit": limits[name]} for name in limits}
    lines = info + [f"build {build_s!r} s, phases {timings!r}",
                    f"setup {setup_s!r} s, peak {peak} bytes, resident "
                    f"{resident} bytes"] + lines
    lines += [f"reading {name} {value!r} (not compared: no control reads "
              f"it 3x above the program)"
              for name, value in numbers.items() if name not in limits]
    lines += [f"check {name} {numbers.get(name, float('nan'))!r} limit "
              f"{limits[name]!r}" for name in limits]
    return result, lines


def window_lines(win: Window) -> list:
    """How the window went, for standard error."""
    return [f"window: {win.attempted} queries sent, {win.completed} "
            f"answered, {win.failed} failed, {win.elapsed_s!r} s, "
            f"{win.searches} driver calls, {len(win.answers)} answers kept"]


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
        mine = train.train(base, cfg["index"], train_generator(seed, dev))
        numbers = compare.train_numbers(base, trained, mine)
        del mine
        own = ref.build(base, trained, ref.EXACT)
        numbers["lost_rows"] = compare.lost_rows(given, held, n)
        numbers.update(compare.build_numbers(base, trained, given, own))
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
            numbers.update(compare.answer_numbers(
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
