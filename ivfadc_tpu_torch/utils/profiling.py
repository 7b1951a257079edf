"""Build-phase timing, a profiler trace, search stage spans and search
counters (port of `ivfadc_tpu/utils/profiling.py`, plus `span` and
`counting`).

Phase timings end at a device sync, so the numbers cover the device work
the phase queued, not only its launches.

Search stages: every search names the stage its host is in with `span`,
which records a range only while a torch.profiler records (`trace` is
one); otherwise it is one shared no-op object. The stages, in a search's
order:

  ivfadc.search   each `search` / `search_padded` / `search_stream` call,
                  from entry to the host results
  ivfadc.setup    checks, the query copy and bucket padding, environment
                  reads, route choice, the dense view, the scan chunk, the
                  gather plan and the pos8 gate
  ivfadc.probe    the coarse probe and the scan vectors it yields (the
                  fused kernel, the quantizer's search, the LUT tables)
  ivfadc.tileprep the grouped scan's tile placement, the per-probe scan's
                  slot ranges, the kernels' argument casts; past 4096
                  cells its sort-based ranks and layout in the nested
                  range `ivfadc.tileprep.sort`, which is no stage
  ivfadc.scan     the scan kernels (grouped, qc, per-probe), the gathered
                  engine and the LUT engine's table lookups
  ivfadc.merge    the output reorder, the top-k merges, `finalize`, the
                  batch slice
  ivfadc.graph    a dense search replayed from its CUDA graph
                  (models/graphs.py): the query copy in, the capture on a
                  key's second call, the replay, the copies out and the
                  counters' sums; it stands for probe to merge
  ivfadc.to_host  the device-to-host copy of the results

A stage opened inside another stage records nothing: the outer stage owns
the work (the two-level quantizer's grouped stage 2 is probe work).

Mutations name theirs with spans that are no stage (they nest anywhere):

  ivfadc.push     `push`, `push_front`, `push_batch`: the coarse search and
                  encode of the new points, the store's append (and grows)
  ivfadc.delete   `delete`, `pop`, `pop_front`: the swap-removes and the
                  renumbering on the host and on the views
  ivfadc.flush    the patch of the views' dirty slots at the next view
                  access (models/inverted.py `_flush_dirty`), when there
                  is one: inside a search's `ivfadc.setup`

The ranges are host ranges (torch.profiler's function scope, which puts no
annotation on the device's timeline); a device operation belongs to the
stage its launch, the runtime call with its correlation id, lies in.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import numpy as np
import torch


class BuildTimer:
    """Wall time per named phase, summed over repeated phases. On a CUDA
    `device` each phase starts and ends at a sync of that device."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.timings: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (host and, where there is a card,
    device activity); writes a Chrome trace, `trace.json`, into
    `log_dir`."""
    import os
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


SEARCH = "ivfadc.search"
STAGES = ("ivfadc.setup", "ivfadc.probe", "ivfadc.tileprep", "ivfadc.scan",
          "ivfadc.merge", "ivfadc.graph", "ivfadc.to_host")
_STAGE_SET = frozenset(STAGES)

_profiler_enabled = torch._C._autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast
_open = threading.local()        # .stage: the stage this thread is in,
                                 # .quiet: counting is off (`uncounted`),
                                 # .plans: a capture's plan log (`planning`)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "stage", "rf")

    def __init__(self, name: str):
        self.name = name
        self.stage = name in _STAGE_SET
        self.rf = None

    def __enter__(self):
        if self.stage:
            if getattr(_open, "stage", None) is not None:
                return self               # inside a stage: the outer owns it
            _open.stage = self.name
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
            if self.stage:
                _open.stage = None
        return False


def span(name: str):
    """A named host range while a torch.profiler records, else the shared
    no-op object: no record function, no allocation, no device work. It
    never syncs and reads no device value. Stage names (`STAGES`) do not
    nest: one opened inside another records nothing."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _Span(name)


COUNTS = ("searches", "queries", "padded_queries", "probes",
          "postings_probed", "scan_pairs", "graph_captures", "graph_replays",
          "scan_cache_bytes", "probe_narrow_launches",
          "scan_single_tile_launches", "scan_probe_order_launches",
          "tileprep_sort_launches", "probe_wide_select_launches",
          "pushed_rows", "deleted_rows", "flushed_slots", "view_rebuilds",
          "graph_drops", "cell_grows")
_DEVICE_COUNTS = ("postings_probed", "scan_pairs", "scan_cache_bytes")


class _Tally:
    """The counters of one `counting()` block: host ints, and per device
    one (2,) int64 tensor that the searches add their device sums into."""

    def __init__(self):
        self.host = dict.fromkeys(COUNTS, 0)
        self.dev: Dict[torch.device, torch.Tensor] = {}
        self.lock = threading.Lock()

    def _add(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            acc = self.dev.get(value.device)
            if acc is None:
                with self.lock:
                    acc = self.dev.setdefault(value.device, torch.zeros(
                        len(_DEVICE_COUNTS), dtype=torch.int64,
                        device=value.device))
            acc[_DEVICE_COUNTS.index(name)].add_(value)
        else:
            with self.lock:
                self.host[name] += int(value)

    def search(self, queries: int, padded: int, w: int) -> None:
        """One search of `queries` rows, bucketed to `padded`, w probes a
        row."""
        with self.lock:
            self.host["searches"] += 1
            self.host["queries"] += queries
            self.host["padded_queries"] += padded
            self.host["probes"] += queries * w

    def probed(self, cells, sizes, rows=None) -> None:
        """postings_probed += the probed cells' sizes over the first `rows`
        query rows of `cells` (B, w) (None: every row)."""
        c = cells if rows is None else cells[:rows]
        self._add("postings_probed", sizes[c.to(torch.int64)].sum())

    def scanned(self, pairs) -> None:
        """scan_pairs += `pairs` (an int or a device scalar)."""
        self._add("scan_pairs", pairs)

    def streamed(self, nbytes) -> None:
        """scan_cache_bytes += `nbytes` (an int or a device scalar)."""
        self._add("scan_cache_bytes", nbytes)

    def graph(self, captured: bool, plans=()) -> None:
        """One search run from its CUDA graph: captured, or replayed; each
        name of `plans` (`planning()`'s log of its capture) counts once."""
        self._add("graph_captures" if captured else "graph_replays", 1)
        for name in plans:
            self._add(name, 1)

    def read(self) -> Dict[str, int]:
        out = dict(self.host)
        for acc in self.dev.values():
            for name, v in zip(_DEVICE_COUNTS, acc.tolist()):
                out[name] += v
        return out


_tally: "_Tally | None" = None


def tally():
    """The open `counting()` block's counters, or None: the search path
    counts only `if tally() is not None`. None inside `uncounted()`."""
    if _tally is None or getattr(_open, "quiet", False):
        return None
    return _tally


@contextlib.contextmanager
def uncounted():
    """No counting on this thread inside the block: a CUDA graph's capture
    must not hold the sums of one `counting()` block (the graph's caller
    counts each replay instead)."""
    _open.quiet = True
    try:
        yield
    finally:
        _open.quiet = False


@contextlib.contextmanager
def planning():
    """Log, instead of counting, the launch plans this thread's launches
    count inside the block (a CUDA graph's capture); yields the log, the
    names each replay of the graph counts (`_Tally.graph`)."""
    log: list = []
    _open.plans = log
    try:
        yield log
    finally:
        _open.plans = None


def plans_counted() -> bool:
    """Whether a launch's plan counts on this thread (`planned`): an open
    `counting()` block, or a capture's log. Launch sites ask first, so
    that outside both they look up no plan."""
    return getattr(_open, "plans", None) is not None or tally() is not None


def planned(name: str) -> None:
    """One kernel launch that ran the plan `name` counts
    (`probe_narrow_launches`, `scan_single_tile_launches`,
    `scan_probe_order_launches`, `tileprep_sort_launches`,
    `probe_wide_select_launches`): logged inside
    `planning()`, else added to the open `counting()` block, if any."""
    log = getattr(_open, "plans", None)
    if log is not None:
        log.append(name)
    else:
        t = tally()
        if t is not None:
            t._add(name, 1)


def count(name: str, n: int = 1) -> None:
    """Add n to the open `counting()` block's host counter `name`, if any
    (the mutation path's counters)."""
    t = tally()
    if t is not None:
        t._add(name, n)


@contextlib.contextmanager
def counting():
    """Count the searches run inside the block; yields a dict that holds,
    once the block ends, Python ints:

      searches, queries, padded_queries (the bucketed batch rows), probes
                      (queries x w)
      postings_probed the probed cells' sizes summed over the real (not
                      padding) query rows: the (query, posting) pairs the
                      problem needs (`probe_stats`'
                      scanned_postings_per_query x queries)
      scan_pairs      the (probe slot, row) pairs the scan scores, from
                      each route's own loop bounds, padding rows included:
                      grouped and qc scans sum_c ceil(n_c / h) * h *
                      size_c over the probed cells (n_c probes in cell c,
                      h = tile_height(pb) slots a tile, empty slots
                      included: the sum over the tiles of tile_size * h);
                      per-probe scan sum over probes of the cell's size;
                      gathered engine probes x window; LUT engine probes x
                      window
      graph_captures, graph_replays
                      dense searches run from a CUDA graph (models/
                      graphs.py): captured (a key's second call), replayed
                      (every later call); the other counts read the same
                      as on the eager path
      scan_cache_bytes
                      decoded-cache bytes the dense routes' scans stream:
                      the rows each tile (grouped, qc), probe (per probe)
                      or gathered window reads, times the cache's row
                      bytes (d_pad x 1 for int8, x 2 for bf16); grouped
                      and qc scans sum_c ceil(n_c / h) * size_c rows
      probe_narrow_launches
                      coarse-kernel launches (kernels 1, 7, 10) that ran
                      16-query tiles (coarse_scan.plan's `narrow`), for
                      whatever reason: the wider tiles fit every d, so
                      only a batch too small to fill them leads there
      scan_single_tile_launches
                      grouped-scan launches (kernel 3 and its variants,
                      the qc kernel) planned with one staged bf16 tile
                      because two do not fit the card's shared memory
                      (int8 cache at d_pad = 1024, pb = 64)
      scan_probe_order_launches
                      grouped-scan launches (kernel 3 and its variants,
                      the qc kernel) whose slot map writes each probe's
                      row at the probe's index (the tile prep's inv_row:
                      fewer output rows than slots), so no gather follows;
                      0 where a caller asks for tile order (`dense_scan.
                      tile_order`)
      tileprep_sort_launches
                      grouped tile preps that ranked their probes by one
                      sort (`dense_scan.sort_ranks` and `cell_rank.
                      tile_layout`) instead of the counting kernel: one a
                      grouped scan over more than MAX_KC = 4096 cells (or
                      a two-level stage 2's groups), 1 a grouped search of
                      such an index, else 0; the same tensor code runs on
                      the CPU, so it counts there too
      probe_wide_select_launches
                      coarse-kernel launches (kernels 1, 7, 10) planned on
                      the large-w selection (coarse_scan.plan's `wide`:
                      w > 32, each warp owning its rows' lists): 1 a
                      search at w = 64, 0 at w <= 32
      pushed_rows, deleted_rows
                      points the index's `push`, `push_front` and
                      `push_batch` added; ids its `delete`, `pop` and
                      `pop_front` removed
      flushed_slots   slots a view patch (models/inverted.py
                      `_flush_dirty`) wrote, counted once whatever the
                      number of views
      view_rebuilds   events that dropped a built view for a rebuild:
                      `_invalidate` calls that found one, grows that could
                      not move a view's rows in place, a switch of the
                      dense view's cache type
      graph_drops     `SearchGraphs.clear` calls that dropped at least one
                      captured search
      cell_grows      cells relocated to double their capacity

    Inside, each search adds device-side sums into one small tensor per
    device, read once (one sync) when the block ends; the five launch
    counts are host ints, and all but `tileprep_sort_launches` read 0
    where no kernel launches (the plain versions on the CPU). Outside any block the
    counters launch nothing and allocate nothing. Searches on any
    thread count; blocks do not nest. The sharded views count their
    scans' postings and pairs, padding rows included, not their
    searches."""
    global _tally
    if _tally is not None:
        raise RuntimeError("counting() blocks do not nest")
    t = _tally = _Tally()
    counts: Dict[str, int] = {}
    try:
        yield counts
    finally:
        _tally = None
        counts.update(t.read())


class SearchStats:
    """Counters a serving layer aggregates; `record` takes a lock, since
    dispatch threads record concurrently (serving.py)."""

    def __init__(self):
        self.queries = 0
        self.batches = 0
        self.seconds = 0.0
        self._lock = threading.Lock()

    def record(self, batch: int, seconds: float) -> None:
        with self._lock:
            self.queries += batch
            self.batches += 1
            self.seconds += seconds

    @property
    def qps(self) -> float:
        return self.queries / self.seconds if self.seconds else 0.0


def probe_stats(index, queries, w: int) -> Dict[str, float]:
    """Per-query work counters at probe width w: the postings the scan
    touches, the slots it spans (padding included), the share of the
    database scanned and the largest probed cell."""
    q = torch.as_tensor(np.asarray(queries, np.float32), device=index.device)
    w_eff = min(w, index.config.kc)
    cells, _ = index.coarse.search(q, w_eff)
    cells_h = cells.cpu().numpy()
    sizes = np.asarray(index.store.sizes)[cells_h]          # (B, w)
    caps = np.asarray(index.store.caps)[cells_h]
    n = max(1, len(index))
    return {
        "nprobe": float(w_eff),
        "scanned_postings_per_query": float(sizes.sum(1).mean()),
        "scanned_slots_per_query": float(caps.sum(1).mean()),
        "scan_selectivity": float(sizes.sum(1).mean() / n),
        "max_cell_in_probe": float(sizes.max(initial=0)),
    }
