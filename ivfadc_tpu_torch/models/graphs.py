"""CUDA graphs of the dense search, one per shape key.

`IVFADCIndex._device_search` runs its dense route through `SearchGraphs.run`
where the index lives on the current CUDA device and the current stream is
not capturing already. The first call of a key runs eager, which makes the
per-launch set-up outside any capture (the cell-rank scratch, the occupancy
fits, the kernels' shared-memory limits); the second captures the route from
the padded query batch to the finalized results and replays it; later calls
replay. A call then costs the host one query copy, one graph launch and the
copies out.

The graphs of one (device, stream) share one memory pool. One graph's
outputs may then lie where another's intermediates were at its capture, so
a lock per pool keeps each call's copy-in, replay and copy-out together
against every other graph of the pool: the copies out are on the stream
before any other replay, and no caller sees its results change by a later
search. Each graph has a static query buffer whose rows past the call's hold
zeros, as the eager padding makes them.

The store keeps at most `CAP` graphs, the least recently used dropped first,
and drops them all wherever it drops or replaces a cached view. A key that
was dropped for room runs eager again until it has made twice as many eager
calls as before its last capture, so traffic that rotates more keys than
`CAP` captures a key a number of times that grows with the logarithm of its
calls, not with the calls; keys past the last `_SEEN_CAP` seen run eager.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple

import torch

from ivfadc_tpu_torch import _build
from ivfadc_tpu_torch.utils import profiling

# graphs a store keeps: serving's eight buckets from 8 to 1,024 rows for
# four (k, w) pairs. The first graph of a pool holds the route's
# intermediates (0.33 GiB at 10,240 rows, 1.5 GiB at 65,536, d = 128,
# w = 8); each later one adds its static query buffer and outputs, 39 MiB
# at 65,536 rows, 0.6 MiB at 1,024 (on an H100, 17 graphs of 8 to 10,240
# rows beside one of 65,536 added 4 MiB to the reserved memory)
CAP = 32
# keys whose eager calls are counted (the first call's, and a dropped key's)
_SEEN_CAP = 64

_capture_lock = threading.Lock()     # one capture at a time in the process
_capture_streams: dict = {}          # device index -> side stream


def stream_key(dev: torch.device) -> Optional[tuple]:
    """(device, current stream) of a search on `dev` that runs from a graph,
    or None where it runs eager: off the current CUDA device, or while the
    current stream is capturing already."""
    if dev.type != "cuda":
        return None
    cur = torch.cuda.current_device()
    if dev.index not in (None, cur) \
            or torch.cuda.is_current_stream_capturing():
        return None
    return cur, torch.cuda.current_stream().cuda_stream


def stage_host(tensors: Sequence[torch.Tensor]):
    """Copies of card tensors into page-locked buffers of torch's caching
    host allocator, queued on the current stream -> (buffers, an event
    recorded after them). The pageable copy measured several times slower
    behind a replay; the buffers go back to the cache when freed."""
    bufs = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        bufs.append(h)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensors[0].device))
    return bufs, done


class _Pool:
    """The memory pool the graphs of one (device, stream) share, and the
    lock that keeps one call's copy-in, replay and copy-out apart from any
    other graph's. `anchor`, the first graph captured into the pool, keeps
    the pool alive while the store holds it (it is never replayed once
    dropped)."""

    __slots__ = ("lock", "handle", "anchor")

    def __init__(self):
        self.lock = threading.Lock()
        self.handle = self.anchor = None


class _Graph:
    """One captured search. `ready` is set once its capture has ended;
    `graph` stays None if the capture failed. `need`: the eager calls its
    key made before the capture; `plans`: the launch plans its capture
    counted (`profiling.planning`)."""

    __slots__ = ("graph", "q", "outs", "kernels", "plans", "rows", "pin",
                 "pool", "need", "ready")

    def __init__(self, pin, pool: _Pool, need: int = 1):
        self.graph = None
        self.q = self.outs = None
        self.kernels = []
        self.plans = []
        self.rows = 0
        self.pin = pin                 # objects whose ids the key holds
        self.pool = pool
        self.need = need
        self.ready = threading.Event()


def _capture(body: Callable, q: torch.Tensor, pool):
    """Capture body(q) on a side stream of q's device into a new graph in
    `pool` (None: a new pool) -> (graph, outputs, the kernels it launches,
    its pool). Nothing runs: the caller replays."""
    dev = q.device
    graph = torch.cuda.CUDAGraph()
    with _capture_lock:
        side = _capture_streams.get(dev.index)
        if side is None:
            side = _capture_streams[dev.index] = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side), _build.capturing() as kernels, \
                profiling.uncounted():
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outs = body(q)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass                   # the capture was invalidated
                raise
            graph.capture_end()
        cur.wait_stream(side)
    return graph, outs, kernels, graph.pool() if pool is None else pool


class SearchGraphs:
    """A store's captured dense searches by shape key, least recently used
    dropped past `CAP`."""

    def __init__(self):
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        # key -> [eager calls since its first call or its drop, the eager
        # calls it makes before it captures]
        self._seen: "OrderedDict[tuple, list]" = OrderedDict()
        self._pools: dict = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        """Drop every graph and pool (a pool's memory goes once no caller
        holds a graph of it)."""
        with self._lock:
            if self._graphs:
                profiling.count("graph_drops")
            self._graphs.clear()
            self._seen.clear()
            self._pools.clear()

    def _remember(self, key, seen: list) -> None:
        self._seen[key] = seen
        self._seen.move_to_end(key)
        while len(self._seen) > _SEEN_CAP:
            self._seen.popitem(last=False)

    def _entry(self, key, pin) -> Tuple[Optional[_Graph], bool]:
        """(the key's graph, whether this call captures it), or (None,
        False) where the call runs eager."""
        with self._lock:
            g = self._graphs.get(key)
            if g is not None:
                self._graphs.move_to_end(key)
                return g, False
            calls, need = self._seen.pop(key, (0, 1))
            if calls < need:
                self._remember(key, [calls + 1, need])
                return None, False
            pool = self._pools.get(key[-1])
            if pool is None:
                pool = self._pools[key[-1]] = _Pool()
            g = self._graphs[key] = _Graph(pin, pool, need)
            while len(self._graphs) > CAP:
                old_key, old = self._graphs.popitem(last=False)
                self._remember(old_key, [0, 2 * old.need])
            return g, True

    def run(self, key, q: torch.Tensor, padded: int, body: Callable,
            pin=(), after: Optional[Callable] = None, host: bool = False):
        """The search of `key` from its graph -> (ids, dists) of q's rows,
        device tensors or (host) numpy arrays, or None where this call runs
        eager: the key's first calls, or a key whose capture failed. `key`
        ends in `stream_key`'s (device, stream), which names its pool. q
        (rows, d) on the device, the batch before padding; body(static_q
        (padded, d)) -> (ids, dists, ...) over the padded batch;
        after(outputs) runs under the pool's lock after the replay (the
        counters' sums); `pin` holds what the key names by id."""
        g, fresh = self._entry(key, pin)
        if g is None:
            return None
        if not fresh:
            g.ready.wait()
        rows, done = q.shape[0], None
        with g.pool.lock:
            if fresh:
                try:
                    g.q = torch.zeros((padded, q.shape[1]), dtype=q.dtype,
                                      device=q.device)
                    g.q[:rows].copy_(q)
                    g.rows = rows
                    with profiling.planning() as g.plans:
                        g.graph, g.outs, g.kernels, handle = _capture(
                            body, g.q, g.pool.handle)
                    if g.pool.anchor is None:
                        g.pool.handle, g.pool.anchor = handle, g.graph
                except BaseException:
                    with self._lock:
                        if self._graphs.get(key) is g:
                            del self._graphs[key]
                            self._remember(key, [0, 2 * g.need])
                    raise
                finally:
                    g.ready.set()
            elif g.graph is None:
                return None
            else:
                g.q[:rows].copy_(q)
                if rows < g.rows:
                    g.q[rows:g.rows].zero_()
                g.rows = rows
            g.graph.replay()
            _build.credit(g.kernels)
            t = profiling.tally()
            if t is not None:
                t.graph(fresh, g.plans)
            if after is not None:
                after(g.outs)
            outs = (g.outs[0][:rows], g.outs[1][:rows])
            if not host:
                return outs[0].clone(), outs[1].clone()
            if outs[0].is_cuda:
                outs, done = stage_host(outs)
            else:
                outs = [o.clone() for o in outs]
        if done is not None:
            done.synchronize()
        return outs[0].numpy(), outs[1].numpy()
