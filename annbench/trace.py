"""Reading a torch.profiler trace of the measured window.

Device busy time is the union of the device operations' intervals, a
layer's time is the summed time of the kernels its layer map assigns to
it, and each idle gap of the device is named by the innermost host
operation running at its middle. A driver that mutates the index wraps
each mutation in a `MUTATE_SPAN`: the device operations launched inside
one (matched to their launch by correlation id, as `stages.py` does; by
their start where no launch is seen) go to no search's layers, and their
summed time is `mutate_s`. A trace without such spans is read as before.
"""

from __future__ import annotations

import bisect
import re
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SEARCH_SPAN = "annbench.search"
MUTATE_SPAN = "annbench.mutate"
# the harness's own spans, which also show on the device's timeline as
# annotations: no device operations
SPANS = (SEARCH_SPAN, MUTATE_SPAN)


@dataclass
class Trace:
    """What the readers of per-layer metrics get from a traced window."""
    window_s: float
    busy_s: float
    device_ops: int                       # kernels, copies and sets
    layer_s: Dict[str, float]             # layer -> summed kernel seconds
    searches: int                         # harness search spans (batch)
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    first_search: List[str] = field(default_factory=list)   # kernel order
    mutate_s: float = 0.0                 # device seconds of mutations


@contextmanager
def profiled():
    """torch.profiler over the block, host and device activity; yields a
    holder whose `.prof` and `.wall_s` are set when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    class Holder:
        prof = None
        wall_s = 0.0

    h = Holder()
    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield h
        if card:
            torch.cuda.synchronize()
        h.wall_s = time.perf_counter() - t0
    h.prof = prof


def classify(name: str, rules: list, nth: int, seen: set
             ) -> Optional[str]:
    """The layer of a kernel: the first rule whose `match` (a regular
    expression) finds the name, where the rule lists `nth`, whose list
    holds this launch's rank among the kernels of that name in its search
    (1-based), and where it names an `after` pattern, once a kernel of
    that pattern has run in the search (`seen`: the `after` patterns met
    so far)."""
    for rule in rules:
        if re.search(rule["match"], name) and (
                "nth" not in rule or nth in rule["nth"]) and (
                "after" not in rule or rule["after"] in seen):
            return rule["layer"]
    return None


def _is_device(e) -> bool:
    from torch.autograd import DeviceType
    return getattr(e, "device_type", None) == DeviceType.CUDA


def read(prof, wall_s: float, layer_map: dict, top: int = 10) -> Trace:
    """Reduce a profiler to a `Trace` under `layer_map` ({"rules": [...]};
    kernels no rule matches count as "other")."""
    events = prof.events()
    devs = sorted((e for e in events
                   if _is_device(e) and e.name not in SPANS),
                  key=lambda e: e.time_range.start)
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in devs]
    host = [e for e in events if not _is_device(e)]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in host if e.name == SEARCH_SPAN)
    mutating = _mutation_ops(devs, host)
    # busy: union of device intervals
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    # layer time: launches ranked by name within their search span
    starts = [s for s, _ in spans]
    rank: Dict[Tuple[int, str], int] = {}
    layer_s: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    first = []
    afters = {r["after"] for r in layer_map["rules"] if "after" in r}
    seen: Dict[int, set] = {}
    mutate = 0.0
    for j, (s, e, name) in enumerate(dev):
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        if j in mutating:
            mutate += (e - s) / 1e6
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i == 1 and spans[1][0] <= s <= spans[1][1]:
            first.append(name)
        key = (i, name)
        rank[key] = rank.get(key, 0) + 1
        met = seen.setdefault(i, set())
        layer = classify(name, layer_map["rules"], rank[key], met) \
            or "other"
        met.update(a for a in afters if re.search(a, name))
        layer_s[layer] = layer_s.get(layer, 0.0) + (e - s) / 1e6
    # idle gaps: named by the innermost host op at the gap's middle
    host_iv = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in host if e.name != SEARCH_SPAN)
    host_starts = [h[0] for h in host_iv]
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        j = bisect.bisect_right(host_starts, mid)
        label = "host outside torch ops"
        for h0, h1, hname in reversed(host_iv[max(0, j - 256):j]):
            if h1 >= mid:            # the latest start that covers mid
                label = hname
                break
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    return Trace(
        window_s=wall_s, busy_s=busy / 1e6, device_ops=len(dev),
        layer_s=layer_s, searches=len(spans),
        top_ops=sorted(by_name.items(), key=lambda t: -t[1])[:top],
        idle_gaps=sorted(idle.items(), key=lambda t: -t[1])[:top],
        first_search=first, mutate_s=mutate)


def _mutation_ops(devs: list, host: list) -> set:
    """Positions in `devs` of the device operations launched inside a
    `MUTATE_SPAN`: by the host launch that carries the operation's
    correlation id, or by the operation's start where none does."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in host if e.name == MUTATE_SPAN)
    if not spans:
        return set()
    starts = [s for s, _ in spans]
    ids = {getattr(e, "id", None) for e in devs}
    launch = {e.id: e.time_range.start for e in host
              if e.name.startswith("cu") and getattr(e, "id", None) in ids}

    def inside(t) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][1]

    return {j for j, e in enumerate(devs)
            if inside(launch.get(getattr(e, "id", None), e.time_range.start))}
