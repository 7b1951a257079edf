"""The program's search stages in a traced window.

The port names the stage its host is in with host ranges
(`ivfadc_tpu_torch/utils/profiling.py`): `ivfadc.search` around each call,
and inside it `ivfadc.setup`, `.probe`, `.tileprep`, `.scan`, `.merge` and
`.to_host`, which never nest. A device operation belongs to the stage its
launch lies in: the host's runtime call (`cudaLaunchKernel`,
`cudaMemcpyAsync`, ...) that carries the operation's correlation id. The
device operations are `trace.read`'s (every device event but the
harness's search annotation), so the stages' seconds and `outside_s` sum
to its per-operation sums.

Not yet read by a metric: the accepted harness keeps only `trace.read`'s
reduction of the profiler, and runs no counting pass.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from annbench.trace import SEARCH_SPAN, _is_device

PREFIX = "ivfadc."
SEARCH = "ivfadc.search"
TO_HOST = "ivfadc.to_host"


@dataclass
class Stages:
    """Seconds of a traced window by program stage."""
    span_s: Dict[str, float]          # stage -> device seconds of its ops
    outside_s: float                  # device seconds launched outside
    unmatched_ops: int                # device ops with no launch found
    searches: int                     # `ivfadc.search` spans
    issue_s: float                    # host: search start to to_host start
    idle_s: float                     # device idle gaps in the window
    idle_in_program_s: float          # gaps whose middle is in an ivfadc span
    idle_by_stage: List[Tuple[str, float]] = field(default_factory=list)


def _innermost(ivs, starts, t):
    """The name of the latest-starting interval of `ivs` that covers t,
    or None."""
    j = bisect.bisect_right(starts, t)
    for s, e, name in reversed(ivs[max(0, j - 64):j]):
        if e >= t:
            return name
    return None


def read(prof) -> Stages:
    """Reduce a profiler (`prof.events()`) to `Stages`."""
    events = prof.events()
    dev = sorted(((e.time_range.start, e.time_range.end, e.id)
                  for e in events if _is_device(e)
                  and e.name != SEARCH_SPAN
                  and not e.name.startswith(PREFIX)), key=lambda t: t[0])
    host = [e for e in events if not _is_device(e)]
    ids = {i for _, _, i in dev}
    launch = {e.id: e.time_range.start for e in host
              if e.name.startswith("cu") and e.id in ids}
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in host if e.name.startswith(PREFIX))
    stages = [s for s in spans if s[2] != SEARCH]
    st_starts = [s[0] for s in stages]
    span_s: Dict[str, float] = {}
    outside = 0.0
    unmatched = 0
    for s, e, i in dev:
        t = launch.get(i)
        if t is None:
            unmatched += 1
            outside += (e - s) / 1e6
            continue
        name = _innermost(stages, st_starts, t)
        if name is None:
            outside += (e - s) / 1e6
        else:
            key = name[len(PREFIX):]
            span_s[key] = span_s.get(key, 0.0) + (e - s) / 1e6
    # issue: each search's host time up to its copy of the results
    searches = [s for s in spans if s[2] == SEARCH]
    to_host = sorted(s[0] for s in stages if s[2] == TO_HOST)
    issue = 0.0
    for s0, s1, _ in searches:
        j = bisect.bisect_left(to_host, s0)
        if j < len(to_host) and to_host[j] <= s1:
            issue += (to_host[j] - s0) / 1e6
    # idle gaps of the device, each put down to the span at its middle
    gaps, cur_e = [], None
    for s, e, _ in dev:
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    sp_starts = [s[0] for s in spans]
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        name = _innermost(spans, sp_starts, 0.5 * (g0 + g1))
        key = "outside" if name is None else name[len(PREFIX):]
        idle[key] = idle.get(key, 0.0) + (g1 - g0) / 1e6
    idle_s = sum(idle.values())
    return Stages(
        span_s=span_s, outside_s=outside, unmatched_ops=unmatched,
        searches=len(searches), issue_s=issue, idle_s=idle_s,
        idle_in_program_s=idle_s - idle.get("outside", 0.0),
        idle_by_stage=sorted(idle.items(), key=lambda t: -t[1]))
