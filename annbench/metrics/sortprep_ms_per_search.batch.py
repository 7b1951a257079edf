"""sortprep_ms_per_search.batch

Device time of the sort-based tile prep (the radix sort and the
searchsorted kernels of `ops/dense_scan.py` `sort_ranks` and
`ops/cell_rank.py` `tile_layout`, by the configuration's layer map) a
search. Nothing to read where the map has no such layer or no search
took the sort route (kc <= 4096).
"""


def read(run):
    t = run.trace
    s = t.layer_s.get("sortprep") if t else None
    return 1e3 * s / t.searches if s and t.searches else None
