"""tileprep_ms_per_search.batch

Device time of the tile prep (the rank kernel, the layout copies and the
gathers, by the configuration's layer map) a search.
"""


def read(run):
    t = run.trace
    s = t.layer_s.get("tileprep") if t else None
    return 1e3 * s / t.searches if s and t.searches else None
