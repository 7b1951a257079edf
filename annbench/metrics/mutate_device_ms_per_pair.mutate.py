"""mutate_device_ms_per_pair.mutate

Device time of the mutations a pair (one `push_batch` and one `delete`):
the device operations launched inside the harness's `annbench.mutate`
spans (`Trace.mutate_s`), in ms, over the window's pairs (its `delete`
entries less the warm-up's one). The views' patch at the next search is
search time, not this.
"""


def read(run):
    t = run.trace
    pairs = sum(m[0] == "delete" for m in run.window.mutations) - 1
    if t is None or t.mutate_s <= 0 or pairs <= 0:
        return None
    return 1e3 * t.mutate_s / pairs
