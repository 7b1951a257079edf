"""device_ms_per_search.batch

Device busy time a `search_padded` call over the traced calls: the union
of the device intervals over the calls. Steadier than `qps`, which the
shared host's jitter moves: it reads the kernels' gains alone.
"""


def read(run):
    t = run.trace
    return 1e3 * t.busy_s / t.searches if t and t.searches and t.busy_s \
        else None
