"""device_ops_per_search.batch

Device operations (kernels, copies, sets) a `search_padded` call
launches, over the traced calls.
"""


def read(run):
    t = run.trace
    return t.device_ops / t.searches \
        if t and t.searches and t.device_ops else None
