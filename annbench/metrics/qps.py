"""qps

Every query answered in the window over the window's whole time; each
call ends in `search_padded`'s numpy results, so the copy to the host
is inside it.
"""


def read(run):
    w = run.window
    return w.completed / w.elapsed_s if w.elapsed_s > 0 else None
