"""device_peak_gib

`torch.cuda.max_memory_allocated()` over the window, the peak reset
after the warm-up and the harness's base points freed: the resident
index plus the search workspace.
"""


def read(run):
    return run.peak_bytes / 2 ** 30
