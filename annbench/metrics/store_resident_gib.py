"""store_resident_gib

`torch.cuda.memory_allocated()` after the warm-up, less the harness's
query pool: what the index keeps resident.
"""


def read(run):
    return run.resident_bytes / 2 ** 30 if run.resident_bytes > 0 else None
