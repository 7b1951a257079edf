"""build_s

`IVFADCIndex.build` wall time, ending at a device sync.
"""


def read(run):
    return run.build_s
