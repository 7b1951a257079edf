"""setup_s

Set-up: from the process's start to the window (imports, inputs, build,
kernel build on a first run, warm-up).
"""


def read(run):
    return run.setup_s
