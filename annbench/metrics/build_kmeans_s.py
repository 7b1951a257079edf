"""build_kmeans_s

The build's `coarse_kmeans` phase (`build_timings`, bounded by device
syncs).
"""


def read(run):
    return run.build_timings.get("coarse_kmeans")
