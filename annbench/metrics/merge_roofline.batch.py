"""merge_roofline.batch

The merge's least time over its device time: its results (an id and a
distance each) written once.
"""

from annbench import roofline


def read(run):
    return roofline.layer_share(run, "merge", "bf16")
