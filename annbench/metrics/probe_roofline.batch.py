"""probe_roofline.batch

The probe's least time over its device time: queries and the centroids
it needs read once, 2*d operations a (query, centroid) pair it must
score, against the bf16 dense peak (989 TFLOP/s; a bf16 split reaches
float32 accuracy on it).
"""

from annbench import roofline


def read(run):
    return roofline.layer_share(run, "probe", "bf16")
