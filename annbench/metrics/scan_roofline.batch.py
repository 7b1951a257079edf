"""scan_roofline.batch

The scan's least time over its device time: each probed posting read
once a batch in stored form (m code bytes and its id), 2*d operations a
(query, posting) pair, against the int8 dense peak (1979 TOP/s).
"""

from annbench import roofline


def read(run):
    return roofline.layer_share(run, "scan", "int8")
