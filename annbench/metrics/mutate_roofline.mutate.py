"""mutate_roofline.mutate

A mutation pair's least device time over its device time (`Trace.
mutate_s` a pair). The least time is a lower bound counted from the
problem (`pair_work`): the push reads its points, the centroids and the
codebooks once and writes each new row's codes and 4-byte id once, at
2·d·k' + 2·d·k* operations a point (its nearest cell and its codes); the
delete reads and writes each live point's 4-byte id once (the survivors'
renumbering). Least time = max(bytes / 3.35e12 B/s, operations / 67e12
f32 FLOP/s).
"""

from annbench import roofline

F32_PEAK = 67e12           # NVIDIA H100 SXM, float32 outside tensor cores


def pair_work(cfg: dict, traffic: dict):
    """(bytes, ops) of one push_batch of traffic["push"] points and one
    delete of traffic["delete"] ids over n = the configuration's points."""
    d, n = cfg["data"]["d"], cfg["data"]["n"]
    idx = cfg["index"]
    kc, m, ks = idx["kc"], idx["m"], idx["k"]
    p = traffic["push"]
    push_bytes = 4.0 * d * (p + kc + ks) + p * (m + 4.0)
    push_ops = 2.0 * d * (kc + ks) * p
    delete_bytes = 8.0 * n
    return push_bytes + delete_bytes, push_ops


def read(run):
    t = run.trace
    pairs = sum(m[0] == "delete" for m in run.window.mutations) - 1
    if t is None or t.mutate_s <= 0 or pairs <= 0:
        return None
    nbytes, ops = pair_work(run.config, run.traffic)
    least = max(nbytes / roofline.PEAK_BYTES_S, ops / F32_PEAK)
    return 100.0 * least * pairs / t.mutate_s
