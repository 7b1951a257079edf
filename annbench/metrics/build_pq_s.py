"""build_pq_s

The build's `train_quantizer` and `encode` phases (`build_timings`).
"""


def read(run):
    bt = run.build_timings
    if "train_quantizer" not in bt:
        return None
    return bt["train_quantizer"] + bt.get("encode", 0.0)
