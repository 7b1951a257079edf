"""device_idle_share.batch

Share of the traced window in which no device operation ran: 1 - the
union of the device intervals over the window.
"""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
