"""Share of the traced window in which no operation ran on the device:
1 - (union of device-operation intervals) / traced wall, in %."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
