"""Device ms of kernels A and C over the traced ticks (a global step counts
as a tick)."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    ac = t.ms.get("kernel A", 0.0) + t.ms.get("kernel C", 0.0)
    return ac / run.counters["steps"] if ac > 0 else None
