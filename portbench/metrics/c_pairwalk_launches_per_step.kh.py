"""Launches a step of kernel C's pair walk in the 2D cell: the traced
window's device operations whose name holds ``forces_pairs``, over its
steps. 1 where every derived pass takes the pair walk (one derived pass a
step), 0 where kernel C's lanes walk every survivor."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    n = sum("forces_pairs" in name for name, _, _ in t.device)
    return n / run.counters["steps"]
