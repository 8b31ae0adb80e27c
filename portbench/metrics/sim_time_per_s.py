"""Simulated time of every chunk completed in the window (the sum of its
global dts), over the window's wall (host clock from the window's start to
the synchronise after its last chunk)."""


def read(run):
    c = run.counters
    return c["sim_time"] / c["wall"] if c["wall"] > 0 else None
