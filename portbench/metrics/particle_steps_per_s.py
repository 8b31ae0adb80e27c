"""N x steps completed in the window, over the window's wall (host clock
from the window's start to the synchronise after its last chunk)."""


def read(run):
    c = run.counters
    return run.n * c["steps"] / c["wall"] if c["wall"] > 0 else None
