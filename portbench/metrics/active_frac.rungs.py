"""Closing particles a tick over N, in %, as rung_chunk returns it,
averaged over the traced ticks."""


def read(run):
    c = run.counters
    return 100.0 * c["active"] / c["steps"] if c["active"] else None
