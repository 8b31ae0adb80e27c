"""Idle device ms a tick while the host was in no program span: the chunk's
entry and exit, and the harness. The five idle_*_ms_per_tick.rungs add up to
the idle time between the traced window's device operations
(``portbench/spans.py``)."""
from portbench import spans


def read(run):
    return spans.idle_ms_per_tick(run, "outside")
