"""Idle device ms a step while the host was in the window build
(``sphax_torch.build``). The five idle_*_ms_per_tick.sedov add up to the
idle time between the traced window's device operations
(``portbench/spans.py``)."""
from portbench import spans


def read(run):
    return spans.idle_ms_per_tick(run, "build")
