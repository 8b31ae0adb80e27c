"""Idle device ms a step while the host was in a step's own work, outside its
build and derived pass (``sphax_torch.step``: local_dt, the drift gate and
the KDK step's kicks and drift). The five idle_*_ms_per_tick.sedov add up to
the idle time between the traced window's device operations
(``portbench/spans.py``)."""
from portbench import spans


def read(run):
    return spans.idle_ms_per_tick(run, "integrate")
