"""Idle device ms a tick while the host was in a tick's own work, outside its
build and derived pass (``sphax_torch.tick``: the rung start, open_drift,
the drift gate, the closing half-kick and the rung update). The five
idle_*_ms_per_tick.rungs add up to the idle time between the traced window's
device operations (``portbench/spans.py``)."""
from portbench import spans


def read(run):
    return spans.idle_ms_per_tick(run, "integrate")
