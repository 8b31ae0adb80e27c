"""Idle device ms a tick while the host was in a derived pass's own work,
outside its kernel wrappers (``sphax_torch.derived``: the gathers, packing,
eos, the unsort). The five idle_*_ms_per_tick.rungs add up to the idle time
between the traced window's device operations (``portbench/spans.py``)."""
from portbench import spans


def read(run):
    return spans.idle_ms_per_tick(run, "derived")
