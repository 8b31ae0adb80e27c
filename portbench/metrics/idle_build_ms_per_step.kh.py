"""Idle device ms a step while the host was in the window build
(``sphax_torch.build``: its host synchronisations and launches), from the
split of the traced window's idle time by program span
(``portbench/spans.py``)."""
from portbench import spans


def read(run):
    return spans.idle_ms_per_tick(run, "build")
