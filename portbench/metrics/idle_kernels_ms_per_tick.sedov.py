"""Idle device ms a step while the host was in the wrappers of kernels A and C
(``sphax_torch.kernel_a`` and ``sphax_torch.kernel_c``: packing, checks, the
launch). The five idle_*_ms_per_tick.sedov add up to the idle time between
the traced window's device operations (``portbench/spans.py``)."""
from portbench import spans


def read(run):
    return spans.idle_ms_per_tick(run, "kernels")
