"""Launches a step of kernel C's gravity mode (a ``forces..._kernel``
template of ``sphax_torch/csrc/window_kernels.cu`` whose GRAV argument is
true): 1 where every derived pass fuses the P3M short range into C."""
from portbench import yardstick_grav as Y


def read(run):
    got = Y.device_ms(run, Y.grav_c)
    if got is None or not run.counters["steps"]:
        return None
    return got[1] / run.counters["steps"]
