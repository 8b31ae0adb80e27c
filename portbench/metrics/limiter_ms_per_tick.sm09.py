"""Device ms a tick of the timestep limiter's kernels (``rung_limit_tick``
and the sync point's ``rung_limit_sync`` of ``sphax_torch/csrc/
rung_limit.cu``): the traced window's device operations whose name holds
``rung_limit``, over its ticks. None where no such kernel ran."""
from portbench import yardstick_grav as Y
from portbench import yardstick_limiter as L


def read(run):
    got = Y.device_ms(run, L.limiter_op)
    if not got or not got[1] or not run.counters["steps"]:
        return None
    return got[0] / run.counters["steps"]
