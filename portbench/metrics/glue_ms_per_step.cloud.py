"""Device ms a step of every operation but kernels A and C, the sorts and
the P3M mesh's own operations: the row gathers, packing, copies,
reductions and elementwise work around the pair walks and the FFTs."""
from portbench import yardstick_grav as Y


def read(run):
    t = run.trace
    if t is None or not t.device or not run.counters["steps"]:
        return None
    mesh = Y.device_ms(run, Y.mesh_op)[0]
    glue = t.total_ms - mesh - sum(t.ms.get(k, 0.0)
                                   for k in ("kernel A", "kernel C", "sorts"))
    return glue / run.counters["steps"]
