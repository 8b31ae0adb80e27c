"""Device ms a step of the P3M mesh's own operations (the FFTs, the
deposit's scatter-add and the k-space solve's complex arithmetic, by the
names ``yardstick_grav.MESH`` freezes): the mesh's integer and real
elementwise work and its gathers share their kernels with the glue and
count there."""
from portbench import yardstick_grav as Y


def read(run):
    got = Y.device_ms(run, Y.mesh_op)
    if not got or not got[1] or not run.counters["steps"]:
        return None
    return got[0] / run.counters["steps"]
