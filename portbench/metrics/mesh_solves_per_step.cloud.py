"""Mesh solves a step in the traced window: the program's
``sphax_torch.mesh`` spans around ``pm.mesh_accel``, over the window's
steps. None where the program has no such span."""


def read(run):
    t = run.trace
    if t is None or not run.counters["steps"]:
        return None
    n = sum(1 for name, _, _ in t.host if name == "sphax_torch.mesh")
    return n / run.counters["steps"] if n else None
