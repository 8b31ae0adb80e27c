"""Device ms a step of every operation but kernels A and C and the sorts: the
row gathers, packing, copies, reductions and elementwise work around the
pair walks."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    glue = t.total_ms - sum(t.ms.get(k, 0.0)
                            for k in ("kernel A", "kernel C", "sorts"))
    return glue / run.counters["steps"]
