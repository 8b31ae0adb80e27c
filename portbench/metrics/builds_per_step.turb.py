"""Window builds a step in the traced window: the builds wengine.simulate
returns under the drift gate, one per 2 steps at the fixed cadence."""


def read(run):
    c = run.counters
    return c["builds"] / c["steps"] if c["steps"] else None
