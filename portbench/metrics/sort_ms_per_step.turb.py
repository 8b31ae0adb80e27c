"""Device ms a step of the sorts (the window build's radix sorts)."""


def read(run):
    t = run.trace
    if t is None or not t.device or not t.ms.get("sorts"):
        return None
    return t.ms["sorts"] / run.counters["steps"]
