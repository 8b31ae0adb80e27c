"""The limiter's tick kernel's share of its roofline, in %: the bound of
one launch (``yardstick_limiter.tick_bound``: the window's mean closers a
tick, from the closings ``rung_chunk`` reports, each with the final state's
mean pairs inside 2 max(h_i, h_j) a row) over the mean device ms a launch
of ``rung_limit_tick`` in the trace. None where no such kernel ran."""
from portbench import yardstick_grav as Y
from portbench import yardstick_limiter as L


def read(run):
    got = Y.device_ms(run, L.tick_op)
    steps = run.counters["steps"]
    if not got or not got[1] or not steps or not run.counters["active"]:
        return None
    closers = run.counters["active"] * run.n / steps
    _, pairs_c = run.pairs()
    ms, _ = L.tick_bound(closers, pairs_c / run.n, run.config["dtype"])
    return 100.0 * ms / (got[0] / got[1])
