"""Kernel C's share of its roofline in 2D, in %: the bound of one launch
(yardstick_2d.kernel_c: N particles' inputs and outputs once at D = 2, the
pairs inside 2 max(h_i, h_j) of the final state) over its mean device ms a
launch in the trace."""
from portbench import yardstick_2d


def read(run):
    t = run.trace
    launches = t.launches.get("kernel C", 0) if t is not None else 0
    if not launches:
        return None
    _, pairs_c = yardstick_2d.pairs(run)
    ms, _ = yardstick_2d.kernel_c(run.n, pairs_c, run.config["dtype"])
    return 100.0 * ms / (t.ms["kernel C"] / launches)
