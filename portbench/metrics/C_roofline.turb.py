"""Kernel C's share of its roofline, in %: the bound of one launch
(yardstick.kernel_c: N particles' inputs and outputs once, the pairs inside
2 max(h_i, h_j) of the final state) over its mean device ms a launch in the
trace."""
from portbench import yardstick


def read(run):
    t = run.trace
    launches = t.launches.get("kernel C", 0) if t is not None else 0
    if not launches:
        return None
    _, pairs_c = run.pairs()
    ms, _ = yardstick.kernel_c(run.n, pairs_c, run.config["sph"]["balsara"],
                               run.config["dtype"])
    return 100.0 * ms / (t.ms["kernel C"] / launches)
