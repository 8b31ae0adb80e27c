"""Kernel A's share of its roofline, in %: the bound of one launch
(yardstick.kernel_a: N particles' inputs and outputs once, the Newton walks
and the final walk over the pairs inside 2 h_i of the final state) over its
mean device ms a launch in the trace."""
from portbench import yardstick


def read(run):
    t = run.trace
    launches = t.launches.get("kernel A", 0) if t is not None else 0
    if not launches:
        return None
    sph = run.config["sph"]
    pairs_a, _ = run.pairs()
    ms, _ = yardstick.kernel_a(run.n, pairs_a, sph["newton_iters"],
                               sph["balsara"], run.config["dtype"])
    return 100.0 * ms / (t.ms["kernel A"] / launches)
