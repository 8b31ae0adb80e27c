"""Kernel A's share of its roofline in 2D, in %: the bound of one launch
(yardstick_2d.kernel_a: N particles' inputs and outputs once at D = 2, the
Newton walks and the final walk over the pairs inside 2 h_i of the final
state) over its mean device ms a launch in the trace."""
from portbench import yardstick_2d


def read(run):
    t = run.trace
    launches = t.launches.get("kernel A", 0) if t is not None else 0
    if not launches:
        return None
    pairs_a, _ = yardstick_2d.pairs(run)
    ms, _ = yardstick_2d.kernel_a(run.n, pairs_a,
                                  run.config["sph"]["newton_iters"],
                                  run.config["dtype"])
    return 100.0 * ms / (t.ms["kernel A"] / launches)
