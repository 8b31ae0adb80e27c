"""Kernel C's share of its roofline in its gravity mode, in %: the bound of
one launch (yardstick_grav.kernel_c_grav: N particles' inputs and outputs
once, the pairs inside 2 max(h_i, h_j) and inside the cutoff of the final
state) over the mean device ms a launch of the mode in the trace."""
from portbench import yardstick_grav as Y


def read(run):
    got = Y.device_ms(run, Y.grav_c)
    if not got or not got[1]:
        return None
    _, pairs_c, pairs_cut = Y.pairs(run)
    ms, _ = Y.kernel_c_grav(run.n, pairs_c, pairs_cut, run.config["dtype"])
    return 100.0 * ms / (got[0] / got[1])
