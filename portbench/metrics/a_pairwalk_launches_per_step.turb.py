"""Launches a step of kernel A's pair walk (``sphax_torch/csrc/
window_kernels.cu``: the 3D walk that tests every row against every staged
survivor, then gives each lane only its own row's pairs): the traced
window's device operations whose name holds ``solve_h_density_pairs``, over
its steps. 1 where every derived pass takes the pair walk (one derived pass
a step), 0 where kernel A's lanes walk every survivor."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    n = sum("solve_h_density_pairs" in name for name, _, _ in t.device)
    return n / run.counters["steps"]
