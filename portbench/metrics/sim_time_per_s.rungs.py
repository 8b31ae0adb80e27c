"""Under block timesteps: simulated time of every chunk completed in the
window (the base dt of each of its ticks, summed), over the window's wall."""


def read(run):
    c = run.counters
    return c["sim_time"] / c["wall"] if c["wall"] > 0 else None
