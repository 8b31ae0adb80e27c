"""Closers whose rung the timestep limiter lowered, over the closings of
the limiter's ticks, in %: the program's counter
``sphax_torch.integrate.rungs.LIMITED["sums"]`` [lowered, closings],
summed over the process's limited ticks (the set-up's warm-up chunk and the
window), read once after the window. None where the program keeps no such
counter or ran no limited tick."""


def read(run):
    from sphax_torch.integrate import rungs

    sums = getattr(rungs, "LIMITED", {}).get("sums")
    if sums is None:
        return None
    lowered, closings = (int(v) for v in sums.tolist())
    return 100.0 * lowered / closings if closings else None
