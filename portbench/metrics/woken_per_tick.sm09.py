"""Rows the wake-up shortened a tick: the program's counter
``sphax_torch.integrate.rungs.WOKEN`` (the rows, on the device, and the
limited ticks, on the host), summed over the process's limited ticks (the
set-up's warm-up chunk and the window), read once after the window. None
where the program keeps no such counter or ran no limited tick."""


def read(run):
    from sphax_torch.integrate import rungs

    book = getattr(rungs, "WOKEN", {})
    sums, ticks = book.get("sums"), book.get("ticks", 0)
    if sums is None or not ticks:
        return None
    return int(sums.sum()) / ticks
