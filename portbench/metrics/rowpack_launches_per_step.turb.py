"""Launches a step of the derived pass's row-packing kernels
(``sphax_torch/csrc/rowpack.cu``): the traced window's device operations
whose name holds ``rowpack_``, over its steps. 3 where every derived pass
takes them (one derived pass a step), 0 where the torch gathers and
concatenations they replaced run instead."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    n = sum("rowpack_" in name for name, _, _ in t.device)
    return n / run.counters["steps"]
