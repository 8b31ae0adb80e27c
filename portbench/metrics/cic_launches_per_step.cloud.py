"""Launches a step of the P3M mesh's CIC kernels (``cic_deposit_kernel``
and ``cic_interp_kernel`` of ``sphax_torch/csrc/cic.cu``): the traced
window's device operations whose name holds ``cic_deposit`` or
``cic_interp``, over its steps. 2 where every mesh solve takes them (one
solve a step), 0 where the torch CIC they replaced runs instead."""


def read(run):
    t = run.trace
    if t is None or not t.device or not run.counters["steps"]:
        return None
    n = sum("cic_deposit" in name or "cic_interp" in name
            for name, _, _ in t.device)
    return n / run.counters["steps"]
