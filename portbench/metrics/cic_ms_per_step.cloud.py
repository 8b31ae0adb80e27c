"""Device ms a step of the P3M mesh's CIC kernels (``cic_deposit_kernel``
and ``cic_interp_kernel`` of ``sphax_torch/csrc/cic.cu``): the traced
window's device operations whose name holds ``cic_deposit`` or
``cic_interp``, over its steps. They count as glue in
``glue_ms_per_step.cloud``, outside ``mesh_ms_per_step.cloud``'s named
operations; nothing where no CIC kernel ran (the torch CIC they replaced)."""
from portbench import yardstick_grav as Y


def cic_op(name: str) -> bool:
    return "cic_deposit" in name or "cic_interp" in name


def read(run):
    got = Y.device_ms(run, cic_op)
    if not got or not got[1] or not run.counters["steps"]:
        return None
    return got[0] / run.counters["steps"]
