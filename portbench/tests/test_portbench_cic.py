"""``cic_launches_per_step.cloud`` and ``cic_ms_per_step.cloud`` on a
made-up trace: 0 launches and no ms a step without a CIC kernel, 2
launches and their device ms a step with the deposit and the interpolation
launched once a step, and nothing without a device trace; the CIC kernels
count as glue, outside the mesh's named operations and the kinds of A, C
and the sorts."""
import pytest

from portbench import spec, trace
from portbench import yardstick_grav as Y

READ = spec.reader("cic_launches_per_step.cloud")
READ_MS = spec.reader("cic_ms_per_step.cloud")
STEPS = 40


class Run:
    def __init__(self, t, steps=STEPS):
        self.trace, self.counters = t, {"steps": steps}


def _trace(extra=()):
    dev = [("void solve_h_density_kernel<float, 3>", 0.0, 400.0),
           ("void forces_kernel<float, 3, true>", 500.0, 800.0),
           ("void fft_c2c_kernel", 900.0, 950.0),
           ("vectorized_gather_kernel", 1500.0, 1600.0)] + list(extra)
    return trace.Trace(device=dev, host=[("portbench.chunk", 0.0, 9000.0)],
                       window_s=9000e-6)


CIC = [(f"void (anonymous namespace)::cic_{k}<float, true{g}>(float "
        f"const*, float const*, int, int, float*)",
        3000.0 + 10 * i, 3005.0 + 10 * i)
       for i in range(STEPS) for k, g in (("deposit_kernel", ""),
                                          ("interp_kernel", ", 3"))]


def test_no_cic_kernel_reads_zero():
    assert READ(Run(_trace())) == 0.0


def test_two_launches_a_step():
    assert READ(Run(_trace(CIC))) == pytest.approx(2.0)


def test_no_cic_kernel_reads_no_ms():
    assert READ_MS(Run(_trace())) is None


def test_ms_a_step():
    # each step's deposit and interpolation take 5 us each
    assert READ_MS(Run(_trace(CIC))) == pytest.approx(0.010)


@pytest.mark.parametrize("read", [READ, READ_MS])
def test_nothing_without_a_device_trace(read):
    assert read(Run(None)) is None
    assert read(Run(trace.Trace(device=[], host=[], window_s=1.0))) is None


def test_the_cic_kernels_count_as_glue():
    assert not any(Y.mesh_op(name) or Y.grav_c(name)
                   or trace.kind(name) in ("kernel A", "kernel C", "sorts")
                   for name, _, _ in CIC)
