"""``rowpack_launches_per_step.turb`` on a made-up trace: 0 a step without
a row-packing kernel, 3 a step with the three launched once a step, and
nothing without a device trace."""
import pytest

from portbench import spec, trace

READ = spec.reader("rowpack_launches_per_step.turb")
STEPS = 40


class Run:
    def __init__(self, t, steps=STEPS):
        self.trace, self.counters = t, {"steps": steps}


def _trace(extra=()):
    dev = [("void solve_h_density_kernel<float, 3>", 0.0, 400.0),
           ("void forces_kernel<float, 3>", 500.0, 800.0),
           ("cub::DeviceRadixSortOnesweepKernel", 700.0, 900.0),
           ("vectorized_gather_kernel", 1500.0, 1600.0)] + list(extra)
    return trace.Trace(device=dev, host=[("portbench.chunk", 0.0, 9000.0)],
                       window_s=9000e-6)


PACKS = [(f"void (anonymous namespace)::rowpack_{k}<float, 3, true>(float "
          f"const*, int const*)", 3000.0 + 10 * i, 3005.0 + 10 * i)
         for i in range(STEPS) for k in ("gather_a", "gather_c",
                                         "scatter_out")]


def test_no_row_packing_kernel_reads_zero():
    assert READ(Run(_trace())) == 0.0


def test_three_launches_a_step():
    assert READ(Run(_trace(PACKS))) == pytest.approx(3.0)


def test_nothing_without_a_device_trace():
    assert READ(Run(None)) is None
    assert READ(Run(trace.Trace(device=[], host=[], window_s=1.0))) is None


def test_the_kinds_of_a_and_c_and_the_sorts_keep_their_kernels():
    """The rooflines of A and C and the glue read kernels by these kinds;
    the row-packing kernels fall in none of the three."""
    t = _trace(PACKS)
    assert not any(trace.kind(name) in ("kernel A", "kernel C", "sorts")
                   for name, _, _ in PACKS)
    assert t.launches["kernel A"] == t.launches["kernel C"] == 1
