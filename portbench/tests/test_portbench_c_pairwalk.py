"""``c_pairwalk_launches_per_step.turb`` and ``.kh`` on made-up traces: 1 a
step where kernel C launches as its pair walk once a step, 0 where it
launches under its other names, and nothing without a device trace."""
import pytest

from portbench import spec, trace

READERS = ("c_pairwalk_launches_per_step.turb",
           "c_pairwalk_launches_per_step.kh")
STEPS = 40
A_PAIRS = ("void (anonymous namespace)::solve_h_density_pairs_kernel<float, "
           "3, true>(float const*, float const*, int const*, int const*, "
           "int)")


class Run:
    def __init__(self, t, steps=STEPS):
        self.trace, self.counters = t, {"steps": steps}


def _trace(c_name):
    dev = []
    for i in range(STEPS):
        t0 = 1000.0 * i
        dev += [(A_PAIRS, t0, t0 + 400.0),
                (c_name, t0 + 500.0, t0 + 800.0),
                ("cub::DeviceRadixSortOnesweepKernel", t0 + 850.0,
                 t0 + 900.0)]
    return trace.Trace(device=dev, host=[("portbench.chunk", 0.0, 1e6)],
                       window_s=1.0)


PAIRS = ("void (anonymous namespace)::forces_pairs_kernel<float, 3, true, "
         "false, false>(float const*, int const*, int const*, int)")
PAIRS_COMPACT = ("void (anonymous namespace)::forces_pairs_compact_kernel<"
                 "float, 2, true, false, false>(float const*)")
WARP = ("void (anonymous namespace)::forces_kernel<float, 3, true, false, "
        "false>(float const*, int const*, int const*, int)")


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("c_name,want", [(PAIRS, 1.0), (PAIRS_COMPACT, 1.0),
                                         (WARP, 0.0)])
def test_pair_walk_launches_a_step(name, c_name, want):
    assert spec.reader(name)(Run(_trace(c_name))) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_device_trace(name):
    read = spec.reader(name)
    assert read(Run(None)) is None
    assert read(Run(trace.Trace(device=[], host=[], window_s=1.0))) is None


@pytest.mark.parametrize("c_name", [PAIRS, PAIRS_COMPACT])
def test_the_pair_walk_is_kernel_c_to_the_trace(c_name):
    """C's roofline and the glue read C by its kind: the pair walk's
    kernels are kernel C, one launch a step, and never kernel A."""
    assert trace.kind(c_name) == "kernel C"
    t = _trace(c_name)
    assert t.launches["kernel A"] == t.launches["kernel C"] == STEPS
