"""The rate, idle-share and roofline arithmetic on hand-made numbers."""
import pytest

from portbench import spec, trace, yardstick
from portbench.run import Run


def _run(**kw):
    base = dict(n=1000, counters=dict(steps=40, chunks=4, sim_time=2e-3,
                                      builds=20, active=5.0, episodes=1,
                                      wall=2.0),
                setup_s=12.5, peak_bytes=500_000,
                config=spec.load("configs", "turb-bs12-256"),
                traffic=spec.load("traffic", "fixed"))
    base.update(kw)
    return Run(**base)


def _trace():
    dev = [("void solve_h_density_kernel<float, 3>", 0.0, 400.0),
           ("void forces_kernel<float, 3>", 500.0, 800.0),
           ("cub::DeviceRadixSortOnesweepKernel", 700.0, 900.0),
           ("vectorized_gather_kernel", 1500.0, 1600.0),
           ("void solve_h_density_kernel<float, 3>", 2000.0, 2400.0)]
    host = [("portbench.chunk", 0.0, 2500.0), ("aten::nonzero", 950.0, 1450.0),
            ("aten::item", 1610.0, 1990.0)]
    return trace.Trace(device=dev, host=host, window_s=2500e-6)


def test_kinds_busy_and_gaps():
    t = _trace()
    assert t.ms["kernel A"] == pytest.approx(0.8)
    assert t.ms["kernel C"] == pytest.approx(0.3)
    assert t.ms["sorts"] == pytest.approx(0.2)
    assert t.launches["kernel A"] == 2
    # busy: [0,400] [500,900] [1500,1600] [2000,2400] -> 1300 us
    assert t.busy_s == pytest.approx(1300e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["aten::nonzero"] == pytest.approx(600e-6)
    assert gaps["aten::item"] == pytest.approx(400e-6)
    assert gaps["portbench.chunk"] == pytest.approx(100e-6)
    assert t.top_ops()[0] == ["void solve_h_density_kernel<float, 3>",
                              pytest.approx(800e-6)]


def test_end_to_end_readers():
    r = _run()
    assert spec.reader("particle_steps_per_s")(r) == pytest.approx(20_000)
    assert spec.reader("sim_time_per_s")(r) == pytest.approx(1e-3)
    assert spec.reader("peak_bytes_per_particle")(r) == pytest.approx(500)
    assert spec.reader("setup_s")(r) == 12.5


def test_per_layer_readers():
    r = _run(trace=_trace())
    r._pairs = (100_000, 90_000)
    assert spec.reader("idle_share.turb")(r) == pytest.approx(48.0)
    assert spec.reader("builds_per_step.turb")(r) == pytest.approx(0.5)
    assert spec.reader("sort_ms_per_step.turb")(r) == pytest.approx(0.2 / 40)
    glue = 0.1 / 40
    assert spec.reader("glue_ms_per_step.turb")(r) == pytest.approx(glue)
    assert spec.reader("AC_ms_per_tick.sedov")(r) == pytest.approx(1.1 / 40)
    assert spec.reader("active_frac.rungs")(r) == pytest.approx(12.5)
    for name in ("idle_share", "AC_ms_per_tick", "glue_ms_per_tick"):
        assert (spec.reader(f"{name}.rungs")(r)
                == spec.reader(f"{name}.sedov")(r))
    bound_a, _ = yardstick.kernel_a(1000, 100_000, 2, True, "float32")
    assert spec.reader("A_roofline.turb")(r) == pytest.approx(
        100 * bound_a / 0.4)
    bound_c, _ = yardstick.kernel_c(1000, 90_000, True, "float32")
    assert spec.reader("C_roofline.turb")(r) == pytest.approx(
        100 * bound_c / 0.3)
    # without a device trace a reader finds nothing and returns nothing
    bare = _run()
    for m in ("idle_share.turb", "A_roofline.turb", "glue_ms_per_step.turb"):
        assert spec.reader(m)(bare) is None


def test_bounds():
    # 1000 particles, 1e5 pairs: A reads 8 and writes 5 floats a particle
    ms, by = yardstick.kernel_a(1000, 100_000, 2, True, "float32")
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 100_000 * (2 * 31 + 59) / 67e12)
    ms, by = yardstick.kernel_c(10**8, 10, True, "float32")
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 17 * 4 * 10**8 / 3.35e12)
