"""McNally et al. 2012's Kelvin-Helmholtz ICs (``kh smooth=1``), the port's
2D window engine against the benchmark's plain 2D reference, and the
window build's candidate counter.

The reference (``portbench/reference_kh2d.py``) imports nothing of the
program; here, on the CPU, it is held to the window engine's plain walks
(the card's path, as ``portbench/tests`` runs it) on seeded McNally ICs:
1e-10 of the largest value in fp64, 1e-5 in fp32.
"""
import numpy as np
import pytest
import torch

from portbench import ics as ICS
from portbench import reference_kh2d as R
from portbench import spec as bench_spec
from sphax.ics import kh as jkh
from sphax_torch import configs, make_state, problems
from sphax_torch.core.state import box
from sphax_torch.ics import kh
from sphax_torch.integrate import leapfrog
from sphax_torch.neighbors import window as win
from sphax_torch.physics import window_kernels as wk

F64 = torch.float64
CONFIG = bench_spec.load("configs", "kh-mcnally12-1024")


@pytest.mark.parametrize("n", [32, 64])
def test_smooth_ics_count_and_mass(n):
    ic = kh.build_mcnally(n)
    assert len(ic["pos"]) == 3 * n * n // 2
    assert np.all(ic["mass"] == 1.0 / (n * n))
    assert ic["mass"].sum() == pytest.approx(1.5, rel=1e-12)
    rho, _ = kh.mcnally_profile(ic["pos"][:, 1])
    assert rho.min() > 1.0 and rho.max() < 2.0
    np.testing.assert_allclose(ic["h"], 1.3 * np.sqrt(ic["mass"] / rho))
    np.testing.assert_allclose(ic["u"] * rho * (kh.GAMMA - 1.0), 2.5)


@pytest.mark.parametrize("n", [32, 64])
def test_column_mass_follows_the_profile(n):
    """The mass in each y band is the profile's integral over the band to
    within one row's mass (1/n outside the band, 2/n inside it)."""
    ic = kh.build_mcnally(n)
    y, m = ic["pos"][:, 1], ic["mass"]
    edges = np.linspace(0.0, 1.0, 41)
    for a, b in zip(edges[:-1], edges[1:]):
        got = m[(y >= a) & (y < b)].sum()
        want = kh.mcnally_mass(b) - kh.mcnally_mass(a)
        row = 2.0 / n if 0.25 <= a < 0.75 else 1.0 / n
        assert abs(got - want) <= row, (a, b, got, want)
    # the profile itself: McNally's formulas at a few heights
    y = np.array([0.1, 0.2499, 0.2501, 0.4, 0.6, 0.7499, 0.7501, 0.9])
    rho, vx = kh.mcnally_profile(y)
    e = np.exp(-np.abs(np.where(y < 0.5, y - 0.25, 0.75 - y)) / 0.025)
    inside = (y >= 0.25) & (y < 0.75)
    np.testing.assert_allclose(rho, np.where(inside, 2 - 0.5 * e, 1 + 0.5 * e))
    np.testing.assert_allclose(vx, np.where(inside, -0.5 + 0.5 * e,
                                            0.5 - 0.5 * e))


@pytest.mark.parametrize("n", [32, 64])
def test_program_ics_equal_the_benchmarks(n):
    ic = dict(CONFIG["ics"], n_side=n, jitter_max=0.0)
    got = ICS.make(ic, 5, F64, "cpu")
    want = kh.build_mcnally(n)
    for k in ("pos", "vel", "mass", "u", "h"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_sharp_kh_still_matches_the_jax_package():
    st = problems.kh(n=16, smooth=0, dtype=F64, device="cpu").state
    ic = jkh.build(nx=16)
    for k in ("pos", "vel", "mass", "u"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), ic[k])


def test_smooth_kh_plans_for_the_profiles_largest_h(monkeypatch):
    """The window is planned for eta / n, the h the rows far from the band
    approach, which the benchmark's configuration states."""
    with pytest.raises(SystemExit):
        problems.kh(n=16, smooth="maybe", device="cpu")
    monkeypatch.setattr(problems, "_auto_engine",
                        lambda st, cfg, dom: (*problems._window_engine(
                            st, cfg, dom), "window"))
    assert kh.build_mcnally(32)["h"].max() < 1.3 / 32
    p = problems.kh(n=32, smooth=1, dtype=F64, device="cpu")
    assert p.wspec.cutoff == pytest.approx(2 * 1.25 * 1.3 * 1.3 / 32,
                                           rel=1e-12)


def _seeded(dtype, n=32):
    ic = dict(CONFIG["ics"], n_side=n)
    made = ICS.make(ic, 2**31 + 11, dtype, "cpu")
    st = make_state(made["pos"], made["vel"], made["mass"], made["u"],
                    made["h"])
    dom = box(torch.zeros(2, dtype=dtype), torch.ones(2, dtype=dtype))
    eng, spec = problems._window_engine(st, configs.KH, dom)
    return made, st, dom, eng, spec


def _close(got, want, fields, tol):
    """Each field within ``tol`` of its largest value; div v, acc and
    du/dt, sums whose terms cancel (the pressure is uniform), within
    ``tol`` of the largest sum of their terms' magnitudes (what bounds
    their rounding, as ``portbench/check.py`` scales them)."""
    abs_of = {"divv": "div_abs", "acc": "acc_abs", "du_dt": "du_abs"}
    for k in fields:
        a, b = got[k].double(), want[k].double()
        scale = float(want[abs_of.get(k, k)].abs().max())
        assert float((a - b).abs().max()) <= tol * scale, (k, float(
            (a - b).abs().max()) / scale)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_window_engine_matches_the_2d_reference(dtype, tol):
    """The derived pass on seeded McNally ICs at n = 32, then one KDK
    step from it, against ``reference_kh2d`` in float64."""
    made, st, dom, eng, spec = _seeded(dtype)
    sph = CONFIG["sph"]
    hcap = 0.5 * spec.cutoff
    rows = torch.arange(st.n)
    s0 = eng(st)
    ref = R.derived_start(R.Arith(), made, rows, sph, hcap, 1.0)
    _close(s0._asdict(), ref, ("h", "rho", "omega", "divv", "acc", "du_dt"),
           tol)
    want, dt = leapfrog.step(s0, configs.KH, dom, eng)
    ref = R.kdk_step(R.Arith(), s0._asdict(), rows, sph, hcap, 1.0)
    assert float(ref["dt"]) == pytest.approx(float(dt), rel=tol)
    _close(want._asdict(), ref, ("vel", "u", "h", "rho", "divv", "acc",
                                 "du_dt"), tol)
    d = want.pos.double() - ref["pos"]
    assert float((d - torch.round(d)).abs().max()) <= tol


def _worst(got, want, fields):
    """The largest gap of ``fields``, scaled as ``_close`` scales them."""
    abs_of = {"divv": "div_abs", "acc": "acc_abs", "du_dt": "du_abs"}
    out = 0.0
    for k in fields:
        d = float((got[k].double() - want[k].double()).abs().max())
        out = max(out, d / float(want[abs_of.get(k, k)].abs().max()))
    return out


def test_float32_gap_is_the_stored_states_rounding():
    """The reference rounds what it stores (images, the half-kicked
    velocities and energies, the drifted positions) to the state's dtype:
    handed the float32 state it sits far closer to the float32 program's
    step than handed the same numbers as float64, where nothing is
    rounded and the velocities' rounding at |v| = 0.5 shows against the
    small neighbour differences of the first step."""
    made, st, dom, eng, spec = _seeded(torch.float32)
    sph, hcap, rows = CONFIG["sph"], 0.5 * spec.cutoff, torch.arange(st.n)
    s0 = eng(st)
    want, _ = leapfrog.step(s0, configs.KH, dom, eng)
    fields = ("h", "rho", "divv", "acc", "du_dt")
    s_in = s0._asdict()
    rounded = _worst(want._asdict(), R.kdk_step(
        R.Arith(), s_in, rows, sph, hcap, 1.0), fields)
    plain = _worst(want._asdict(), R.kdk_step(
        R.Arith(), {k: v.double() if torch.is_floating_point(v) else v
                    for k, v in s_in.items()}, rows, sph, hcap, 1.0), fields)
    assert rounded < 5e-6 and plain > 4 * rounded, (rounded, plain)


def test_reference_images_are_rounded_to_the_state():
    """A pair across x = 1: the image of x_j near 0 lies at x_j + 1 rounded
    to the state's dtype, as a float32 program stores it; x_i - x_j across
    the near edge is exact."""
    pos = torch.tensor([[0.99975, 0.5], [0.0002, 0.5]],
                       dtype=torch.float32).double()
    dx = {}
    for store in (torch.float32, torch.float64):
        i, j, d, _ = R.Grid(pos, 0.01, 1.0, store=store).pairs(
            torch.arange(2))
        dx[store] = {(a, b): c for a, b, c in
                     zip(i.tolist(), j.tolist(), d[:, 0].tolist())}
        img = float((pos[1, 0] + 1.0).to(store))
        assert dx[store][0, 1] == float(pos[0, 0]) - img
        assert dx[store][1, 0] == float(pos[1, 0] - (pos[0, 0] - 1.0))
    assert dx[torch.float32][0, 1] != dx[torch.float64][0, 1]


def test_reference_2d_refuses_driving_and_rungs():
    for fn in (R.rung_tick, R.drive_modes, R.ou_update):
        with pytest.raises(NotImplementedError):
            fn()


# ---- the window build's candidate counter ----------------------------------


def _direct_count(wd, spec):
    """Kernel A's candidates summed over the real rows, from the walk's
    candidate table (``window_kernels.candidate_table``)."""
    g = torch.arange(spec.n_groups)
    _, valid = wk.candidate_table(wd, spec, g)
    real = wd.is_real.reshape(spec.n_groups, spec.group).sum(1)
    return int((valid.sum(1) * real).sum()), int(real.sum())


def _states():
    p2 = problems.kh(n=32, smooth=1, dtype=F64, device="cpu")
    g = torch.Generator().manual_seed(4)
    n = 12
    ax = (torch.arange(n, dtype=F64) + 0.5) / n
    pos = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    pos = (pos.reshape(-1, 3) + 0.02 * torch.randn(n**3, 3, generator=g,
                                                    dtype=F64)) % 1.0
    dom3 = box(torch.zeros(3, dtype=F64), torch.ones(3, dtype=F64))
    h3 = torch.full((n**3,), 1.3 / n, dtype=F64)
    return {2: (p2.state.pos, p2.domain, float(p2.state.h.max()) * 1.3),
            3: (pos, dom3, float(h3.max()) * 1.05)}


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_candidate_counter_equals_a_direct_count(dim, compact):
    pos, dom, h_max = _states()[dim]
    plan = win.plan_compact if compact else win.plan_measured
    spec = plan(pos, dom, h_max, dim, fast_sub=3, rgroups=2)
    win.CANDIDATES["sums"] = None
    wd = win.build(pos, dom, spec)
    sums = win.CANDIDATES["sums"]
    assert sums.dtype == torch.int64 and sums.device == pos.device
    want = _direct_count(wd, spec)
    assert tuple(sums.tolist()) == want
    assert want[1] == len(pos) and want[0] > want[1]
    win.build(pos, dom, spec)
    assert tuple(win.CANDIDATES["sums"].tolist()) == (2 * want[0],
                                                      2 * want[1])


def test_a_build_reads_nothing_back_to_the_host(monkeypatch):
    """The counter stays on the device: a whole build, the counter's
    update included, converts no tensor to a host value."""
    pos, dom, h_max = _states()[2]
    spec = win.plan_measured(pos, dom, h_max, 2, fast_sub=3, rgroups=2)
    win.CANDIDATES["sums"] = None

    def refuse(*args, **kwargs):
        raise AssertionError("a host read of a tensor")
    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    win.build(pos, dom, spec)
    sums = win.CANDIDATES["sums"]
    monkeypatch.undo()
    assert isinstance(sums, torch.Tensor) and sums.shape == (2,)


def test_counter_takes_the_structures_own_tables():
    """In place, a group's candidates are its segments' 128-row blocks
    with the overlap of a later segment clipped at the earlier ends; an
    empty segment clips nothing."""
    spec = win.WindowSpec(res=(4, 12), cutoff=0.1, ghost_caps=(0, 0),
                          tile=128, wseg=512, n_sorted=1024)
    w_lo = torch.tensor([[0, 128, 512], [256, 0, 256], [0, 0, 0]],
                        dtype=torch.int32)
    w_nact = torch.tensor([[2, 2, 1], [1, 0, 2], [0, 0, 0]],
                          dtype=torch.int32)
    real = torch.zeros((3, spec.group), dtype=torch.bool)
    real[0, :5] = real[1, :2] = real[2, :7] = True
    sums = win.candidate_sums(w_lo, w_nact, None, real, spec)
    # group 0: [0, 256) + [256, 384) + [512, 640) = 512 rows; group 1:
    # [256, 384) + [384, 512) = 256 rows; group 2: none
    assert sums.tolist() == [5 * 512 + 2 * 256, 14]
