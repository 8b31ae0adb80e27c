"""The port's problem suite against ``sphax`` on the same inputs, float64.

The 2D window structure and the 2D plain kernels (against the Pallas
kernels in interpret mode), a 4-step 2D window-engine trajectory, the dense
engine, each problem's initial and first derived state, the run
loop and the conservation summary; then the JAX package's Sod L1 gate on
the port's dense engine. The CUDA 2D kernels are held against the plain
versions in tests/test_torch_gpu.py, and the KH growth gate runs on the card
(chip_smoke.py phase 16): on the CPU its few hundred dense steps at
N = 1536 take minutes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax import problems as jprob
from sphax import run as jrun
from sphax.diag import conservation as jcons
from sphax.ics import kh as jkh
from sphax.neighbors import window as jwin
from sphax.physics import dense as jdense
from sphax.physics import pallas_kernels as pk
from sphax.physics import wengine as jeng
from sphax_torch import configs as tconf
from sphax_torch import convert, problems, run
from sphax_torch.diag import conservation, riemann
from sphax_torch.ics import sod as tsod
from sphax_torch.neighbors import window as twin
from sphax_torch.physics import dense
from sphax_torch.physics import wengine as teng
from sphax_torch.physics import window_kernels as wk
from tests.parity.test_dense_vs_reference import CONFIGS, make_problem
from tests.test_torch_window import _assert_same_structure

torch.set_num_threads(1)

DERIVED = ("h", "rho", "P", "cs", "omega", "divv", "acc", "du_dt")


def _jcfg(cfg):
    return sphax.SPHConfig(**dataclasses.asdict(cfg))


def _tcfg(cfg):
    return tconf.SPHConfig(**dataclasses.asdict(cfg))


def _close(got, want, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _to_torch(jst):
    return convert.state_from_numpy(
        {k: np.asarray(getattr(jst, k)) for k in jst._fields}, "cpu",
        torch.float64)


def _kh_states(nx):
    ic = jkh.build(nx=nx)
    fields = ("pos", "vel", "mass", "u", "h")
    jst = sphax.make_state(*(jnp.asarray(ic[k]) for k in fields))
    jd = sphax.box(jnp.zeros(2), jnp.ones(2))
    td = convert.domain_from_numpy(np.zeros(2), np.ones(2), True, "cpu",
                                   torch.float64)
    return jst, jd, _to_torch(jst), td


# ---------------------------------------------------------------------------
# 2D window structure and kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", ["measured", "plain"])
def test_window_build_2d_equals_reference(plan):
    """kh.build(nx=32): the production plan (fast_sub=3, rgroups=2) and
    the plain plan _window_engine falls back to give equal specs and equal
    integer tables; a box too small for the fine grid raises in both."""
    jst, jd, tst, td = _kh_states(32)
    kw = dict(h_max=float(jst.h.max()) * 1.3, dim=2, cutoff_scale=1.25)
    if plan == "measured":
        kw.update(fast_sub=3, rgroups=2)
    jspec = jwin.plan_measured(jst.pos, jd, **kw)
    tspec = twin.plan_measured(tst.pos, td, **kw)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert tspec.n_seg == 3
    jw = jax.jit(jwin.build, static_argnums=2)(jst.pos, jd, jspec)
    tw = twin.build(tst.pos, td, tspec)
    _assert_same_structure(jw, tw, jst.n)
    assert int(tw.overflow) == 0
    # nx = 8 leaves 2 cells across the box: no fine fast-axis grid fits
    jst, jd, tst, td = _kh_states(8)
    kw.update(h_max=float(jst.h.max()) * 1.3, fast_sub=3, rgroups=2)
    for mod, st, d in ((jwin, jst, jd), (twin, tst, td)):
        with pytest.raises(ValueError):
            mod.plan_measured(st.pos, d, **kw)


def _problem_2d(rgroups, seed=3):
    """CONFIGS["dim2"] geometry at n_side=12, planned as
    tests/parity/test_window_vs_dense.py plans it, with sorted numpy inputs
    made from a seed, owner-consistent on ghost rows."""
    pos, vel, mass, u, h = make_problem(dim=2, n_side=12, seed=seed)
    n = len(pos)
    rng = np.random.default_rng(seed)
    jd = sphax.box(jnp.zeros(2), jnp.ones(2))
    spec = jwin.plan_windows(jd, h_max=float(h.max()) * 1.25, n=n, dim=2,
                             rgroups=rgroups)
    jw = jax.jit(jwin.build, static_argnums=2)(jnp.asarray(pos), jd, spec)
    td = convert.domain_from_numpy(np.zeros(2), np.ones(2), True, "cpu",
                                   torch.float64)
    tspec = convert.spec_from_fields(**dataclasses.asdict(spec))
    tw = twin.build(torch.as_tensor(pos), td, tspec)
    g = np.minimum(np.asarray(jw.g), n)

    def srt(a, fill):
        return np.concatenate([a, np.full((1,) + a.shape[1:], fill)])[g]

    rho = rng.uniform(0.8, 1.2, n)
    f = dict(pos_s=np.array(jw.pos_s), vel_s=srt(vel, 0.0),
             mass_s=srt(mass, 0.0), u_s=srt(u, 0.0), h0_s=srt(h, 1.0),
             h_s=srt(h * rng.uniform(0.95, 1.05, n), 1.0),
             rho_s=srt(rho, 1.0), P_s=srt(rho * rng.uniform(0.9, 1.1, n), 1.0),
             cs_s=srt(rng.uniform(0.8, 1.2, n), 1.0),
             om_s=srt(rng.uniform(0.9, 1.1, n), 1.0),
             bf_s=srt(rng.uniform(0.0, 1.0, n), 0.0))
    return spec, tspec, jw, tw, f, np.asarray(jw.is_real)


@pytest.mark.parametrize("rgroups", [1, 2])
def test_plain_kernels_2d_match_pallas(rgroups):
    """solve_h_density_plain and forces_plain in 2D (CONFIGS["dim2"]:
    adaptive h, grad-h, Balsara) against the Pallas kernels at 1e-10, on
    real rows."""
    cfg = _tcfg(dataclasses.replace(CONFIGS["dim2"], newton_iters=2))
    spec, tspec, jw, tw, f, real = _problem_2d(rgroups)
    assert tspec.n_seg == 3

    def t(k):
        return torch.as_tensor(f[k])

    def j(k):
        return jnp.asarray(f[k])

    args = ("pos_s", "mass_s", "h0_s")
    want = pk.solve_h_density(jw, spec, *map(j, args), _jcfg(cfg),
                              vel_s=j("vel_s"), u_s=j("u_s"))
    got = wk.solve_h_density(tw, tspec, *map(t, args), cfg, vel_s=t("vel_s"))
    assert len(got) == len(want) == 5
    for k, (a, b) in enumerate(zip(got, want)):
        _close(a.numpy()[real], np.asarray(b)[real], 1e-10, f"A out {k}")
    args = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s",
            "om_s", "bf_s")
    want = pk.forces(jw, spec, *map(j, args), _jcfg(cfg))
    got = wk.forces(tw, tspec, *map(t, args), cfg)
    assert tuple(got[0].shape) == (tspec.n_sorted, 2)
    _close(got[0].numpy()[real], np.asarray(want[0])[real], 1e-10, "acc")
    _close(got[1].numpy()[real], np.asarray(want[1])[real], 1e-10, "du")


def test_kh_window_trajectory_lockstep():
    """4 KDK steps of the 2D window engine (rebuild every 2) on KH ICs at
    nx=16 against the reference's jnp path at 1e-9."""
    steps = 4
    cfg = dataclasses.replace(tconf.KH, newton_iters=2)
    jst, jd, tst, td = _kh_states(16)
    spec = jwin.plan_measured(jst.pos, jd, h_max=float(jst.h.max()) * 1.3,
                              dim=2, cutoff_scale=1.25, fast_sub=3,
                              rgroups=2)
    tspec = convert.spec_from_fields(**dataclasses.asdict(spec))
    jst = jeng.update_derived(jst, _jcfg(cfg), jd, spec, use_pallas=False)
    jout, _, jdts, jovf = jeng.simulate(jst, _jcfg(cfg), jd, spec, steps,
                                        rebuild_every=2, use_pallas=False)
    tst = teng.update_derived(tst, cfg, td, tspec)
    tout, _, tdts, tovf = teng.simulate(tst, cfg, td, tspec, steps,
                                        rebuild_every=2)
    assert int(tovf) == int(jovf) == 0
    _close(tdts, jdts, 1e-9, "dts")
    for k in ("pos", "vel", "u", "h", "rho", "acc"):
        _close(getattr(tout, k), getattr(jout, k), 1e-9, k)


# ---------------------------------------------------------------------------
# dense engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["balsara_3d", "dim2", "direct_open"])
def test_dense_update_derived_matches(case):
    """dense.update_derived at 1e-10: 3D adaptive + grad-h + Balsara, the
    2D configuration, and direct gravity in an open box."""
    periodic = True
    if case == "balsara_3d":
        cfg, dim, n_side = CONFIGS["balsara"], 3, 6
    elif case == "dim2":
        cfg, dim, n_side = CONFIGS["dim2"], 2, 10
    else:
        cfg = sphax.SPHConfig(dim=3, adaptive_h=True, newton_iters=4,
                              gravity=True, G=2.3, grav_eps=0.05)
        dim, n_side, periodic = 3, 6, False
    pos, vel, mass, u, h = make_problem(dim=dim, n_side=n_side, seed=3)
    jd = sphax.box(jnp.zeros(dim), jnp.ones(dim), periodic=periodic)
    td = convert.domain_from_numpy(np.zeros(dim), np.ones(dim), periodic,
                                   "cpu", torch.float64)
    jst = sphax.make_state(*map(jnp.asarray, (pos, vel, mass, u, h)))
    want = jdense.update_derived(jst, cfg, jd, block=64)
    got = dense.update_derived(_to_torch(jst), _tcfg(cfg), td, block=50)
    for k in DERIVED:
        _close(getattr(got, k), getattr(want, k), 1e-10, k)
    # the default block (about 2^20 pairs) gives the same result
    again = dense.update_derived(_to_torch(jst), _tcfg(cfg), td)
    for k in DERIVED:
        _close(getattr(again, k), getattr(got, k), 1e-13, k)


# ---------------------------------------------------------------------------
# problems, run loop, conservation
# ---------------------------------------------------------------------------


PROBLEMS = {
    "sod": dict(n=8),
    "sedov": dict(n=8),
    "sedov_mm": dict(n=8, visc="mm"),
    "kh": dict(n=16),
    "evrard": dict(n=300),
    "turb": dict(n=12),
}


@pytest.mark.parametrize("case", sorted(PROBLEMS))
def test_problem_matches_reference(case):
    """Each problem on the CPU: the same ICs and config as sphax.problems,
    and its first derived state at 1e-10 (dense on both sides, or the
    window engine for turb, with the same WindowSpec)."""
    name = case.split("_")[0]
    kw = PROBLEMS[case]
    jp = jprob.REGISTRY[name](dtype=jnp.float64, **kw)
    tp = problems.REGISTRY[name](dtype=torch.float64, device="cpu", **kw)
    assert dataclasses.asdict(tp.cfg) == dataclasses.asdict(jp.cfg)
    assert tp.t_end == jp.t_end
    assert tp.engine_name == ("window" if name == "turb" else "dense")
    assert (tp.wspec is None) == (jp.wspec is None)
    if tp.wspec is not None:
        assert dataclasses.asdict(tp.wspec) == dataclasses.asdict(jp.wspec)
    for k in ("pos", "vel", "mass", "u", "alpha"):
        np.testing.assert_array_equal(getattr(tp.state, k).numpy(),
                                      np.asarray(getattr(jp.state, k)), k)
    for k in DERIVED:
        _close(getattr(tp.state, k), getattr(jp.state, k), 1e-10, k)
    np.testing.assert_array_equal(tp.domain.lo.numpy(), jp.domain.lo)
    np.testing.assert_array_equal(tp.domain.hi.numpy(), jp.domain.hi)
    assert tp.domain.periodic == jp.domain.periodic
    if name == "turb":
        assert tp.drive_spec == tuple(jp.drive_spec)
        assert tp.seed == 1 and tp.noise is not None
        _close(tp.drive.amp_re, jp.drive.amp_re, 0.0, "amp_re")


def test_window_engine_spec_matches_reference():
    """_window_engine on the kh ICs at nx=32 plans the same WindowSpec as
    the JAX version, with the production knobs."""
    jst, jd, tst, td = _kh_states(32)
    _, jspec = jprob._window_engine(jst, _jcfg(tconf.KH), jd)
    _, tspec = problems._window_engine(tst, tconf.KH, td)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert (tspec.fast_sub, tspec.rgroups) == (3, 2)


def test_auto_engine_and_device():
    """On the CPU a problem at or below 3,000 particles takes dense (above,
    the cell list: tests/test_torch_clist.py); device=None means CUDA and
    raises where no card is visible."""
    ic = tsod.build(nx_left=8, n_trans=4)
    st = problems._state(ic, torch.float64, torch.device("cpu"))
    dom = problems._box(ic, 3, torch.float64, torch.device("cpu"))
    eng, spec, name = problems._auto_engine(st, tconf.SOD, dom)
    assert (spec, name) == (None, "dense")
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None runs there")
    with pytest.raises(RuntimeError):
        problems.sod(n=8)


def test_simulate_until_sod_matches():
    """run.simulate_until on sod (dense) against sphax.run at 1e-9, and
    conservation.summary against the JAX summary at 1e-12."""
    jp = jprob.sod(n=8, dtype=jnp.float64)
    tp = problems.sod(n=8, dtype=torch.float64, device="cpu")
    times = {"j": [], "t": []}
    jst, _, jt, jn = jrun.simulate_until(
        jp.state, jp.cfg, jp.domain, jp.engine, t_end=0.05, chunk=4,
        callback=lambda s, t, n: times["j"].append(t))
    tst, _, tt, tn = run.simulate_until(
        tp.state, tp.cfg, tp.domain, tp.engine, t_end=0.05, chunk=4,
        callback=lambda s, t, n: times["t"].append(t))
    assert tn == jn and len(times["t"]) == len(times["j"]) > 1
    np.testing.assert_allclose(times["t"], times["j"], rtol=1e-9)
    for k in ("pos", "vel", "u", "h", "rho", "acc", "du_dt"):
        _close(getattr(tst, k), getattr(jst, k), 1e-9, k)
    # the summary of the same states in both packages
    for tstate, cfg in (
            (tst, tp.cfg),
            (problems.evrard(n=300, dtype=torch.float64, device="cpu").state,
             tconf.EVRARD),
            (problems.kh(n=16, dtype=torch.float64, device="cpu").state,
             tconf.KH)):
        jstate = sphax.ParticleState(**{
            k: jnp.asarray(getattr(tstate, k).numpy())
            for k in tstate._fields})
        want = jcons.summary(jstate, _jcfg(cfg), 0.25)
        got = conservation.summary(tstate, cfg, 0.25)
        assert list(got) == list(want)
        scale = max(abs(want["e_kin"]), abs(want["e_int"]))
        for k in want:
            if k == "finite":
                assert got[k] is want[k] is True
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                           atol=1e-12 * scale, err_msg=k)
        if cfg.gravity:
            # the row-blocked sum, in blocks that do not divide N
            np.testing.assert_allclose(
                float(conservation.gravitational_energy(tstate, cfg,
                                                        block=7)),
                want["e_grav"], rtol=1e-12)


def test_sod_l1_gate():
    """tests/problems/test_sod.py on the port's dense engine: L1(rho)
    against the exact Riemann solution < 0.06, exact momentum."""
    ic = tsod.build(nx_left=16, n_trans=4)            # N = 288
    cfg = tconf.SPHConfig(dim=3, gamma=1.4, adaptive_h=True, newton_iters=8)
    dom = problems._box(ic, 3, torch.float64, torch.device("cpu"))
    st = problems._state(ic, torch.float64, torch.device("cpu"))

    def engine(s):
        return dense.update_derived(s, cfg, dom, block=128)
    st = engine(st)
    p0 = conservation.momentum(st).numpy()
    st, _, t, nsteps = run.simulate_until(st, cfg, dom, engine, t_end=0.1)
    assert nsteps < 200
    x, rho = st.pos[:, 0].numpy(), st.rho.numpy()
    assert np.isfinite(rho).all()
    win = (x > 0.2) & (x < 0.85)
    rho_exact, _, _ = riemann.sod_solution(x[win], t)
    l1 = float(np.mean(np.abs(rho[win] - rho_exact)))
    assert l1 < 0.06, f"L1={l1}"
    assert np.all(np.abs(conservation.momentum(st).numpy() - p0) < 1e-10)
