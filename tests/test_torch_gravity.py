"""Self-gravity in the port against ``sphax`` on the same inputs.

The pair formula, the P3M mesh (deposit, interpolation, periodic and open
Poisson solves, mesh acceleration, dense short range), the direct sums, kernel
C's fused short range (the plain version against the Pallas kernel in
interpret mode), the derived pass in all three gravity branches and a 2-step
P3M trajectory, all in float64; then the JAX package's own P3M physics gates
run on the port alone. The CUDA kernels are held against the plain versions
in tests/test_torch_gpu.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
import sphax.reference_cpu as ref
from sphax.neighbors import window as jwin
from sphax.physics import clist as jclist
from sphax.physics import pairs as jpairs
from sphax.physics import pallas_kernels as pk
from sphax.physics import pm as jpm
from sphax.physics import wengine as jeng
from sphax_torch import configs as tconf
from sphax_torch import convert
from sphax_torch.physics import clist as tclist
from sphax_torch.physics import direct_gravity as tdg
from sphax_torch.physics import pairs as tpairs
from sphax_torch.physics import pm as tpm
from sphax_torch.physics import wengine as teng
from sphax_torch.physics import window_kernels as wk
from tests.parity.test_dense_vs_reference import make_problem
from tests.test_torch_kernels import _problem

torch.set_num_threads(1)

# test_pm.py's configuration of the P3M gates
PM_CFG = tconf.SPHConfig(dim=3, gravity=True, G=1.0, grav_eps=0.004,
                         grav_solver="p3m", grav_mesh=64, grav_rs_cells=2.0)


def _jcfg(cfg):
    return sphax.SPHConfig(**dataclasses.asdict(cfg))


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _domains(periodic, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0)):
    jd = sphax.box(jnp.asarray(lo), jnp.asarray(hi), periodic=periodic)
    td = convert.domain_from_numpy(np.asarray(lo), np.asarray(hi), periodic,
                                   "cpu", torch.float64)
    return jd, td


def _cloud(n=1500, seed=5):
    """test_pm.py's cloud: half uniform, half a Gaussian clump."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.random((n // 2, 3)),
                          np.mod(0.3 + 0.12 * rng.standard_normal(
                              (n // 2, 3)), 1.0)])
    pos = np.clip(pos, 1e-3, 1 - 1e-3)
    return pos, rng.random(n) + 0.5


def test_gravity_terms_agree():
    rng = np.random.default_rng(2)
    dx = rng.uniform(-1.0, 1.0, (600, 3))
    dx[:3] = 0.0
    r = np.sqrt(np.sum(dx * dx, -1))
    m = rng.uniform(0.5, 1.5, 600)
    kw = dict(gravity=True, G=1.7, grav_eps=0.05)
    _close(tpairs.gravity_terms(_t(dx), _t(r), _t(m),
                                tconf.SPHConfig(**kw)),
           jpairs.gravity_terms(jnp.asarray(dx), jnp.asarray(r),
                                jnp.asarray(m), sphax.SPHConfig(**kw)),
           1e-12)


@pytest.mark.parametrize("periodic", [True, False])
def test_mesh_pieces_agree(periodic):
    """CIC deposit and interpolation, the Poisson solve, the mesh
    acceleration (periodic positions given unwrapped) and the dense short
    range, at 1e-10."""
    cfg = dataclasses.replace(PM_CFG, grav_mesh=32)
    jcfg = _jcfg(cfg)
    M = cfg.grav_mesh
    pos, mass = _cloud(n=600, seed=3)
    if periodic:
        # a non-cubic box, and positions drifted out of it
        lo, hi = (0.0, -0.5, 0.25), (1.0, 0.7, 1.5)
        pos = np.asarray(lo) + pos * (np.asarray(hi) - np.asarray(lo))
        pos[::3] += np.array([1.0, -1.2, 1.25])
    else:
        lo, hi = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    jd, td = _domains(periodic, lo, hi)
    jp, jm, tp, tm = (jnp.asarray(pos), jnp.asarray(mass), _t(pos),
                      _t(mass))
    jlo, tlo = jd.lo, td.lo
    jcell, tcell = jd.extent / M, td.extent / M
    jdep, tdep = jd.wrap(jp), td.wrap(tp)

    jgrid = jpm._deposit(jdep, jm, jlo, jcell, M, periodic)
    _close(tpm._deposit(tdep, tm, tlo, tcell, M, periodic), jgrid, 1e-10,
           "deposit")
    grids = np.random.default_rng(4).standard_normal((3, M, M, M))
    _close(tpm._interp(list(_t(grids)), tdep, tlo, tcell, M, periodic),
           jpm._interp(list(jnp.asarray(grids)), jdep, jlo, jcell, M,
                       periodic), 1e-10, "interp")
    jrs = jpm.rs_traced(jcfg, jd, jnp.float64)
    trs = tpm.rs_traced(cfg, td, torch.float64)
    _close(trs, jrs, 1e-15, "rs")
    _close(tpm._solve_grids(_t(jgrid), td, cfg.G, trs, M, periodic),
           jpm._solve_grids(jgrid, jd, jcfg.G, jrs, M, periodic), 1e-10,
           "solve")
    _close(tpm.mesh_accel(tp, tm, cfg, td),
           jpm.mesh_accel(jp, jm, jcfg, jd), 1e-10, "mesh_accel")
    _close(tpm.short_accel_dense(tp, tm, cfg, td),
           jpm.short_accel_dense(jp, jm, jcfg, jd), 1e-10, "short")
    assert tpm.r_cut(cfg, td) == pytest.approx(jpm.r_cut(jcfg, jd),
                                               rel=1e-15)


def test_gravity_plain_matches_pallas_and_reference():
    """The test_window_vs_dense.py pattern: n = 300, open boundaries."""
    rng = np.random.default_rng(11)
    n = 300
    pos = rng.standard_normal((n, 3)) * 0.3
    mass = rng.random(n) + 0.1
    cfg = tconf.SPHConfig(dim=3, gravity=True, G=1.7, grav_eps=0.05)
    got = tdg.gravity(_t(pos), _t(mass), cfg)   # CPU tensor: plain version
    _close(got, ref.gravity(pos, mass, _jcfg(cfg)), 1e-9, "reference")
    _close(got, pk.gravity(jnp.asarray(pos), jnp.asarray(mass), _jcfg(cfg)),
           1e-9, "pallas")
    with pytest.raises(ValueError):
        tdg.gravity(_t(pos), _t(mass), dataclasses.replace(cfg, grav_eps=0))


@pytest.mark.parametrize("periodic", [True, False])
def test_gravity_dense_agrees(periodic):
    pos, mass = _cloud(n=400, seed=7)
    cfg = tconf.SPHConfig(dim=3, gravity=True, G=2.3, grav_eps=0.05)
    jd, td = _domains(periodic)
    _close(tclist.gravity_dense(_t(pos), _t(mass), cfg, td),
           jclist.gravity_dense(jnp.asarray(pos), jnp.asarray(mass),
                                _jcfg(cfg), jd), 1e-12)


@pytest.mark.parametrize("rgroups", [1, 2])
def test_forces_plain_grav_matches_pallas(rgroups):
    """Kernel C's fused P3M short range: the plain version (forces_plain +
    gravity_short_pass) against the Pallas kernel in interpret mode, which
    keeps the exact erfc. A dropped pair between 2h and the cutoff shows
    here."""
    cfg = dataclasses.replace(tconf.TURB, gravity=True, grav_solver="p3m",
                              G=1.3, grav_eps=0.01, grav_mesh=16)
    spec, tspec, jw, tw, f, real = _problem(rgroups, seed=5)
    jd, td = _domains(True)
    jrs = jpm.rs_traced(_jcfg(cfg), jd, jnp.float64, cutoff=spec.cutoff)
    trs = tpm.rs_traced(cfg, td, torch.float64, cutoff=tspec.cutoff)
    _close(trs, jrs, 1e-15, "rs")
    args = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s",
            "om_s", "bf_s")
    want = pk.forces(jw, spec, *(jnp.asarray(f[k]) for k in args),
                     _jcfg(cfg), grav=(jrs, cfg.grav_eps))
    got = wk.forces(tw, tspec, *(torch.as_tensor(f[k]) for k in args), cfg,
                    grav=(trs, cfg.grav_eps))
    nograv = wk.forces(tw, tspec, *(torch.as_tensor(f[k]) for k in args),
                       cfg)
    for k, what in ((0, "acc"), (1, "du")):
        a, b = np.asarray(got[k])[real], np.asarray(want[k])[real]
        _close(a, b, 1e-10, what)
    # the gravity term is really there, and du does not see it
    assert np.abs(np.asarray(got[0] - nograv[0])[real]).max() > 1e-3
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(nograv[1]))


GRAV_CASES = {
    "p3m_periodic": ("p3m", True),
    "direct_open": ("direct", False),
    "direct_periodic": ("direct", True),
}


@pytest.mark.parametrize("case", sorted(GRAV_CASES))
def test_update_derived_gravity_agrees(case):
    """All three gravity branches of derived_with against the JAX jnp path
    (update_derived(use_pallas=False)) at test_window_vs_dense.py's sizes."""
    solver, periodic = GRAV_CASES[case]
    cfg = tconf.SPHConfig(dim=3, adaptive_h=True, newton_iters=2,
                          gravity=True, grav_solver=solver, G=1.3,
                          grav_eps=0.01, grav_mesh=16)
    pos, vel, mass, u, h = make_problem(dim=3, n_side=8, seed=3)
    jd, td = _domains(periodic)
    jst = sphax.make_state(*(jnp.asarray(a) for a in (pos, vel, mass, u, h)))
    spec = jwin.plan_windows(jd, h_max=float(h.max()) * 1.25, n=len(pos),
                             dim=3)
    tspec = convert.spec_from_fields(**dataclasses.asdict(spec))
    tst = convert.state_from_numpy(
        {k: np.asarray(getattr(jst, k)) for k in jst._fields}, "cpu",
        torch.float64)
    want = jeng.update_derived(jst, _jcfg(cfg), jd, spec, tile_block=4,
                               use_pallas=False)
    got = teng.update_derived(tst, cfg, td, tspec)
    for k in ("h", "rho", "P", "omega", "acc", "du_dt"):
        _close(getattr(got, k), getattr(want, k), 1e-10, k)


def test_simulate_p3m_lockstep():
    """2 KDK steps of the P3M turbulence box (rebuild every 2, h_predict,
    production window knobs) against the JAX jnp simulate at 1e-9."""
    from tests.test_torch_slice import _setup

    cfg = dataclasses.replace(tconf.TURB, newton_iters=1, h_predict=True,
                              gravity=True, grav_solver="p3m", grav_mesh=16)
    jst, jd, spec, tst, td, tspec = _setup(n_side=8, seed=13)
    jst = jeng.update_derived(jst, _jcfg(cfg), jd, spec, use_pallas=False)
    jout, _, jdts, jovf = jeng.simulate(jst, _jcfg(cfg), jd, spec, 2,
                                        rebuild_every=2, use_pallas=False)
    tst = teng.update_derived(tst, cfg, td, tspec)
    tout, _, tdts, tovf = teng.simulate(tst, cfg, td, tspec, 2,
                                        rebuild_every=2)
    assert int(tovf) == int(jovf) == 0
    _close(tdts, jdts, 1e-9, "dts")
    got = convert.state_to_numpy(tout)
    for k in ("pos", "vel", "h", "rho", "acc"):
        _close(got[k], getattr(jout, k), 1e-9, k)


# ---- the JAX package's P3M physics gates (tests/unit/test_pm.py), run on
# the port alone


def test_p3m_open_box_matches_direct_sum():
    pos, mass = _cloud()
    _, td = _domains(False)
    a_ref = tclist.gravity_dense(_t(pos), _t(mass), PM_CFG, td).numpy()
    a_p3m = tpm.p3m_accel_dense(_t(pos), _t(mass), PM_CFG, td).numpy()
    rel = (np.linalg.norm(a_p3m - a_ref, axis=1)
           / np.linalg.norm(a_ref, axis=1))
    assert np.sqrt(np.mean(rel ** 2)) < 7e-3, np.sqrt(np.mean(rel ** 2))
    assert np.percentile(rel, 99) < 3e-2


@pytest.mark.parametrize("periodic", [True, False])
def test_p3m_momentum_conservation(periodic):
    pos, mass = _cloud(n=800, seed=9)
    _, td = _domains(periodic)
    a = tpm.p3m_accel_dense(_t(pos), _t(mass), PM_CFG, td).numpy()
    ptot = (mass[:, None] * a).sum(0)
    scale = np.abs(mass[:, None] * a).sum(0).max()
    assert np.all(np.abs(ptot) < 2e-3 * scale), (ptot, scale)
