"""The dim=1 instantiation of the window engine against ``sphax``.

A 1D periodic box has one pencil segment per row-group (n_seg = 1), so the
cross-segment dedup has nothing to compare, and kernel A's curl is zero.
On a jittered 1D lattice with a seeded velocity (numpy), float64: the
window tables equal the reference's exactly, in place and compact; the
plain versions of kernels A and C match the Pallas kernels (interpret mode)
at 1e-10 in both walks; and 4 steps of ``wengine.simulate`` match the
reference's jnp path at 1e-9. The CUDA ``_1d`` kernels are held against the
plain versions in tests/test_torch_gpu.py.

Rows that are not real particles are don't-care by contract, so the kernel
comparisons are on ``is_real`` rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax.neighbors import window as jwin
from sphax.physics import pallas_kernels as pk
from sphax.physics import wengine as jeng
from sphax_torch import configs as tconf
from sphax_torch import convert, make_state
from sphax_torch.neighbors import window as twin
from sphax_torch.physics import wengine as teng
from sphax_torch.physics import window_kernels as wk
from tests.test_torch_slice import _close, _jcfg

torch.set_num_threads(1)

RTOL = 1e-10
N = 4096
CFG = tconf.SPHConfig(dim=1, gamma=1.4, adaptive_h=True, grad_h=True,
                      balsara=True, newton_iters=2)
A_ARGS = ("pos_s", "mass_s", "h0_s")
C_ARGS = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s", "om_s",
          "bf_s")
_jbuild = jax.jit(jwin.build, static_argnums=2)


def _ic(seed=1):
    """N particles on a unit periodic line: a lattice jittered by 0.2
    spacings, a 0.1 N(0,1) velocity, h = eta / N."""
    rng = np.random.default_rng(seed)
    dx = 1.0 / N
    pos = ((np.arange(N) + 0.5 + 0.2 * rng.uniform(-1, 1, N)) * dx)[:, None]
    return dict(pos=pos, vel=0.1 * rng.standard_normal((N, 1)),
                mass=np.full(N, dx), u=np.full(N, 1.0),
                h=np.full(N, CFG.eta * dx))


def _geometry(compact, seed=1):
    ic = _ic(seed)
    jd = sphax.box(jnp.zeros(1), jnp.ones(1))
    td = convert.domain_from_numpy(np.zeros(1), np.ones(1), True, "cpu",
                                   torch.float64)
    kw = dict(h_max=float(ic["h"].max()) * 1.3, dim=1, cutoff_scale=1.25)
    plan = "plan_compact" if compact else "plan_measured"
    spec = getattr(jwin, plan)(jnp.asarray(ic["pos"]), jd, **kw)
    tspec = getattr(twin, plan)(torch.as_tensor(ic["pos"]), td, **kw)
    return ic, jd, td, spec, tspec


def _problem(compact, seed=1):
    """Sorted kernel inputs made with numpy, owner-consistent on ghost rows
    (tests/test_torch_kernels.py's recipe)."""
    ic, jd, td, spec, tspec = _geometry(compact, seed)
    jw = _jbuild(jnp.asarray(ic["pos"]), jd, spec)
    tw = twin.build(torch.as_tensor(ic["pos"]), td, tspec)
    rng = np.random.default_rng(seed + 10)
    g = np.minimum(np.asarray(jw.g), N)

    def srt(a, fill):
        return np.concatenate([a, np.full((1,) + a.shape[1:], fill)])[g]

    rho = rng.uniform(0.8, 1.2, N)
    h = ic["h"]
    f = dict(pos_s=np.array(jw.pos_s), vel_s=srt(ic["vel"], 0.0),
             mass_s=srt(ic["mass"], 0.0), u_s=srt(ic["u"], 0.0),
             h0_s=srt(h, 1.0), h_s=srt(h * rng.uniform(0.95, 1.05, N), 1.0),
             rho_s=srt(rho, 1.0), P_s=srt(rho * rng.uniform(0.9, 1.1, N), 1.0),
             cs_s=srt(rng.uniform(0.8, 1.2, N), 1.0),
             om_s=srt(rng.uniform(0.9, 1.1, N), 1.0),
             bf_s=srt(rng.uniform(0.0, 1.0, N), 0.0))
    return spec, tspec, jw, tw, f, np.asarray(jw.is_real)


def _compare(got, want, real, what):
    got, want = np.asarray(got)[real], np.asarray(want)[real]
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("compact", [False, True])
def test_window_tables_1d_equal_reference(compact):
    ic, jd, td, spec, tspec = _geometry(compact)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(spec)
    assert tspec.n_seg == 1 and bool(tspec.cwidth) == compact
    jw = _jbuild(jnp.asarray(ic["pos"]), jd, spec)
    tw = twin.build(torch.as_tensor(ic["pos"]), td, tspec)
    names = ["g", "src", "inv", "is_real", "w_lo", "w_nact", "t_lo",
             "t_nact", "overflow", "max_run"]
    if compact:
        names += ["c_n", "c_max"]
        np.testing.assert_array_equal(
            twin.compact_index(tw, tspec).numpy(), np.asarray(jw.c_idx))
    for k in names:
        np.testing.assert_array_equal(getattr(tw, k).numpy(),
                                      np.asarray(getattr(jw, k)), err_msg=k)
    assert int(tw.overflow) == 0


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("case", ["cold_newton2", "h_predict"])
def test_solve_h_density_1d_plain_matches_pallas(case, compact):
    cfg = CFG if case == "cold_newton2" else dataclasses.replace(
        CFG, newton_iters=1, h_predict=True)
    spec, tspec, jw, tw, f, real = _problem(compact)
    want = pk.solve_h_density(jw, spec, *(jnp.asarray(f[k]) for k in A_ARGS),
                              _jcfg(cfg), vel_s=jnp.asarray(f["vel_s"]),
                              u_s=jnp.asarray(f["u_s"]))
    got = wk.solve_h_density(tw, tspec, *(torch.as_tensor(f[k])
                                          for k in A_ARGS), cfg,
                             vel_s=torch.as_tensor(f["vel_s"]))
    assert len(got) == len(want) == 5
    for k, (a, b) in enumerate(zip(got, want)):
        _compare(a, b, real, f"{case} output {k}")
    # no curl in one dimension
    assert not bool(got[4][torch.as_tensor(real.copy())].any())


@pytest.mark.parametrize("compact", [False, True])
def test_forces_1d_plain_matches_pallas(compact):
    spec, tspec, jw, tw, f, real = _problem(compact, seed=2)
    want = pk.forces(jw, spec, *(jnp.asarray(f[k]) for k in C_ARGS),
                     _jcfg(CFG))
    got = wk.forces(tw, tspec, *(torch.as_tensor(f[k]) for k in C_ARGS), CFG)
    assert tuple(got[0].shape) == (tspec.n_sorted, 1)
    _compare(got[0], want[0], real, "acc")
    _compare(got[1], want[1], real, "du")


def test_trajectory_1d_lockstep():
    """4 KDK steps with a rebuild every 2 on the 1D box: the port's
    simulate against the reference's jnp path at 1e-9."""
    ic, jd, td, spec, tspec = _geometry(False, seed=3)
    fields = ("pos", "vel", "mass", "u", "h")
    jst = sphax.make_state(*(jnp.asarray(ic[k]) for k in fields))
    tst = make_state(*(torch.as_tensor(ic[k]) for k in fields))
    jst = jeng.update_derived(jst, _jcfg(CFG), jd, spec, use_pallas=False)
    tst = teng.update_derived(tst, CFG, td, tspec)
    for k in ("h", "rho", "P", "omega", "divv", "acc", "du_dt"):
        _close(getattr(tst, k), getattr(jst, k), 1e-10, k)
    jout, _, jdts, jovf = jeng.simulate(jst, _jcfg(CFG), jd, spec, 4,
                                        rebuild_every=2, use_pallas=False)
    tout, _, tdts, tovf = teng.simulate(tst, CFG, td, tspec, 4,
                                        rebuild_every=2)
    assert int(tovf) == int(jovf) == 0
    _close(tdts, jdts, 1e-9, "dts")
    for k in ("pos", "vel", "u", "h", "rho"):
        _close(getattr(tout, k), getattr(jout, k), 1e-9, k)
