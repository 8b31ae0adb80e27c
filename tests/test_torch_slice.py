"""The port's main path against ``sphax.physics.wengine`` on the same inputs.

One derived pass (cold Newton solve, Balsara, production window knobs)
against the Pallas kernels in interpret mode, and a 4-step driven
trajectory with the h predictor against the jnp path, with the JAX
package's own OU draws replayed into the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import sphax
from sphax.ics import turbulence as jturb
from sphax.neighbors import window as jwin
from sphax.physics import driving as jdrv
from sphax.physics import wengine as jeng
from sphax.run import DriveSpec as JDriveSpec
from sphax_torch import configs as tconf
from sphax_torch import convert
from sphax_torch.physics import driving as tdrv
from sphax_torch.physics import wengine as teng

torch.set_num_threads(1)

# bench.py's window knobs (production geometry)
KNOBS = dict(cutoff_scale=1.05, ghost_safety=1.4, fast_sub=3, rgroups=2)
DERIVED = ("h", "rho", "P", "omega", "divv", "acc", "du_dt")


def _jcfg(cfg):
    return sphax.SPHConfig(**dataclasses.asdict(cfg))


def _setup(n_side=10, seed=11):
    """Turbulence ICs with a seeded 0.3 N(0,1) velocity, in both packages,
    with the reference's measured plan carried across."""
    ic = jturb.build(n_side=n_side)
    ic["vel"] = 0.3 * np.random.default_rng(seed).standard_normal(
        ic["pos"].shape)
    fields = ("pos", "vel", "mass", "u", "h")
    jst = sphax.make_state(*(jnp.asarray(ic[k]) for k in fields))
    jd = sphax.box(jnp.zeros(3), jnp.asarray(ic["box"]))
    spec = jwin.plan_measured(jst.pos, jd, h_max=float(ic["h"].max()) * 1.05,
                              dim=3, **KNOBS)
    tst = convert.state_from_numpy(
        {k: np.asarray(getattr(jst, k)) for k in jst._fields}, "cpu",
        torch.float64)
    td = convert.domain_from_numpy(np.zeros(3), ic["box"], True, "cpu",
                                   torch.float64)
    tspec = convert.spec_from_fields(**dataclasses.asdict(spec))
    return jst, jd, spec, tst, td, tspec


def _close(got, want, rtol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def test_update_derived_matches_pallas_interpret():
    cfg = dataclasses.replace(tconf.TURB, newton_iters=1)
    jst, jd, spec, tst, td, tspec = _setup()
    want = jeng.update_derived(jst, _jcfg(cfg), jd, spec, use_pallas=True)
    got = teng.update_derived(tst, cfg, td, tspec)
    for k in DERIVED:
        _close(getattr(got, k), getattr(want, k), 1e-10, k)
    assert int(teng.overflow_count(tst, td, tspec)) == 0
    assert int(teng.capped_count(got, tspec)) == int(
        jeng.capped_count(want, spec))


def _jax_noise(key, n_modes, steps):
    """The standard-normal draws jax's driving.update makes, step by step."""
    draws = []
    for _ in range(steps):
        key, k1, k2 = jax.random.split(key, 3)
        draws.append(tuple(np.array(jax.random.normal(k, (n_modes, 3),
                                                      jnp.float64))
                           for k in (k1, k2)))
    return draws


def test_driven_trajectory_lockstep():
    """4 KDK steps, rebuild every 2, h_predict + OU driving: the port's
    simulate against the reference's jnp path at rtol 1e-9."""
    steps = 4
    cfg = dataclasses.replace(tconf.TURB, newton_iters=1, h_predict=True)
    jst, jd, spec, tst, td, tspec = _setup(seed=12)
    modes = tuple(map(tuple, jdrv.make_modes(1, 2).astype(int)))
    np.testing.assert_array_equal(tdrv.make_modes(1, 2),
                                  jdrv.make_modes(1, 2))
    jspec = JDriveSpec(modes=modes, tau=0.5, accel_rms=3.0)
    tspec_d = tdrv.DriveSpec(modes=modes, tau=0.5, accel_rms=3.0)
    key = jax.random.PRNGKey(5)
    jdr = jdrv.init(key, modes)
    tdr = convert.drive_from_numpy(np.asarray(jdr.amp_re),
                                   np.asarray(jdr.amp_im), "cpu",
                                   torch.float64)

    jst = jeng.update_derived(jst, _jcfg(cfg), jd, spec, use_pallas=False)
    jout, jdr, jdts, jovf = jeng.simulate(
        jst, _jcfg(cfg), jd, spec, steps, rebuild_every=2, use_pallas=False,
        drive=jdr, drive_spec=jspec)

    draws = iter(_jax_noise(key, len(modes), steps))

    def noise(shape, dtype, device):
        return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                     for x in next(draws))

    tst = teng.update_derived(tst, cfg, td, tspec)
    tout, tdr, tdts, tovf = teng.simulate(
        tst, cfg, td, tspec, steps, rebuild_every=2,
        drive=tdr, drive_spec=tspec_d, noise=noise)

    assert int(tovf) == int(jovf) == 0
    _close(tdts, jdts, 1e-9, "dts")
    got = convert.state_to_numpy(tout)
    for k in ("pos", "vel", "h", "rho"):
        _close(got[k], getattr(jout, k), 1e-9, k)
    _close(tdr.amp_re, jdr.amp_re, 1e-9, "amp_re")
    _close(tdr.amp_im, jdr.amp_im, 1e-9, "amp_im")
