"""Drift-gated window rebuilds (``wengine.simulate(adaptive_rebuild=K)``).

The port of tests/unit/test_wengine_adaptive.py: the gate changes when the
structure is rebuilt, never the pair set, so the adaptive trajectory equals
the fixed cadence's to summation-order roundoff, and under hot velocities
the gate fires before the age cap. Then a lockstep against ``sphax``'s
adaptive loop with the same noise draws, and ``adaptive=K`` through the
CLI.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import torch

from sphax.physics import driving as jdrv
from sphax.physics import wengine as jeng
from sphax.run import DriveSpec as JDriveSpec
from sphax_torch import configs as tconf
from sphax_torch import convert, make_state
from sphax_torch.__main__ import main
from sphax_torch.core.state import box
from sphax_torch.ics import turbulence
from sphax_torch.neighbors import window as win
from sphax_torch.physics import driving, wengine
from tests.test_torch_slice import _close, _jax_noise, _jcfg, _setup

torch.set_num_threads(1)

CFG = dataclasses.replace(tconf.TURB, newton_iters=2)


def _state(n_side=10, vel_seed=0, vel_scale=0.1):
    """test_wengine_adaptive.py's set-up in the port: turbulence ICs with a
    seeded normal velocity (numpy), h_max 1.3 x, cutoff_scale 1.25."""
    ic = turbulence.build(n_side=n_side)
    vel = vel_scale * np.random.default_rng(vel_seed).standard_normal(
        ic["pos"].shape)
    st = make_state(*(torch.as_tensor(a) for a in (
        ic["pos"], vel, ic["mass"], ic["u"], ic["h"])))
    dom = box(torch.zeros(3, dtype=torch.float64),
              torch.as_tensor(ic["box"]))
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.3,
                             dim=3, cutoff_scale=1.25)
    return wengine.update_derived(st, CFG, dom, spec), dom, spec


def _replay(draws):
    it = iter(draws)

    def noise(shape, dtype, device):
        return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                     for x in next(it))
    return noise


def test_adaptive_rebuild_matches_fixed():
    st, dom, spec = _state()
    modes = tuple(map(tuple, driving.make_modes(1, 2).astype(int)))
    dspec = driving.DriveSpec(modes=modes, tau=0.5, accel_rms=0.5,
                              box_size=float(dom.hi[0]))
    dr = driving.init(len(modes), dtype=torch.float64)
    nsteps = 6
    rng = np.random.default_rng(3)
    draws = [tuple(rng.standard_normal((len(modes), 3)) for _ in range(2))
             for _ in range(nsteps)]
    ref, drv_f, dts_f, ovf_f = wengine.simulate(
        st, CFG, dom, spec, nsteps, rebuild_every=1, drive=dr,
        drive_spec=dspec, noise=_replay(draws))
    st_a, drv_a, dts_a, ovf_a, builds = wengine.simulate(
        st, CFG, dom, spec, nsteps, drive=dr, drive_spec=dspec,
        noise=_replay(draws), adaptive_rebuild=nsteps)
    assert int(ovf_f) == 0 and int(ovf_a) == 0
    assert 1 <= builds < nsteps          # fewer builds than the fixed run
    np.testing.assert_allclose(dts_a.numpy(), dts_f.numpy(), rtol=1e-9)
    for f in ("pos", "vel", "u", "rho", "h", "P"):
        np.testing.assert_allclose(getattr(st_a, f).numpy(),
                                   getattr(ref, f).numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=f)
    np.testing.assert_allclose(drv_a.amp_re.numpy(), drv_f.amp_re.numpy(),
                               rtol=1e-8, atol=1e-12)


def test_adaptive_gate_forces_rebuild_under_drift():
    """Hot velocities and a cap that never binds: only the gate can
    rebuild, and it must, or the structure goes stale; overflow stays 0."""
    st, dom, spec = _state(vel_seed=4)
    st = st._replace(vel=5.0 * st.vel)
    st_a, _, dts_a, ovf_a, builds = wengine.simulate(
        st, CFG, dom, spec, 8, adaptive_rebuild=10_000)
    assert int(ovf_a) == 0
    assert builds > 1
    assert bool(torch.isfinite(st_a.rho).all())
    assert bool((dts_a > 0).all())


def test_adaptive_lockstep_with_reference():
    """The port's adaptive loop against sphax's (jnp path), float64, the
    bench window knobs, OU driving with the reference's draws replayed, at
    1e-9; a tight skin makes the gate and the age cap both decide."""
    steps, K = 6, 4
    cfg = dataclasses.replace(tconf.TURB, newton_iters=1, h_predict=True)
    jst, jd, spec, tst, td, tspec = _setup(seed=13)
    modes = tuple(map(tuple, jdrv.make_modes(1, 2).astype(int)))
    jspec = JDriveSpec(modes=modes, tau=0.5, accel_rms=3.0)
    key = jax.random.PRNGKey(7)
    jdr = jdrv.init(key, modes)
    tdr = convert.drive_from_numpy(np.asarray(jdr.amp_re),
                                   np.asarray(jdr.amp_im), "cpu",
                                   torch.float64)
    jst = jeng.update_derived(jst, _jcfg(cfg), jd, spec, use_pallas=False)
    jout, jdr, jdts, jovf = jeng.simulate(
        jst, _jcfg(cfg), jd, spec, steps, use_pallas=False, drive=jdr,
        drive_spec=jspec, adaptive_rebuild=K)
    tst = wengine.update_derived(tst, cfg, td, tspec)
    tout, tdr, tdts, tovf, builds = wengine.simulate(
        tst, cfg, td, tspec, steps, drive=tdr,
        drive_spec=driving.DriveSpec(modes=modes, tau=0.5, accel_rms=3.0),
        noise=_replay(_jax_noise(key, len(modes), steps)),
        adaptive_rebuild=K)
    assert int(tovf) == int(jovf) == 0
    assert builds > 1 + steps // K      # the gate fired, not only the cap
    _close(tdts, jdts, 1e-9, "dts")
    got = convert.state_to_numpy(tout)
    for k in ("pos", "vel", "h", "rho", "u"):
        _close(got[k], getattr(jout, k), 1e-9, k)
    _close(tdr.amp_re, jdr.amp_re, 1e-9, "amp_re")
    _close(tdr.amp_im, jdr.amp_im, 1e-9, "amp_im")


def test_cli_adaptive_records_rebuilds(tmp_path):
    """adaptive=K through the CLI: a chunk runs exactly ``chunk`` steps
    (no rounding to whole rebuild periods), clamped to max_steps, and each
    record carries the builds of its chunk."""
    out = str(tmp_path)
    _, _, step = main(["turb", "n=12", "adaptive=4", "max_steps=5",
                       "chunk=3", "device=cpu", f"out={out}"])
    assert step == 5
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [3, 5, 5]
    assert all(r["finite"] for r in recs)
    # 3 steps with an age cap of 4: one build, or two if the gate fired
    assert [1 <= r["rebuilds"] <= 2 for r in recs[:2]] == [True, True]
    assert "rebuilds" not in recs[-1]
