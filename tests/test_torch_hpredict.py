"""The h predictor's gates (``cfg.h_predict``) on the port's
``wengine.stage_density`` (the port of tests/unit/test_h_predict.py's
``test_h_predict_walk_clamped_to_structural_cap``,
``test_h_predict_trash_rows_inert`` and
``test_h_predict_config_validation``): the density walk never runs above
the structural cap h = cutoff / 2, rows without mass pass through the
lagged Newton correction untouched, and the configuration is validated.
The predictor pass itself, over-cap rows and pad rows included, equals the
JAX package's jnp pass at 1e-10. The card's gates (Sod L1 and a 30-step
lockstep against full Newton) are ``chip_smoke.py`` phase 32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax.neighbors import window as jwin
from sphax.physics import wengine as jeng
from sphax_torch import configs, convert, make_state
from sphax_torch.core.state import box
from sphax_torch.ics import turbulence
from sphax_torch.neighbors import window as win
from sphax_torch.physics import wengine

torch.set_num_threads(1)

BASE = dataclasses.replace(configs.TURB, newton_iters=6)
PRED = dataclasses.replace(BASE, h_predict=True, newton_iters=1)


def _setup(cfg, n_side=10, vel_seed=0):
    """test_h_predict.py's set-up on the port: the turbulence lattice with
    a seeded 0.3 N(0,1) velocity (numpy), plan_measured at h_max x 1.3 and
    cutoff_scale 1.25, the derived pass."""
    ic = turbulence.build(n_side=n_side)
    ic["vel"] = 0.3 * np.random.default_rng(vel_seed).standard_normal(
        ic["pos"].shape)
    st = make_state(*(torch.as_tensor(ic[k]) for k in
                      ("pos", "vel", "mass", "u", "h")))
    dom = box(torch.zeros(3, dtype=torch.float64),
              torch.as_tensor(ic["box"]))
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.3,
                             dim=3, cutoff_scale=1.25)
    return wengine.update_derived(st, cfg, dom, spec), dom, spec


def _sorted_inputs(st, wd):
    return (win.refresh_pos(st.pos, wd), win.gather_sorted(st.vel, wd),
            win.gather_sorted(st.mass, wd), win.gather_sorted(st.u, wd))


def test_h_predict_walk_clamped_to_structural_cap():
    """An over-cap input h gives EXACTLY the outputs of h at the cap on
    every real row (windows cover neighbours to spec.cutoff only: an
    unclamped walk would truncate the sums), and no output h exceeds it."""
    st, dom, spec = _setup(PRED)
    wd = win.build(st.pos, dom, spec)
    pos_s, vel_s, mass_s, u_s = _sorted_inputs(st, wd)
    hcap = 0.5 * spec.cutoff
    over = wengine.stage_density(wd, spec, PRED, pos_s, vel_s, mass_s, u_s,
                                 torch.full_like(mass_s, 1.2 * hcap))
    capped = wengine.stage_density(wd, spec, PRED, pos_s, vel_s, mass_s, u_s,
                                   torch.full_like(mass_s, hcap))
    real = mass_s > 0
    for a, b, name in zip(over, capped, ("h", "rho", "om", "vf", "divv")):
        assert torch.equal(a[real], b[real]), name
    assert float(over[0][real].max()) <= hcap * (1 + 1e-6)


def test_h_predict_trash_rows_inert():
    """Rows without mass (h fill 1.0) leave the lagged Newton correction
    as they came in (it would drive them to h = 0.5)."""
    st, dom, spec = _setup(PRED)
    wd = win.build(st.pos, dom, spec)
    pos_s, vel_s, mass_s, u_s = _sorted_inputs(st, wd)
    h_s = win.gather_sorted(st.h, wd, fill=1.0)
    h_out = wengine.stage_density(wd, spec, PRED, pos_s, vel_s, mass_s, u_s,
                                  h_s)[0]
    trash = ~(mass_s > 0)
    assert bool(trash.any())
    assert torch.equal(h_out[trash], h_s[trash])


def test_h_predict_config_validation():
    with pytest.raises(ValueError, match="h_predict"):
        configs.SPHConfig(h_predict=True)  # no need_divv source
    with pytest.raises(ValueError, match="h_predict"):
        dataclasses.replace(configs.TURB, h_predict=True, adaptive_h=False)
    # the valid combination constructs
    dataclasses.replace(configs.TURB, h_predict=True)


def test_h_predict_pass_matches_reference():
    """The predictor's density pass (the cap clamp before the walk, one
    Newton walk, the lagged correction on real rows) equals the JAX
    package's jnp pass at 1e-10 on real rows, with a quarter of the rows
    above the cap, and bitwise on the rows without mass."""
    st, dom, spec = _setup(PRED)
    wd = win.build(st.pos, dom, spec)
    pos_s, vel_s, mass_s, u_s = _sorted_inputs(st, wd)
    hcap = 0.5 * spec.cutoff
    h_s = win.gather_sorted(st.h, wd, fill=1.0)
    h_s = torch.where(torch.arange(h_s.numel()) % 4 == 0, 1.1 * hcap, h_s)
    got = wengine.stage_density(wd, spec, PRED, pos_s, vel_s, mass_s, u_s,
                                h_s)
    jdom = sphax.box(jnp.zeros(3), jnp.ones(3))
    h_max = float(turbulence.build(n_side=10)["h"].max()) * 1.3
    jspec = jwin.plan_measured(jnp.asarray(st.pos.numpy()), jdom,
                               h_max=h_max, dim=3, cutoff_scale=1.25)
    assert convert.spec_from_fields(**dataclasses.asdict(jspec)) == spec
    # the two builds' tables are equal (tests/test_torch_window.py), so
    # both passes take the same sorted rows
    jwd = jax.jit(jwin.build, static_argnums=2)(
        jnp.asarray(st.pos.numpy()), jdom, jspec)
    want = jeng.stage_density(
        jwd, jspec, sphax.SPHConfig(**dataclasses.asdict(PRED)),
        *(jnp.asarray(f.numpy()) for f in (pos_s, vel_s, mass_s, u_s, h_s)))
    real = (mass_s > 0).numpy()
    for a, b, name in zip(got, want, ("h", "rho", "om", "vf", "divv")):
        a, b = a.numpy(), np.asarray(b)
        scale = np.abs(b[real]).max()
        np.testing.assert_allclose(a[real], b[real], rtol=1e-10,
                                   atol=1e-10 * scale, err_msg=name)
    np.testing.assert_array_equal(got[0].numpy()[~real],
                                  np.asarray(want[0])[~real])
