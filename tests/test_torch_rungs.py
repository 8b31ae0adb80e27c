"""Block timesteps (``sphax_torch.integrate.rungs``, the CLI's ``rungs=B``)
against ``sphax.integrate.rungs`` on the same inputs, float64, on the CPU.

The masked tables equal the reference's exactly; one masked derived pass
agrees at 1e-10 (jnp path and interpret-mode Pallas), equals bit for bit
the composition it ran before it became ``wengine.derived_with`` over its
closers, and with every particle closing equals ``derived_with``; B = 1
equals the port's own global-dt loop at 1e-9; a multi-rung Sedov span
equals the reference's at 1e-9 with equal counters; drift-gated rebuilds
change when the structure is built, never the pairs (1e-6 against the
fixed cadence, 1e-9 against the reference's gated loop); a compact spec
gives the in-place trajectory; and the CLI's rung chunk reports and
refuses what the JAX CLI does. Tolerances are relative, with the same
factor of the largest value as the absolute floor: sums are taken in
another order.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax.ics import sedov as jsedov
from sphax.ics import turbulence as jturb
from sphax.integrate import rungs as jrungs
from sphax.neighbors import window as jwin
from sphax.physics import wengine as jeng
from sphax_torch import __main__ as cli
from sphax_torch import configs as tconf
from sphax_torch import convert, problems
from sphax_torch.integrate import rungs
from sphax_torch.neighbors import window as win
from sphax_torch.physics import wengine
from sphax_torch.physics.eos import eos
from tests.test_torch_slice import _close, _jcfg

torch.set_num_threads(1)

SEDOV2 = dataclasses.replace(tconf.SEDOV, newton_iters=2)
SEDOV_MM = dataclasses.replace(SEDOV2, balsara=False, mm_visc=True)
TURB2 = dataclasses.replace(tconf.TURB, newton_iters=2)
STATE = ("pos", "vel", "u", "rho", "h", "P")


def _setup(cfg, ic="sedov", n_side=10, vel_seed=None, vel_scale=0.1,
           **plan_kw):
    """tests/unit/test_rungs.py's set-up in both packages: the ICs (with a
    seeded normal velocity from numpy where asked), plan_measured at
    h_max x 1.3 and cutoff_scale 1.25, and the reference's cold derived pass
    (jnp path), whose state the port starts from."""
    ic = (jsedov.build(n_side=n_side, E=1.0) if ic == "sedov"
          else jturb.build(n_side=n_side))
    if vel_seed is not None:
        ic["vel"] = vel_scale * np.random.default_rng(
            vel_seed).standard_normal(ic["pos"].shape)
    jd = sphax.box(jnp.zeros(3), jnp.asarray(ic["box"]))
    jst = sphax.make_state(
        *(jnp.asarray(ic[k]) for k in ("pos", "vel", "mass", "u", "h")),
        alpha0=cfg.mm_alpha_min if cfg.mm_visc else 1.0)
    spec = jwin.plan_measured(jst.pos, jd, h_max=float(ic["h"].max()) * 1.3,
                              dim=3, cutoff_scale=1.25, **plan_kw)
    jst = jeng.update_derived(jst, _jcfg(cfg), jd, spec, use_pallas=False)
    tst = convert.state_from_numpy(
        {k: np.asarray(getattr(jst, k)) for k in jst._fields}, "cpu",
        torch.float64)
    td = convert.domain_from_numpy(np.zeros(3), ic["box"], True, "cpu",
                                   torch.float64)
    tspec = convert.spec_from_fields(**dataclasses.asdict(spec))
    return jst, jd, spec, tst, td, tspec


def _states_close(got, want, rtol, fields=STATE):
    for k in fields:
        a, b = getattr(got, k), getattr(want, k)
        _close(a, b.numpy() if isinstance(b, torch.Tensor) else b, rtol, k)


@pytest.mark.parametrize("rgroups", [1, 2])
def test_mask_structure_tables_equal_reference(rgroups):
    """One active particle: the groups (and tiles) without an active row
    lose their w_nact (t_nact) rows, the others keep them, exactly as in
    the reference."""
    kw = dict(rgroups=2, fast_sub=3) if rgroups == 2 else {}
    jst, jd, spec, tst, td, tspec = _setup(
        dataclasses.replace(tconf.TURB, newton_iters=1), ic="turb",
        n_side=12, **kw)
    assert tspec.rgroups == rgroups
    jwd = jax.jit(jwin.build, static_argnums=2)(jst.pos, jd, spec)
    twd = win.build(tst.pos, td, tspec)
    close = np.zeros(tst.n, bool)
    close[tst.n // 2] = True
    jact = jwin.gather_sorted(jnp.asarray(close, jst.pos.dtype), jwd) > 0.5
    tact = win.gather_sorted(torch.as_tensor(close, dtype=torch.float64),
                             twd) > 0.5
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    jm = jrungs.mask_structure(jwd, spec, jact)
    tm = rungs.mask_structure(twd, tspec, tact)
    for k in ("w_lo", "w_nact", "t_lo", "t_nact"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), k)
        assert getattr(tm, k).dtype == torch.int32
    act_g = tact.reshape(tspec.n_groups, tspec.group).any(1).numpy()
    assert act_g.any() and not act_g.all()
    assert (tm.w_nact.numpy()[~act_g] == 0).all()
    np.testing.assert_array_equal(tm.w_nact.numpy()[act_g],
                                  twd.w_nact.numpy()[act_g])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_derived_rungs_matches_reference(use_pallas):
    """One masked derived pass with a seeded close mask (30 % closing) and a
    seeded stale viscosity factor: every field of the state and the carried
    factor at 1e-10, against the jnp path and against interpret-mode
    Pallas."""
    jst, jd, spec, tst, td, tspec = _setup(SEDOV2, vel_seed=2)
    rng = np.random.default_rng(5)
    close = rng.random(tst.n) < 0.3
    bf_prev = rng.uniform(0.0, 1.0, tst.n)
    jwd = jax.jit(jwin.build, static_argnums=2)(jst.pos, jd, spec)
    want, bf_want = jrungs._derived_rungs(
        jst, jnp.asarray(bf_prev), jwd, _jcfg(SEDOV2), jd, spec,
        jnp.asarray(close), 16, use_pallas)
    got, bf_got = rungs._derived_rungs(
        tst, torch.as_tensor(bf_prev), win.build(tst.pos, td, tspec), SEDOV2,
        td, tspec, torch.as_tensor(close))
    _states_close(got, want, 1e-10, fields=(
        "h", "rho", "P", "cs", "omega", "acc", "du_dt", "divv"))
    _close(bf_got, bf_want, 1e-10, "bf")
    # the rows that did not close keep their stale force fields
    stale = torch.as_tensor(~close)
    assert torch.equal(got.acc[stale], tst.acc[stale])
    assert torch.equal(got.du_dt[stale], tst.du_dt[stale])


def _rung_pass_before(state, bf_prev, wd, cfg, domain, spec, close_m):
    """``rungs._derived_rungs`` as it was before the rung tick's pass became
    ``wengine.derived_with`` over its closers, frozen: one packed gather of
    the close flag, the kinematics, u and the stale h, rho, Omega and
    viscosity factor; the field-taking entries of kernels A and C on the
    masked structure; the fresh-or-stale select, the owner mirror, the EOS
    and the unsort written out."""
    dim = state.dim
    dtype = state.pos.dtype
    cols = [close_m.to(dtype)[:, None], state.pos, state.vel,
            state.mass[:, None], state.u[:, None], state.h[:, None],
            state.rho[:, None], state.omega[:, None], bf_prev[:, None]]
    fills = [0.0] + [0.0] * (2 * dim) + [0.0, 0.0, 1.0, 1.0, 1.0, 1.0]
    if cfg.mm_visc:
        cols.append(state.alpha[:, None])
        fills.append(1.0)
    g_s = win.gather_sorted_cols(torch.cat(cols, dim=-1), wd, fills)
    act_s = g_s[:, 0] > 0.5
    wd_act = rungs.mask_structure(wd, spec, act_s)
    pos_s = g_s[:, 1:1 + dim] + wd.shift_s
    vel_s = g_s[:, 1 + dim:1 + 2 * dim]
    c0 = 1 + 2 * dim
    mass_s, u_s, h_s = g_s[:, c0], g_s[:, c0 + 1], g_s[:, c0 + 2]
    alpha_s = g_s[:, c0 + 6] if cfg.mm_visc else None
    h_f, rho_f, om_f, bf_f, divv_f = wengine.stage_density(
        wd_act, spec, cfg, pos_s, vel_s, mass_s, u_s, h_s, alpha_s=alpha_s)
    fresh = torch.stack([h_f, rho_f, om_f, bf_f], dim=-1)
    stale = g_s[:, c0 + 2:c0 + 6]
    mirrored = torch.where(act_s[:, None], fresh, stale)[wd.src]
    h_c, rho_c, om_c, bf_c = mirrored.unbind(-1)
    P_c, cs_c = eos(rho_c, u_s, cfg)
    acc_s, du_s = wengine.stage_forces(
        wd_act, spec, cfg, pos_s, vel_s, mass_s, h_c, rho_c, P_c, cs_c,
        om_c, bf_c)
    out = torch.stack([h_c, rho_c, P_c, cs_c, om_c, du_s, divv_f, bf_c]
                      + list(acc_s.unbind(-1)), dim=-1)[wd.inv]
    acc = torch.where(close_m[:, None], out[:, 8:8 + dim], state.acc)
    return state._replace(
        h=out[:, 0], rho=out[:, 1], P=out[:, 2], cs=out[:, 3],
        omega=out[:, 4],
        du_dt=torch.where(close_m, out[:, 5], state.du_dt),
        divv=torch.where(close_m, out[:, 6], state.divv),
        acc=acc), out[:, 7]


def _rung_pass_inputs(problem, dtype, h_predict=False):
    """The port's own set-up of one rung pass, on the CPU: the CLI's Sedov
    (10^3, grad-h, Balsara) or 2D Kelvin-Helmholtz (n=16) ICs with a seeded
    velocity, one cold derived pass, then a seeded drift of 0.05 h so
    that the stale fields are not the fresh ones; the structure built on
    the drifted positions, a seeded 30 % close mask and a seeded stale
    viscosity factor. Returns (state, domain, spec, wd, cfg, close_m,
    bf_prev)."""
    prob = (problems.sedov(n=10, dtype=dtype, device="cpu")
            if problem == "sedov"
            else problems.kh(n=16, dtype=dtype, device="cpu"))
    st, dom, cfg = prob.state, prob.domain, prob.cfg
    gen = torch.Generator().manual_seed(5)
    st = st._replace(vel=0.1 * torch.randn(st.vel.shape, generator=gen,
                                           dtype=dtype))
    _, spec = problems._window_engine(st, cfg, dom, h_margin=1.5)
    st = wengine.update_derived(st, cfg, dom, spec)
    st = st._replace(pos=dom.wrap(st.pos + 0.05 * st.h[:, None] * torch.randn(
        st.pos.shape, generator=gen, dtype=dtype)))
    if h_predict:
        cfg = dataclasses.replace(cfg, newton_iters=1, h_predict=True)
    close = torch.rand(st.n, generator=gen) < 0.3
    bf_prev = torch.rand(st.n, generator=gen, dtype=dtype)
    return (st, dom, spec, win.build(st.pos, dom, spec), cfg, close,
            bf_prev)


DERIVED = ("h", "rho", "P", "cs", "omega", "acc", "du_dt", "divv")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("h_predict", [False, True])
@pytest.mark.parametrize("problem", ["sedov", "kh"])
def test_derived_rungs_equals_the_composition_it_replaced(problem, h_predict,
                                                          dtype):
    """The rung tick's pass, now ``wengine.derived_with`` over its closers
    and packing through ``rowpack``, gives the frozen composition's every
    output bit for bit: the EOS of the owner's row equals the EOS of the
    mirrored row on every real and ghost row."""
    st, dom, spec, wd, cfg, close, bf_prev = _rung_pass_inputs(
        problem, dtype, h_predict)
    assert 0 < int(close.sum()) < st.n
    got, bf_got = rungs._derived_rungs(st, bf_prev, wd, cfg, dom, spec,
                                       close)
    want, bf_want = _rung_pass_before(st, bf_prev, wd, cfg, dom, spec, close)
    for f in DERIVED:
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a, b), (f, int((a != b).sum()))
    assert torch.equal(bf_got, bf_want)
    assert not torch.equal(got.rho[close], st.rho[close])
    assert torch.equal(got.acc[~close], st.acc[~close])


@pytest.mark.parametrize("problem", ["sedov", "kh"])
def test_derived_rungs_with_every_row_closing_is_derived_with(problem):
    """With every particle closing the rung tick's pass is the global
    step's, bit for bit."""
    st, dom, spec, wd, cfg, _, bf_prev = _rung_pass_inputs(problem,
                                                           torch.float64)
    every = torch.ones(st.n, dtype=torch.bool)
    got, _ = rungs._derived_rungs(st, bf_prev, wd, cfg, dom, spec, every)
    want = wengine.derived_with(st, wd, cfg, dom, spec)
    for f in DERIVED:
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a, b), (f, int((a != b).sum()))


@pytest.mark.parametrize("h_predict", [False, True])
def test_rungs_b1_matches_global_dt(h_predict):
    """n_rungs=1: every particle on rung 0 and spans of one tick, the
    global-dt KDK sequence of the port's own wengine.simulate, at 1e-9;
    with h_predict the per-closer predictor is leapfrog.step's."""
    cfg = (dataclasses.replace(tconf.TURB, newton_iters=1, h_predict=True)
           if h_predict else TURB2)
    _, _, _, st, dom, spec = _setup(TURB2, ic="turb", vel_seed=0)
    nsteps = 4
    st_g, _, dts_g, ovf_g = wengine.simulate(st, cfg, dom, spec, nsteps,
                                             rebuild_every=1)
    st_r, dts_r, nact, ovf_r, viol, builds = rungs.simulate_rungs(
        st, cfg, dom, spec, nspans=nsteps, n_rungs=1, rebuild_every=1)
    assert int(ovf_g) == 0 and int(ovf_r) == 0 and int(viol) == 0
    assert builds == nsteps and nact.dtype == torch.int32
    assert bool((nact == st.n).all())
    np.testing.assert_allclose(dts_r.numpy(), dts_g.numpy(), rtol=1e-12)
    _states_close(st_r, st_g, 1e-9)


@pytest.mark.parametrize("visc", ["balsara", "mm"])
def test_multirung_lockstep_with_reference(visc):
    """Sedov n_side=10, B = 3, one span of 4 ticks with a rebuild every 2:
    dts and the state at 1e-9 against sphax's simulate_rungs (jnp path),
    with equal closing counts, dt violations and builds; the blast spreads
    the particles over the rungs."""
    cfg = SEDOV_MM if visc == "mm" else SEDOV2
    jst, jd, spec, tst, td, tspec = _setup(cfg)
    jout, jdts, jnact, jovf, jviol, jnrb = jrungs.simulate_rungs(
        jst, _jcfg(cfg), jd, spec, nspans=1, n_rungs=3, rebuild_every=2,
        use_pallas=False)
    tout, tdts, tnact, tovf, tviol, tnrb = rungs.simulate_rungs(
        tst, cfg, td, tspec, nspans=1, n_rungs=3, rebuild_every=2)
    assert int(tovf) == int(jovf) == 0
    np.testing.assert_array_equal(tnact.numpy(), np.asarray(jnact))
    assert int(tnact.min()) < tst.n == int(tnact[-1])
    assert (int(tviol), tnrb) == (int(jviol), int(jnrb))
    _close(tdts, jdts, 1e-9, "dts")
    _states_close(tout, jout, 1e-9, fields=STATE + ("acc", "du_dt", "alpha"))


def test_adaptive_rebuild_matches_fixed_and_reference():
    """Drift-gated rebuilds (cap 8 ticks, rebuild_every ignored) against a
    rebuild every tick: fewer builds, equal closing counts and violations,
    the state at 1e-6; and against sphax's gated loop at 1e-9 with the same
    builds."""
    jst, jd, spec, tst, td, tspec = _setup(SEDOV2)
    kw = dict(nspans=2, n_rungs=3)
    ref, dts_f, nact_f, ovf_f, viol_f, nrb_f = rungs.simulate_rungs(
        tst, SEDOV2, td, tspec, rebuild_every=1, **kw)
    st_a, dts_a, nact_a, ovf_a, viol_a, nrb_a = rungs.simulate_rungs(
        tst, SEDOV2, td, tspec, rebuild_every=3, adaptive_rebuild=8, **kw)
    assert int(ovf_f) == 0 and int(ovf_a) == 0
    assert 1 <= nrb_a < nrb_f == 8
    np.testing.assert_allclose(dts_a.numpy(), dts_f.numpy(), rtol=1e-9)
    assert torch.equal(nact_a, nact_f) and int(viol_a) == int(viol_f)
    _states_close(st_a, ref, 1e-6)
    jout, jdts, jnact, jovf, jviol, jnrb = jrungs.simulate_rungs(
        jst, _jcfg(SEDOV2), jd, spec, rebuild_every=3, use_pallas=False,
        adaptive_rebuild=8, **kw)
    assert (nrb_a, int(viol_a)) == (int(jnrb), int(jviol))
    np.testing.assert_array_equal(nact_a.numpy(), np.asarray(jnact))
    _close(dts_a, jdts, 1e-9, "dts")
    _states_close(st_a, jout, 1e-9)


def test_rungs_on_a_compact_spec_equal_in_place():
    """A compact spec walks the same pairs in another order, and its masked
    groups skip as the in-place ones do: the same closing counts and the
    state at 1e-9."""
    _, _, _, st, dom, _ = _setup(SEDOV2)
    cspec = win.plan_compact(st.pos, dom, h_max=float(st.h.max()) * 1.3,
                             dim=3, cutoff_scale=1.25)
    assert cspec.cwidth > 0
    spec = dataclasses.replace(cspec, cwidth=0)
    kw = dict(nspans=1, n_rungs=3, rebuild_every=2)
    ref, dts, nact, ovf, viol, _ = rungs.simulate_rungs(st, SEDOV2, dom,
                                                        spec, **kw)
    out, dts_c, nact_c, ovf_c, viol_c, _ = rungs.simulate_rungs(
        st, SEDOV2, dom, cspec, **kw)
    assert int(ovf) == int(ovf_c) == 0
    assert torch.equal(nact, nact_c) and int(viol) == int(viol_c)
    np.testing.assert_allclose(dts_c.numpy(), dts.numpy(), rtol=1e-9)
    _states_close(out, ref, 1e-9)
    # the mask reaches the tables the compact walks read
    wd = win.build(st.pos, dom, cspec)
    none = torch.zeros(cspec.n_sorted, dtype=torch.bool)
    wm = rungs.mask_structure(wd, cspec, none)
    assert int(wm.c_len.sum()) == int(wm.c_n.sum()) == 0


def _sedov_problem(n=10):
    """The CLI's sedov problem on the window engine, on the CPU, where the
    registry itself would take the dense engine."""
    dense = problems.sedov(n=n, dtype=torch.float64, device="cpu")
    eng, spec = problems._window_engine(dense.state, dense.cfg, dense.domain,
                                        h_margin=1.5)
    return dense._replace(engine=eng, wspec=spec, engine_name="window",
                          state=eng(dense.state))


def test_cli_rung_chunk(monkeypatch):
    """The CLI's rung chunk: ceil(chunk / span) whole spans, with the
    overflow, the violations, the active fraction and the builds; it raises
    above 25 % violating closings."""
    prob = _sedov_problem()
    st, dts, ovf, viol, frac, builds = cli.rung_chunk(prob, prob.state, 3, 5)
    assert len(dts) == 8 and builds == 4      # 2 spans of 4, rebuild every 2
    assert int(ovf) == 0 and viol >= 0 and 0.0 < frac < 1.0
    assert bool(torch.isfinite(st.rho).all()) and bool((dts > 0).all())
    # one dt for all at the span's start (everyone on rung 0, closing every
    # tick), a tenth of it ever after: every mid-span closing violates
    calls, real = [], rungs.particle_dt

    def shrinking(state, cfg):
        calls.append(1)
        dt = real(state, cfg)
        return torch.full_like(dt, float(dt.min())) * (
            1.0 if len(calls) == 1 else 0.1)

    monkeypatch.setattr(rungs, "particle_dt", shrinking)
    with pytest.raises(RuntimeError, match="dt-violating closings"):
        cli.rung_chunk(prob, prob.state, 3, 4)


def test_cli_rungs_records(tmp_path, monkeypatch):
    """rungs=B through the CLI's loop, on a problem that carries a window
    spec on the CPU: max_steps=5 with spans of 4 ticks runs 8, and each
    chunk's record carries dt_viol, active_frac and, with adaptive=K, the
    builds."""
    prob = _sedov_problem()
    monkeypatch.setitem(problems.REGISTRY, "wsedov", lambda device: prob)
    out = str(tmp_path)
    st, t, step = cli.main(["wsedov", "rungs=3", "adaptive=8", "max_steps=5",
                            "chunk=16", "device=cpu", f"out={out}"])
    assert step == 8 and t > 0.0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [8, 8]
    assert all(r["finite"] for r in recs)
    assert recs[0]["dt_viol"] >= 0 and 0.0 < recs[0]["active_frac"] < 1.0
    assert 1 <= recs[0]["rebuilds"] <= 8 and recs[0]["h_capped"] == 0
    assert "active_frac" not in recs[1]


@pytest.mark.parametrize("argv", [["sod", "n=8", "rungs=2", "device=cpu"],
                                  ["sedov", "n=8", "rungs=2", "device=cpu"],
                                  ["evrard", "n=64", "rungs=2", "device=cpu"],
                                  ["turb", "n=12", "rungs=2", "device=cpu"]])
def test_cli_refuses_rungs_off_the_window_engine(argv, tmp_path):
    """rungs>1 needs the window engine without gravity or driving, as in
    the JAX CLI: the dense engine (every problem but turb on the CPU),
    evrard's gravity and turb's driving are refused."""
    with pytest.raises(SystemExit, match="rungs>1 needs the window engine"):
        cli.main(argv + [f"out={tmp_path}"])
