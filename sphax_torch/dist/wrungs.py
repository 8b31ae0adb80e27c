r"""Block timesteps over the slab decomposition (torch twin of
``sphax.dist.wrungs``).

The single-device rung integrator (``integrate/rungs.py``: power-of-two
rungs whose saving is skipping whole row-groups of the sorted window
structure) composes with the slab decomposition (``dist/wslab.py``)
because the two work at different levels:

* the TICK SCHEDULE is global: dt_min is a MIN all-reduce at each span's
  start, so every rank agrees which base ticks exist, and whether a
  particle closes at tick k depends on its own dt only, wherever it lives;
* the ACTIVITY MASK is per rank: each rank masks its OWN sorted structure
  to the groups holding its closing local rows (``rungs.mask_structure``
  on the shard's tables, whose slab ghosts and padding are already
  inactive). Ghost rows are never closers here: their owner closes them on
  the same tick, and the phase-2 hydro exchange ships CURRENT-BEST values
  (fresh where the owner closed this tick, stale otherwise) instead of
  always-fresh ones. That one change carries the stale-neighbour
  approximation across slab faces with no extra messages.

Every rank runs the same exchanges and all-reduces on every tick, a rank
with no closer included: its kernels A and C run on a fully masked
structure and give h0 and zeros, which the per-row select discards. The
closing counts and the dt violations are summed over the ranks once, at
the end of the chunk.

The cost is rung imbalance: a tick takes as long as the busiest rank's
active walk, so a blast inside one slab leaves the others waiting; the
work-weighted cuts (``wslab.work_histogram``) answer it.

Scope, as ``integrate/rungs.py``: the window engine, no self-gravity, no
OU driving; ``h_predict`` composes through the per-closer predictor.
"""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.dist.wslab import (WSlabSpec, _exchange,
                                    _exchange_and_build, _ship_kinematics,
                                    _sorted_inputs, _wrap_transverse)
from sphax_torch.integrate.rungs import (_rung_of, close_rungs,
                                        mask_structure, open_drift)
from sphax_torch.integrate.timestep import particle_dt
from sphax_torch.neighbors import window as win
from sphax_torch.physics import pairs, wengine
from sphax_torch.physics.eos import eos


def _local_derived_rungs(comm, st: ParticleState, bf_prev, wd, routes,
                         slab_lo, cfg: SPHConfig, domain: Domain,
                         spec: WSlabSpec, close_m):
    """One rank's rung derived pass: ``wslab._local_derived`` with kernels
    A and C on the close-masked shard structure, and phase 2 shipping
    current-best hydro. ``close_m`` [nl] bool must exclude padding rows.

    Returns (state', bf_now): outputs fresh on the closers and stale
    elsewhere; ``bf_now`` [nl] the current-best viscosity factor."""
    nG, nl, dim = 2 * spec.ghost_cap, st.n, st.dim
    wspec = spec.wspec
    comb = _ship_kinematics(comm, st, routes, slab_lo, domain, spec)
    win_a, pos_s, vel_s, mass_s, u_s, h_s, alpha_s = _sorted_inputs(
        st, comb, wd, nG, cfg)
    # ghost rows are never closers (their owners close them on the same
    # global tick)
    act_s = win.gather_sorted(torch.cat([close_m, close_m.new_zeros(nG)]),
                              wd)
    wd_act = mask_structure(wd, wspec, act_s)

    # ---- kernel A on the closers' groups
    fresh = torch.stack(wengine.stage_density(
        wd_act, wspec, cfg, pos_s, vel_s, mass_s, u_s, h_s, alpha_s=alpha_s,
        win=win_a), dim=-1)[wd.inv][:nl]                          # [nl, 5]
    # current-best LOCAL hydro: fresh where the row closed, stale otherwise
    cm = close_m
    h_cb = torch.where(cm, fresh[:, 0], st.h)
    rho_cb = torch.where(cm, fresh[:, 1], st.rho)
    om_cb = torch.where(cm, fresh[:, 2], st.omega)
    bf_cb = torch.where(cm, fresh[:, 3], bf_prev)
    divv_cb = torch.where(cm, fresh[:, 4], st.divv)
    # the predicted-u EOS on the current-best rho, for every row, as the
    # single-device pass takes P and cs from (stale rho, predicted u)
    P_cb, cs_cb = eos(rho_cb, st.u, cfg)

    # ---- phase 2: CURRENT-BEST owner hydro of the same boundary sets
    loc_hyd = torch.stack([h_cb, rho_cb, P_cb, cs_cb, om_cb, bf_cb], dim=-1)
    gR2, gL2 = _exchange(comm, loc_hyd, (1.0, 1.0, 0.0, 0.0, 1.0, 0.0),
                         routes)
    hyd_s = win.gather_sorted(torch.cat([loc_hyd, gL2, gR2]), wd)
    h_s2 = torch.where(mass_s > 0, hyd_s[:, 0], 1.0)
    rho_s2 = torch.clamp_min(hyd_s[:, 1], 1e-15)
    om_s2 = torch.where(mass_s > 0, hyd_s[:, 4], 1.0)

    # ---- kernel C on the same masked structure
    acc_s, du_s = wengine.stage_forces(
        wd_act, wspec, cfg, pos_s, vel_s, mass_s, h_s2, rho_s2, hyd_s[:, 2],
        hyd_s[:, 3], om_s2, hyd_s[:, 5])
    out = torch.stack([du_s] + list(acc_s.unbind(-1)), dim=-1)[wd.inv][:nl]
    return st._replace(
        h=h_cb, rho=rho_cb, P=P_cb, cs=cs_cb, omega=om_cb,
        du_dt=torch.where(cm, out[:, 0], st.du_dt),
        acc=torch.where(cm[:, None], out[:, 1:1 + dim], st.acc),
        divv=divv_cb), bf_cb


def _visc_factor_seed(comm, st: ParticleState, cuts, domain: Domain,
                      spec: WSlabSpec, cfg: SPHConfig):
    """One unmasked kernel-A pass to seed the stale viscosity-factor carry
    (the twin of ``rungs._visc_factor_full``); ones when no viscosity
    switch is configured. Every rank runs it (it exchanges ghosts)."""
    if not cfg.visc_factor_on:
        return torch.ones_like(st.h)
    wd, routes, slab_lo, _ = _exchange_and_build(comm, st, cuts, domain,
                                                 spec)
    comb = _ship_kinematics(comm, st, routes, slab_lo, domain, spec)
    win_a, pos_s, vel_s, mass_s, u_s, h_s, alpha_s = _sorted_inputs(
        st, comb, wd, 2 * spec.ghost_cap, cfg)
    bf_s = wengine.stage_density(wd, spec.wspec, cfg, pos_s, vel_s, mass_s,
                                 u_s, h_s, alpha_s=alpha_s, win=win_a)[3]
    return bf_s[wd.inv][:st.n]


def chunk_rungs(comm, st: ParticleState, cuts, domain: Domain,
                cfg: SPHConfig, spec: WSlabSpec, nspans: int,
                n_rungs: int = 4, rebuild_every: int = 2,
                adaptive_rebuild: int = 0, skin_safety: float = 0.8):
    """``nspans`` spans of 2^(n_rungs-1) globally synchronized base ticks
    on this rank (the twin of ``make_chunk_rungs``' function): the KDK and
    rung discipline of ``rungs.simulate_rungs``, the structure reuse and
    health contract of ``wslab.chunk``.

    ``rebuild_every`` (which must divide the span) is the cadence of the
    route selection, exchange and window build. ``adaptive_rebuild = K >
    0`` rebuilds on the drift gate instead: after each tick's drift the
    displacement since the last build and the largest h are MAX
    all-reduced, so every rank takes the same branch, and the structure
    is rebuilt right before the derived pass when 4 max|disp|^2 >=
    (skin_safety max(cutoff - 2 max h, 0))^2 or it would reach K ticks of
    age.

    Returns (state, dts, nacts, health, dt_viol, builds):
      dts     [nspans * 2^{B-1}] the all-reduced base dt of every tick;
      nacts   [same] int64, the closing particles of every tick over the
              ranks;
      health  [2] int64, (ghosts dropped, window overflow): each rank's
              maximum over its builds, summed over the ranks;
      dt_viol closings mid-span that wanted dt < dt_min, over the ranks;
      builds  the window builds of this chunk (the seed pass's apart).
    ``nacts``, ``health`` and ``dt_viol`` come from one SUM all-reduce at
    the end of the chunk."""
    if cfg.gravity:
        raise NotImplementedError(
            "block timesteps + self-gravity: the PM/direct mesh stage is a "
            "global solve with no group skipping to exploit; run global-dt")
    span_ticks = 1 << (n_rungs - 1)
    if not adaptive_rebuild and span_ticks % rebuild_every:
        raise ValueError("rebuild_every must divide 2^(n_rungs-1)")
    ax = spec.slab_axis
    real = st.mass > 0
    bf = _visc_factor_seed(comm, st, cuts, domain, spec, cfg)

    def close_tick(s, bf_prev, rung, wd, routes, slab_lo, k, dt_min, dt_r,
                   period_mask):
        """Derived pass on the closers' groups, closing half-kick, rung
        update and this rank's dt-violation count."""
        close_m = (torch.bitwise_and(period_mask, k + 1) == 0) & real
        if cfg.h_predict and cfg.adaptive_h:
            # the per-closer continuity predictor, on LOCAL rows: the
            # owner predicts its ghosts' h the same way, and phase 2 ships
            # it
            fac = torch.clamp(1.0 + (dt_r / cfg.dim) * s.divv, 0.9, 1.1)
            s = s._replace(h=torch.where(close_m, s.h * fac, s.h))
        s, bf_now = _local_derived_rungs(comm, s, bf_prev, wd, routes,
                                         slab_lo, cfg, domain, spec, close_m)
        half = torch.where(close_m, 0.5 * dt_r, 0.0)
        s = s._replace(vel=s.vel + half[:, None] * s.acc,
                       u=torch.clamp_min(s.u + half * s.du_dt, cfg.u_floor))
        if cfg.mm_visc:
            a_new = pairs.mm_alpha_update(s.alpha, s.divv, s.h, s.cs, dt_r,
                                          cfg)
            s = s._replace(alpha=torch.where(close_m, a_new, s.alpha))
        rung, viol = close_rungs(
            rung, torch.where(real, particle_dt(s, cfg), cfg.dt_max),
            dt_min, close_m, k, n_rungs)
        return s, bf_now, rung, close_m.sum(), viol

    def start_rungs(s):
        """Span sync: every real particle closed on the previous tick;
        padding rows sit at dt_max, on the top rung, out of the MIN."""
        dt_des0 = torch.where(real, particle_dt(s, cfg), cfg.dt_max)
        dt_min = comm.all_reduce_min(dt_des0.amin())
        return dt_min, _rung_of(dt_des0, dt_min, n_rungs)

    def rebuild(s):
        s = s._replace(pos=_wrap_transverse(s.pos, domain, ax))
        wd, routes, slab_lo, dropped = _exchange_and_build(comm, s, cuts,
                                                           domain, spec)
        health.append(torch.stack([dropped.to(torch.int64),
                                   wd.overflow.to(torch.int64)]))
        return s, (wd, routes, slab_lo)

    dts, nacts, viols, health = [], [], [], []

    def tick(s, bf, rung, built, k, dt_min, dt_r, pm):
        s, bf, rung, nact, viol = close_tick(s, bf, rung, *built, k, dt_min,
                                             dt_r, pm)
        dts.append(dt_min)
        nacts.append(nact)
        viols.append(viol)
        return s, bf, rung

    if adaptive_rebuild:
        st, built = rebuild(st)
        ref, since = st.pos, 0
        for _ in range(nspans):
            dt_min, rung = start_rungs(st)
            for k in range(span_ticks):
                st, dt_r, pm = open_drift(st, rung, dt_min, k, cfg)
                disp = st.pos - ref
                gate = comm.all_reduce_max(torch.stack([
                    torch.where(real, torch.sum(disp * disp, dim=-1),
                                0.0).amax(),
                    torch.where(real, st.h, 0.0).amax()]))
                slack = torch.clamp_min(spec.wspec.cutoff - 2.0 * gate[1],
                                        0.0)
                if (since + 1 >= adaptive_rebuild
                        or bool(4.0 * gate[0] >= (skin_safety * slack) ** 2)):
                    st, built = rebuild(st)
                    ref, since = st.pos, 0
                else:
                    since += 1
                st, bf, rung = tick(st, bf, rung, built, k, dt_min, dt_r, pm)
    else:
        for _ in range(nspans):
            dt_min, rung = start_rungs(st)
            for k in range(span_ticks):
                if k % rebuild_every == 0:
                    st, built = rebuild(st)
                st, dt_r, pm = open_drift(st, rung, dt_min, k, cfg)
                st, bf, rung = tick(st, bf, rung, built, k, dt_min, dt_r, pm)
    sums = comm.all_reduce_sum(torch.cat([
        torch.stack(health).amax(0), torch.stack(nacts).to(torch.int64),
        torch.stack(viols).sum().to(torch.int64).reshape(1)]))
    return (st, torch.stack(dts), sums[2:-1], sums[:2], sums[-1],
            len(health))

