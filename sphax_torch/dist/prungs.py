r"""Block timesteps over the 2D pencil decomposition (torch twin of
``sphax.dist.prungs``).

The pencil twin of ``dist/wrungs.py``, which sets out the scheme: a global
tick schedule (dt_min a MIN all-reduce at each span's start), each rank's
own sorted structure masked to its closing rows (``rungs.mask_structure``),
and phase 2 shipping CURRENT-BEST hydro so that the stale-neighbour
approximation crosses shard faces with no extra message. What changes is
the exchange topology, ``dist/pencil.py``'s:

* phase-1 kinematics and the phase-2 current-best hydro ride the two-hop
  exchange, x then y; a corner ghost arrives through the intermediate
  shard, whose x-ghost slots were just filled with current-best values,
  so its j-fields are exactly its owner's current-best;
* the schedule's MIN and the health and closing-count SUMs span both axes
  (they are the world's reductions).

Every rank runs every exchange and all-reduce of every tick, a rank with no
closer included: its kernels A and C run on a fully masked structure and
give h0 and zeros, which the per-row select discards.

Scope, as ``integrate/rungs.py``: the window engine, no self-gravity, no
OU driving; ``h_predict`` composes through the per-closer predictor.
"""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.dist.pencil import (_HYDRO_FILLS, PencilSpec,
                                     _exchange_and_build, _health,
                                     _ship_hydro, _ship_kinematics,
                                     _wrap_other)
from sphax_torch.dist.wslab import _sorted_inputs
from sphax_torch.integrate.rungs import (_rung_of, close_rungs,
                                        mask_structure, open_drift)
from sphax_torch.integrate.timestep import particle_dt
from sphax_torch.neighbors import window as win
from sphax_torch.physics import pairs, wengine
from sphax_torch.physics.eos import eos


def _local_derived_rungs(comm, st: ParticleState, bf_prev, wd, routes, lo0,
                         lo1, cfg: SPHConfig, domain: Domain,
                         spec: PencilSpec, close_m):
    """One pencil's rung derived pass: ``pencil._local_derived`` with
    kernels A and C on the close-masked structure, and phase 2 shipping
    current-best hydro over the two hops. ``close_m`` [nl] bool must
    exclude padding rows. Returns (state', bf_now)."""
    nG = 2 * (spec.ghost_cap0 + spec.ghost_cap1)
    nl, dim = st.n, st.dim
    wspec = spec.wspec
    comb = _ship_kinematics(comm, st, routes, lo0, lo1, domain, spec)
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
    # the predicted-u EOS on the current-best rho, for every row
    P_cb, cs_cb = eos(rho_cb, st.u, cfg)

    # ---- phase 2: CURRENT-BEST owner hydro over the two-hop routes
    loc_hyd = torch.stack([h_cb, rho_cb, P_cb, cs_cb, om_cb, bf_cb], dim=-1)
    hyd_s = win.gather_sorted(_ship_hydro(comm, loc_hyd, _HYDRO_FILLS,
                                          routes), wd)
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


def _visc_factor_seed(comm, st: ParticleState, cuts0, cuts1,
                      domain: Domain, spec: PencilSpec, cfg: SPHConfig):
    """One unmasked kernel-A pass to seed the stale viscosity-factor carry
    (the twin of ``wrungs._visc_factor_seed``); ones when no viscosity
    switch is configured. Every rank runs it (it exchanges ghosts). Its
    dropped-ghost count is discarded: the chunk's first build runs on the
    same state and cuts and reports it."""
    if not cfg.visc_factor_on:
        return torch.ones_like(st.h)
    wd, routes, lo0, lo1, _ = _exchange_and_build(comm, st, cuts0, cuts1,
                                                  domain, spec)
    comb = _ship_kinematics(comm, st, routes, lo0, lo1, domain, spec)
    win_a, pos_s, vel_s, mass_s, u_s, h_s, alpha_s = _sorted_inputs(
        st, comb, wd, 2 * (spec.ghost_cap0 + spec.ghost_cap1), cfg)
    bf_s = wengine.stage_density(wd, spec.wspec, cfg, pos_s, vel_s, mass_s,
                                 u_s, h_s, alpha_s=alpha_s, win=win_a)[3]
    return bf_s[wd.inv][:st.n]


def chunk_rungs(comm, st: ParticleState, cuts0, cuts1, domain: Domain,
                cfg: SPHConfig, spec: PencilSpec, nspans: int,
                n_rungs: int = 4, rebuild_every: int = 2):
    """``nspans`` spans of 2^(n_rungs-1) globally synchronized base ticks
    on this rank (the twin of ``make_chunk_rungs``' function): the rung
    discipline of ``wrungs.chunk_rungs`` at the fixed rebuild cadence
    ``rebuild_every`` (which must divide the span), the structure reuse and
    health contract of ``pencil.chunk``.

    Returns (state, dts, nacts, health, dt_viol, builds), as
    ``wrungs.chunk_rungs``: dts the base dt of every tick; nacts the
    closings of every tick over the ranks; health (ghosts dropped, window
    overflow), each rank's maximum over its builds summed over the ranks;
    dt_viol the closings mid-span that wanted dt < dt_min over the ranks;
    builds the window builds of the chunk (the seed pass's apart)."""
    if cfg.gravity:
        raise NotImplementedError(
            "block timesteps + self-gravity: the PM/direct mesh stage is a "
            "global solve with no group skipping to exploit; run global-dt")
    span_ticks = 1 << (n_rungs - 1)
    if span_ticks % rebuild_every:
        raise ValueError("rebuild_every must divide 2^(n_rungs-1)")
    real = st.mass > 0
    bf = _visc_factor_seed(comm, st, cuts0, cuts1, domain, spec, cfg)
    dts, nacts, viols, health = [], [], [], []
    for _ in range(nspans):
        # span sync: padding rows sit at dt_max, out of the MIN
        dt_des0 = torch.where(real, particle_dt(st, cfg), cfg.dt_max)
        dt_min = comm.all_reduce_min(dt_des0.amin())
        rung = _rung_of(dt_des0, dt_min, n_rungs)
        for k in range(span_ticks):
            if k % rebuild_every == 0:
                st = st._replace(pos=_wrap_other(st.pos, domain))
                wd, routes, lo0, lo1, dropped = _exchange_and_build(
                    comm, st, cuts0, cuts1, domain, spec)
                health.append(_health(dropped, wd))
            st, dt_r, pm = open_drift(st, rung, dt_min, k, cfg)
            close_m = (torch.bitwise_and(pm, k + 1) == 0) & real
            if cfg.h_predict and cfg.adaptive_h:
                # the per-closer continuity predictor on LOCAL rows: owners
                # predict their ghosts' h, and phase 2 ships it
                fac = torch.clamp(1.0 + (dt_r / cfg.dim) * st.divv, 0.9, 1.1)
                st = st._replace(h=torch.where(close_m, st.h * fac, st.h))
            st, bf = _local_derived_rungs(comm, st, bf, wd, routes, lo0, lo1,
                                          cfg, domain, spec, close_m)
            half = torch.where(close_m, 0.5 * dt_r, 0.0)
            st = st._replace(vel=st.vel + half[:, None] * st.acc,
                             u=torch.clamp_min(st.u + half * st.du_dt,
                                               cfg.u_floor))
            if cfg.mm_visc:
                a_new = pairs.mm_alpha_update(st.alpha, st.divv, st.h,
                                              st.cs, dt_r, cfg)
                st = st._replace(alpha=torch.where(close_m, a_new,
                                                   st.alpha))
            rung, viol = close_rungs(
                rung, torch.where(real, particle_dt(st, cfg), cfg.dt_max),
                dt_min, close_m, k, n_rungs)
            dts.append(dt_min)
            nacts.append(close_m.sum())
            viols.append(viol)
    sums = comm.all_reduce_sum(torch.cat([
        torch.stack(health).amax(0), torch.stack(nacts).to(torch.int64),
        torch.stack(viols).sum().to(torch.int64).reshape(1)]))
    return (st, torch.stack(dts), sums[2:-1], sums[:2], sums[-1],
            len(health))
