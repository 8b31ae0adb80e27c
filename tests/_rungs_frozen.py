"""``rungs.simulate_rungs`` as it was before the timestep limiter, frozen:
the trajectory that ``tests/test_torch_limiter.py`` holds the loop to, bit
for bit, with the limiter off. It calls the module's own functions (the
derived pass, the drift, the rung update), which the limiter leaves as they
were. Importing it changes nothing; it imports no JAX."""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.integrate import rungs
from sphax_torch.io.metrics import span
from sphax_torch.neighbors import window as win
from sphax_torch.neighbors.window import WindowSpec
from sphax_torch.physics import pairs, wengine


def simulate_rungs_before(state: ParticleState, cfg: SPHConfig,
                          domain: Domain, spec: WindowSpec, nspans: int,
                          n_rungs: int = 4, rebuild_every: int = 2,
                          adaptive_rebuild: int = 0,
                          skin_safety: float = 0.8):
    """Block-timestep production loop.

    ``state`` must carry current derived quantities (run update_derived
    first, as for ``wengine.simulate``). Advances ``nspans`` spans of
    2^{n_rungs-1} base ticks each; the window structure rebuilds every
    ``rebuild_every`` ticks, which must divide the span.

    ``adaptive_rebuild=K > 0`` rebuilds on the drift gate instead
    (``rebuild_every`` is then ignored): after a tick's drift, when the
    displacement since the last build threatens the Verlet skin,
    4 max|x - ref|^2 >= (skin_safety max(cutoff - 2 max h, 0))^2, or when
    the structure would reach K ticks of age, the state is wrapped and the
    structure rebuilt right before the derived pass, so a fresh structure
    has no staleness. (``wengine.simulate`` gates before the step instead.)
    The candidate set stays a superset of the neighbour set, so the
    trajectory equals the fixed cadence's to summation order. The gate's
    bool is read on the host once per tick; a tick whose age cap binds
    skips the read.

    Returns (state, dts, n_active, overflow, dt_viol, n_rebuilds):
      dts        [nspans * 2^{B-1}] base dt of every tick;
      n_active   [nspans * 2^{B-1}] closing particles per tick (int32); the
                 integrated active fraction is the work saved;
      overflow   max window-structure overflow over all builds (must be 0);
      dt_viol    closings mid-span that wanted dt < dt_min, summed;
      n_rebuilds window builds of the run, a host int (adaptive: counted,
                 the first build included; fixed: the static count).
    """
    if cfg.gravity:
        raise NotImplementedError(
            "block timesteps + self-gravity: the PM/direct mesh stage is a "
            "global solve with no group skipping to exploit; run global-dt")
    span_ticks = 1 << (n_rungs - 1)
    if not adaptive_rebuild and span_ticks % rebuild_every:
        raise ValueError("rebuild_every must divide 2^(n_rungs-1)")

    def close_tick(st, bf_prev, rung, wd, k, dt_min, dt_r, period_mask):
        """Derived pass on the closers' groups, closing half-kick, rung
        update."""
        close_m = torch.bitwise_and(period_mask, k + 1) == 0
        if cfg.h_predict and cfg.adaptive_h:
            # per-closer continuity predictor: a closer's divv dates from
            # its own last close, one particle-step back, the staleness
            # leapfrog.step's predictor rides. Its h advances through its
            # OWN step dt_r with the same clipped factor; kernel A then
            # walks once at the predicted h and the lagged Newton
            # correction lands on closing rows only (the select in
            # _derived_rungs). Non-closers keep their stale h.
            fac = torch.clamp(1.0 + (dt_r / cfg.dim) * st.divv, 0.9, 1.1)
            st = st._replace(h=torch.where(close_m, st.h * fac, st.h))
        st, bf_now = rungs._derived_rungs(st, bf_prev, wd, cfg, domain,
                                          spec, close_m)
        half = torch.where(close_m, 0.5 * dt_r, 0.0)
        vel = st.vel + half[:, None] * st.acc
        u = torch.clamp_min(st.u + half * st.du_dt, cfg.u_floor)
        st = st._replace(vel=vel, u=u)
        if cfg.mm_visc:
            a_new = pairs.mm_alpha_update(st.alpha, st.divv, st.h, st.cs,
                                          dt_r, cfg)
            st = st._replace(alpha=torch.where(close_m, a_new, st.alpha))

        rung, viol = rungs.close_rungs(rung, rungs.particle_dt(st, cfg),
                                       dt_min, close_m, k, n_rungs)
        return st, bf_now, rung, close_m.sum(), viol

    def start_rungs(st):
        """Span sync point: every particle closed on the previous tick."""
        dt_des0 = rungs.particle_dt(st, cfg)
        dt_min = dt_des0.amin()
        return dt_min, rungs._rung_of(dt_des0, dt_min, n_rungs)

    def rebuild(st):
        st = st._replace(pos=domain.wrap(st.pos))
        wd = win.build(st.pos, domain, spec)
        ovfs.append(wd.overflow)
        return st, wd

    bf = rungs._visc_factor_full(state, cfg, domain, spec)
    dts, nacts, viols, ovfs = [], [], [], []

    def tick(st, bf, rung, wd, k, dt_min, dt_r, pm):
        st, bf, rung, nact, viol = close_tick(st, bf, rung, wd, k, dt_min,
                                              dt_r, pm)
        dts.append(dt_min)
        nacts.append(nact)
        viols.append(viol)
        return st, bf, rung

    if adaptive_rebuild:
        state, wd = rebuild(state)
        ref, since = state.pos, 0
        for _ in range(nspans):
            for k in range(span_ticks):
                with span("sphax_torch.tick"):
                    if k == 0:
                        dt_min, rung = start_rungs(state)
                    state, dt_r, pm = rungs.open_drift(state, rung, dt_min,
                                                       k, cfg)
                    if (since + 1 >= adaptive_rebuild
                            or wengine.skin_spent(state.pos, ref, state.h,
                                                  spec, skin_safety)):
                        state, wd = rebuild(state)
                        ref, since = state.pos, 0
                    else:
                        since += 1
                    state, bf, rung = tick(state, bf, rung, wd, k, dt_min,
                                           dt_r, pm)
    else:
        for _ in range(nspans):
            for k in range(span_ticks):
                with span("sphax_torch.tick"):
                    if k == 0:
                        dt_min, rung = start_rungs(state)
                    if k % rebuild_every == 0:
                        state, wd = rebuild(state)
                    state, dt_r, pm = rungs.open_drift(state, rung, dt_min,
                                                       k, cfg)
                    state, bf, rung = tick(state, bf, rung, wd, k, dt_min,
                                           dt_r, pm)
    return (state._replace(pos=domain.wrap(state.pos)), torch.stack(dts),
            torch.stack(nacts).to(torch.int32), torch.stack(ovfs).amax(),
            torch.stack(viols).sum(), len(ovfs))
