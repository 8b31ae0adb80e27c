r"""Block (individual) timesteps on power-of-two rungs (torch twin of
``sphax.integrate.rungs``).

Particle i advances with its own dt_i = 2^{r_i} dt_min, so the cold bulk of
a blast stops paying for the shock front's CFL step. The saving comes from
skipping whole row-groups of the sorted window structure: the pencil sort
makes sorted groups rung-coherent, and a group with no closing row gets its
``w_nact`` row zeroed (``mask_structure``), which kernels A and C answer
with h = h0 and zeros without walking a candidate.

Scheme (KDK, synchronized at force evaluations):

* A span is 2^{B-1} ticks of the base step dt_min, measured at the
  span-start sync point where every particle has fresh derived state:
  dt_min = min_i dt_i and r_i = clip(floor(log2(dt_i / dt_min)), 0, B-1).
* At tick k, particles with k % 2^{r_i} == 0 open a step (half-kick with
  their stored acceleration); everyone drifts by dt_min; particles with
  (k+1) % 2^{r_i} == 0 close their step: the derived pass runs with only
  their groups active, and they half-kick with the fresh forces.
* Inactive particles contribute their positions at the current time, their
  predicted u (advanced at their last half-kick) and their stale
  rho/P/h/viscosity factor.
* Rungs change only when a particle closes: decreases always, increases
  only onto ticks the new rung divides (Hernquist & Katz 1989), so
  "k % 2^r == 0 with the current rungs" is exactly the set of step
  boundaries.
* Every span ends with all particles closing, so span boundaries are full
  sync points where dt_min and the rungs re-adapt.

With n_rungs=1 this is the global-dt leapfrog of ``wengine.simulate``, to
roundoff. A particle whose wanted dt falls below dt_min mid-span cannot be
honoured until the next sync; the returned ``dt_viol`` counts such closings.

``limiter=A`` (A = 2^a; 0, the default, runs none of it) adds Saitoh &
Makino's (2009) timestep limiter with the wake-up of sleeping neighbours
(Durier & Dalla Vecchia 2012), so that a shock never runs into particles
asleep on long steps. Neighbours are the pairs kernel C walks, |x_i - x_j| <
2 max(h_i, h_j):

* At a span's sync point each rung is cut to at most a above the lowest
  rung among its neighbours, repeated to the fixed point.
* At a closing, the closer's wanted dt is cut to at most A min_j dt_{r_j}
  over its neighbours' current steps before ``close_rungs`` turns it into
  a rung (the Hernquist-Katz alignment stays).
* A row j that does not close and has a closing neighbour i with r_j >
  r_i' + a (r_i' the closer's new rung) wakes: it takes the rung r' =
  max(r_i' + a, ceil(log2(k + 2 - k0))), the least over such i, where k0 =
  k - k mod 2^{r_j} is its opening tick, so its step ends on r''s first
  boundary after tick k. Its velocity and u lose 1/2 (2^{r_j} - 2^{r'})
  dt_min times its stored acceleration and du/dt, which makes its opening
  half-kick the one a step of 2^{r'} opens with; the closing half-kick
  stays as it is. Its drift stands (an error of order dt^2 a).

``physics.rung_limit`` holds the pair passes (a kernel a tick, and the sync
point's passes), the counters ``LIMITED`` and ``WOKEN`` below what they did.

Scope: the single-device window engine, no self-gravity (the mesh is a
global solve with no group skipping), no OU driving.

``lax.scan`` became Python loops: the tick index is a host integer; dt_min,
the rungs and every counter stay device tensors. The fixed-cadence loop
never waits on the device; the drift-gated one reads the gate's bool once
per tick, as ``wengine.simulate`` does.
"""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.integrate.timestep import particle_dt
from sphax_torch.io.metrics import LIMIT_SPAN, span
from sphax_torch.neighbors import window as win
from sphax_torch.neighbors.window import WindowData, WindowSpec
from sphax_torch.physics import pairs, rowpack, rung_limit, wengine

# What the limiter did in this process, on the device (added to without a
# host read; read it once, after the work): ``LIMITED["sums"]`` [closers
# whose rung the limiter lowered, closings of the limiter's ticks],
# ``WOKEN["sums"]`` [rows the wake-up shortened], ``WOKEN["ticks"]`` the
# limiter's ticks (a host int). A run on another device starts them afresh.
LIMITED = {"sums": None}
WOKEN = {"sums": None, "ticks": 0}


def _add(book: dict, sums):
    prev = book["sums"]
    book["sums"] = (sums.clone() if prev is None or prev.device != sums.device
                    else prev + sums)


def mask_structure(wd: WindowData, spec: WindowSpec, act_s) -> WindowData:
    """Zero the active-block tables of row-groups (and tiles) with no active
    row. ``act_s`` [n_sorted] bool: activity per sorted row (images carry
    their owner's flag through the build's g-gather). Kernels A and C then
    write h = h0 and zeros on the masked groups, which the caller discards
    per row.

    On a compact spec the walks read ``c_len`` (CUDA) and ``c_n`` (plain),
    not ``w_nact``, so those are zeroed on the same groups. (The reference
    rebuilds ``w_nact`` from ``c_n`` there and computes every tile; the
    per-row select makes both the same trajectory.)
    """
    act_g = act_s.reshape(spec.n_groups, spec.group).any(dim=1)
    w_nact = torch.where(act_g[:, None], wd.w_nact, 0)
    if spec.rgroups > 1:
        act_t = act_g.reshape(spec.n_tiles, spec.rgroups).any(dim=1)
        t_nact = torch.where(act_t[:, None], wd.t_nact, 0)
    else:
        t_nact = w_nact
    wd = wd._replace(w_nact=w_nact, t_nact=t_nact)
    if spec.cwidth > 0:
        wd = wd._replace(c_len=torch.where(act_g[:, None], wd.c_len, 0),
                         c_n=torch.where(act_g, wd.c_n, 0))
    return wd


def _derived_rungs(state: ParticleState, bf_prev, wd: WindowData,
                   cfg: SPHConfig, domain: Domain, spec: WindowSpec, close_m):
    """The window engine's derived pass over the closing particles' groups:
    ``wengine.derived_with`` with ``closing=(close_m, bf_prev)``, packing
    through ``rowpack`` as every derived pass does. Returns (state',
    bf_now), ``bf_now`` [n] the viscosity factor to carry."""
    return wengine.derived_with(state, wd, cfg, domain, spec,
                                closing=(close_m, bf_prev))


def _visc_factor_full(state: ParticleState, cfg: SPHConfig, domain: Domain,
                      spec: WindowSpec):
    """One full kernel-A pass to seed the stale viscosity-factor carry (the
    factor comes from div and curl, which ParticleState does not store).
    Ones when no viscosity switch is configured."""
    if not cfg.visc_factor_on:
        return torch.ones_like(state.h)
    with span("sphax_torch.derived"):
        pos_w = domain.wrap(state.pos)
        wd = win.build(pos_w, domain, spec)
        win_a, h_s, u_s, alpha_s = rowpack.gather_a(
            wd, pos_w, state.vel, state.mass, state.u, state.h,
            state.alpha if cfg.mm_visc else None)
        bf_s = wengine.stage_density(wd, spec, cfg, *rowpack.a_fields(win_a),
                                     u_s, h_s, alpha_s=alpha_s, win=win_a)[3]
        return bf_s[wd.inv]


def simulate_rungs(state: ParticleState, cfg: SPHConfig, domain: Domain,
                   spec: WindowSpec, nspans: int, n_rungs: int = 4,
                   rebuild_every: int = 2, adaptive_rebuild: int = 0,
                   skin_safety: float = 0.8, limiter: int = 0):
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

    ``limiter=A`` (a power of two; 0 runs no limiter) keeps neighbours'
    steps within a factor A of each other and wakes sleeping neighbours
    (the module's notes): one ``rung_limit.tick`` launch a tick, and
    ``rung_limit.sync_passes`` launches at each span's sync point.

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
    a = limiter_exponent(limiter)

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
        st, bf_now = _derived_rungs(st, bf_prev, wd, cfg, domain, spec,
                                    close_m)
        half = torch.where(close_m, 0.5 * dt_r, 0.0)
        vel = st.vel + half[:, None] * st.acc
        u = torch.clamp_min(st.u + half * st.du_dt, cfg.u_floor)
        st = st._replace(vel=vel, u=u)
        if cfg.mm_visc:
            a_new = pairs.mm_alpha_update(st.alpha, st.divv, st.h, st.cs,
                                          dt_r, cfg)
            st = st._replace(alpha=torch.where(close_m, a_new, st.alpha))

        nact = close_m.sum()
        if a is None:
            rung, viol = close_rungs(rung, particle_dt(st, cfg), dt_min,
                                     close_m, k, n_rungs)
        else:
            st, rung, viol = limited_close(st, rung, wd, spec, cfg, close_m,
                                           nact, k, dt_min, n_rungs, a)
        return st, bf_now, rung, nact, viol

    def start_rungs(st, wd):
        """Span sync point: every particle closed on the previous tick;
        ``wd`` is a structure valid at the state's positions."""
        dt_des0 = particle_dt(st, cfg)
        dt_min = dt_des0.amin()
        rung = _rung_of(dt_des0, dt_min, n_rungs)
        if a is not None:
            with span(LIMIT_SPAN):
                for _ in range(rung_limit.sync_passes(n_rungs, a)):
                    rung = rung_limit.sync(wd, spec, st.pos, st.h, st.mass,
                                           rung, a, n_rungs)
        return dt_min, rung

    def rebuild(st):
        st = st._replace(pos=domain.wrap(st.pos))
        wd = win.build(st.pos, domain, spec)
        ovfs.append(wd.overflow)
        return st, wd

    bf = _visc_factor_full(state, cfg, domain, spec)
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
                        dt_min, rung = start_rungs(state, wd)
                    state, dt_r, pm = open_drift(state, rung, dt_min, k, cfg)
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
                    if k % rebuild_every == 0:
                        state, wd = rebuild(state)
                    if k == 0:
                        dt_min, rung = start_rungs(state, wd)
                    state, dt_r, pm = open_drift(state, rung, dt_min, k, cfg)
                    state, bf, rung = tick(state, bf, rung, wd, k, dt_min,
                                           dt_r, pm)
    return (state._replace(pos=domain.wrap(state.pos)), torch.stack(dts),
            torch.stack(nacts).to(torch.int32), torch.stack(ovfs).amax(),
            torch.stack(viols).sum(), len(ovfs))


def limiter_exponent(limiter: int):
    """a with ``limiter`` = 2^a, or None for 0 (no limiter); raise for
    anything else."""
    limiter = int(limiter)
    if limiter == 0:
        return None
    if limiter < 2 or limiter & (limiter - 1):
        raise ValueError(f"limiter={limiter}: expected 0 (off) or a power of "
                         "two >= 2")
    return limiter.bit_length() - 1


def limited_close(st: ParticleState, rung, wd: WindowData, spec: WindowSpec,
                  cfg: SPHConfig, close_m, nact, k: int, dt_min, n_rungs: int,
                  a: int):
    """The close of tick ``k`` under the limiter, after the closers'
    derived pass and half-kick: the neighbours' lowest rungs and the wake
    targets (``rung_limit.tick``), the woken rows' kick correction
    (``wake``), then the closers' wanted dt cut to 2^a times their
    neighbours' lowest step before ``close_rungs`` turns it into a rung.
    The closers' wanted rungs come from ``particle_dt`` before the wake-up
    and again after it, on the state the tick ends with: it reads h, cs and
    acc, which the wake-up leaves as they were. Returns (state, rung,
    dt_viol)."""
    with span(LIMIT_SPAN):
        r_des = _rung_of(particle_dt(st, cfg), dt_min, n_rungs)
        m, target, n_limited = rung_limit.tick(
            wd, spec, st.pos, st.h, st.mass, rung, r_des, k, a,
            _alignment(k + 1, n_rungs), n_rungs)
        st, woken = wake(st, rung, target, dt_min, cfg)
    cap = dt_min * torch.bitwise_left_shift(
        torch.ones_like(m, dtype=torch.int64), m + a).to(dt_min.dtype)
    r_new, viol = close_rungs(rung, torch.minimum(particle_dt(st, cfg), cap),
                              dt_min, close_m, k, n_rungs)
    _add(LIMITED, torch.cat([n_limited.to(torch.int64), nact.reshape(1)]))
    _add(WOKEN, woken.sum().reshape(1))
    WOKEN["ticks"] += 1
    return st, torch.where(close_m, r_new, target), viol


def wake(st: ParticleState, rung, target, dt_min, cfg: SPHConfig):
    """The wake-up of the rows whose ``target`` lies below their
    ``rung`` (none of them closes): velocity and u lose 1/2 (2^rung -
    2^target) dt_min times the stored acceleration and du/dt, so their
    opening half-kick is the one a step of 2^target opens with. Returns
    (state, woken)."""
    woken = target < rung
    dt = st.pos.dtype
    back = torch.where(woken, 0.5 * dt_min * (torch.exp2(rung.to(dt))
                                              - torch.exp2(target.to(dt))),
                       0.0)
    vel = torch.where(woken[:, None], st.vel - back[:, None] * st.acc,
                      st.vel)
    u = torch.where(woken, torch.clamp_min(st.u - back * st.du_dt,
                                           cfg.u_floor), st.u)
    return st._replace(vel=vel, u=u), woken


def open_drift(st: ParticleState, rung, dt_min, k: int, cfg: SPHConfig):
    """Tick ``k``'s opening half: half-kick the particles whose step opens
    (k % 2^rung == 0) with their stored forces, drift everyone by dt_min
    (unwrapped). Returns (state, dt_r, period_mask): each particle's step
    and 2^rung - 1."""
    dt_r = dt_min * torch.exp2(rung.to(st.pos.dtype))
    period_mask = torch.bitwise_left_shift(torch.ones_like(rung), rung) - 1
    open_m = torch.bitwise_and(period_mask, k) == 0       # k % 2^r == 0
    half = torch.where(open_m, 0.5 * dt_r, 0.0)
    vel = st.vel + half[:, None] * st.acc
    u = torch.clamp_min(st.u + half * st.du_dt, cfg.u_floor)
    return (st._replace(pos=st.pos + dt_min * vel, vel=vel, u=u), dt_r,
            period_mask)


def close_rungs(rung, dt_des, dt_min, close_m, k: int, n_rungs: int):
    """The closers' new rungs after tick ``k`` from their wanted dt:
    decrease freely, increase only onto ticks the new rung divides (the
    Hernquist-Katz alignment of k + 1). Returns (rung, dt_viol): the
    closers mid-span that wanted dt < dt_min, which cannot be honoured
    until the next sync (the span's last tick is no violation: everyone
    re-syncs right after it)."""
    span_ticks = 1 << (n_rungs - 1)
    viol = (close_m & (dt_des < dt_min)).sum()
    if k + 1 >= span_ticks:
        viol = torch.zeros_like(viol)
    r_des = _rung_of(dt_des, dt_min, n_rungs)
    align = _alignment(k + 1, n_rungs)
    r_new = torch.where(r_des < rung, r_des, torch.clamp_max(r_des, align))
    return torch.where(close_m, r_new, rung), viol


def _alignment(kp: int, n_rungs: int) -> int:
    """The highest rung a closing at tick kp - 1 may rise to: how many of
    2, 4, ..., 2^(n_rungs - 1) divide kp."""
    return sum((kp & ((1 << j) - 1)) == 0 for j in range(1, n_rungs))


def _rung_of(dt_des, dt_min, n_rungs: int):
    """clip(floor(log2(max(dt / dt_min, 1))), 0, B-1) as int32, computed in
    the state's dtype (in fp32 a ratio a hair under a power of two lands a
    rung lower than in fp64, as in the reference)."""
    r = torch.floor(torch.log2(torch.clamp_min(dt_des / dt_min, 1.0)))
    return torch.clamp(r, 0, n_rungs - 1).to(torch.int32)

