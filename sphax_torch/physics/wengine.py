"""Sorted-window execution engine (torch twin of ``sphax.physics.wengine``).

Consumes the structure from ``sphax_torch.neighbors.window``: row-groups of
consecutive sorted rows interact with 3^(D-1) contiguous candidate windows
of ``wseg`` sorted rows. Images are pre-shifted, so pair displacement is a
plain subtraction, and window overruns are provably outside the kernel
support or zero-mass.

The two pair walks of a step go through ``window_kernels``: the CUDA
kernels A and C for CUDA tensors, their plain torch versions (built on
``_tile_pass`` below) for CPU tensors.

Self-gravity (``cfg.gravity``) takes the JAX package's three branches:
P3M fuses the screened short range into kernel C and adds the FFT mesh
(``pm.mesh_accel``); the direct solver runs kernel G
(``direct_gravity.gravity``) on an open box and the min-image direct sum
(``clist.gravity_dense``) on a periodic one. The JAX package takes its
sorted-order mesh wherever it runs Pallas; the port keeps the scatter
mesh, the cheaper of the two on a card, and ``mesh_fallback_count``
reports what the sorted one (``pm.mesh_accel_sorted``) would drop.
"""
from __future__ import annotations

import dataclasses

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.integrate import leapfrog
from sphax_torch.integrate.timestep import local_dt
from sphax_torch.io.metrics import MESH_SPAN, span
from sphax_torch.neighbors import window as win
from sphax_torch.neighbors.window import WindowData, WindowSpec
from sphax_torch.physics import clist, direct_gravity, pm
from sphax_torch.physics import driving as drv
from sphax_torch.physics import pairs, rowpack
from sphax_torch.physics import window_kernels as wk
from sphax_torch.physics.eos import eos


def dedup_mask(w_lo_block, n_seg: int, S: int):
    """First-occurrence mask over a group's stacked segments: segment s
    keeps row k only if no earlier segment's window [w_lo[s'], w_lo[s']+S)
    already contains it. [TB, n_seg] -> [TB, n_seg * S] bool."""
    ar = torch.arange(S, dtype=torch.int32, device=w_lo_block.device)
    k = w_lo_block[..., None] + ar                       # [TB, n_seg, S]
    keep = torch.ones(k.shape, dtype=torch.bool, device=k.device)
    for s in range(1, n_seg):
        dup = torch.zeros(k.shape[:-2] + (S,), dtype=torch.bool,
                          device=k.device)
        for sp in range(s):
            lo = w_lo_block[..., sp, None]
            dup |= (k[..., s, :] >= lo) & (k[..., s, :] < lo + S)
        keep[..., s, :] = ~dup
    return keep.reshape(k.shape[:-2] + (n_seg * S,))


def _tile_pass(kernel_fn, wd: WindowData, spec: WindowSpec, own_fields,
               win_fields, mass_axis: int = None):
    """Map ``kernel_fn(own, winf)`` over blocks of row-groups.

    own_fields/win_fields: [Ns, ...] sorted tensors; kernel_fn gets own
    [TB, T, ...] rows and [TB, n_seg*S, ...] window gathers and returns a
    tuple of [TB, T, ...]. ``mass_axis`` names the win_fields entry carrying
    the pair weight; it is zeroed on duplicate candidates.

    With spec.cwidth > 0 the window of a group is instead its own cwidth
    slice of the compacted candidate buffer (``window.gather_cands``, one
    block of groups at a time): no dedup, and the pair weight zeroed on
    the padding entries past c_n.

    Only groups with candidates run: the walks' contract gives every other
    group h = h0 and zeros, which the callers apply, so their rows come
    back zero here. (Groups of ghost rows only are most of a small box. A
    slab rank with no closer on a rung tick has no group with candidates:
    then group 0 runs, for the outputs' shapes, and every row comes back
    zero.)
    """
    T, nt = spec.group, spec.n_groups
    n_seg = spec.n_seg
    compact = spec.cwidth > 0
    width = spec.cwidth if compact else n_seg * spec.wseg
    # keep the live [TB, width] window gathers bounded
    TB = max(1, 600_000 // width)
    dev = wd.w_lo.device
    ar = torch.arange(width if compact else spec.wseg, dtype=torch.int64,
                      device=dev)
    ar_t = torch.arange(T, dtype=torch.int64, device=dev)
    gids = torch.nonzero(wk._group_active(wd, spec)).reshape(-1)
    idle = gids.numel() == 0
    if idle:
        gids = gids.new_zeros(1)
    rows_all, outs = [], []
    for b0 in range(0, gids.numel(), TB):
        g = gids[b0:b0 + TB]
        tb = g.numel()
        rows = (g[:, None] * T + ar_t).reshape(-1)
        own = tuple(f[rows].reshape((tb, T) + f.shape[1:])
                    for f in own_fields)
        if compact:
            idx = win.compact_index(wd, spec, g).long()
        else:
            w_lo = wd.w_lo[g]
            idx = (w_lo[..., None].long() + ar).reshape(tb, width)
        winf = [f[idx] for f in win_fields]
        if mass_axis is not None and compact:
            live = ar < wd.c_n[g, None]
            winf[mass_axis] = torch.where(live, winf[mass_axis], 0.0)
        elif mass_axis is not None and n_seg > 1:
            keep = dedup_mask(w_lo, n_seg, spec.wseg)
            winf[mass_axis] = torch.where(keep, winf[mass_axis], 0.0)
        rows_all.append(rows)
        outs.append(kernel_fn(own, tuple(winf)))
    rows = torch.cat(rows_all)
    result = []
    for k in range(len(outs[0])):
        o = torch.cat([o_[k] for o_ in outs])
        o = o.reshape((-1,) + o.shape[2:])
        full = o.new_zeros((nt * T,) + o.shape[1:])
        if not idle:
            full[rows] = o
        result.append(full)
    return tuple(result)


def gravity_short_pass(wd, spec: WindowSpec, pos_s, mass_s, cfg: SPHConfig,
                       rs, eps):
    """Screened P3M short-range gravity over the window candidates, the
    plain walk that kernel C's gravity mode fuses (``rs`` from
    ``pm.rs_traced`` with the structure's cutoff, so the 4.5 r_s tail fits
    inside spec.cutoff). Returns acc [Ns, D] in sorted order."""
    G = float(cfg.G)

    def kfn(own, winf):
        (pos_i, m_i), (pos_j, m_j) = own, winf
        shape = tuple(m_i.shape)
        # the screened force reaches to the cutoff, past the SPH support
        reach = torch.full_like(m_i, spec.cutoff)
        lp = wk._LivePairs(pos_i, m_i, pos_j, m_j, reach)
        f = pm.short_range_factor(lp.r, rs, eps)
        # hard cut at the structure's coverage radius: the screening is not
        # exactly zero there, and window rows beyond the true range must
        # contribute nothing
        f = torch.where((lp.r > 0.0) & (lp.r <= spec.cutoff), f, 0.0)
        f = f * lp.win(m_j)
        return (-G * lp.sum(f[:, None] * lp.dx, shape),)

    return _tile_pass(kfn, wd, spec, (pos_s, mass_s), (pos_s, mass_s),
                      mass_axis=1)[0]


def stage_density(wd, spec: WindowSpec, cfg: SPHConfig, pos_s, vel_s, mass_s,
                  u_s, h_s, alpha_s=None, win=None):
    """Density stage: Newton-h + density + Omega + viscosity factor.

    Returns (h, rho, om, vf, divv) in SORTED order, valid on OWNER rows only
    (ghost rows ran on junk windows); the caller mirrors ghosts. ``win``:
    ``rowpack.gather_a``'s window, which kernel A then reads in place of
    the fields (without the Balsara sums, its first dim + 1 rows).
    """
    if win is not None and not cfg.need_divv:
        win = win[:cfg.dim + 1]
    if cfg.h_predict and cfg.adaptive_h:
        # the continuity predictor can push h past the structural cap, and
        # windows only cover neighbours to spec.cutoff: clamp BEFORE the
        # walk, real rows only (pad rows keep their h=1 fill)
        h_s = torch.where(mass_s > 0,
                          torch.clamp_max(h_s, 0.5 * spec.cutoff), h_s)
    outs = wk.solve_h_density(wd, spec, pos_s, mass_s, h_s, cfg,
                              vel_s=vel_s if cfg.need_divv else None, win=win)
    h_s, rho_s, drho_dh = outs[:3]
    rho_s = torch.clamp_min(rho_s, 1e-15)
    if cfg.grad_h:
        om_s = 1.0 + h_s / (cfg.dim * rho_s) * drho_dh
    else:
        om_s = torch.ones_like(rho_s)
    bf_s = None
    if cfg.need_divv:
        div_sum, curl_sum = outs[3:]
        divv_s = -div_sum / rho_s
        curl_s = curl_sum / rho_s
        if cfg.balsara:
            _, cs_pre = eos(rho_s, u_s, cfg)
            bf_s = pairs.balsara_factor(divv_s, curl_s, cs_pre, h_s)
    else:
        divv_s = torch.zeros_like(rho_s)
    vf_s = pairs.visc_factor(cfg, bf=bf_s, alpha=alpha_s)
    if vf_s is None:
        vf_s = torch.ones_like(rho_s)
    if cfg.h_predict and cfg.adaptive_h:
        # lagged Newton correction (kernel A's newton_update, same clamps)
        # from THIS walk's sums; rho/om/divv stay at the predicted h.
        # Real rows only: pad rows would be driven to h = 0.5.
        m_safe = torch.clamp_min(mass_s, 1e-30)
        eta_d = float(cfg.eta) ** cfg.dim
        hcap = 0.5 * float(spec.cutoff)
        rho_c = torch.clamp_min(rho_s, 1e-30)
        rho_h = m_safe * eta_d / h_s ** cfg.dim
        phi = rho_c - rho_h
        dphi = drho_dh + cfg.dim * rho_h / h_s
        dphi = torch.where(torch.abs(dphi) < 1e-30, -1e-30, dphi)
        dh = torch.minimum(torch.maximum(-phi / dphi, -0.5 * h_s), 0.5 * h_s)
        h_s = torch.where(mass_s > 0, torch.clamp_max(h_s + dh, hcap), h_s)
    return h_s, rho_s, om_s, vf_s, divv_s


def stage_forces(wd, spec: WindowSpec, cfg: SPHConfig, pos_s, vel_s, mass_s,
                 h_s, rho_s, P_s, cs_s, om_s, bf_s, grav=None, win=None):
    """Force stage: symmetrized pressure + viscosity + du/dt (sorted order),
    with ``grav=(rs, eps)`` the fused screened P3M short range. All j-side
    inputs must already be owner-correct on every sorted row. ``win``:
    kernel C's window prepacked (``window_kernels.forces``)."""
    return wk.forces(wd, spec, pos_s, vel_s, mass_s, h_s, rho_s, P_s, cs_s,
                     om_s, bf_s, cfg, grav=grav, win=win)


def derived_with(state: ParticleState, wd, cfg: SPHConfig, domain: Domain,
                 spec: WindowSpec, closing=None):
    """Derived pass against a PRE-BUILT (possibly stale) window structure,
    valid while spec.cutoff exceeds 2 h_max plus twice the drift since the
    build.

    ``closing=(close_m, bf_prev)`` makes it a rung tick's pass over the
    closing particles ``close_m`` [n] bool (``rungs._derived_rungs``), and
    it returns (state', bf_now) then. Kernels A and C run on the groups
    holding a closing row (``rungs.mask_structure``). h, rho, Omega and
    the viscosity factor are fresh on closing rows and stale elsewhere
    (``state``'s, and the carried factor ``bf_prev``) BEFORE the owner
    mirror, so kernel C's j-sides see every particle's current-best values
    on ghost images too; P and cs come from their EOS at the predicted u.
    du/dt, div v and acc are selected against ``state`` per original row;
    ``bf_now`` [n] is the current-best factor to carry."""
    if state.dim != cfg.dim:
        raise ValueError(f"state dim {state.dim} != cfg.dim {cfg.dim}")
    with span("sphax_torch.derived"):
        # the state's fields into kernel A's window (pos with the image
        # shifts added back, m, vel) and the sorted h0, u, alpha
        win_a, h_s, u_s, alpha_s = rowpack.gather_a(
            wd, state.pos, state.vel, state.mass, state.u, state.h,
            state.alpha if cfg.mm_visc else None)
        pos_s, vel_s, mass_s = rowpack.a_fields(win_a)
        wd_walk = wd
        if closing is not None:
            from sphax_torch.integrate import rungs   # it imports this module
            close_m, bf_prev = closing
            # the close flag and the stale rho, Omega and viscosity factor
            # (pad rows stale, at 1), one 1-D gather each: on an H100 one
            # gather of their [Ns, 4] rows took 9x as long as the four
            act_s = win.gather_sorted(close_m, wd)
            stale = (h_s,) + tuple(win.gather_sorted(f, wd, fill=1.0)
                                   for f in (state.rho, state.omega, bf_prev))
            wd_walk = rungs.mask_structure(wd, spec, act_s)
        # rebinding h_s frees h0 here unless the rung pass keeps it as stale
        h_s, rho_s, om_s, bf_s, divv_s = stage_density(
            wd_walk, spec, cfg, pos_s, vel_s, mass_s, u_s, h_s,
            alpha_s=alpha_s, win=win_a)
        if closing is not None:
            h_s, rho_s, om_s, bf_s = (
                torch.where(act_s, fresh, old)
                for fresh, old in zip((h_s, rho_s, om_s, bf_s), stale))
        # on the stage's own rows: u_s is owner-correct, so gather_c's
        # owner mirror of P and cs is the EOS of the mirrored rows
        P_s, cs_s = eos(rho_s, u_s, cfg)
        # kernel C's window, the four window-shipped scalars owner-mirrored
        win_c, mirrored = rowpack.gather_c(win_a, wd, cfg, h_s, rho_s, om_s,
                                           bf_s, P_s, cs_s)
        p3m = cfg.gravity and cfg.grav_solver == "p3m"
        grav = None
        if p3m:
            # the screened short range rides kernel C's walk; rs stays a device
            # tensor (it depends on domain.extent)
            rs = pm.rs_traced(cfg, domain, pos_s.dtype, cutoff=spec.cutoff)
            grav = (rs, float(cfg.grav_eps))
        acc_s, du_s = stage_forces(wd_walk, spec, cfg, pos_s, vel_s, mass_s,
                                   *mirrored, grav=grav, win=win_c)
        # the outputs back to original order (owner rows)
        h, rho, P, cs, om, du, divv, acc = rowpack.scatter_out(
            wd, h_s, rho_s, P_s, cs_s, om_s, du_s, divv_s, acc_s)
        if p3m:
            # O(N log N) FFT mesh long range on the unsorted state (Ewald on a
            # periodic box, Hockney free space on an open one)
            with span(MESH_SPAN):
                acc = acc + pm.mesh_accel(state.pos, state.mass, cfg, domain,
                                          rs=rs)
        elif cfg.gravity and not any(domain.periodic_axes(state.dim)):
            # direct sum, kernel G (open-boundary convention)
            acc = acc + direct_gravity.gravity(state.pos, state.mass, cfg)
        elif cfg.gravity:
            # direct sum with the min-image convention on a periodic box
            acc = acc + clist.gravity_dense(state.pos, state.mass, cfg, domain)
        if closing is not None:
            acc = torch.where(close_m[:, None], acc, state.acc)
            du = torch.where(close_m, du, state.du_dt)
            divv = torch.where(close_m, divv, state.divv)
        out = state._replace(h=h, rho=rho, P=P, cs=cs, omega=om, acc=acc,
                             du_dt=du, divv=divv)
        return out if closing is None else (out, bf_s[wd.inv])


def update_derived(state: ParticleState, cfg: SPHConfig, domain: Domain,
                   spec: WindowSpec) -> ParticleState:
    """Build the structure and run one derived pass. Ignores cfg.h_predict:
    the predictor needs an already-converged h, so this cold-start entry
    always runs the full Newton solve."""
    if cfg.h_predict:
        cfg = dataclasses.replace(cfg, h_predict=False)
    wd = win.build(state.pos, domain, spec)
    return derived_with(state, wd, cfg, domain, spec)


def simulate(state: ParticleState, cfg: SPHConfig, domain: Domain,
             spec: WindowSpec, nsteps: int, rebuild_every: int = 2,
             drive=None, drive_spec=None, noise=None,
             adaptive_rebuild: int = 0, skin_safety: float = 0.8):
    """Fixed-cadence production loop: every ``rebuild_every`` steps wrap
    positions into the box and rebuild the structure; the steps in between
    drift UNWRAPPED against the fixed structure (a wrap teleports a
    particle, which a stale structure cannot represent).

    ``adaptive_rebuild=K > 0`` switches to drift-gated rebuilds (the
    reference's scheme; ``rebuild_every`` is then ignored): wrap and build
    once, then rebuild at the top of a step when this step's exact
    end-of-drift displacement since the build, dt (v + dt/2 a), would spend
    the Verlet skin, 4 max|disp|^2 >= (skin_safety max(cutoff - 2 max h,
    0))^2, or when the structure would reach K steps of age. The candidate
    set stays a superset of the neighbour set, so this changes when builds
    happen, never the pairs. The gate's bool is read on the host once per
    step, the one host synchronisation in the loop (``lax.cond`` has no
    torch twin); a step whose age cap binds skips the read.

    With ``drive_spec`` the OU driving amplitudes advance once per step
    with the step's dt; ``noise(shape, dtype, device) -> (xi_re, xi_im)``
    supplies the standard-normal draws (``driving.gaussian_noise``).

    On a card and a periodic box the fixed-cadence loop replays its
    builds as one CUDA graph (``graphed_build``): the positions between
    builds live in the graph's buffer, so a state the loop hands to a step
    before its last sees them overwritten later; the states it returns do
    not.

    Returns (state, drive, dts, overflow); ``overflow`` is the MAX
    per-rebuild structure overflow and must be 0 (a saturated structure
    silently drops pairs). No host synchronisation happens in the
    fixed-cadence loop. The adaptive loop returns (state, drive, dts,
    overflow, rebuilds): ``rebuilds`` counts its builds, the first one
    included.
    """
    if not adaptive_rebuild and nsteps % rebuild_every:
        raise ValueError("nsteps must be a multiple of rebuild_every")
    if drive_spec is not None and (drive is None or noise is None):
        raise ValueError("driving needs an initial DriveState and a noise "
                         "source")
    modes = None
    if drive_spec is not None:
        modes = torch.tensor(drive_spec.modes, dtype=state.pos.dtype,
                             device=state.pos.device)

    def step_with(st, wd, dr, dt):
        if drive_spec is not None:
            xi = noise(dr.amp_re.shape, dr.amp_re.dtype, dr.amp_re.device)
            dr = drv.update(dr, modes, dt, drive_spec.tau,
                            drive_spec.accel_rms, drive_spec.box_size,
                            noise=xi)

            def derived(s):
                out = derived_with(s, wd, cfg, domain, spec)
                a = drv.acceleration(s.pos, dr, modes, drive_spec.box_size)
                return out._replace(acc=out.acc + a)
        else:
            def derived(s):
                return derived_with(s, wd, cfg, domain, spec)
        st, dt = leapfrog.step(st, cfg, domain, derived, dt=dt, wrap=False)
        return st, dr, dt

    def rebuild(st):
        if graph is not None:
            # the graph wraps into its own buffer, which then holds the
            # state's positions
            wd = graph(st.pos, domain)
            ovfs.append(wd.overflow.clone())
            return st._replace(pos=graph.pos), wd
        st = st._replace(pos=domain.wrap(st.pos))
        wd = win.build(st.pos, domain, spec)
        ovfs.append(wd.overflow)
        return st, wd

    dts, ovfs = [], []
    graph = None
    if adaptive_rebuild:
        state, wd = rebuild(state)
        ref, since = state.pos, 0
        for _ in range(nsteps):
            with span("sphax_torch.step"):
                dt = local_dt(state, cfg)
                if (since + 1 >= adaptive_rebuild
                        or drift_gate(state, ref, dt, spec, skin_safety)):
                    state, wd = rebuild(state)
                    ref, since = state.pos, 0
                else:
                    since += 1
                state, drive, dt = step_with(state, wd, drive, dt)
                dts.append(dt)
        return (state._replace(pos=domain.wrap(state.pos)), drive,
                torch.stack(dts), torch.stack(ovfs).amax(), len(ovfs))
    graph = graphed_build(state, domain, spec)
    for i in range(nsteps):
        with span("sphax_torch.step"):
            if i % rebuild_every == 0:
                state, wd = rebuild(state)
            state, drive, dt = step_with(state, wd, drive,
                                         local_dt(state, cfg))
            dts.append(dt)
            if graph is not None and i + 1 < nsteps:
                # keep the positions in the graph's buffer, so that no
                # more of them are alive than without the graph
                graph.pos.copy_(state.pos)
                state = state._replace(pos=graph.pos)
    return (state._replace(pos=domain.wrap(state.pos)), drive,
            torch.stack(dts), torch.stack(ovfs).amax())


# the graphed builds of the fixed-cadence loop: one per structure, shape,
# dtype and card, kept with its memory pool for the process
_GRAPHS = {}


def graphed_build(state: ParticleState, domain: Domain, spec: WindowSpec):
    """The ``window.GraphedBuild`` of this spec and these positions' shape,
    dtype and card (made at the first call and kept), or None on the CPU
    or a box that is not periodic on every axis. Its buffer takes the place
    of the state's positions between builds: a state that ``simulate``
    hands to a step before its last holds positions the loop overwrites
    later."""
    pos = state.pos
    if not (pos.is_cuda and all(domain.periodic_axes(state.dim))):
        return None
    key = (spec, tuple(pos.shape), pos.dtype, pos.device)
    if key not in _GRAPHS:
        _GRAPHS[key] = win.GraphedBuild(pos, domain, spec)
    return _GRAPHS[key]


def drift_gate(state: ParticleState, ref, dt, spec: WindowSpec,
               skin_safety: float) -> bool:
    """True when the step about to run would drift some particle far enough
    from its build position ``ref`` to spend the Verlet skin. KDK drifts by
    dt (v + dt/2 a) with the carried acceleration, so the end-of-drift
    displacement is exact before the walk. Reads one bool back from the
    device."""
    return skin_spent(state.pos + dt * (state.vel + 0.5 * dt * state.acc),
                      ref, state.h, spec, skin_safety)


def skin_spent(pos, ref, h, spec: WindowSpec, skin_safety: float) -> bool:
    """True when some particle at ``pos`` is far enough from its build
    position ``ref`` to threaten the Verlet skin: a pair now within 2 h_max
    was at most 2 max_drift farther apart at build time. Reads one bool
    back from the device."""
    disp = pos - ref
    maxd2 = torch.sum(disp * disp, dim=-1).amax()
    slack = torch.clamp_min(spec.cutoff - 2.0 * h.amax(), 0.0)
    return bool(4.0 * maxd2 >= (skin_safety * slack) ** 2)


def overflow_count(state: ParticleState, domain: Domain, spec: WindowSpec):
    """Tiles whose candidate range exceeded wseg, plus dropped ghosts
    (must be 0)."""
    return win.build(state.pos, domain, spec).overflow


def mesh_fallback_count(state: ParticleState, cfg: SPHConfig,
                        domain: Domain, spec: WindowSpec):
    """(fallback rows, dropped rows) of the sorted-order P3M mesh
    (``pm.mesh_accel_sorted``) on a fresh structure: rows past the
    fallback's capacity would lose their mesh gravity there. The CLI logs
    the fallback rows of its P3M runs, as the JAX CLI does; its runs take
    the scatter mesh, which drops nothing."""
    from sphax_torch.physics import pm_sorted

    M = int(cfg.grav_mesh)
    plan = pm_sorted.plan_mesh(spec, M)
    wd = win.build(state.pos, domain, spec)
    periodic = all(domain.periodic_axes(state.dim))
    mass_s = win.gather_sorted(state.mass, wd)
    return pm_sorted.fallback_stats(wd.pos_s, wd.is_real & (mass_s > 0),
                                    domain, M, periodic, plan)


def capped_count(state: ParticleState, spec: WindowSpec):
    """Particles pinned at the STRUCTURAL h cap (h == cutoff/2), where the
    adaptive h wants more than the structure covers."""
    hcap = 0.5 * spec.cutoff
    return (state.h >= hcap * (1.0 - 1e-6)).sum()
