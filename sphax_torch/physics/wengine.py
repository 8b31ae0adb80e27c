"""Sorted-window execution engine (torch twin of ``sphax.physics.wengine``).

Consumes the structure from ``sphax_torch.neighbors.window``: row-groups of
consecutive sorted rows interact with 3^(D-1) contiguous candidate windows
of ``wseg`` sorted rows. Images are pre-shifted, so pair displacement is a
plain subtraction, and window overruns are provably outside the kernel
support or zero-mass.

The two pair walks of a step go through ``window_kernels``: the CUDA
kernels A and C for CUDA tensors, their plain torch versions (built on
``_tile_pass`` below) for CPU tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.integrate import leapfrog
from sphax_torch.integrate.timestep import local_dt
from sphax_torch.neighbors import window as win
from sphax_torch.neighbors.window import WindowData, WindowSpec
from sphax_torch.physics import driving as drv
from sphax_torch.physics import pairs
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
    """
    T, S, nt = spec.group, spec.wseg, spec.n_groups
    n_seg = spec.n_seg
    # keep the live [TB, n_seg * S] window gathers bounded
    TB = max(1, 600_000 // (n_seg * S))
    ar = torch.arange(S, dtype=torch.int64, device=wd.w_lo.device)
    outs = []
    for t0 in range(0, nt, TB):
        tb = min(TB, nt - t0)
        own = tuple(f[t0 * T:(t0 + tb) * T].reshape((tb, T) + f.shape[1:])
                    for f in own_fields)
        w_lo = wd.w_lo[t0:t0 + tb]
        idx = (w_lo[..., None].long() + ar).reshape(tb, n_seg * S)
        winf = [f[idx] for f in win_fields]
        if mass_axis is not None and n_seg > 1:
            keep = dedup_mask(w_lo, n_seg, S)
            winf[mass_axis] = torch.where(keep, winf[mass_axis], 0.0)
        outs.append(kernel_fn(own, tuple(winf)))
    return tuple(torch.cat([o[k] for o in outs]).reshape(
        (nt * T,) + outs[0][k].shape[2:]) for k in range(len(outs[0])))


def stage_density(wd, spec: WindowSpec, cfg: SPHConfig, pos_s, vel_s, mass_s,
                  u_s, h_s, alpha_s=None):
    """Density stage: Newton-h + density + Omega + viscosity factor.

    Returns (h, rho, om, vf, divv) in SORTED order, valid on OWNER rows only
    (ghost rows ran on junk windows); the caller mirrors ghosts.
    """
    if cfg.h_predict and cfg.adaptive_h:
        # the continuity predictor can push h past the structural cap, and
        # windows only cover neighbours to spec.cutoff: clamp BEFORE the
        # walk, real rows only (pad rows keep their h=1 fill)
        h_s = torch.where(mass_s > 0,
                          torch.clamp_max(h_s, 0.5 * spec.cutoff), h_s)
    outs = wk.solve_h_density(wd, spec, pos_s, mass_s, h_s, cfg,
                              vel_s=vel_s if cfg.need_divv else None)
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
                 h_s, rho_s, P_s, cs_s, om_s, bf_s):
    """Force stage: symmetrized pressure + viscosity + du/dt (sorted order).
    All j-side inputs must already be owner-correct on every sorted row."""
    return wk.forces(wd, spec, pos_s, vel_s, mass_s, h_s, rho_s, P_s, cs_s,
                     om_s, bf_s, cfg)


def derived_with(state: ParticleState, wd, cfg: SPHConfig, domain: Domain,
                 spec: WindowSpec) -> ParticleState:
    """Derived pass against a PRE-BUILT (possibly stale) window structure,
    valid while spec.cutoff exceeds 2 h_max plus twice the drift since the
    build."""
    if state.dim != cfg.dim:
        raise ValueError(f"state dim {state.dim} != cfg.dim {cfg.dim}")
    if cfg.gravity:
        raise NotImplementedError("self-gravity is not ported yet")
    dim = state.dim
    # ONE packed input gather; pos gets the image shifts added back
    cols = [state.pos, state.vel, state.mass[:, None], state.u[:, None],
            state.h[:, None]]
    fills = [0.0] * (2 * dim) + [0.0, 0.0, 1.0]
    if cfg.mm_visc:
        cols.append(state.alpha[:, None])
        fills.append(1.0)
    g_s = win.gather_sorted_cols(torch.cat(cols, dim=-1), wd, fills)
    pos_s = g_s[:, :dim] + wd.shift_s
    vel_s = g_s[:, dim:2 * dim]
    mass_s = g_s[:, 2 * dim]
    u_s = g_s[:, 2 * dim + 1]
    h_s = g_s[:, 2 * dim + 2]
    alpha_s = g_s[:, 2 * dim + 3] if cfg.mm_visc else None
    h_s, rho_s, om_s, bf_s, divv_s = stage_density(
        wd, spec, cfg, pos_s, vel_s, mass_s, u_s, h_s, alpha_s=alpha_s)
    # one packed owner-mirror gather fixes the four window-shipped scalars
    mirrored = torch.stack([h_s, rho_s, om_s, bf_s], dim=-1)[wd.src]
    h_s, rho_s, om_s, bf_s = mirrored.unbind(-1)
    P_s, cs_s = eos(rho_s, u_s, cfg)
    acc_s, du_s = stage_forces(wd, spec, cfg, pos_s, vel_s, mass_s, h_s,
                               rho_s, P_s, cs_s, om_s, bf_s)
    # one packed unsort gather for all outputs
    out = torch.stack([h_s, rho_s, P_s, cs_s, om_s, du_s, divv_s]
                      + list(acc_s.unbind(-1)), dim=-1)[wd.inv]
    return state._replace(h=out[:, 0], rho=out[:, 1], P=out[:, 2],
                          cs=out[:, 3], omega=out[:, 4],
                          acc=out[:, 7:7 + dim], du_dt=out[:, 5],
                          divv=out[:, 6])


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
             adaptive_rebuild: int = 0):
    """Fixed-cadence production loop: every ``rebuild_every`` steps wrap
    positions into the box and rebuild the structure; the steps in between
    drift UNWRAPPED against the fixed structure (a wrap teleports a
    particle, which a stale structure cannot represent).

    With ``drive_spec`` the OU driving amplitudes advance once per step
    with the step's dt; ``noise(shape, dtype, device) -> (xi_re, xi_im)``
    supplies the standard-normal draws (``driving.gaussian_noise``).

    Returns (state, drive, dts, overflow); ``overflow`` is the MAX
    per-rebuild structure overflow and must be 0 (a saturated structure
    silently drops pairs). No host synchronisation happens in the loop.
    """
    if adaptive_rebuild:
        raise NotImplementedError("drift-gated rebuilds are not ported yet")
    if nsteps % rebuild_every:
        raise ValueError("nsteps must be a multiple of rebuild_every")
    if drive_spec is not None and (drive is None or noise is None):
        raise ValueError("driving needs an initial DriveState and a noise "
                         "source")
    modes = None
    if drive_spec is not None:
        modes = torch.tensor(drive_spec.modes, dtype=state.pos.dtype,
                             device=state.pos.device)

    def step_with(st, wd, dr):
        dt = local_dt(st, cfg)
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

    dts, ovfs = [], []
    for _ in range(nsteps // rebuild_every):
        state = state._replace(pos=domain.wrap(state.pos))
        wd = win.build(state.pos, domain, spec)
        ovfs.append(wd.overflow)
        for _ in range(rebuild_every):
            state, drive, dt = step_with(state, wd, drive)
            dts.append(dt)
    return (state._replace(pos=domain.wrap(state.pos)), drive,
            torch.stack(dts), torch.stack(ovfs).amax())


def overflow_count(state: ParticleState, domain: Domain, spec: WindowSpec):
    """Tiles whose candidate range exceeded wseg, plus dropped ghosts
    (must be 0)."""
    return win.build(state.pos, domain, spec).overflow


def capped_count(state: ParticleState, spec: WindowSpec):
    """Particles pinned at the STRUCTURAL h cap (h == cutoff/2), where the
    adaptive h wants more than the structure covers."""
    hcap = 0.5 * spec.cutoff
    return (state.h >= hcap * (1.0 - 1e-6)).sum()
