"""Slab decomposition running the window engine (torch twin of
``sphax.dist.wslab``).

The box is cut into slabs along one axis at cell-granular, count-balanced
positions; each rank holds one slab's particles and runs the window
engine's kernels A and C on its own rows plus ghosts:

  * phase 1: the ring (``Comm.ring``) ships boundary kinematics
    (pos/vel/mass) to the two face neighbours;
  * each rank builds its sorted pencil-window structure over a LOCAL bin box
    (open slab axis with a trash band below the slab, globally periodic
    transverse axes), with ``active`` = its local real rows and ``image`` =
    mass > 0, and runs kernel A on it;
  * phase 2: the ring ships the owner-computed hydro fields
    (h/rho/P/cs/Omega/visc factor) of the SAME boundary sets, so the ghosts'
    j-values in kernel C are exactly the owner's;
  * one MIN all-reduce gives the global timestep.

After a chunk, particles that left their slab migrate one ring hop per pass
with fixed-capacity send buffers, and the cuts are rebalanced from a global
histogram of the slab-axis cells (the only array the host reads). Direct
self-gravity hops (pos, mass) blocks around the ring; P3M deposits every
rank's particles on a full copy of the mesh and sums the grids. Dropped
ghosts and emigrants and window overflow are counted and summed over the
ranks: the caller raises on any of them.

Every rank's state is [n_local] rows, real particles first as distributed
or migrated, zero-mass padding rows parked in the trash band. The JAX
package's ``make_*`` factories (jitted ``shard_map`` functions) are plain
per-rank functions here that take the rank's ``Comm``: ``step``,
``chunk``, ``migrate``, ``misplaced``, ``histogram``, ``diagnostics`` and
``max_run``; with block timesteps (``wrungs``) ``work_histogram`` and
``shard_work`` take the place of ``make_work_histogram`` and
``make_shard_work``. ``cuts`` is a host array of ``n_shards + 1`` cell indices,
the same on every rank. P3M runs the scatter mesh (``pm.mesh_accel``),
the cheaper one on a card; the JAX package's ``sorted_mesh`` option and
its ``_mesh_plan`` are not taken (the sorted-order CIC is
``pm.mesh_accel_sorted``, a library function).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.integrate.rungs import _rung_of
from sphax_torch.integrate.timestep import local_dt, particle_dt
from sphax_torch.neighbors import window as win
from sphax_torch.neighbors.window import WindowSpec
from sphax_torch.physics import driving as drv
from sphax_torch.physics import pairs, pm, rowpack, wengine
from sphax_torch.physics.eos import eos


@dataclasses.dataclass(frozen=True)
class WSlabSpec:
    """Static decomposition parameters (the fields of
    ``sphax.dist.wslab.WSlabSpec`` but its mesh axis name).

    The slab axis is divided into ``ncell_ax`` global cells of width
    ``cell_ax`` (>= the window cutoff); cut positions are cell indices, so
    rebalancing moves cuts without changing any shape as long as no slab
    exceeds ``res_max`` cells.
    """

    n_shards: int
    n_local: int        # particle rows per shard incl. zero-mass padding
    ghost_cap: int      # ghost buffer capacity per face
    migrate_cap: int    # emigrant buffer capacity per face per migration
    slab_axis: int
    ncell_ax: int       # global slab-axis cell count
    res_max: int        # max slab width (cells) any shard may own
    margin_cells: int   # ghost margin in cells (margin >= window cutoff)
    wspec: WindowSpec   # per-shard window spec over the local bin box

    @property
    def trash_cells(self) -> int:
        """Bin-box cells below the slab reserved for padding rows."""
        return 2 * self.margin_cells


FIELDS = ParticleState._fields


def equal_cuts(ncell_ax: int, n_shards: int) -> np.ndarray:
    return np.round(np.linspace(0, ncell_ax, n_shards + 1)).astype(np.int32)


def plan(domain: Domain, n: int, h_max: float, n_shards: int,
         slab_axis: int = 0, cutoff_scale: float = 1.2,
         margin_scale: float = 1.05, pad_factor: float = 1.35,
         ghost_safety: float = 2.0, migrate_frac: float = 0.25,
         balance_headroom: float = 1.6, seg_safety: float = 1.35,
         tile: int = 128, fast_sub: int = 1, rgroups: int = 1) -> WSlabSpec:
    """Choose the decomposition's static parameters from the problem's
    scales (host-side; the JAX package's arithmetic). ``fast_sub`` and
    ``rgroups`` pass through to the per-shard window plan; ``SlabRun``
    sets the production 3 and 2 on the card."""
    lo = domain.lo.detach().cpu().double().numpy()
    hi = domain.hi.detach().cpu().double().numpy()
    ext = hi - lo
    dim = len(lo)
    cutoff = 2.0 * float(h_max) * cutoff_scale
    ncell_ax = max(int(np.floor(ext[slab_axis] / cutoff)), 1)
    cell_ax = ext[slab_axis] / ncell_ax
    margin_cells = max(int(np.ceil(margin_scale * cutoff / cell_ax)), 1)
    width0 = ncell_ax / n_shards
    if width0 < margin_cells:
        raise ValueError(
            f"slabs of ~{width0:.1f} cells are thinner than the ghost margin "
            f"({margin_cells} cells); use fewer shards or smaller h")
    res_max = min(int(np.ceil(width0 * balance_headroom)), ncell_ax)

    # cell-granular cuts cannot split ncell_ax cells evenly: the widest
    # initial slab owns ceil(ncell_ax/ns) cells
    max_share = max(1.0 / n_shards,
                    np.ceil(ncell_ax / n_shards) / ncell_ax)
    nl = int(np.ceil(n * max_share * pad_factor / 8.0) * 8)
    frac = margin_cells * cell_ax / (ext[slab_axis] / n_shards)
    G = int(np.ceil(n / n_shards * frac * ghost_safety / 8.0) * 8)
    G = min(max(G, 16), nl)
    M = max(int(np.ceil(nl * migrate_frac / 8.0) * 8), 64)

    # per-shard local bin box: trash band + margin | <= res_max cells | margin
    ext_local = ext.copy()
    ext_local[slab_axis] = (2 * margin_cells + margin_cells + res_max
                            + margin_cells) * cell_ax
    per = domain.periodic_axes(dim)
    local_dom = Domain(lo=torch.zeros(dim, dtype=torch.float64),
                       hi=torch.as_tensor(ext_local),
                       periodic=tuple(False if d == slab_axis else per[d]
                                      for d in range(dim)))
    wspec = win.plan_windows(local_dom, h_max=h_max, n=nl + 2 * G, dim=dim,
                             tile=tile, cutoff_scale=cutoff_scale,
                             ghost_safety=ghost_safety,
                             seg_safety=seg_safety, fast_sub=fast_sub,
                             rgroups=rgroups)
    return WSlabSpec(n_shards=n_shards, n_local=nl, ghost_cap=G,
                     migrate_cap=M, slab_axis=slab_axis, ncell_ax=ncell_ax,
                     res_max=res_max, margin_cells=margin_cells, wspec=wspec)


# ---------------------------------------------------------------------------
# geometry (device scalars; cuts is a host array)
# ---------------------------------------------------------------------------


def _geom(domain: Domain, spec: WSlabSpec, dtype):
    ax = spec.slab_axis
    glo = domain.lo[ax].to(dtype)
    ext_ax = (domain.hi[ax] - domain.lo[ax]).to(dtype)
    cell_ax = ext_ax / spec.ncell_ax
    margin = spec.margin_cells * cell_ax
    return ax, glo, ext_ax, cell_ax, margin


def _slab_lo(domain: Domain, spec: WSlabSpec, cuts, rank: int, dtype):
    _, glo, _, cell_ax, _ = _geom(domain, spec, dtype)
    return glo + float(cuts[rank]) * cell_ax


def _local_domain(domain: Domain, spec: WSlabSpec, slab_lo, dtype):
    """Per-shard bin box for the window build (trash band below the slab)."""
    dim = domain.lo.shape[0]
    ax, _, _, cell_ax, _ = _geom(domain, spec, dtype)
    lo_ax = slab_lo - (spec.trash_cells + spec.margin_cells) * cell_ax
    hi_ax = lo_ax + (spec.trash_cells + 2 * spec.margin_cells
                     + spec.res_max) * cell_ax
    lo = domain.lo.to(dtype).clone()
    hi = domain.hi.to(dtype).clone()
    lo[ax], hi[ax] = lo_ax, hi_ax
    per = domain.periodic_axes(dim)
    return Domain(lo=lo, hi=hi, periodic=tuple(False if d == ax else per[d]
                                               for d in range(dim)))


def _trash_pos(nrows: int, domain: Domain, spec: WSlabSpec, slab_lo, dtype,
               salt: float = 0.61803398875):
    """Deterministic parking spots in the trash band: spread across the
    band's cells on the slab axis (strictly below the ghost margin band, at
    least one cutoff-sized cell from any real particle, so trash rows never
    join a real particle's windows) and across the box transversely."""
    dim = domain.lo.shape[0]
    ax, _, _, cell_ax, _ = _geom(domain, spec, dtype)
    i = torch.arange(nrows, dtype=dtype, device=domain.lo.device)
    cols = []
    for d in range(dim):
        if d == ax:
            span = (spec.trash_cells - 1) * cell_ax
            base = slab_lo - (spec.trash_cells + spec.margin_cells) * cell_ax
            cols.append(base + span * torch.remainder(0.37 * i, 1.0))
        else:
            lo_d, hi_d = domain.lo[d].to(dtype), domain.hi[d].to(dtype)
            cols.append(lo_d + (hi_d - lo_d)
                        * torch.remainder(salt * (i + 1.0), 1.0))
    return torch.stack(cols, dim=-1)


def _wrap_transverse(pos, domain: Domain, ax: int):
    """Wrap the periodic TRANSVERSE axes only: the slab axis stays
    unwrapped within a chunk so that slab locality survives the periodic
    seam (migration wraps it)."""
    dim = pos.shape[1]
    per = domain.periodic_axes(dim)
    if not any(per[d] for d in range(dim) if d != ax):
        return pos
    wrapped = domain.lo + torch.remainder(pos - domain.lo, domain.extent)
    mask = torch.tensor([per[d] and d != ax for d in range(dim)],
                        device=pos.device)
    return torch.where(mask, wrapped, pos)


def _pack_select(mask, G: int):
    """Indices of up to G True entries (in row order), their validity, and
    the DROPPED count (entries beyond capacity; must be zero)."""
    n = mask.shape[0]
    key = torch.where(mask, torch.arange(n, dtype=torch.int32,
                                         device=mask.device), n)
    take = torch.sort(key).values[:G]
    valid = take < n
    take = torch.clamp_max(take, n - 1).long()
    dropped = torch.clamp_min(mask.sum() - G, 0)
    return take, valid, dropped


def _sel(f, take, valid, fill):
    v = f[take]
    m = valid.reshape((valid.shape[0],) + (1,) * (f.dim() - 1))
    return torch.where(m, v, torch.as_tensor(fill, dtype=v.dtype,
                                             device=v.device))


def _cell(pos, domain: Domain, spec: WSlabSpec):
    """The global slab-axis cell of each (wrapped) position."""
    ax, glo, _, cell_ax, _ = _geom(domain, spec, pos.dtype)
    return torch.clamp(torch.floor((pos[:, ax] - glo) / cell_ax), 0,
                       spec.ncell_ax - 1).long()


def _target_shard(pos, domain: Domain, spec: WSlabSpec, cuts):
    """The shard owning each (wrapped) position under ``cuts``."""
    cellf = _cell(pos, domain, spec)
    inner = torch.as_tensor(np.asarray(cuts[1:spec.n_shards], np.int64),
                            device=pos.device)
    if inner.numel() == 0:
        return torch.zeros_like(cellf)
    return torch.searchsorted(inner, cellf, right=True)


# ---------------------------------------------------------------------------
# the derived pass of one rank
# ---------------------------------------------------------------------------


def _plan_routes(comm, st: ParticleState, cuts, domain: Domain,
                 spec: WSlabSpec):
    """Boundary-set selection for the two-phase ghost exchange.

    Rebuild-cadence work: the selected rows ("routes") stay FIXED while a
    window structure is reused, exactly like the single-device Verlet
    skin: the ghost margin exceeds the support 2 h_max, so a particle that
    drifts into interaction range of a face during the reuse window was
    already inside the selection margin at build time.

    Returns (routes, slab_lo, dropped): routes = ((take, valid) of the low
    face, (take, valid) of the high face).
    """
    dtype = st.pos.dtype
    _, _, _, cell_ax, margin = _geom(domain, spec, dtype)
    slab_lo = _slab_lo(domain, spec, cuts, comm.rank, dtype)
    slab_hi = _slab_lo(domain, spec, cuts, comm.rank + 1, dtype)
    x = st.pos[:, spec.slab_axis]
    real = st.mass > 0
    take_lo, val_lo, drop_lo = _pack_select((x < slab_lo + margin) & real,
                                            spec.ghost_cap)
    take_hi, val_hi, drop_hi = _pack_select((x > slab_hi - margin) & real,
                                            spec.ghost_cap)
    return ((take_lo, val_lo), (take_hi, val_hi)), slab_lo, drop_lo + drop_hi


def _exchange(comm, cols, fills, routes, axis=None):
    """ONE packed message per face: ``cols`` [nl, K] carries all K fields
    stacked column-wise; the low face's rows go to the left neighbour and
    the high face's to the right one, invalid capacity rows filled with
    ``fills`` [K]. ``axis``: the grid axis whose ring carries them (the
    pencil decomposition's). Returns (from_right, from_left)."""
    fillv = torch.tensor(fills, dtype=cols.dtype, device=cols.device)
    msgs = [torch.where(valid[:, None], cols[take], fillv[None, :])
            for take, valid in routes]
    return comm.ring(msgs[0], msgs[1], axis=axis)


def _ship_kinematics(comm, st: ParticleState, routes, slab_lo,
                     domain: Domain, spec: WSlabSpec):
    """Phase-1 exchange of pos/vel/mass over the FIXED routes (per-step
    work under structure reuse). Returns [nl + 2G] combined arrays in the
    layout every other helper assumes: [local | ghosts-from-left |
    ghosts-from-right], invalid ghost rows parked in the trash band."""
    ns, G, ax = spec.n_shards, spec.ghost_cap, spec.slab_axis
    dim, dtype, me = st.dim, st.pos.dtype, comm.rank
    _, _, ext_ax, _, _ = _geom(domain, spec, dtype)
    trash = _trash_pos(G, domain, spec, slab_lo, dtype)

    kin = torch.cat([st.pos, st.vel, st.mass[:, None]], dim=-1)
    gR, gL = _exchange(comm, kin, (0.0,) * (2 * dim + 1), routes)
    gR_pos, gR_vel, gR_mass = gR[:, :dim].clone(), gR[:, dim:2 * dim], \
        gR[:, 2 * dim]
    gL_pos, gL_vel, gL_mass = gL[:, :dim].clone(), gL[:, dim:2 * dim], \
        gL[:, 2 * dim]
    # ghosts that crossed the periodic seam of the slab axis
    if me == ns - 1:
        gR_pos[:, ax] += ext_ax
    if me == 0:
        gL_pos[:, ax] -= ext_ax
    if not domain.periodic_axes(dim)[ax]:
        if me == ns - 1:
            gR_mass = torch.zeros_like(gR_mass)
        if me == 0:
            gL_mass = torch.zeros_like(gL_mass)
    gR_pos = torch.where((gR_mass > 0)[:, None], gR_pos, trash)
    gL_pos = torch.where((gL_mass > 0)[:, None], gL_pos, trash)
    return (torch.cat([st.pos, gL_pos, gR_pos]),
            torch.cat([st.vel, gL_vel, gR_vel]),
            torch.cat([st.mass, gL_mass, gR_mass]))


def _exchange_and_build(comm, st: ParticleState, cuts, domain: Domain,
                        spec: WSlabSpec):
    """Route selection + phase-1 exchange + this rank's window build (the
    rebuild-cadence bundle). Only LOCAL real rows define windows: the
    slab ghosts' own outputs are discarded (phase 2 re-ships the owner's),
    so letting them widen tiles near the dense face would only inflate
    wseg. Returns (wd, routes, slab_lo, dropped)."""
    routes, slab_lo, dropped = _plan_routes(comm, st, cuts, domain, spec)
    comb_pos, _, comb_mass = _ship_kinematics(comm, st, routes, slab_lo,
                                              domain, spec)
    ldom = _local_domain(domain, spec, slab_lo, st.pos.dtype)
    active = torch.cat([st.mass > 0, st.mass.new_zeros(2 * spec.ghost_cap,
                                                       dtype=torch.bool)])
    wd = win.build(comb_pos, ldom, spec.wspec, active=active,
                   image=comb_mass > 0)
    return wd, routes, slab_lo, dropped


def _sorted_inputs(st: ParticleState, comb, wd, n_ghost: int,
                   cfg: SPHConfig):
    """``rowpack.gather_a`` on a shard's combined rows: ``comb`` = the
    combined (pos, vel, mass), and the local rows' u, h and alpha with
    ``n_ghost`` ghost slots behind them (u 0, h 1, alpha 1). Zero-mass rows
    (local padding, unused ghost slots) keep h = 1. Returns (win_a, pos_s,
    vel_s, mass_s, u_s, h_s, alpha_s) in sorted order."""
    def combined(f, fill):
        return torch.cat([f, f.new_full((n_ghost,), fill)])

    win_a, h_s, u_s, alpha_s = rowpack.gather_a(
        wd, *comb, combined(st.u, 0.0), combined(st.h, 1.0),
        combined(st.alpha, 1.0) if cfg.mm_visc else None)
    pos_s, vel_s, mass_s = rowpack.a_fields(win_a)
    return (win_a, pos_s, vel_s, mass_s, u_s,
            torch.where(mass_s > 0, h_s, 1.0), alpha_s)


def _local_derived(comm, st: ParticleState, wd, routes, slab_lo,
                   cfg: SPHConfig, domain: Domain, spec: WSlabSpec, cuts):
    """The window engine's derived pass on one rank with two-phase ghosts,
    against a PRE-BUILT (possibly stale) structure ``wd`` and FIXED ghost
    routes: the kinematics are re-shipped over the routes and the sorted
    positions refreshed from the stale permutation (the distributed twin of
    ``wengine.derived_with``)."""
    nl, dim, dtype = st.n, st.dim, st.pos.dtype
    wspec = spec.wspec
    comb = _ship_kinematics(comm, st, routes, slab_lo, domain, spec)
    win_a, pos_s, vel_s, mass_s, u_s, h_s, alpha_s = _sorted_inputs(
        st, comb, wd, 2 * spec.ghost_cap, cfg)

    # ---- kernel A (+ Omega, viscosity factor); owner-valid on LOCAL rows
    h_s, rho_s, om_s, bf_s, divv_s = wengine.stage_density(
        wd, wspec, cfg, pos_s, vel_s, mass_s, u_s, h_s, alpha_s=alpha_s,
        win=win_a)
    dsc = torch.stack([h_s, rho_s, om_s, bf_s, divv_s], dim=-1)[wd.inv][:nl]
    h_c, rho_c, om_c, bf_c, divv_c = dsc.unbind(-1)
    P_c, cs_c = eos(rho_c, st.u, cfg)

    # ---- phase 2: owner-computed hydro for the SAME boundary sets
    loc_hyd = torch.stack([h_c, rho_c, P_c, cs_c, om_c, bf_c],
                          dim=-1)                                 # [nl, 6]
    gR2, gL2 = _exchange(comm, loc_hyd, (1.0, 1.0, 0.0, 0.0, 1.0, 0.0),
                         routes)
    # re-sort: every sorted row (transverse images too) gets owner values
    hyd_s = win.gather_sorted(torch.cat([loc_hyd, gL2, gR2]), wd)
    h_s2 = torch.where(mass_s > 0, hyd_s[:, 0], 1.0)
    rho_s2 = torch.clamp_min(hyd_s[:, 1], 1e-15)
    om_s2 = torch.where(mass_s > 0, hyd_s[:, 4], 1.0)

    # ---- kernel C with exact ghost j-fields
    p3m = cfg.gravity and cfg.grav_solver == "p3m"
    grav = None
    if p3m:
        # the screened short range rides kernel C's walk over this rank's
        # candidates (the ghost margin >= cutoff >= 4.5 r_s covers every
        # cross-boundary pair)
        rs = pm.rs_traced(cfg, domain, dtype, cutoff=wspec.cutoff)
        grav = (rs, float(cfg.grav_eps))
    acc_s, du_s = wengine.stage_forces(
        wd, wspec, cfg, pos_s, vel_s, mass_s, h_s2, rho_s2, hyd_s[:, 2],
        hyd_s[:, 3], om_s2, hyd_s[:, 5], grav=grav)
    out = torch.stack([du_s] + list(acc_s.unbind(-1)), dim=-1)[wd.inv]
    acc = out[:nl, 1:1 + dim]
    if p3m:
        # every rank deposits its particles on a full copy of the global
        # mesh; one SUM all-reduce replicates it
        acc = acc + pm.mesh_accel(st.pos, st.mass, cfg, domain, rs=rs,
                                  group=comm)
    elif cfg.gravity:
        acc = acc + _gravity_ring(comm, st.pos, st.mass, cfg, domain)
    return st._replace(h=h_c, rho=rho_c, P=P_c, cs=cs_c, omega=om_c,
                       du_dt=out[:nl, 0], acc=acc, divv=divv_c)


def _gravity_ring(comm, pos, mass, cfg: SPHConfig, domain: Domain,
                  block_pairs: int = 1 << 22):
    """Distributed direct-sum gravity: each rank's (pos, mass) block hops
    the ring to the right while every rank accumulates its rows' partial
    accelerations (open-boundary convention on a non-periodic box, the
    min-image convention on a periodic one, as ``clist.gravity_dense``).
    Plain torch in row blocks of about ``block_pairs`` pairs."""
    n, dim = pos.shape
    eps2 = float(cfg.grav_eps) ** 2
    rows = max(1, block_pairs // max(n, 1))

    def partial_acc(bp, bm):
        out = torch.empty_like(pos)
        for i0 in range(0, n, rows):
            dx = domain.displacement(pos[i0:i0 + rows, None, :] - bp[None])
            r2 = torch.sum(dx * dx, dim=-1) + eps2
            w = bm[None, :] * torch.rsqrt(r2) / r2
            out[i0:i0 + rows] = -torch.sum(w[..., None] * dx, dim=1)
        return out

    blk = torch.cat([pos, mass[:, None]], dim=-1)
    acc = torch.zeros_like(pos)
    for k in range(comm.world):
        acc = acc + partial_acc(blk[:, :dim], blk[:, dim])
        if k < comm.world - 1:
            _, blk = comm.ring(None, blk)
    return float(cfg.G) * acc


# ---------------------------------------------------------------------------
# distributed step / chunk
# ---------------------------------------------------------------------------


def _close(comm, s, dr, wd, routes, slab_lo, dt, cfg, domain, spec, cuts,
           drive_spec, modes):
    """Derived pass + drive acceleration + closing half-kick + alpha
    update: the post-drift half of a KDK step."""
    s = _local_derived(comm, s, wd, routes, slab_lo, cfg, domain, spec, cuts)
    if drive_spec is not None:
        s = s._replace(acc=s.acc + drv.acceleration(s.pos, dr, modes,
                                                    drive_spec.box_size))
    half = 0.5 * dt
    s = s._replace(vel=s.vel + half * s.acc,
                   u=torch.clamp_min(s.u + half * s.du_dt, cfg.u_floor))
    if cfg.mm_visc:
        s = s._replace(alpha=pairs.mm_alpha_update(s.alpha, s.divv, s.h,
                                                   s.cs, dt, cfg))
    return s


def step(comm, st: ParticleState, cuts, domain: Domain, cfg: SPHConfig,
         spec: WSlabSpec):
    """One distributed KDK step with a fresh structure (the twin of
    ``make_step``'s function; no driving, no h predictor). Returns (state,
    dt, health): health = (ghosts dropped, window overflow), summed over
    the ranks."""
    st = st._replace(pos=_wrap_transverse(st.pos, domain, spec.slab_axis))
    wd, routes, slab_lo, dropped = _exchange_and_build(comm, st, cuts,
                                                       domain, spec)
    dt = comm.all_reduce_min(local_dt(st, cfg))
    half = 0.5 * dt
    vel = st.vel + half * st.acc
    u = torch.clamp_min(st.u + half * st.du_dt, cfg.u_floor)
    st = _close(comm, st._replace(pos=st.pos + dt * vel, vel=vel, u=u), None,
                wd, routes, slab_lo, dt, cfg, domain, spec, cuts, None, None)
    health = comm.all_reduce_sum(torch.stack([
        dropped.to(torch.int64), wd.overflow.to(torch.int64)]))
    return st, dt, health


def chunk(comm, st: ParticleState, cuts, domain: Domain, cfg: SPHConfig,
          spec: WSlabSpec, nsteps: int, rebuild_every: int = 1, drive=None,
          drive_spec=None, noise=None, adaptive_rebuild: int = 0,
          skin_safety: float = 0.8):
    """``nsteps`` distributed KDK steps (the twin of ``make_chunk``'s
    function).

    ``rebuild_every`` is the structure-reuse cadence: the ghost routes and
    the window structure are built once per ``rebuild_every`` steps, and
    the steps between re-ship only kinematics over the fixed routes.
    Positions drift UNWRAPPED between rebuilds; the transverse axes wrap at
    each rebuild.

    ``drive_spec`` (with ``drive`` and ``noise``): OU driving, REPLICATED:
    every rank draws the same normals from its own ``noise`` (the same
    seeded stream on every rank, the single-device run's stream) and
    advances identical amplitudes with the all-reduced dt; each evaluates
    the acceleration at its own particles.

    ``adaptive_rebuild = K > 0``: drift-gated rebuilds (``rebuild_every``
    is ignored). After each drift the maximum displacement since the last
    build and the maximum h are MAX all-reduced, so every rank takes the
    same branch; the rebuild runs when 4 max|disp|^2 >= (skin_safety
    max(cutoff - 2 max h, 0))^2 or the structure is K steps old. The gate
    reads one bool per step on the host.

    Returns (state, drive, dts [nsteps], health, builds): health =
    (ghosts dropped, window overflow) as a [2] int64 tensor, the per-rank
    maximum over the chunk's builds summed over the ranks (one bad build
    cannot hide); builds counts the window builds of the chunk.
    """
    if not adaptive_rebuild and nsteps % rebuild_every:
        raise ValueError("nsteps must be a multiple of rebuild_every")
    if drive_spec is not None and (drive is None or noise is None):
        raise ValueError("driving needs an initial DriveState and a noise "
                         "source")
    modes = None
    if drive_spec is not None:
        modes = torch.tensor(drive_spec.modes, dtype=st.pos.dtype,
                             device=st.pos.device)
    ax = spec.slab_axis

    def kick_drift(s, dr, dt):
        """Drive update + opening half-kick + unwrapped drift (+ the h
        predictor): the pre-derived half of a KDK step."""
        if drive_spec is not None:
            xi = noise(dr.amp_re.shape, dr.amp_re.dtype, dr.amp_re.device)
            dr = drv.update(dr, modes, dt, drive_spec.tau,
                            drive_spec.accel_rms, drive_spec.box_size,
                            noise=xi)
        half = 0.5 * dt
        vel = s.vel + half * s.acc
        u = torch.clamp_min(s.u + half * s.du_dt, cfg.u_floor)
        s = s._replace(pos=s.pos + dt * vel, vel=vel, u=u)
        if cfg.h_predict and cfg.adaptive_h:
            # before the derived pass, so phase 1 ships the predicted h;
            # pad rows carry divv = 0 -> factor 1
            fac = torch.clamp(1.0 + (dt / cfg.dim) * s.divv, 0.9, 1.1)
            s = s._replace(h=s.h * fac)
        return s, dr

    def rebuild(s):
        s = s._replace(pos=_wrap_transverse(s.pos, domain, ax))
        wd, routes, slab_lo, dropped = _exchange_and_build(comm, s, cuts,
                                                           domain, spec)
        health.append(torch.stack([dropped.to(torch.int64),
                                   wd.overflow.to(torch.int64)]))
        return s, wd, routes, slab_lo

    dts, health = [], []
    dr = drive
    if adaptive_rebuild:
        st, wd, routes, slab_lo = rebuild(st)
        ref, since = st.pos, 0
        for _ in range(nsteps):
            dt = comm.all_reduce_min(local_dt(st, cfg))
            st, dr = kick_drift(st, dr, dt)
            real = st.mass > 0
            disp = st.pos - ref
            gate = comm.all_reduce_max(torch.stack([
                torch.where(real, torch.sum(disp * disp, dim=-1), 0.0).amax(),
                torch.where(real, st.h, 0.0).amax()]))
            slack = torch.clamp_min(spec.wspec.cutoff - 2.0 * gate[1], 0.0)
            if (since + 1 >= adaptive_rebuild
                    or bool(4.0 * gate[0] >= (skin_safety * slack) ** 2)):
                st, wd, routes, slab_lo = rebuild(st)
                ref, since = st.pos, 0
            else:
                since += 1
            st = _close(comm, st, dr, wd, routes, slab_lo, dt, cfg, domain,
                        spec, cuts, drive_spec, modes)
            dts.append(dt)
    else:
        for _ in range(nsteps // rebuild_every):
            st, wd, routes, slab_lo = rebuild(st)
            for _ in range(rebuild_every):
                dt = comm.all_reduce_min(local_dt(st, cfg))
                st, dr = kick_drift(st, dr, dt)
                st = _close(comm, st, dr, wd, routes, slab_lo, dt, cfg,
                            domain, spec, cuts, drive_spec, modes)
                dts.append(dt)
    hmax = comm.all_reduce_sum(torch.stack(health).amax(0))
    return st, dr, torch.stack(dts), hmax, len(health)


# ---------------------------------------------------------------------------
# migration and count-based rebalancing
# ---------------------------------------------------------------------------


def _pad_template(nl: int, domain: Domain, spec: WSlabSpec, slab_lo, dtype,
                  dim: int) -> ParticleState:
    pos = _trash_pos(nl, domain, spec, slab_lo, dtype, salt=0.7548776662)
    z = pos.new_zeros(nl)
    one = pos.new_ones(nl)
    return ParticleState(pos=pos, vel=pos.new_zeros(nl, dim), mass=z, u=z,
                         h=one, rho=one, P=z, cs=z,
                         acc=pos.new_zeros(nl, dim), du_dt=z, omega=one,
                         alpha=one, divv=z)


def _pack(st: ParticleState):
    """[n, F] column-stacked fields, in ParticleState order."""
    return torch.cat([f if f.dim() == 2 else f[:, None] for f in st], dim=-1)


def _unpack(packed, dim: int) -> ParticleState:
    out, o = {}, 0
    for k in FIELDS:
        w = dim if k in ("pos", "vel", "acc") else 1
        out[k] = packed[:, o:o + w] if w > 1 else packed[:, o]
        o += w
    return ParticleState(**out)


def migrate(comm, st: ParticleState, cuts, domain: Domain, spec: WSlabSpec):
    """One migration pass (the twin of ``make_migrate``'s function):
    positions wrap into the box, and each real particle outside its shard's
    slab hops ONE shard toward its target (the shorter ring direction)
    through a send buffer of ``migrate_cap`` rows per face. Each rank then
    compacts: stayers first, arrivals appended, padding re-templated.
    Returns (state, dropped): buffer overflow, summed over the ranks, which
    the caller must hold to zero. Passes repeat until ``misplaced`` is 0."""
    ns, M, me = spec.n_shards, spec.migrate_cap, comm.rank
    nl, dim, dtype = st.n, st.dim, st.pos.dtype
    st = st._replace(pos=domain.wrap(st.pos))
    t = _target_shard(st.pos, domain, spec, cuts)
    real = st.mass > 0
    stay = real & (t == me)
    dl = torch.remainder(me - t, ns)
    dr = torch.remainder(t - me, ns)
    take_l, val_l, drop_l = _pack_select(real & ~stay & (dl <= dr), M)
    take_r, val_r, drop_r = _pack_select(real & ~stay & (dr < dl), M)

    packed = _pack(st)                                      # [nl, F]
    im = 2 * dim                                            # mass column
    arr_from_r, arr_from_l = comm.ring(_sel(packed, take_l, val_l, 0.0),
                                       _sel(packed, take_r, val_r, 0.0))
    arrivals = torch.cat([arr_from_l, arr_from_r])          # [2M, F]
    va = arrivals[:, im] > 0

    order = torch.argsort((~stay).to(torch.uint8), stable=True)
    nk = stay.sum()
    tmpl = _pack(_pad_template(nl, domain, spec,
                               _slab_lo(domain, spec, cuts, me, dtype),
                               dtype, dim))
    rows = torch.arange(nl, device=st.pos.device)
    out = torch.where((rows < nk)[:, None], packed[order], tmpl)
    slot = nk + torch.cumsum(va, 0) - 1
    land = va & (slot < nl)
    out[slot[land]] = arrivals[land]
    dropped = drop_l + drop_r + va.sum() - land.sum()
    return _unpack(out, dim), comm.all_reduce_sum(dropped.to(torch.int64))


def misplaced(comm, st: ParticleState, cuts, domain: Domain,
              spec: WSlabSpec) -> int:
    """Real particles not owned by their current shard, over all ranks
    (the migration's stopping rule; read on the host)."""
    t = _target_shard(domain.wrap(st.pos), domain, spec, cuts)
    bad = ((st.mass > 0) & (t != comm.rank)).sum().to(torch.int64)
    return int(comm.all_reduce_sum(bad))


def histogram(comm, st: ParticleState, domain: Domain,
              spec: WSlabSpec) -> np.ndarray:
    """The global slab-axis cell histogram of the real particles
    [ncell_ax] (the only array the rebalancer reads on the host)."""
    cellf = _cell(domain.wrap(st.pos), domain, spec)
    h = torch.zeros(spec.ncell_ax, dtype=torch.int64, device=st.pos.device)
    h.index_add_(0, cellf, (st.mass > 0).to(torch.int64))
    return comm.all_reduce_sum(h).cpu().numpy()


def work_weights(comm, st: ParticleState, cfg: SPHConfig, n_rungs: int):
    """Each row's expected WORK under block timesteps [n]: a particle the
    span-start rung assignment puts on rung r closes 2^{B-1-r} times a
    span, so its share is 2^-r. dt_min is a MIN all-reduce and the rung
    is quantized as ``wrungs.chunk_rungs`` assigns it (``rungs._rung_of``,
    in the state's dtype). Padding rows weigh zero."""
    real = st.mass > 0
    dt_des = torch.where(real, particle_dt(st, cfg), cfg.dt_max)
    dt_min = comm.all_reduce_min(dt_des.amin())
    r = _rung_of(dt_des, dt_min, n_rungs).to(st.pos.dtype)
    return torch.where(real, torch.exp2(-r), 0.0)


def work_histogram(comm, st: ParticleState, domain: Domain, spec: WSlabSpec,
                   cfg: SPHConfig, n_rungs: int) -> np.ndarray:
    """The global slab-axis histogram of expected work [ncell_ax] (float;
    the twin of ``histogram`` for block timesteps): cuts quantiled on it
    give slabs of equal work, not of equal counts. Any legal cuts give
    the same trajectory, so this moves load only."""
    cellf = _cell(domain.wrap(st.pos), domain, spec)
    h = st.pos.new_zeros(spec.ncell_ax)
    h.index_add_(0, cellf, work_weights(comm, st, cfg, n_rungs))
    return comm.all_reduce_sum(h).cpu().numpy()


def shard_work(comm, st: ParticleState, cfg: SPHConfig,
               n_rungs: int) -> np.ndarray:
    """Every rank's total expected work [n_shards]; its max over its mean
    is the imbalance (how much slower the busiest rank runs a tick than a
    balanced decomposition would)."""
    out = st.pos.new_zeros(comm.world)
    out[comm.rank] = work_weights(comm, st, cfg, n_rungs).sum()
    return comm.all_reduce_sum(out).cpu().numpy()


def diagnostics(comm, st: ParticleState, t: float) -> dict:
    """The conservation and flow record of the sharded state (the twin of
    ``make_diagnostics``: the keys of ``sphax.dist.wslab.diag_host``), from
    one SUM and one MAX all-reduce; padding rows are left out by the
    mass > 0 mask. Gravitational energy is omitted (the O(N^2) term)."""
    real = st.mass > 0
    v2 = torch.sum(st.vel ** 2, dim=-1)
    mom = torch.sum(st.mass[:, None] * st.vel, dim=0)
    sums = comm.all_reduce_sum(torch.stack([
        real.sum().to(st.pos.dtype), 0.5 * torch.sum(st.mass * v2),
        torch.sum(st.mass * st.u), *mom.unbind(),
        torch.sum(torch.where(real, st.h, 0.0)),
        torch.sum(torch.where(real, v2 / torch.clamp_min(st.cs, 1e-30) ** 2,
                              0.0))]).double())
    big = torch.finfo(st.pos.dtype).max
    maxes = comm.all_reduce_max(torch.stack([
        torch.where(real, torch.sqrt(v2), 0.0).amax(),
        torch.where(real, st.rho, 0.0).amax(),
        torch.where(real, -st.rho, -big).amax()]).double())
    s, mx = sums.tolist(), maxes.tolist()
    dim = st.dim
    n_real = int(round(s[0]))
    p = s[3:3 + dim] + [0.0] * (3 - dim)
    rec = dict(t=float(t), e_kin=s[1], e_int=s[2], px=p[0], py=p[1],
               pz=p[2], max_v=mx[0], max_rho=mx[1], min_rho=-mx[2],
               mean_h=s[3 + dim] / max(n_real, 1),
               mach_rms=math.sqrt(s[4 + dim] / max(n_real, 1)),
               n_real=n_real)
    rec["e_total"] = rec["e_kin"] + rec["e_int"]
    rec["finite"] = bool(math.isfinite(rec["e_total"]) and rec["max_rho"] > 0)
    return rec


def max_run(comm, st: ParticleState, cuts, domain: Domain, spec: WSlabSpec):
    """The largest aligned window length any rank's build needs, and the
    ghosts dropped, over all ranks (the twin of ``make_max_run``; feeds
    ``refine_wseg``)."""
    wd, _, _, dropped = _exchange_and_build(comm, st, cuts, domain, spec)
    return (int(comm.all_reduce_max(wd.max_run.to(torch.int64))),
            int(comm.all_reduce_sum(dropped.to(torch.int64))))


def refine_wseg(spec: WSlabSpec, max_run: int,
                headroom: float = 1.6) -> WSlabSpec:
    """Resize the window segment width to the MEASURED requirement times
    ``headroom`` (call after ``distribute`` with ``max_run``'s result)."""
    wspec = spec.wspec
    wseg = max(int(np.ceil(int(max_run) * headroom / 128.0) * 128), 128)
    quantum = int(np.lcm(wspec.tile, 128))
    n_sorted = int(np.ceil(max(wspec.n_sorted, wseg) / quantum) * quantum)
    if wseg == wspec.wseg and n_sorted == wspec.n_sorted:
        return spec
    wspec = dataclasses.replace(wspec, wseg=wseg, n_sorted=n_sorted)
    return dataclasses.replace(spec, wspec=wspec)


def rebalance_cuts(hist: np.ndarray, spec: WSlabSpec) -> np.ndarray:
    """Quantile cuts from a global histogram (host-side, cell-granular),
    widths clamped to [margin_cells, res_max]."""
    return quantile_cuts(hist, spec.n_shards, spec.margin_cells,
                         spec.res_max)


def quantile_cuts(hist: np.ndarray, n_shards: int, margin_cells: int,
                  res_max: int) -> np.ndarray:
    """Axis-generic core of ``rebalance_cuts``."""
    ns = n_shards
    nc = len(hist)
    c = np.concatenate([[0], np.cumsum(np.asarray(hist, np.float64))])
    total = c[-1]
    cuts = np.zeros(ns + 1, np.int32)
    cuts[ns] = nc
    for s in range(1, ns):
        cuts[s] = int(np.searchsorted(c, total * s / ns))
    # enforce monotone widths within [margin_cells, res_max]
    for s in range(1, ns + 1):
        cuts[s] = max(cuts[s], cuts[s - 1] + margin_cells)
        cuts[s] = min(cuts[s], cuts[s - 1] + res_max)
    cuts[ns] = nc
    for s in range(ns, 0, -1):   # backward pass: keep final coverage legal
        cuts[s - 1] = max(cuts[s - 1], cuts[s] - res_max)
        cuts[s - 1] = min(cuts[s - 1], cuts[s] - margin_cells)
    cuts[0] = 0
    if not np.all(np.diff(cuts) >= margin_cells) or \
       not np.all(np.diff(cuts) <= res_max):
        raise ValueError(
            f"cannot cover {nc} cells with {ns} slabs of width in "
            f"[{margin_cells}, {res_max}]; re-plan with more "
            "balance_headroom")
    return cuts


# ---------------------------------------------------------------------------
# set-up and gather (host-side; set-up and checkpoints only)
# ---------------------------------------------------------------------------


def distribute(state: ParticleState, domain: Domain, spec: WSlabSpec, cuts,
               rank: int) -> ParticleState:
    """Shard ``rank``'s rows of a single-device state (set-up only, on the
    state's device): its slab's particles in row order, then padding rows
    parked in its trash band. Every rank calls this with the same state
    and cuts."""
    ns, nl, ax = spec.n_shards, spec.n_local, spec.slab_axis
    dev, dtype = state.pos.device, state.pos.dtype
    lo = domain.lo.detach().cpu().double().numpy()
    ext = domain.hi.detach().cpu().double().numpy() - lo
    cell_ax = ext[ax] / spec.ncell_ax
    # the slab-axis cell in float64, truncated as the reference's host
    # arithmetic does
    cellf = torch.clamp(((state.pos[:, ax].double() - lo[ax]) / cell_ax)
                        .long(), 0, spec.ncell_ax - 1)
    inner = torch.as_tensor(np.asarray(cuts[1:ns], np.int64), device=dev)
    sid = (torch.searchsorted(inner, cellf, right=True) if ns > 1
           else torch.zeros_like(cellf))
    rows = torch.nonzero(sid == rank).reshape(-1)
    if rows.numel() > nl:
        raise ValueError(f"shard {rank} holds {rows.numel()} > n_local={nl} "
                         "particles; re-plan with a larger pad_factor")
    slab_lo = torch.tensor(lo[ax] + float(cuts[rank]) * cell_ax, dtype=dtype,
                           device=dev)
    tmpl = _pad_template(nl - rows.numel(), domain, spec, slab_lo, dtype,
                         state.dim)
    return ParticleState(*(torch.cat([f[rows], t]) for f, t in zip(state,
                                                                  tmpl)))


def gather_real(comm, st: ParticleState):
    """Rank 0: the real rows of every rank, in shard order then row order,
    as one ParticleState on its device; None on the other ranks."""
    rows = comm.gather_rows(_pack(st)[st.mass > 0])
    return None if rows is None else _unpack(rows, st.dim)
