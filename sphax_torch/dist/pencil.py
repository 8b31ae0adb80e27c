"""The 2D pencil decomposition running the window engine (torch twin of
``sphax.dist.pencil``).

Slabs stop scaling once a slab is no wider than its ghost margin; cutting
along TWO axes raises that ceiling to the product of the per-axis limits.
The box is cut into ``ns0 x ns1`` pencils at cell-granular, count-balanced
positions (independent quantile cuts per axis from two marginal
histograms), one pencil a rank on the ranks' grid (``Comm.grid``: rank =
i0 * ns1 + i1, the JAX package's ``Mesh(devs.reshape(ns0, ns1), ("sx",
"sy"))``).

Everything a rank does is the slab engine's (``dist/wslab.py``): kernels A
and C of the window engine over a local bin box, fixed-capacity ghost
routes, migration, all-reduced health counters. What changes is the
exchange topology:

  * ghosts arrive through TWO ring exchanges in turn: the x faces first
    (the ring along axis 0), then the y faces selected from the COMBINED
    local and x-ghost rows (the ring along axis 1), so corner ghosts ride
    the second hop with no diagonal exchange;
  * phase 2 re-ships the owners' hydro over the same two hops in the same
    order, so a corner ghost's j-fields are exactly its owner's;
  * migration hops along axis 0 toward the target pencil, then along axis
    1; a particle (kx, ky) pencils from home is resident after max(kx, ky)
    passes (``misplaced`` is the stopping rule);
  * reductions (the dt MIN, the health and histogram SUMs) are the world's.

A rank's state is [n_local] rows, real particles first, zero-mass padding
parked in a trash band below the x-slab (at least one cutoff-sized cell
from any real or ghost row along x, which alone rules out an interaction).
Its window structure has ``n_comb = n_local + 2 (ghost_cap0 + ghost_cap1)``
rows: only the real own rows are active, the ghosts are imaged by mass.
Gravity is P3M only (the mesh's SUM all-reduce spans both axes, the
screened short range rides kernel C's walk); the direct-sum ring is the
slab engine's.

The JAX package's ``make_*`` factories are plain per-rank functions of the
rank's ``Comm`` here: ``step``, ``chunk``, ``migrate``, ``misplaced``,
``histograms`` and ``max_run``; ``diagnostics``, ``gather_real``,
``equal_cuts`` and ``refine_wseg`` are the slab engine's (reductions over
the world span both axes). ``cuts0`` and ``cuts1``
are host arrays of ``ns0 + 1`` and ``ns1 + 1`` cell indices, the same on
every rank. P3M runs the scatter mesh, as ``wslab`` does: the JAX
package's ``sorted_mesh`` option and its ``_mesh_plan`` are not taken.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.dist.wslab import (_exchange, _pack, _pack_select, _sel,
                                    _sorted_inputs, _unpack, diagnostics,
                                    equal_cuts, gather_real, quantile_cuts,
                                    refine_wseg)
from sphax_torch.integrate.timestep import local_dt
from sphax_torch.neighbors import window as win
from sphax_torch.neighbors.window import WindowSpec
from sphax_torch.physics import driving as drv
from sphax_torch.physics import pairs, pm, wengine
from sphax_torch.physics.eos import eos

__all__ = ["PencilSpec", "plan", "equal_cuts", "distribute", "gather_real",
           "step", "chunk", "migrate", "misplaced", "histograms",
           "rebalance", "max_run", "refine_wseg", "diagnostics"]


@dataclasses.dataclass(frozen=True)
class PencilSpec:
    """Static decomposition parameters (the fields of
    ``sphax.dist.pencil.PencilSpec``).

    Axis 0 and axis 1 are each divided into global cells of width >= the
    window cutoff; cuts are cell indices per axis, so rebalancing either
    axis moves cuts without changing any shape as long as every pencil
    stays within (res_max0, res_max1) cells.
    """

    ns0: int
    ns1: int
    n_local: int         # particle rows per shard incl. zero-mass padding
    ghost_cap0: int      # ghost capacity per x face
    ghost_cap1: int      # ghost capacity per y face (selected from the
    #                      nl + 2 ghost_cap0 combined rows: corners ride)
    migrate_cap: int     # emigrant capacity per face per migration hop
    ncell0: int
    ncell1: int
    res_max0: int
    res_max1: int
    margin_cells0: int
    margin_cells1: int
    wspec: WindowSpec    # per-shard window spec over the local bin box

    @property
    def n_shards(self) -> int:
        return self.ns0 * self.ns1

    @property
    def trash_cells(self) -> int:
        """Bin-box cells below the x-slab reserved for padding rows."""
        return 2 * self.margin_cells0

    @property
    def n_comb(self) -> int:
        return self.n_local + 2 * self.ghost_cap0 + 2 * self.ghost_cap1


def plan(domain: Domain, n: int, h_max: float, ns0: int, ns1: int,
         cutoff_scale: float = 1.2, margin_scale: float = 1.05,
         pad_factor: float = 1.5, ghost_safety: float = 2.0,
         migrate_frac: float = 0.25, balance_headroom: float = 1.6,
         seg_safety: float = 1.35, tile: int = 128, fast_sub: int = 1,
         rgroups: int = 1) -> PencilSpec:
    """Choose the decomposition's static parameters from the problem's
    scales (host-side; the JAX package's arithmetic). ``fast_sub`` and
    ``rgroups`` pass through to the per-shard window plan."""
    lo = domain.lo.detach().cpu().double().numpy()
    hi = domain.hi.detach().cpu().double().numpy()
    ext = hi - lo
    dim = len(lo)
    if dim < 3:
        raise ValueError("pencil decomposition needs dim >= 3 (two cut "
                         "axes + the window fast axis); use dist.wslab")
    cutoff = 2.0 * float(h_max) * cutoff_scale

    ncell, margin, res_max, cellw = [], [], [], []
    for a, ns in ((0, ns0), (1, ns1)):
        nc = max(int(np.floor(ext[a] / cutoff)), 1)
        cw = ext[a] / nc
        mc = max(int(np.ceil(margin_scale * cutoff / cw)), 1)
        width = nc / ns
        if width < mc:
            raise ValueError(
                f"axis-{a} pencils of ~{width:.1f} cells are thinner than "
                f"the ghost margin ({mc} cells); use fewer shards along it")
        ncell.append(nc)
        margin.append(mc)
        res_max.append(min(int(np.ceil(width * balance_headroom)), nc))
        cellw.append(cw)

    share0 = max(1.0 / ns0, np.ceil(ncell[0] / ns0) / ncell[0])
    share1 = max(1.0 / ns1, np.ceil(ncell[1] / ns1) / ncell[1])
    n_per = n * share0 * share1
    nl = int(np.ceil(n_per * pad_factor / 8.0) * 8)
    frac0 = margin[0] * cellw[0] / (ext[0] / ns0)
    G0 = int(np.ceil(n_per * frac0 * ghost_safety / 8.0) * 8)
    G0 = min(max(G0, 16), nl)
    frac1 = margin[1] * cellw[1] / (ext[1] / ns1)
    G1 = int(np.ceil(n_per * (1.0 + 2.0 * frac0) * frac1
                     * ghost_safety / 8.0) * 8)
    G1 = min(max(G1, 16), nl + 2 * G0)
    M = max(int(np.ceil(nl * migrate_frac / 8.0) * 8), 64)

    # local bin box: x = trash band + margin | res_max0 | margin (open);
    # y = margin | res_max1 | margin (open); the other axes global
    ext_local = ext.copy()
    ext_local[0] = (2 * margin[0] + margin[0] + res_max[0]
                    + margin[0]) * cellw[0]
    ext_local[1] = (margin[1] + res_max[1] + margin[1]) * cellw[1]
    per = domain.periodic_axes(dim)
    local_dom = Domain(lo=torch.zeros(dim, dtype=torch.float64),
                       hi=torch.as_tensor(ext_local),
                       periodic=tuple(False if d in (0, 1) else per[d]
                                      for d in range(dim)))
    wspec = win.plan_windows(local_dom, h_max=h_max, n=nl + 2 * (G0 + G1),
                             dim=dim, tile=tile, cutoff_scale=cutoff_scale,
                             ghost_safety=ghost_safety,
                             seg_safety=seg_safety, fast_sub=fast_sub,
                             rgroups=rgroups)
    return PencilSpec(ns0=ns0, ns1=ns1, n_local=nl, ghost_cap0=G0,
                      ghost_cap1=G1, migrate_cap=M, ncell0=ncell[0],
                      ncell1=ncell[1], res_max0=res_max[0],
                      res_max1=res_max[1], margin_cells0=margin[0],
                      margin_cells1=margin[1], wspec=wspec)


def rebalance(hist0: np.ndarray, hist1: np.ndarray, spec: PencilSpec):
    """Independent per-axis quantile cuts (host-side, cell-granular)."""
    return (quantile_cuts(hist0, spec.ns0, spec.margin_cells0,
                          spec.res_max0),
            quantile_cuts(hist1, spec.ns1, spec.margin_cells1,
                          spec.res_max1))


# ---------------------------------------------------------------------------
# geometry (device scalars; cuts0/cuts1 are host arrays)
# ---------------------------------------------------------------------------


def _geom(domain: Domain, spec: PencilSpec, dtype):
    glo = domain.lo.to(dtype)
    ext = (domain.hi - domain.lo).to(dtype)
    cell0 = ext[0] / spec.ncell0
    cell1 = ext[1] / spec.ncell1
    return (glo, ext, cell0, cell1, spec.margin_cells0 * cell0,
            spec.margin_cells1 * cell1)


def _slab_bounds(comm, cuts0, cuts1, domain: Domain, spec: PencilSpec,
                 dtype):
    """(lo0, hi0, lo1, hi1): this rank's pencil."""
    me0, me1 = comm.coords
    glo, _, cell0, cell1, _, _ = _geom(domain, spec, dtype)
    return (glo[0] + float(cuts0[me0]) * cell0,
            glo[0] + float(cuts0[me0 + 1]) * cell0,
            glo[1] + float(cuts1[me1]) * cell1,
            glo[1] + float(cuts1[me1 + 1]) * cell1)


def _local_domain(domain: Domain, spec: PencilSpec, slab_lo0, slab_lo1,
                  dtype):
    """Per-shard bin box for the window build (trash band below the
    x-slab; both cut axes open)."""
    dim = domain.lo.shape[0]
    _, _, cell0, cell1, _, _ = _geom(domain, spec, dtype)
    lo = domain.lo.to(dtype).clone()
    hi = domain.hi.to(dtype).clone()
    lo[0] = slab_lo0 - (spec.trash_cells + spec.margin_cells0) * cell0
    hi[0] = lo[0] + (spec.trash_cells + 2 * spec.margin_cells0
                     + spec.res_max0) * cell0
    lo[1] = slab_lo1 - spec.margin_cells1 * cell1
    hi[1] = lo[1] + (2 * spec.margin_cells1 + spec.res_max1) * cell1
    per = domain.periodic_axes(dim)
    return Domain(lo=lo, hi=hi, periodic=tuple(False if d in (0, 1)
                                               else per[d]
                                               for d in range(dim)))


def _trash_pos(nrows: int, domain: Domain, spec: PencilSpec, slab_lo0,
               slab_lo1, dtype, salt: float = 0.61803398875):
    """Deterministic parking spots in the x trash band: x across the band
    (at least one cutoff-sized cell below every real or ghost row), y
    across the local bin height, the other axes across the box."""
    dim = domain.lo.shape[0]
    _, _, cell0, cell1, _, _ = _geom(domain, spec, dtype)
    i = torch.arange(nrows, dtype=dtype, device=domain.lo.device)
    span0 = (spec.trash_cells - 1) * cell0
    base0 = slab_lo0 - (spec.trash_cells + spec.margin_cells0) * cell0
    cols = [base0 + span0 * torch.remainder(0.37 * i, 1.0)]
    span1 = (2 * spec.margin_cells1 + spec.res_max1 - 0.01) * cell1
    base1 = slab_lo1 - spec.margin_cells1 * cell1
    cols.append(base1 + span1 * torch.remainder(salt * (i + 1.0), 1.0))
    for d in range(2, dim):
        lo_d, hi_d = domain.lo[d].to(dtype), domain.hi[d].to(dtype)
        cols.append(lo_d + (hi_d - lo_d)
                    * torch.remainder(salt * 1.7 * (i + 1.0), 1.0))
    return torch.stack(cols, dim=-1)


def _wrap_other(pos, domain: Domain):
    """Wrap the periodic NON-cut axes only: both cut axes stay unwrapped
    within a chunk so that pencil locality survives the seams (migration
    wraps them)."""
    dim = pos.shape[1]
    per = domain.periodic_axes(dim)
    if not any(per[d] for d in range(2, dim)):
        return pos
    wrapped = domain.lo + torch.remainder(pos - domain.lo, domain.extent)
    mask = torch.tensor([per[d] and d >= 2 for d in range(dim)],
                        device=pos.device)
    return torch.where(mask, wrapped, pos)


def _cells(pos, domain: Domain, spec: PencilSpec):
    """The global (axis-0, axis-1) cells of (wrapped) positions."""
    glo, _, cell0, cell1, _, _ = _geom(domain, spec, pos.dtype)
    return (torch.clamp(torch.floor((pos[:, 0] - glo[0]) / cell0), 0,
                        spec.ncell0 - 1).long(),
            torch.clamp(torch.floor((pos[:, 1] - glo[1]) / cell1), 0,
                        spec.ncell1 - 1).long())


def _owner(cellf, cuts, ns: int):
    """The pencil index along one axis that owns each cell."""
    if ns == 1:
        return torch.zeros_like(cellf)
    inner = torch.as_tensor(np.asarray(cuts[1:ns], np.int64),
                            device=cellf.device)
    return torch.searchsorted(inner, cellf, right=True)


# ---------------------------------------------------------------------------
# the two-hop exchanges and the derived pass of one rank
# ---------------------------------------------------------------------------


def _hop_kin(comm, pos, vel, mass, routes, axis: int, ext_a, periodic_a,
             trash):
    """One axis of the phase-1 kinematics exchange: ship both faces' rows
    to the ring neighbours along ``axis``, seam-shift arrivals, park
    invalid rows in the trash band, and append [.. | from-left |
    from-right]."""
    dim = pos.shape[1]
    me, ns = comm.coords[axis], comm.shape[axis]
    kin = torch.cat([pos, vel, mass[:, None]], dim=-1)
    gR, gL = _exchange(comm, kin, (0.0,) * (2 * dim + 1), routes, axis=axis)
    gR_pos, gR_vel, gR_mass = gR[:, :dim].clone(), gR[:, dim:2 * dim], \
        gR[:, 2 * dim]
    gL_pos, gL_vel, gL_mass = gL[:, :dim].clone(), gL[:, dim:2 * dim], \
        gL[:, 2 * dim]
    if me == ns - 1:
        gR_pos[:, axis] += ext_a
    if me == 0:
        gL_pos[:, axis] -= ext_a
    if not periodic_a:
        if me == ns - 1:
            gR_mass = torch.zeros_like(gR_mass)
        if me == 0:
            gL_mass = torch.zeros_like(gL_mass)
    gR_pos = torch.where((gR_mass > 0)[:, None], gR_pos, trash)
    gL_pos = torch.where((gL_mass > 0)[:, None], gL_pos, trash)
    return (torch.cat([pos, gL_pos, gR_pos]), torch.cat([vel, gL_vel, gR_vel]),
            torch.cat([mass, gL_mass, gR_mass]))


def _ship_kinematics(comm, st: ParticleState, routes, slab_lo0, slab_lo1,
                     domain: Domain, spec: PencilSpec):
    """Two-hop phase-1 exchange over FIXED routes (per-step work under
    structure reuse). Layout: [local | x-gL | x-gR | y-gL | y-gR], the y
    ghosts selected from the combined local and x rows (corners)."""
    dtype = st.pos.dtype
    per = domain.periodic_axes(st.dim)
    _, ext, _, _, _, _ = _geom(domain, spec, dtype)
    rx_lo, rx_hi, ry_lo, ry_hi = routes
    trash0 = _trash_pos(spec.ghost_cap0, domain, spec, slab_lo0, slab_lo1,
                        dtype)
    c1 = _hop_kin(comm, st.pos, st.vel, st.mass, (rx_lo, rx_hi), 0, ext[0],
                  per[0], trash0)
    trash1 = _trash_pos(spec.ghost_cap1, domain, spec, slab_lo0, slab_lo1,
                        dtype, salt=0.7548776662)
    return _hop_kin(comm, *c1, (ry_lo, ry_hi), 1, ext[1], per[1], trash1)


def _plan_routes(comm, st: ParticleState, cuts0, cuts1, domain: Domain,
                 spec: PencilSpec):
    """Boundary-set selection for the two-hop ghost exchange (rebuild-
    cadence work; the drift contract is ``wslab._plan_routes``'). The y
    faces are selected from the COMBINED local and x-ghost rows, so their
    fixed row indices stay valid while the x routes are fixed. Returns
    (routes, lo0, lo1, dropped): routes = (x low, x high, y low, y high),
    each (take, valid)."""
    G0, G1 = spec.ghost_cap0, spec.ghost_cap1
    dtype = st.pos.dtype
    per = domain.periodic_axes(st.dim)
    _, ext, _, _, m0, m1 = _geom(domain, spec, dtype)
    lo0, hi0, lo1, hi1 = _slab_bounds(comm, cuts0, cuts1, domain, spec,
                                      dtype)
    x = st.pos[:, 0]
    real = st.mass > 0
    t_lo, v_lo, d_lo = _pack_select((x < lo0 + m0) & real, G0)
    t_hi, v_hi, d_hi = _pack_select((x > hi0 - m0) & real, G0)
    rx_lo, rx_hi = (t_lo, v_lo), (t_hi, v_hi)

    # ship the x kinematics once to place the combined rows, then select y
    trash0 = _trash_pos(G0, domain, spec, lo0, lo1, dtype)
    c_pos, _, c_mass = _hop_kin(comm, st.pos, st.vel, st.mass,
                                (rx_lo, rx_hi), 0, ext[0], per[0], trash0)
    y = c_pos[:, 1]
    realc = c_mass > 0
    u_lo, w_lo, e_lo = _pack_select((y < lo1 + m1) & realc, G1)
    u_hi, w_hi, e_hi = _pack_select((y > hi1 - m1) & realc, G1)
    routes = (rx_lo, rx_hi, (u_lo, w_lo), (u_hi, w_hi))
    return routes, lo0, lo1, d_lo + d_hi + e_lo + e_hi


def _exchange_and_build(comm, st: ParticleState, cuts0, cuts1,
                        domain: Domain, spec: PencilSpec):
    """Route selection + phase-1 exchange + this rank's window build: only
    the local real rows are active, every row with mass is imaged.
    Returns (wd, routes, lo0, lo1, dropped)."""
    nG = 2 * (spec.ghost_cap0 + spec.ghost_cap1)
    routes, lo0, lo1, dropped = _plan_routes(comm, st, cuts0, cuts1, domain,
                                             spec)
    comb_pos, _, comb_mass = _ship_kinematics(comm, st, routes, lo0, lo1,
                                              domain, spec)
    ldom = _local_domain(domain, spec, lo0, lo1, st.pos.dtype)
    active = torch.cat([st.mass > 0, st.mass.new_zeros(nG, dtype=torch.bool)])
    wd = win.build(comb_pos, ldom, spec.wspec, active=active,
                   image=comb_mass > 0)
    return wd, routes, lo0, lo1, dropped


def _ship_hydro(comm, cols, fills, routes):
    """Phase-2 two-hop exchange of owner-computed [n_local, K] columns over
    the SAME routes: x first, then y from the combined columns (a corner
    ghost gets its owner's values through the intermediate shard, whose
    x-ghost slots were just filled). Returns the [n_comb, K] columns."""
    rx_lo, rx_hi, ry_lo, ry_hi = routes
    gR, gL = _exchange(comm, cols, fills, (rx_lo, rx_hi), axis=0)
    comb1 = torch.cat([cols, gL, gR])
    hR, hL = _exchange(comm, comb1, fills, (ry_lo, ry_hi), axis=1)
    return torch.cat([comb1, hL, hR])


# the phase-2 columns (h, rho, P, cs, Omega, visc factor) and their fills
_HYDRO_FILLS = (1.0, 1.0, 0.0, 0.0, 1.0, 0.0)


def _local_derived(comm, st: ParticleState, wd, routes, lo0, lo1,
                   cfg: SPHConfig, domain: Domain, spec: PencilSpec):
    """The window engine's derived pass for one pencil with two-phase,
    two-hop ghosts against a pre-built (possibly stale) structure and
    fixed routes (the pencil twin of ``wslab._local_derived``)."""
    nl, dim, dtype = st.n, st.dim, st.pos.dtype
    wspec = spec.wspec
    comb = _ship_kinematics(comm, st, routes, lo0, lo1, domain, spec)
    win_a, pos_s, vel_s, mass_s, u_s, h_s, alpha_s = _sorted_inputs(
        st, comb, wd, 2 * (spec.ghost_cap0 + spec.ghost_cap1), cfg)

    # ---- kernel A (+ Omega, viscosity factor); owner-valid on LOCAL rows
    h_s, rho_s, om_s, bf_s, divv_s = wengine.stage_density(
        wd, wspec, cfg, pos_s, vel_s, mass_s, u_s, h_s, alpha_s=alpha_s,
        win=win_a)
    dsc = torch.stack([h_s, rho_s, om_s, bf_s, divv_s], dim=-1)[wd.inv][:nl]
    h_c, rho_c, om_c, bf_c, divv_c = dsc.unbind(-1)
    P_c, cs_c = eos(rho_c, st.u, cfg)

    # ---- phase 2: owner-computed hydro over the same two-hop routes
    loc_hyd = torch.stack([h_c, rho_c, P_c, cs_c, om_c, bf_c],
                          dim=-1)                                 # [nl, 6]
    hyd_s = win.gather_sorted(_ship_hydro(comm, loc_hyd, _HYDRO_FILLS,
                                          routes), wd)
    h_s2 = torch.where(mass_s > 0, hyd_s[:, 0], 1.0)
    rho_s2 = torch.clamp_min(hyd_s[:, 1], 1e-15)
    om_s2 = torch.where(mass_s > 0, hyd_s[:, 4], 1.0)

    # ---- kernel C with exact ghost j-fields
    grav = None
    if cfg.gravity:
        if cfg.grav_solver != "p3m":
            raise NotImplementedError(
                "pencil gravity: use grav_solver='p3m' (the O(n_shards) "
                "direct-sum ring is slab-only; see dist.wslab)")
        # the screened short range rides kernel C's walk over this rank's
        # candidates (C's GRAV mode)
        rs = pm.rs_traced(cfg, domain, dtype, cutoff=wspec.cutoff)
        grav = (rs, float(cfg.grav_eps))
    acc_s, du_s = wengine.stage_forces(
        wd, wspec, cfg, pos_s, vel_s, mass_s, h_s2, rho_s2, hyd_s[:, 2],
        hyd_s[:, 3], om_s2, hyd_s[:, 5], grav=grav)
    out = torch.stack([du_s] + list(acc_s.unbind(-1)), dim=-1)[wd.inv]
    acc = out[:nl, 1:1 + dim]
    if grav is not None:
        # each rank deposits its particles on a full copy of the global
        # mesh; one SUM all-reduce over both axes replicates it
        acc = acc + pm.mesh_accel(st.pos, st.mass, cfg, domain, rs=rs,
                                  group=comm)
    return st._replace(h=h_c, rho=rho_c, P=P_c, cs=cs_c, omega=om_c,
                       du_dt=out[:nl, 0], acc=acc, divv=divv_c)


# ---------------------------------------------------------------------------
# distributed step / chunk
# ---------------------------------------------------------------------------


def _close(comm, s, dr, built, dt, cfg, domain, spec, drive_spec, modes):
    """Derived pass + drive acceleration + closing half-kick + alpha
    update: the post-drift half of a KDK step."""
    s = _local_derived(comm, s, *built, cfg, domain, spec)
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


def _health(dropped, wd):
    return torch.stack([dropped.to(torch.int64), wd.overflow.to(torch.int64)])


def step(comm, st: ParticleState, cuts0, cuts1, domain: Domain,
         cfg: SPHConfig, spec: PencilSpec):
    """One distributed KDK step with a fresh structure (the twin of
    ``make_step``'s function). Returns (state, dt, health): health =
    (ghosts dropped, window overflow), summed over the ranks."""
    st = st._replace(pos=_wrap_other(st.pos, domain))
    wd, routes, lo0, lo1, dropped = _exchange_and_build(comm, st, cuts0,
                                                        cuts1, domain, spec)
    dt = comm.all_reduce_min(local_dt(st, cfg))
    half = 0.5 * dt
    vel = st.vel + half * st.acc
    u = torch.clamp_min(st.u + half * st.du_dt, cfg.u_floor)
    st = _close(comm, st._replace(pos=st.pos + dt * vel, vel=vel, u=u), None,
                (wd, routes, lo0, lo1), dt, cfg, domain, spec, None, None)
    return st, dt, comm.all_reduce_sum(_health(dropped, wd))


def chunk(comm, st: ParticleState, cuts0, cuts1, domain: Domain,
          cfg: SPHConfig, spec: PencilSpec, nsteps: int,
          rebuild_every: int = 1, drive=None, drive_spec=None, noise=None):
    """``nsteps`` distributed KDK steps (the twin of ``make_chunk``'s
    function, with ``wslab.chunk``'s contracts): the routes and the window
    structure are built once per ``rebuild_every`` steps, the steps between
    re-ship only kinematics; positions drift unwrapped between rebuilds
    and the non-cut axes wrap at each. ``drive_spec`` (with ``drive`` and
    ``noise``): OU driving replicated from one noise stream, as in
    ``wslab.chunk``.

    Returns (state, drive, dts [nsteps], health, builds): health = (ghosts
    dropped, window overflow), each rank's maximum over its builds, summed
    over the ranks."""
    if nsteps % rebuild_every:
        raise ValueError("nsteps must be a multiple of rebuild_every")
    if drive_spec is not None and (drive is None or noise is None):
        raise ValueError("driving needs an initial DriveState and a noise "
                         "source")
    modes = None
    if drive_spec is not None:
        modes = torch.tensor(drive_spec.modes, dtype=st.pos.dtype,
                             device=st.pos.device)
    dts, health = [], []
    dr = drive
    for _ in range(nsteps // rebuild_every):
        st = st._replace(pos=_wrap_other(st.pos, domain))
        wd, routes, lo0, lo1, dropped = _exchange_and_build(
            comm, st, cuts0, cuts1, domain, spec)
        health.append(_health(dropped, wd))
        for _ in range(rebuild_every):
            dt = comm.all_reduce_min(local_dt(st, cfg))
            if drive_spec is not None:
                xi = noise(dr.amp_re.shape, dr.amp_re.dtype,
                           dr.amp_re.device)
                dr = drv.update(dr, modes, dt, drive_spec.tau,
                                drive_spec.accel_rms, drive_spec.box_size,
                                noise=xi)
            half = 0.5 * dt
            vel = st.vel + half * st.acc
            u = torch.clamp_min(st.u + half * st.du_dt, cfg.u_floor)
            st = st._replace(pos=st.pos + dt * vel, vel=vel, u=u)
            if cfg.h_predict and cfg.adaptive_h:
                # before the derived pass, so phase 1 ships the predicted
                # h; pad rows carry divv = 0 -> factor 1
                fac = torch.clamp(1.0 + (dt / cfg.dim) * st.divv, 0.9, 1.1)
                st = st._replace(h=st.h * fac)
            st = _close(comm, st, dr, (wd, routes, lo0, lo1), dt, cfg,
                        domain, spec, drive_spec, modes)
            dts.append(dt)
    hmax = comm.all_reduce_sum(torch.stack(health).amax(0))
    return st, dr, torch.stack(dts), hmax, len(health)


# ---------------------------------------------------------------------------
# migration and per-axis count-based rebalancing
# ---------------------------------------------------------------------------


def _pad_template(nl: int, domain: Domain, spec: PencilSpec, slab_lo0,
                  slab_lo1, dtype, dim: int) -> ParticleState:
    pos = _trash_pos(nl, domain, spec, slab_lo0, slab_lo1, dtype,
                     salt=0.5352919)
    z = pos.new_zeros(nl)
    one = pos.new_ones(nl)
    return ParticleState(pos=pos, vel=pos.new_zeros(nl, dim), mass=z, u=z,
                         h=one, rho=one, P=z, cs=z,
                         acc=pos.new_zeros(nl, dim), du_dt=z, omega=one,
                         alpha=one, divv=z)


def _axis_hop(comm, packed, im: int, axis: int, cuts, glo_a, cell_a,
              ncell_a: int, M: int, tpacked):
    """One migration hop along one grid axis (the per-axis core of
    ``wslab.migrate``): movers hop one shard toward their target pencil
    along this axis's ring; stayers compact first, arrivals append, the
    rest is re-templated. Returns (packed, dropped)."""
    nl = packed.shape[0]
    me, ns = comm.coords[axis], comm.shape[axis]
    cellf = torch.clamp(torch.floor((packed[:, axis] - glo_a) / cell_a), 0,
                        ncell_a - 1).long()
    t = _owner(cellf, cuts, ns)
    real = packed[:, im] > 0
    stay = real & (t == me)
    dl = torch.remainder(me - t, ns)
    dr = torch.remainder(t - me, ns)
    take_l, val_l, drop_l = _pack_select(real & ~stay & (dl <= dr), M)
    take_r, val_r, drop_r = _pack_select(real & ~stay & (dr < dl), M)
    arr_from_r, arr_from_l = comm.ring(_sel(packed, take_l, val_l, 0.0),
                                       _sel(packed, take_r, val_r, 0.0),
                                       axis=axis)
    arrivals = torch.cat([arr_from_l, arr_from_r])
    va = arrivals[:, im] > 0

    order = torch.argsort((~stay).to(torch.uint8), stable=True)
    nk = stay.sum()
    rows = torch.arange(nl, device=packed.device)
    out = torch.where((rows < nk)[:, None], packed[order], tpacked)
    slot = nk + torch.cumsum(va, 0) - 1
    land = va & (slot < nl)
    out[slot[land]] = arrivals[land]
    return out, drop_l + drop_r + va.sum() - land.sum()


def migrate(comm, st: ParticleState, cuts0, cuts1, domain: Domain,
            spec: PencilSpec):
    """One migration pass (the twin of ``make_migrate``'s function): the
    positions wrap into the box, then one hop along axis 0 and one along
    axis 1 through send buffers of ``migrate_cap`` rows a face. Returns
    (state, dropped): buffer overflow summed over the ranks, which the
    caller must hold to zero. Passes repeat until ``misplaced`` is 0."""
    dim, dtype = st.dim, st.pos.dtype
    glo, _, cell0, cell1, _, _ = _geom(domain, spec, dtype)
    lo0, _, lo1, _ = _slab_bounds(comm, cuts0, cuts1, domain, spec, dtype)
    st = st._replace(pos=domain.wrap(st.pos))
    packed, im = _pack(st), 2 * dim
    tpacked = _pack(_pad_template(st.n, domain, spec, lo0, lo1, dtype, dim))
    packed, d0 = _axis_hop(comm, packed, im, 0, cuts0, glo[0], cell0,
                           spec.ncell0, spec.migrate_cap, tpacked)
    packed, d1 = _axis_hop(comm, packed, im, 1, cuts1, glo[1], cell1,
                           spec.ncell1, spec.migrate_cap, tpacked)
    return _unpack(packed, dim), comm.all_reduce_sum(
        (d0 + d1).to(torch.int64))


def misplaced(comm, st: ParticleState, cuts0, cuts1, domain: Domain,
              spec: PencilSpec) -> int:
    """Real particles not owned by their current pencil, over all ranks
    (the migration's stopping rule; read on the host)."""
    me0, me1 = comm.coords
    c0, c1 = _cells(domain.wrap(st.pos), domain, spec)
    bad = (st.mass > 0) & ((_owner(c0, cuts0, spec.ns0) != me0)
                           | (_owner(c1, cuts1, spec.ns1) != me1))
    return int(comm.all_reduce_sum(bad.sum().to(torch.int64)))


def histograms(comm, st: ParticleState, domain: Domain, spec: PencilSpec):
    """The global MARGINAL cell histograms of the real particles
    ([ncell0], [ncell1]; the only arrays the rebalancer reads on the
    host). Independent per-axis quantile cuts cannot balance a field whose
    joint distribution the marginals miss, but they keep the product grid
    that keeps every shape fixed."""
    c0, c1 = _cells(domain.wrap(st.pos), domain, spec)
    w = (st.mass > 0).to(torch.int64)
    h = torch.zeros(spec.ncell0 + spec.ncell1, dtype=torch.int64,
                    device=st.pos.device)
    h.index_add_(0, torch.cat([c0, c1 + spec.ncell0]), torch.cat([w, w]))
    h = comm.all_reduce_sum(h).cpu().numpy()
    return h[:spec.ncell0], h[spec.ncell0:]


def counts(comm, st: ParticleState) -> np.ndarray:
    """Every rank's real particles [n_shards] (its max over its mean is
    the count imbalance)."""
    out = torch.zeros(comm.world, dtype=torch.int64, device=st.pos.device)
    out[comm.rank] = (st.mass > 0).sum()
    return comm.all_reduce_sum(out).cpu().numpy()


def max_run(comm, st: ParticleState, cuts0, cuts1, domain: Domain,
            spec: PencilSpec):
    """The largest aligned window length any rank's build needs, and the
    ghosts dropped, over all ranks (feeds ``refine_wseg``)."""
    wd, _, _, _, dropped = _exchange_and_build(comm, st, cuts0, cuts1,
                                               domain, spec)
    return (int(comm.all_reduce_max(wd.max_run.to(torch.int64))),
            int(comm.all_reduce_sum(dropped.to(torch.int64))))


# ---------------------------------------------------------------------------
# set-up (host-side)
# ---------------------------------------------------------------------------


def distribute(state: ParticleState, domain: Domain, spec: PencilSpec,
               cuts0, cuts1, rank: int) -> ParticleState:
    """Shard ``rank``'s rows of a single-device state (set-up only, on the
    state's device): its pencil's particles in row order, then padding rows
    parked in its trash band (the JAX layout's rows of shard ``rank``,
    (s0, s1) row-major)."""
    ns0, ns1, nl = spec.ns0, spec.ns1, spec.n_local
    dev, dtype = state.pos.device, state.pos.dtype
    lo = domain.lo.detach().cpu().double().numpy()
    ext = domain.hi.detach().cpu().double().numpy() - lo
    cell0 = ext[0] / spec.ncell0
    cell1 = ext[1] / spec.ncell1
    # the cells in float64, truncated as the reference's host arithmetic
    # does
    c0 = torch.clamp(((state.pos[:, 0].double() - lo[0]) / cell0).long(), 0,
                     spec.ncell0 - 1)
    c1 = torch.clamp(((state.pos[:, 1].double() - lo[1]) / cell1).long(), 0,
                     spec.ncell1 - 1)
    sid = _owner(c0, cuts0, ns0) * ns1 + _owner(c1, cuts1, ns1)
    rows = torch.nonzero(sid == rank).reshape(-1)
    if rows.numel() > nl:
        raise ValueError(f"pencil {rank} holds {rows.numel()} > n_local={nl} "
                         "particles; re-plan with a larger pad_factor")
    i0, i1 = divmod(rank, ns1)
    lo0 = torch.tensor(lo[0] + cuts0[i0] * cell0, dtype=dtype, device=dev)
    lo1 = torch.tensor(lo[1] + cuts1[i1] * cell1, dtype=dtype, device=dev)
    tmpl = _pad_template(nl - rows.numel(), domain, spec, lo0, lo1, dtype,
                         state.dim)
    return ParticleState(*(torch.cat([f[rows], t]) for f, t in zip(state,
                                                                  tmpl)))
