"""Equal-extent slab decomposition over the cell list (torch twin of
``sphax.dist.slab``), the simple fallback beside the window-engine slabs
of ``dist.wslab``.

The box is cut into ``n_shards`` slabs of equal extent along one axis, one
slab a rank, and each step of a rank runs

  * two ghost exchanges with the two face neighbours over the ring
    (``Comm.ring``): phase 1 ships kinematics (pos/vel/mass/h) of the rows
    within ``margin`` of each face, phase 2 the owner-computed hydro fields
    (h/rho/P/cs/Omega/Balsara factor) of the SAME rows, so the ghosts'
    j-values in the force pass are exactly the owner's;
  * one MIN all-reduce for the timestep.

Each rank runs the cell-list passes (``physics.clist``) over a LOCAL bin
box: the slab with a margin on each side and a trash band below it, where
invalid ghost slots and zero-mass padding rows are parked so they never
crowd real particles out of a cell. A padding row past a trash cell's
capacity takes another trash row's outputs: padding rows' outputs are
don't-care, as in the JAX version and in ``dist.wslab``.
Pair geometry stays the global minimum image. Positions are not wrapped
during a run (slab locality survives the periodic seam); ``redistribute``
wraps and re-shards.

The JAX package's ``make_step``/``make_chunk`` (jitted ``shard_map``
functions) are the per-rank functions ``step`` and ``chunk`` here, which
take the rank's ``Comm``; ``distribute`` gives one rank's rows. Beside the
state and the dts they return the health counters the JAX version does
not report: (ghosts past ``ghost_cap``, real rows past a cell's capacity),
summed over the ranks; both must be zero.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.dist.wslab import _exchange, _pack, _pack_select, _unpack
from sphax_torch.dist.wslab import gather_real  # noqa: F401  (the twin's)
from sphax_torch.integrate import leapfrog
from sphax_torch.integrate.timestep import local_dt
from sphax_torch.neighbors import cell_list as cl_mod
from sphax_torch.neighbors.cell_list import Grid
from sphax_torch.physics import clist, pairs
from sphax_torch.physics.eos import eos


@dataclasses.dataclass(frozen=True)
class DistSpec:
    """Static decomposition parameters (the fields of
    ``sphax.dist.slab.DistSpec`` but its mesh axis name)."""

    n_shards: int
    n_local: int        # particles per shard incl. zero-mass padding
    ghost_cap: int      # ghost buffer size per face
    margin: float       # ghost-selection span from each slab face
    grid: Grid          # local cell grid (the same on every shard)
    slab_axis: int = 0


# ---------------------------------------------------------------------------
# host-side planning and distribution
# ---------------------------------------------------------------------------


def _bounds(domain: Domain):
    lo = domain.lo.detach().cpu().double().numpy()
    hi = domain.hi.detach().cpu().double().numpy()
    return lo, hi


def plan(domain: Domain, n: int, h_max: float, n_shards: int,
         slab_axis: int = 0, margin_factor: float = 1.4,
         pad_factor: float = 1.25, ghost_factor: float = 2.0,
         occupancy_safety: float = 3.0) -> DistSpec:
    """Choose the decomposition's parameters from the problem's scales."""
    lo, hi = _bounds(domain)
    cutoff = 2.0 * float(h_max)
    margin = margin_factor * cutoff
    W = (hi[slab_axis] - lo[slab_axis]) / n_shards
    if W < margin:
        # ghosts come from the two face neighbours only; a margin wider
        # than one slab would need next-nearest-neighbour exchange
        raise ValueError(
            f"slab width {W:.4g} thinner than ghost margin {margin:.4g}; "
            "use fewer shards or smaller h")

    # local bin box: trash band (2 margin) + margin + slab + margin
    ext_local = hi - lo
    ext_local[slab_axis] = W + 4.0 * margin
    res = np.maximum(1, np.floor(ext_local / cutoff).astype(int))
    ncells = int(np.prod(res))
    n_local_est = int(np.ceil(n / n_shards * pad_factor / 8.0) * 8)
    # ghosts: the expected particles within margin of a face
    frac = margin / W
    ghost_cap = int(np.ceil(n / n_shards * frac * ghost_factor / 8.0) * 8)
    ghost_cap = min(max(ghost_cap, 16), n_local_est)
    avg = (n_local_est + 2 * ghost_cap) / ncells
    cap = int(max(8, np.ceil(avg * occupancy_safety / 4) * 4))
    grid = Grid(res=tuple(int(r) for r in res), capacity=cap)
    return DistSpec(n_shards=n_shards, n_local=n_local_est,
                    ghost_cap=ghost_cap, margin=float(margin), grid=grid,
                    slab_axis=slab_axis)


def _trash_positions(n_rows, domain_lo, domain_hi, slab_lo, margin,
                     slab_axis, dim, dtype):
    """Deterministic parking spots spread across the trash band (NumPy)."""
    pos = np.zeros((n_rows, dim))
    t = (np.arange(n_rows) + 0.5) / n_rows
    for d in range(dim):
        if d == slab_axis:
            pos[:, d] = slab_lo - 2.0 * margin
        else:
            # a golden-ratio stride spreads rows across transverse cells
            pos[:, d] = domain_lo[d] + (domain_hi[d] - domain_lo[d]) * np.mod(
                0.61803398875 * np.arange(n_rows) + 0.5 * t, 1.0)
    return pos.astype(dtype)


def distribute(state: ParticleState, domain: Domain, spec: DistSpec,
               rank: int) -> ParticleState:
    """Rank ``rank``'s [n_local] rows of a single-device state (set-up, on
    the host, then on the state's device): its slab's particles in row
    order, then zero-mass padding rows parked in its trash band (h the
    mean h, rho and Omega 1). Every rank calls this with the same state."""
    ns, nl, ax = spec.n_shards, spec.n_local, spec.slab_axis
    lo, hi = _bounds(domain)
    W = (hi[ax] - lo[ax]) / ns
    fields = {f: getattr(state, f).detach().cpu().numpy()
              for f in state._fields}
    pos = fields["pos"]
    dtype = pos.dtype
    dim = pos.shape[1]
    sid = np.clip(((pos[:, ax] - lo[ax]) / W).astype(int), 0, ns - 1)
    for s in range(ns):
        if int(np.sum(sid == s)) > nl:
            raise ValueError(
                f"shard {s} holds {int(np.sum(sid == s))} > n_local={nl} "
                "particles; re-plan with a larger pad_factor")
    idx = np.nonzero(sid == rank)[0]
    out = {f: np.zeros((nl,) + v.shape[1:], v.dtype)
           for f, v in fields.items()}
    for f, v in fields.items():
        out[f][:len(idx)] = v[idx]
    npad = nl - len(idx)
    if npad:
        out["pos"][len(idx):] = _trash_positions(
            npad, lo, hi, lo[ax] + rank * W, spec.margin, ax, dim, dtype)
        out["h"][len(idx):] = np.mean(fields["h"]) or 1.0
        out["rho"][len(idx):] = 1.0
        out["omega"][len(idx):] = 1.0
        # mass/vel/u stay zero: inert
    return ParticleState(**{f: torch.as_tensor(v, device=state.pos.device)
                            for f, v in out.items()})


def _all_real(comm, st: ParticleState) -> ParticleState:
    """Every rank's real rows, in shard order then row order, on every
    rank: each rank writes its rows at its offset of a zero buffer and a
    SUM all-reduce fills the rest (exact: the other terms are zeros)."""
    rows = _pack(st)[st.mass > 0]
    counts = torch.zeros(comm.world, dtype=torch.int64, device=comm.device)
    counts[comm.rank] = rows.shape[0]
    counts = comm.all_reduce_sum(counts).cpu()
    off = int(counts[:comm.rank].sum())
    buf = rows.new_zeros((int(counts.sum()), rows.shape[1]))
    buf[off:off + rows.shape[0]] = rows
    return _unpack(comm.all_reduce_sum(buf), st.dim)


def redistribute(comm, st: ParticleState, domain: Domain,
                 spec: DistSpec) -> ParticleState:
    """Wrap positions globally and re-shard (migration at chunk cadence):
    this rank's new rows."""
    every = _all_real(comm, st)
    every = every._replace(pos=domain.wrap(every.pos))
    return distribute(every, domain, spec, comm.rank)


# ---------------------------------------------------------------------------
# the derived pass of one rank
# ---------------------------------------------------------------------------


def _ghost_trash_pos(G, domain: Domain, slab_lo, margin, slab_axis, dim,
                     dtype):
    """Parking spots in the trash band for invalid ghost slots."""
    i = torch.arange(G, dtype=dtype, device=domain.lo.device)
    cols = []
    for d in range(dim):
        if d == slab_axis:
            cols.append(torch.zeros(G, dtype=dtype, device=i.device)
                        + slab_lo - 2.0 * margin)
        else:
            lo_d, hi_d = domain.lo[d].to(dtype), domain.hi[d].to(dtype)
            cols.append(lo_d + (hi_d - lo_d)
                        * torch.remainder(0.7548776662 * (i + 1.0), 1.0))
    return torch.stack(cols, dim=-1)


def _local_derived(comm, st: ParticleState, cfg: SPHConfig, domain: Domain,
                   spec: DistSpec):
    """Derived-quantity pass for one rank with the two-phase ghost
    exchange. Returns (state, health): health = (ghosts dropped, real rows
    past a cell's capacity) of this rank."""
    ns, G, ax = spec.n_shards, spec.ghost_cap, spec.slab_axis
    grid = spec.grid
    nl, dim, dtype = st.n, st.dim, st.pos.dtype
    me = comm.rank
    lo_g = domain.lo[ax].to(dtype)
    ext_g = (domain.hi[ax] - domain.lo[ax]).to(dtype)
    W = ext_g / ns
    slab_lo = lo_g + float(me) * W
    slab_hi = slab_lo + W
    margin = torch.as_tensor(spec.margin, dtype=dtype, device=st.pos.device)

    periodic_ax = domain.periodic_axes(dim)[ax]
    x = st.pos[:, ax]
    real = st.mass > 0
    take_lo, val_lo, drop_lo = _pack_select((x < slab_lo + margin) & real, G)
    take_hi, val_hi, drop_hi = _pack_select((x > slab_hi - margin) & real, G)
    routes = ((take_lo, val_lo), (take_hi, val_hi))
    trash = _ghost_trash_pos(G, domain, slab_lo, margin, ax, dim, dtype)

    # ---- phase 1: kinematics. gR: the right neighbour's low-face rows
    # (ghosts beyond our high face); gL: the left neighbour's high-face rows
    kin = torch.cat([st.pos, st.vel, st.mass[:, None], st.h[:, None]],
                    dim=-1)
    gR, gL = _exchange(comm, kin, (0.0,) * (2 * dim + 1) + (1.0,), routes)
    gR_pos, gL_pos = gR[:, :dim].clone(), gL[:, :dim].clone()
    gR_mass, gL_mass = gR[:, 2 * dim], gL[:, 2 * dim]
    # receiver-side shifts across the periodic seam
    if me == ns - 1:
        gR_pos[:, ax] += ext_g
    if me == 0:
        gL_pos[:, ax] -= ext_g
    if not periodic_ax:
        # an open slab axis: the edge shards have no wrap neighbour
        if me == ns - 1:
            gR_mass = torch.zeros_like(gR_mass)
        if me == 0:
            gL_mass = torch.zeros_like(gL_mass)
    # park invalid slots in the trash band
    gR_pos = torch.where((gR_mass > 0)[:, None], gR_pos, trash)
    gL_pos = torch.where((gL_mass > 0)[:, None], gL_pos, trash)

    comb_pos = torch.cat([st.pos, gL_pos, gR_pos])
    comb_vel = torch.cat([st.vel, gL[:, dim:2 * dim], gR[:, dim:2 * dim]])
    comb_mass = torch.cat([st.mass, gL_mass, gR_mass])
    comb_h = torch.cat([st.h, gL[:, 2 * dim + 1], gR[:, 2 * dim + 1]])
    comb_u = torch.cat([st.u, st.u.new_zeros(2 * G)])
    nc = nl + 2 * G

    # ---- the local cell structure over the extended slab
    is_ax = torch.arange(dim, device=st.pos.device) == ax
    bin_lo = torch.where(is_ax, slab_lo - 3.0 * margin, domain.lo.to(dtype))
    bin_hi = torch.where(is_ax, slab_hi + margin, domain.hi.to(dtype))
    bin_per = tuple(False if d == ax else domain.periodic_axes(dim)[d]
                    for d in range(dim))
    bin_dom = Domain(lo=bin_lo, hi=bin_hi, periodic=bin_per)
    cl = cl_mod.build(comb_pos, bin_dom, grid)
    perm = cl.perm
    cell_block = clist.default_cell_block(grid, dim, st.pos.device)

    def unsort(v):
        out = torch.empty_like(v)
        out[perm] = v
        return out

    pad = clist._sentinel_pad
    pos_p = pad(comb_pos[perm], 0.0)
    vel_p = pad(comb_vel[perm], 0.0)
    mass_p = pad(comb_mass[perm], 0.0)

    # ---- local density / h / eos / Balsara (geometry: the global minimum
    # image)
    h_s = comb_h[perm]
    if cfg.adaptive_h:
        # a zero-mass row sees no mass, so its Newton step is 0 / -1e-300;
        # -1e-300 underflows to -0 in fp32, and the NaN it gives would
        # reach real rows through the force pass's j-side h: keep its h
        h_s = torch.where(mass_p[:-1] > 0,
                          clist.solve_h(cl, grid, domain, nc, cell_block,
                                        pos_p, mass_p, h_s, cfg,
                                        bin_per=bin_per), h_s)
    rho_s, drho_dh = clist.density_pass(cl, grid, domain, nc, cell_block,
                                        pos_p, h_s, mass_p, dim,
                                        bin_per=bin_per)
    rho_s = torch.clamp_min(rho_s, 1e-15)  # trash rows see no neighbours
    if cfg.grad_h:
        om_s = 1.0 + h_s / (dim * rho_s) * drho_dh
    else:
        om_s = torch.ones_like(rho_s)
    P_s, cs_s = eos(rho_s, comb_u[perm], cfg)
    if cfg.balsara:
        divv_s, curl_s = clist.divcurl_pass(cl, grid, domain, nc, cell_block,
                                            pos_p, vel_p, mass_p, h_s, rho_s,
                                            cfg, bin_per=bin_per)
        bf_s = pairs.balsara_factor(divv_s, curl_s, cs_s, h_s)
    else:
        bf_s = torch.ones_like(rho_s)

    # back to combined order; the local rows [0:nl] are owner-correct
    hyd_s = torch.stack([h_s, rho_s, P_s, cs_s, om_s, bf_s], dim=-1)
    loc_hyd = unsort(hyd_s)[:nl]                                  # [nl, 6]

    # ---- phase 2: owner-computed hydro fields for the SAME boundary sets
    gR2, gL2 = _exchange(comm, loc_hyd, (1.0, 1.0, 0.0, 0.0, 1.0, 0.0),
                         routes)
    hyd = torch.cat([loc_hyd, gL2, gR2])[perm]                    # sorted

    # ---- force pass with exact ghost j-fields
    acc_s, du_s = clist.force_pass(
        cl, grid, domain, nc, cell_block, pos_p, vel_p, mass_p,
        hyd[:, 0], torch.clamp_min(hyd[:, 1], 1e-15), hyd[:, 2], hyd[:, 3],
        hyd[:, 4], hyd[:, 5], cfg, bin_per=bin_per)
    out = unsort(torch.cat([du_s[:, None], acc_s], dim=-1))[:nl]
    # padding and invalid ghost rows parked in the trash band may overflow
    # its cells harmlessly; a real row past its cell's capacity loses pairs
    lost = ((cl.slot >= grid.capacity) & (mass_p[:-1] > 0)).sum()
    health = torch.stack([(drop_lo + drop_hi).to(torch.int64),
                          lost.to(torch.int64)])
    return st._replace(h=loc_hyd[:, 0], rho=loc_hyd[:, 1], P=loc_hyd[:, 2],
                       cs=loc_hyd[:, 3], omega=loc_hyd[:, 4],
                       acc=out[:, 1:], du_dt=out[:, 0]), health


# ---------------------------------------------------------------------------
# distributed step / chunk
# ---------------------------------------------------------------------------


def _refuse(cfg: SPHConfig):
    if cfg.gravity or cfg.mm_visc:
        raise NotImplementedError(
            "the clist slab engine is the simple fallback; self-gravity and "
            "Morris-Monaghan viscosity run distributed in the window-engine "
            "decomposition (sphax_torch/dist/wslab.py)")


def _one_step(comm, st, cfg, domain, spec):
    dt = comm.all_reduce_min(local_dt(st, cfg))
    health = []

    def derived(s):
        s, hl = _local_derived(comm, s, cfg, domain, spec)
        health.append(hl)
        return s

    st, _ = leapfrog.step(st, cfg, domain, derived, dt=dt, wrap=False)
    return st, dt, health[0]


def step(comm, st: ParticleState, domain: Domain, cfg: SPHConfig,
         spec: DistSpec):
    """One distributed KDK step (the twin of ``make_step``'s function):
    (state, dt, health), health summed over the ranks."""
    _refuse(cfg)
    st, dt, health = _one_step(comm, st, cfg, domain, spec)
    return st, dt, comm.all_reduce_sum(health)


def chunk(comm, st: ParticleState, domain: Domain, cfg: SPHConfig,
          spec: DistSpec, nsteps: int):
    """``nsteps`` distributed KDK steps (the twin of ``make_chunk``'s
    function): (state, dts [nsteps], health), health each rank's maximum
    over the steps, summed over the ranks."""
    _refuse(cfg)
    dts, health = [], []
    for _ in range(nsteps):
        st, dt, hl = _one_step(comm, st, cfg, domain, spec)
        dts.append(dt)
        health.append(hl)
    return (st, torch.stack(dts),
            comm.all_reduce_sum(torch.stack(health).amax(0)))
