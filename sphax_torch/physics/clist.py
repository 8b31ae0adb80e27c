"""Cell-list engine: O(N) neighbour-limited physics passes (torch twin of
``sphax.physics.clist``).

Particles are Morton-sorted per build (``neighbors.cell_list``), and the
passes evaluate blocks of cells against their stacked neighbour cells'
candidates at fixed shapes. Invalid candidate slots carry a zero-mass
sentinel particle, so every pair term vanishes without explicit masking.
It is plain torch on whatever device its tensors lie, as it is jnp in the
JAX package; ``problems._auto_engine`` takes it above 3,000 particles where
the window engine is not taken.

Exactness: while no cell overflows its capacity (``overflow_count == 0``)
and the cell size covers the kernel support 2 h (``h_saturation_count ==
0``), the candidates are a superset of the neighbours, and the results
equal the dense engine's to roundoff.

``jax.lax.map`` over cell blocks is a Python loop over blocks here, so a
pass costs one round of launches a block: ``auto_cell_block`` (the JAX
version's 8 MB budget, which the CPU takes) would give thousands of blocks
a pass at N = 1e6, so on a card ``default_cell_block`` takes blocks of
``CARD_BLOCK_BYTES``. The blocking changes no result: each particle's sums
run over its own candidate row in one reduction.

``gravity_dense`` is the min-image direct sum over all pairs, which the
window engine also uses for ``grav_solver="direct"`` on a periodic box.
"""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.neighbors import cell_list as cl_mod
from sphax_torch.neighbors.cell_list import CellList, Grid
from sphax_torch.physics import pairs
from sphax_torch.physics.eos import eos


def _sentinel_pad(arr, value):
    """Append one sentinel row holding ``value``."""
    row = torch.full((1,) + tuple(arr.shape[1:]), value, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr, row])


def _run_cell_pass(kernel_fn, cl: CellList, grid: Grid, periodic, n: int,
                   cell_block: int, i_fields, j_fields):
    """Map ``kernel_fn`` over blocks of cells; return per-particle outputs
    in sorted order.

    i_fields / j_fields: tuples of sentinel-padded ``[N+1, ...]`` tensors in
    sorted order. kernel_fn(gi, gj) receives gathered ``[B, C, ...]`` own
    and ``[B, M, ...]`` candidate fields and returns a tuple of
    ``[B, C, ...]`` per-own-particle reductions. A particle past its cell's
    capacity takes the output of slot cap - 1, as in the JAX version
    (``overflow_count`` is the guard).

    A cell's particles fill its slots from 0, so the slots at or past the
    fullest cell's count hold the sentinel in every cell: the pass drops
    them (C and each neighbour's share of M become that count, one host
    read a pass). They would add only zero terms; the JAX version carries
    them."""
    ncells, cap = grid.ncells, grid.capacity
    dev = cl.table.device
    # a block past the last cell would only repeat it
    cell_block = min(cell_block, ncells)
    used = max(1, int((cl.table < n).sum(1).max()))
    table = cl.table[:, :used]
    outs = []
    for c0 in range(0, ncells, cell_block):
        cids = torch.clamp_max(
            torch.arange(c0, c0 + cell_block, device=dev), ncells - 1)
        own = table[cids]                                      # [B, C]
        ncids, okc = cl_mod.neighbor_cids(cids, grid, periodic)
        cand = torch.where(okc[..., None], table[ncids], n)    # [B, n_off, C]
        cand = cand.reshape(cand.shape[0], -1)                 # [B, M]
        outs.append(kernel_fn(tuple(f[own] for f in i_fields),
                              tuple(f[cand] for f in j_fields)))
    # back to sorted particle order: particle k lives at (cid[k], slot[k])
    pick = cl.cid * used + torch.clamp_max(cl.slot, used - 1)
    res = []
    for k in range(len(outs[0])):
        o = torch.cat([blk[k] for blk in outs])
        res.append(o.reshape((-1,) + tuple(o.shape[2:]))[pick])
    return tuple(res)


def _geom(pos_i, pos_j, domain: Domain):
    dx = domain.displacement(pos_i[:, :, None, :] - pos_j[:, None, :, :])
    r = torch.sqrt(torch.sum(dx * dx, dim=-1))
    return dx, r


# ---------------------------------------------------------------------------
# passes (sorted order, sentinel-padded fields)
# ---------------------------------------------------------------------------


def density_pass(cl, grid, domain, n, cell_block, pos_p, h_s, mass_p, dim,
                 bin_per=None):
    """rho and drho/dh of each sorted particle over its cell candidates."""
    def kfn(gi, gj):
        (pos_i, h_i), (pos_j, m_j) = gi, gj
        _, r = _geom(pos_i, pos_j, domain)
        w, dwdh = pairs.density_terms(r, h_i[..., None], m_j[:, None, :],
                                      dim)
        return torch.sum(w, dim=-1), torch.sum(dwdh, dim=-1)

    per = domain.periodic if bin_per is None else bin_per
    return _run_cell_pass(kfn, cl, grid, per, n, cell_block,
                          (pos_p, _sentinel_pad(h_s, 1.0)), (pos_p, mass_p))


def solve_h(cl, grid, domain, n, cell_block, pos_p, mass_p, h0_s,
            cfg: SPHConfig, bin_per=None):
    """Newton-h on the cell candidates (the iteration of dense.solve_h)."""
    dim = cfg.dim
    mass_s = mass_p[:-1]
    h_s = h0_s
    for _ in range(cfg.newton_iters):
        rho, drho_dh = density_pass(cl, grid, domain, n, cell_block,
                                    pos_p, h_s, mass_p, dim, bin_per)
        rho_h = mass_s * (cfg.eta / h_s) ** dim
        phi = rho - rho_h
        dphi = drho_dh + dim * rho_h / h_s
        dphi = torch.where(torch.abs(dphi) < 1e-300, -1e-300, dphi)
        dh = torch.minimum(torch.maximum(-phi / dphi, -0.5 * h_s),
                           0.5 * h_s)
        h_s = h_s + dh
    return h_s


def divcurl_pass(cl, grid, domain, n, cell_block, pos_p, vel_p, mass_p,
                 h_s, rho_s, cfg: SPHConfig, bin_per=None):
    """SPH div/curl gather estimators: returns (div v, |curl v|)."""
    dim = cfg.dim

    def kfn(gi, gj):
        (pos_i, vel_i, h_i), (pos_j, vel_j, m_j) = gi, gj
        dx, r = _geom(pos_i, pos_j, domain)
        dv = vel_i[:, :, None, :] - vel_j[:, None, :, :]
        divv_p, curl_p = pairs.balsara_terms(dx, r, dv, h_i[..., None],
                                             m_j[:, None, :], dim)
        divv = -torch.sum(divv_p, dim=-1)
        if dim == 3:
            curl = torch.sum(curl_p, dim=-2)
            curl_mag = torch.sqrt(torch.sum(curl * curl, dim=-1))
        elif dim == 2:
            curl_mag = torch.abs(torch.sum(curl_p, dim=-1))
        else:
            curl_mag = torch.zeros_like(divv)
        return divv, curl_mag

    per = domain.periodic if bin_per is None else bin_per
    divv, curl_mag = _run_cell_pass(
        kfn, cl, grid, per, n, cell_block,
        (pos_p, vel_p, _sentinel_pad(h_s, 1.0)), (pos_p, vel_p, mass_p))
    rho_safe = torch.clamp_min(rho_s, 1e-15)
    return divv / rho_safe, curl_mag / rho_safe


def force_pass(cl, grid, domain, n, cell_block, pos_p, vel_p, mass_p,
               h_s, rho_s, P_s, cs_s, om_s, bf_s, cfg: SPHConfig,
               bin_per=None):
    """Symmetrized pressure force + viscosity + du/dt over the cell
    candidates: returns (acc, du/dt)."""
    pad = _sentinel_pad
    h_p, rho_p = pad(h_s, 1.0), pad(rho_s, 1.0)
    P_p, cs_p = pad(P_s, 0.0), pad(cs_s, 0.0)
    om_p = pad(om_s, 1.0)
    vf = cfg.visc_factor_on

    def kfn(gi, gj):
        if vf:
            (pos_i, vel_i, h_i, rho_i, P_i, cs_i, om_i, bf_i) = gi
            (pos_j, vel_j, m_j, h_j, rho_j, P_j, cs_j, om_j, bf_j) = gj
        else:
            (pos_i, vel_i, h_i, rho_i, P_i, cs_i, om_i) = gi
            (pos_j, vel_j, m_j, h_j, rho_j, P_j, cs_j, om_j) = gj
            bf_i = bf_j = None
        dx, r = _geom(pos_i, pos_j, domain)
        dv = vel_i[:, :, None, :] - vel_j[:, None, :, :]

        def e(a):        # [B, C] -> [B, C, 1]
            return a[..., None]

        def f(a):        # [B, M] -> [B, 1, M]
            return a[:, None, :]
        fcoef, du = pairs.force_terms(
            dx, r, dv, e(h_i), f(h_j), e(rho_i), f(rho_j), e(P_i), f(P_j),
            e(cs_i), f(cs_j), e(om_i), f(om_j), f(m_j), cfg,
            bf_i=(e(bf_i) if vf else None), bf_j=(f(bf_j) if vf else None))
        acc = -torch.sum(fcoef[..., None] * dx, dim=-2)
        return acc, torch.sum(du, dim=-1)

    ifields = [pos_p, vel_p, h_p, rho_p, P_p, cs_p, om_p]
    jfields = [pos_p, vel_p, mass_p, h_p, rho_p, P_p, cs_p, om_p]
    if vf:
        bf_p = pad(bf_s, 0.0)
        ifields.append(bf_p)
        jfields.append(bf_p)
    per = domain.periodic if bin_per is None else bin_per
    return _run_cell_pass(kfn, cl, grid, per, n, cell_block,
                          tuple(ifields), tuple(jfields))


def _blocked(body, rows, block: int):
    """Apply ``body(row_block)`` to [block]-row slices of ``rows`` ([N, ...])
    and concatenate the results back to [N, ...]."""
    return torch.cat([body(rows[i:i + block])
                      for i in range(0, rows.shape[0], block)])


def gravity_dense(pos_s, mass_s, cfg: SPHConfig, domain: Domain,
                  block: int = 128):
    """Direct-sum softened gravity, row-blocked over ALL pairs (long-range)."""

    def body(pos_i):
        dx = domain.displacement(pos_i[:, None, :] - pos_s[None, :, :])
        r = torch.sqrt(torch.sum(dx * dx, -1))
        g = pairs.gravity_terms(dx, r, mass_s[None, :], cfg)
        return -torch.sum(g[..., None] * dx, dim=-2)

    return _blocked(body, pos_s, block)


# ---------------------------------------------------------------------------
# full derived pass
# ---------------------------------------------------------------------------


def auto_cell_block(grid: Grid, dim: int, budget_bytes: int = 8 << 20) -> int:
    """Cells per block so the [B, C, M, D] pair intermediates stay small
    (the JAX version's rule: an 8 MB budget, at most 128 cells)."""
    per_cell = grid.capacity * grid.n_candidates * dim * 4
    return max(1, min(128, budget_bytes // max(per_cell, 1)))


# the [B, C, M, D] budget of a block on a card, counted at the full
# capacity (a pass walks only the fullest cell's slots, so it holds a few
# pair tensors of this size at once)
CARD_BLOCK_BYTES = 1 << 32


def default_cell_block(grid: Grid, dim: int, device) -> int:
    """``auto_cell_block`` on the CPU; on a card a block of
    ``CARD_BLOCK_BYTES`` of pair displacements, so that a pass is tens of
    blocks, not thousands (each block is a round of launches)."""
    if torch.device(device).type != "cuda":
        return auto_cell_block(grid, dim)
    per_cell = grid.capacity * grid.n_candidates * dim * 4
    return max(1, CARD_BLOCK_BYTES // max(per_cell, 1))


def update_derived(state: ParticleState, cfg: SPHConfig, domain: Domain,
                   grid: Grid, cell_block: int = 0) -> ParticleState:
    """Cell-list analogue of dense.update_derived (same math, same order),
    returned in the caller's particle order. ``cell_block`` cells a block
    (0: ``default_cell_block``)."""
    if state.dim != cfg.dim:
        raise ValueError(f"state dim {state.dim} != cfg.dim {cfg.dim}")
    if cell_block <= 0:
        cell_block = default_cell_block(grid, cfg.dim, state.pos.device)
    n = state.n
    cl = cl_mod.build(state.pos, domain, grid)
    perm = cl.perm

    pos_s = state.pos[perm]
    vel_s = state.vel[perm]
    mass_s = state.mass[perm]
    u_s = state.u[perm]
    h_s = state.h[perm]

    pos_p = _sentinel_pad(pos_s, 0.0)
    vel_p = _sentinel_pad(vel_s, 0.0)
    mass_p = _sentinel_pad(mass_s, 0.0)  # zero-mass sentinel kills all terms

    if cfg.adaptive_h:
        h_s = solve_h(cl, grid, domain, n, cell_block, pos_p, mass_p, h_s,
                      cfg)
    rho_s, drho_dh = density_pass(cl, grid, domain, n, cell_block,
                                  pos_p, h_s, mass_p, cfg.dim)
    if cfg.grad_h:
        om_s = 1.0 + h_s / (cfg.dim * rho_s) * drho_dh
    else:
        om_s = torch.ones_like(rho_s)
    P_s, cs_s = eos(rho_s, u_s, cfg)
    bf_s = None
    if cfg.need_divv:
        divv_s, curl_s = divcurl_pass(cl, grid, domain, n, cell_block, pos_p,
                                      vel_p, mass_p, h_s, rho_s, cfg)
        if cfg.balsara:
            bf_s = pairs.balsara_factor(divv_s, curl_s, cs_s, h_s)
    else:
        divv_s = torch.zeros_like(rho_s)
    vf_s = pairs.visc_factor(cfg, bf=bf_s, alpha=(state.alpha[perm]
                                                  if cfg.mm_visc else None))
    if vf_s is None:
        vf_s = torch.ones_like(rho_s)
    acc_s, du_s = force_pass(cl, grid, domain, n, cell_block, pos_p, vel_p,
                             mass_p, h_s, rho_s, P_s, cs_s, om_s, vf_s, cfg)
    if cfg.gravity:
        acc_s = acc_s + gravity_dense(pos_s, mass_s, cfg, domain)

    def unsort(v):
        out = torch.empty_like(v)
        out[perm] = v
        return out

    return state._replace(
        h=unsort(h_s), rho=unsort(rho_s), P=unsort(P_s), cs=unsort(cs_s),
        acc=unsort(acc_s), du_dt=unsort(du_s), omega=unsort(om_s),
        divv=unsort(divv_s))


def h_saturation_count(state: ParticleState, domain: Domain, grid: Grid):
    """Particles whose solved h outgrew the cell structure (must be 0): the
    neighbour-cell candidates are a superset only while the support 2 h
    fits one cell, and the cell list has no cap to say otherwise."""
    cell = torch.min(domain.extent / torch.as_tensor(
        grid.res, dtype=state.h.dtype, device=state.h.device))
    return torch.sum(2.0 * state.h > cell)


def overflow_count(state: ParticleState, domain: Domain, grid: Grid):
    """Particles that did not fit their cell (must be 0 for exactness)."""
    return cl_mod.build(state.pos, domain, grid).overflow
