"""Dense O(N^2) engine (torch twin of ``sphax.physics.dense``): exact
all-pairs passes, row-blocked so memory stays O(block N).

It holds no kernel of its own: the JAX version is plain jnp, and this is
plain torch on whatever device its tensors lie. It serves the ``evrard``
problem (self-gravity is all-pairs anyway) and every problem whose box the
window planner rejects, and is the CPU engine of the problem registry.

Each pass maps its body over row blocks and concatenates the results; every
row sums over all N columns in one reduction, so the block size changes no
result.
"""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.physics import pairs
from sphax_torch.physics.eos import eos


def _block(n: int, block) -> int:
    """Rows per block: ``block``, or about 2^20 pairs a block."""
    return int(block) if block else max(1, (1 << 20) // max(n, 1))


def _blocked(body, row_arrays, block: int):
    """Map ``body`` over [block]-row slices of ``row_arrays`` ([N, ...]
    each); returns its outputs concatenated back to [N, ...]."""
    n = row_arrays[0].shape[0]
    outs = [body(tuple(a[i:i + block] for a in row_arrays))
            for i in range(0, n, block)]
    return tuple(torch.cat([o[k] for o in outs]) for k in range(len(outs[0])))


def _geom(pos_i, pos_j, domain: Domain):
    """dx [B, N, D] (min-image) and r [B, N] for a row block vs all
    columns."""
    dx = domain.displacement(pos_i[:, None, :] - pos_j[None, :, :])
    r = torch.sqrt(torch.sum(dx * dx, dim=-1))
    return dx, r


def density_pass(pos, mass, h, cfg: SPHConfig, domain: Domain, block=None):
    """rho_i = sum_j m_j W(r_ij, h_i) and drho/dh_i."""
    def body(args):
        pos_i, h_i = args
        _, r = _geom(pos_i, pos, domain)
        w, dwdh = pairs.density_terms(r, h_i[:, None], mass[None, :],
                                      cfg.dim)
        return torch.sum(w, dim=-1), torch.sum(dwdh, dim=-1)

    return _blocked(body, [pos, h], _block(pos.shape[0], block))


def solve_h(pos, mass, h0, cfg: SPHConfig, domain: Domain, block=None):
    """cfg.newton_iters bounded Newton steps of rho_sum(h) = m (eta/h)^d
    (the same iteration and thresholds as the JAX version)."""
    dim = cfg.dim
    h = h0
    for _ in range(cfg.newton_iters):
        rho, drho_dh = density_pass(pos, mass, h, cfg, domain, block)
        rho_h = mass * (cfg.eta / h) ** dim
        phi = rho - rho_h
        dphi = drho_dh + dim * rho_h / h
        dphi = torch.where(torch.abs(dphi) < 1e-300, -1e-300, dphi)
        dh = torch.minimum(torch.maximum(-phi / dphi, -0.5 * h), 0.5 * h)
        h = h + dh
    return h


def divcurl_pass(pos, vel, mass, h, rho, cfg: SPHConfig, domain: Domain,
                 block=None):
    """SPH div/curl gather estimators: returns (div v, |curl v|) per row."""
    dim = cfg.dim

    def body(args):
        pos_i, vel_i, h_i = args
        dx, r = _geom(pos_i, pos, domain)
        dv = vel_i[:, None, :] - vel[None, :, :]
        divv_p, curl_p = pairs.balsara_terms(dx, r, dv, h_i[:, None],
                                             mass[None, :], dim)
        divv = -torch.sum(divv_p, dim=-1)
        if dim == 3:
            curl = torch.sum(curl_p, dim=-2)
            curl_mag = torch.sqrt(torch.sum(curl * curl, dim=-1))
        elif dim == 2:
            curl_mag = torch.abs(torch.sum(curl_p, dim=-1))
        else:
            curl_mag = torch.zeros_like(divv)
        return divv, curl_mag

    divv, curl_mag = _blocked(body, [pos, vel, h],
                              _block(pos.shape[0], block))
    return divv / rho, curl_mag / rho


def force_pass(pos, vel, mass, h, rho, P, cs, omega, bf, cfg: SPHConfig,
               domain: Domain, block=None):
    """Symmetrized pressure force + viscosity + du/dt, plus the direct-sum
    gravity term when cfg.gravity and grav_solver == "direct"."""
    use_vf = bf is not None
    direct = cfg.gravity and cfg.grav_solver == "direct"

    def body(args):
        pos_i, vel_i, h_i, rho_i, P_i, cs_i, om_i, bf_i = args
        dx, r = _geom(pos_i, pos, domain)
        dv = vel_i[:, None, :] - vel[None, :, :]
        fcoef, du = pairs.force_terms(
            dx, r, dv,
            h_i[:, None], h[None, :],
            rho_i[:, None], rho[None, :],
            P_i[:, None], P[None, :],
            cs_i[:, None], cs[None, :],
            om_i[:, None], omega[None, :],
            mass[None, :], cfg,
            bf_i=(bf_i[:, None] if use_vf else None),
            bf_j=(bf[None, :] if use_vf else None),
        )
        if direct:
            fcoef = fcoef + pairs.gravity_terms(dx, r, mass[None, :], cfg)
        acc = -torch.sum(fcoef[..., None] * dx, dim=-2)
        return acc, torch.sum(du, dim=-1)

    one = torch.ones_like(h)
    return _blocked(
        body, [pos, vel, h, rho, P, cs, omega, bf if use_vf else one],
        _block(pos.shape[0], block))


def update_derived(state: ParticleState, cfg: SPHConfig, domain: Domain,
                   block=None) -> ParticleState:
    """density (+Newton-h) -> EOS -> (Balsara) -> forces (+gravity), the
    JAX version's operation order. ``block`` rows per pass (default: about
    2^20 pairs a block)."""
    if state.dim != cfg.dim:
        raise ValueError(
            f"state has dim={state.dim} but cfg.dim={cfg.dim}; kernel "
            "normalisation and curl estimators are dimension-specific")
    pos, vel, mass, u = state.pos, state.vel, state.mass, state.u
    h = state.h
    if cfg.adaptive_h:
        h = solve_h(pos, mass, h, cfg, domain, block)
    rho, drho_dh = density_pass(pos, mass, h, cfg, domain, block)
    if cfg.grad_h:
        omega = 1.0 + h / (cfg.dim * rho) * drho_dh
    else:
        omega = torch.ones_like(rho)
    P, cs = eos(rho, u, cfg)
    if cfg.need_divv:
        divv, curl = divcurl_pass(pos, vel, mass, h, rho, cfg, domain, block)
        bf = (pairs.balsara_factor(divv, curl, cs, h)
              if cfg.balsara else None)
    else:
        divv, bf = torch.zeros_like(rho), None
    vf = pairs.visc_factor(cfg, bf=bf, alpha=state.alpha)
    acc, du = force_pass(pos, vel, mass, h, rho, P, cs, omega, vf, cfg,
                         domain, block)
    if cfg.gravity and cfg.grav_solver == "p3m":
        from sphax_torch.physics import pm

        acc = acc + pm.p3m_accel_dense(pos, mass, cfg, domain)
    return state._replace(h=h, rho=rho, P=P, cs=cs, acc=acc, du_dt=du,
                          omega=omega, divv=divv)
