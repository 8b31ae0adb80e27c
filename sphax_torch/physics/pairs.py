"""Per-pair SPH interaction math (torch twin of ``sphax.physics.pairs``).

Each function takes broadcastable tensors of pair quantities. Self-pairs
(r = 0, dx = 0, dv = 0) contribute exactly zero to every force and energy
term (``kernels.grad_W_over_r`` takes the r -> 0 limit analytically).
"""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.physics import kernels as K


def density_terms(r, h_i, m_j, dim: int):
    """Per-pair density and d rho/d h contributions: (m_j W, m_j dW/dh)."""
    return m_j * K.W(r, h_i, dim), m_j * K.dW_dh(r, h_i, dim)


def force_terms(dx, r, dv, h_i, h_j, rho_i, rho_j, P_i, P_j, cs_i, cs_j,
                om_i, om_j, m_j, cfg: SPHConfig, bf_i=None, bf_j=None):
    """Per-pair force/energy contributions ``(fcoef, du)``:
    acc_i = -sum_j fcoef * dx, du_dt_i = sum_j du, with the Monaghan
    viscosity Pi_ij = (-alpha cbar mu + beta mu^2)/rhobar (mu active only
    when v.r < 0), optionally limited by the per-particle factors bf."""
    dim = cfg.dim
    gi = K.grad_W_over_r(r, h_i, dim)
    gj = K.grad_W_over_r(r, h_j, dim)
    gbar = 0.5 * (gi + gj)

    ci = P_i / (om_i * rho_i * rho_i)
    cj = P_j / (om_j * rho_j * rho_j)

    vdotr = torch.sum(dv * dx, dim=-1)
    hbar = 0.5 * (h_i + h_j)
    mu = hbar * vdotr / (r * r + cfg.eps_visc * hbar * hbar)
    mu = torch.where(vdotr < 0.0, mu, torch.zeros_like(mu))
    cbar = 0.5 * (cs_i + cs_j)
    rhobar = 0.5 * (rho_i + rho_j)
    Pi = (-cfg.alpha_visc * cbar * mu + cfg.beta_visc * mu * mu) / rhobar
    if bf_i is not None:
        Pi = Pi * (0.5 * (bf_i + bf_j))

    fcoef = m_j * (ci * gi + cj * gj + Pi * gbar)
    du = m_j * (ci * gi + 0.5 * Pi * gbar) * vdotr
    return fcoef, du


def balsara_terms(dx, r, dv, h_i, m_j, dim: int):
    """Per-pair div/curl estimator contributions (gather form, gradW(h_i)):
    divv_i = -sum_j divv_pair / rho_i, curl_i = sum_j curl_pair / rho_i."""
    g = K.grad_W_over_r(r, h_i, dim)
    mw = m_j * g
    vdotr = torch.sum(dv * dx, dim=-1)
    divv_pair = mw * vdotr
    if dim == 3:
        cross = torch.stack([
            dv[..., 1] * dx[..., 2] - dv[..., 2] * dx[..., 1],
            dv[..., 2] * dx[..., 0] - dv[..., 0] * dx[..., 2],
            dv[..., 0] * dx[..., 1] - dv[..., 1] * dx[..., 0],
        ], dim=-1)
        curl_pair = mw[..., None] * cross
    elif dim == 2:
        cz = dv[..., 0] * dx[..., 1] - dv[..., 1] * dx[..., 0]
        curl_pair = mw * cz
    else:
        curl_pair = torch.zeros_like(mw)
    return divv_pair, curl_pair


def balsara_factor(divv, curl_mag, cs, h):
    """f_i = |div v| / (|div v| + |curl v| + 1e-4 c/h) (Balsara 1995); the
    1e-30 floor keeps zero-velocity zero-mass pad rows at f = 0, not NaN."""
    return torch.abs(divv) / (torch.abs(divv) + curl_mag + 1e-4 * cs / h
                              + 1e-30)


def visc_factor(cfg: SPHConfig, bf=None, alpha=None):
    """Combine the per-particle viscosity multipliers into one pair channel:
    vf = balsara_f * alpha(t) (either factor optional)."""
    vf = None
    if cfg.balsara:
        vf = bf
    if cfg.mm_visc:
        vf = alpha if vf is None else vf * alpha
    return vf


def mm_alpha_update(alpha, divv, h, cs, dt, cfg: SPHConfig):
    """One explicit-Euler step of the Morris-Monaghan (1997) alpha equation,
    clipped to [alpha_min, alpha_max]."""
    src = torch.clamp_min(-divv, 0.0) * (cfg.mm_alpha_max - alpha)
    decay = (alpha - cfg.mm_alpha_min) * (cfg.mm_sigma * cs
                                          / torch.clamp_min(h, 1e-30))
    return torch.clamp(alpha + dt * (src - decay), cfg.mm_alpha_min,
                       cfg.mm_alpha_max)


def gravity_terms(dx, r, m_j, cfg: SPHConfig):
    """Per-pair softened gravity: acc_i = -G sum_j gcoef * dx."""
    inv = (r * r + cfg.grav_eps**2) ** (-1.5)
    return cfg.G * m_j * inv
