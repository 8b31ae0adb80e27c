"""Conservation and flow diagnostics (torch twin of
``sphax.diag.conservation``; ``summary`` returns the same keys)."""
from __future__ import annotations

import math

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import ParticleState


def momentum(state: ParticleState):
    return torch.sum(state.mass[:, None] * state.vel, dim=0)


def kinetic_energy(state: ParticleState):
    return 0.5 * torch.sum(state.mass * torch.sum(state.vel ** 2, dim=-1))


def internal_energy(state: ParticleState):
    return torch.sum(state.mass * state.u)


def gravitational_energy(state: ParticleState, cfg: SPHConfig,
                         block: int = None):
    """Direct-sum softened potential energy (matches the Plummer force law):
    -G/2 sum_{i != j} m_i m_j (r_ij^2 + eps^2)^-1/2, summed over row blocks
    of about 2^22 pairs (2^26 on a card, where a block is a round of
    launches: at N = 1e6 small blocks make the sum launch-bound), never the
    whole N x N matrix."""
    pos, mass = state.pos, state.mass
    n = pos.shape[0]
    if block is None:
        block = max(1, (1 << (26 if pos.is_cuda else 22)) // max(n, 1))
    eps2 = float(cfg.grav_eps) ** 2
    total = pos.new_zeros(())
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        dx = pos[i0:i1, None, :] - pos[None, :, :]
        inv_r = torch.rsqrt(torch.sum(dx * dx, dim=-1) + eps2)
        rows = torch.arange(i0, i1, device=pos.device)
        inv_r[rows - i0, rows] = 0.0              # no self-pair
        total = total + torch.sum(mass[i0:i1, None] * mass[None, :] * inv_r)
    return -0.5 * cfg.G * total


def total_energy(state: ParticleState, cfg: SPHConfig):
    e = kinetic_energy(state) + internal_energy(state)
    if cfg.gravity:
        e = e + gravitational_energy(state, cfg)
    return e


def mach_rms(state: ParticleState):
    v2 = torch.sum(state.vel ** 2, dim=-1)
    return torch.sqrt(torch.mean(v2 / torch.clamp_min(state.cs, 1e-30) ** 2))


def summary(state: ParticleState, cfg: SPHConfig, t: float) -> dict:
    """JSONL-ready scalar record (one host transfer of the scalars)."""
    p = momentum(state)
    scalars = [kinetic_energy(state), internal_energy(state), p[0], p[1],
               torch.max(torch.sqrt(torch.sum(state.vel ** 2, -1))),
               torch.max(state.rho), torch.min(state.rho),
               torch.mean(state.h), mach_rms(state)]
    if state.dim == 3:
        scalars.append(p[2])
    if cfg.gravity:
        scalars.append(gravitational_energy(state, cfg))
    vals = torch.stack(scalars).double().tolist()
    rec = dict(t=float(t), e_kin=vals[0], e_int=vals[1], px=vals[2],
               py=vals[3], max_v=vals[4], max_rho=vals[5], min_rho=vals[6],
               mean_h=vals[7], mach_rms=vals[8])
    if state.dim == 3:
        rec["pz"] = vals[9]
    if cfg.gravity:
        rec["e_grav"] = vals[-1]
    rec["e_total"] = rec["e_kin"] + rec["e_int"] + rec.get("e_grav", 0.0)
    rec["finite"] = bool(math.isfinite(rec["e_total"]) and rec["max_rho"] > 0)
    return rec
