"""Global timestep criteria (torch twin of ``sphax.integrate.timestep``)."""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import ParticleState

_TINY = 1e-30


def particle_dt(state: ParticleState, cfg: SPHConfig):
    """Per-PARTICLE dt [n]: min of the CFL and force criteria, clamped to
    cfg.dt_max."""
    vsig = state.cs + 0.6 * (cfg.alpha_visc * state.cs
                             + cfg.beta_visc * state.cs)
    dt_cfl = cfg.cfl * state.h / torch.clamp_min(vsig, _TINY)
    amag = torch.sqrt(torch.sum(state.acc * state.acc, dim=-1))
    dt_f = cfg.dt_force * torch.sqrt(state.h / torch.clamp_min(amag, _TINY))
    return torch.clamp_max(torch.minimum(dt_cfl, dt_f), cfg.dt_max)


def local_dt(state: ParticleState, cfg: SPHConfig):
    """Global dt: the min over particles (a 0-d tensor; no host sync)."""
    return torch.amin(particle_dt(state, cfg))
