"""Equations of state (torch twin of ``sphax.physics.eos``)."""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig


def eos(rho, u, cfg: SPHConfig):
    """Return (P, cs). Ideal gamma-law gas or isothermal."""
    if cfg.isothermal:
        P = cfg.cs_iso**2 * rho
        cs = torch.full_like(rho, cfg.cs_iso)
    else:
        P = (cfg.gamma - 1.0) * rho * u
        cs = torch.sqrt(cfg.gamma * torch.clamp_min(P, 0.0) / rho)
    return P, cs
