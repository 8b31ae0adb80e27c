"""Sedov-Taylor point-blast ICs (NumPy copy of ``sphax.ics.sedov``).

Uniform-density unit box (periodic), total blast energy E injected into the
particles within a small radius of the centre, kernel-weighted — the standard
SPH setup. Run with adaptive h + viscosity switch (configs.SEDOV).
"""
from __future__ import annotations

import numpy as np

from sphax_torch.ics.lattice import cubic_lattice


def _cubic_f(q):
    """Vectorised cubic-spline shape function (NumPy, host-side)."""
    return np.where(q < 1.0, 1.0 - 1.5 * q**2 + 0.75 * q**3,
                    np.where(q < 2.0, 0.25 * (2.0 - q) ** 3, 0.0))


def build(n_side: int = 20, E: float = 1.0, rho0: float = 1.0,
          u_bg: float = 1e-6, eta: float = 1.3, r_inj_cells: float = 2.0,
          dtype=np.float64, centre=(0.5, 0.5, 0.5)):
    """Return dict(pos, vel, mass, u, h, box, E, rho0).

    r_inj_cells: injection radius in units of the lattice spacing.
    Injection is energy-conserving: sum(m_i * du_i) == E exactly.
    ``centre``: blast location — an OFF-center blast is the load-balance
    stress case (all low-rung work lands in one slab of a decomposition).
    """
    pos = cubic_lattice((n_side,) * 3, [0, 0, 0], [1, 1, 1], dtype)
    n = len(pos)
    d = 1.0 / n_side
    mass = np.full(n, rho0 / n, dtype)  # box volume = 1
    h = np.full(n, eta * d, dtype)

    centre = np.asarray(centre, dtype)
    r = np.sqrt(np.sum((pos - centre) ** 2, axis=-1))
    r_inj = r_inj_cells * d
    w = _cubic_f(2.0 * r / r_inj)
    if w.sum() <= 0:  # degenerate: dump everything on the nearest particle
        w = np.zeros(n)
        w[np.argmin(r)] = 1.0
    du = E * w / np.sum(w * mass)
    u = np.full(n, u_bg, dtype) + du
    vel = np.zeros_like(pos)
    return dict(pos=pos, vel=vel, mass=mass, u=u, h=h,
                box=np.ones(3, dtype), E=E, rho0=rho0)
