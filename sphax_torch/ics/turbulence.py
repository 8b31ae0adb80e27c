"""Driven isothermal turbulence box ICs (NumPy copy of
``sphax.ics.turbulence``).

Uniform unit box, rho = 1, isothermal EOS (configs.TURB), zero initial
velocity; kinetic energy is injected by the OU force in
``sphax_torch.physics.driving``.
"""
from __future__ import annotations

import numpy as np

from sphax_torch.ics.lattice import cubic_lattice


def build(n_side: int = 32, rho0: float = 1.0, eta: float = 1.3,
          jitter: float = 0.05, seed: int = 7, dtype=np.float64):
    """Return dict(pos, vel, mass, u, h, box). Slight lattice jitter breaks
    the perfect-grid degeneracy so turbulence develops isotropically."""
    pos = cubic_lattice((n_side,) * 3, [0, 0, 0], [1, 1, 1], dtype)
    n = len(pos)
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + jitter / n_side * rng.standard_normal(pos.shape), 1.0)
    mass = np.full(n, rho0 / n, dtype)
    h = np.full(n, eta / n_side, dtype)
    u = np.full(n, 1.0, dtype)  # unused by isothermal EOS; kept for state shape
    vel = np.zeros_like(pos)
    return dict(pos=pos, vel=vel, mass=mass, u=u, h=h, box=np.ones(3, dtype))
