"""2D Kelvin-Helmholtz shear instability ICs (NumPy copy of ``sphax.ics.kh``).

Density contrast 2:1, equal-mass particles: the dense central band doubles
the lattice resolution along x. Opposing shear flow +/- v0/2, seeded with a
small sinusoidal vy perturbation localised at the two interfaces. Run with
configs.KH (grad-h terms on, per BASELINE.json:9).
"""
from __future__ import annotations

import numpy as np

from sphax_torch.ics.lattice import cubic_lattice

GAMMA = 5.0 / 3.0


def build(nx: int = 64, v0: float = 1.0, rho1: float = 1.0, rho2: float = 2.0,
          P0: float = 2.5, amp: float = 0.025, kmode: int = 2,
          sigma_pert: float = 0.05, eta: float = 1.3, dtype=np.float64):
    """Return dict(pos, vel, mass, u, h, box).

    Outer layers (|y-0.5| > 0.25): rho1, vx = -v0/2, lattice nx x nx/4 each.
    Central band  (|y-0.5| < 0.25): rho2 = 2*rho1, vx = +v0/2, lattice
    (2*nx) x nx/2 (doubled x-resolution -> exactly 2x density, equal mass).
    """
    assert nx % 4 == 0
    ny_band = nx // 2
    ny_out = nx // 4

    pos_bot = cubic_lattice((nx, ny_out), [0.0, 0.0], [1.0, 0.25], dtype)
    pos_mid = cubic_lattice((2 * nx, ny_band), [0.0, 0.25], [1.0, 0.75], dtype)
    pos_top = cubic_lattice((nx, ny_out), [0.0, 0.75], [1.0, 1.0], dtype)
    pos = np.concatenate([pos_bot, pos_mid, pos_top], axis=0)
    n = len(pos)

    in_band = (pos[:, 1] >= 0.25) & (pos[:, 1] < 0.75)
    rho = np.where(in_band, rho2, rho1)

    # equal masses by construction: m = rho1 * (1 * 0.5) / (nx*nx/2)
    m = rho1 * 0.5 / (nx * ny_out * 2)
    mass = np.full(n, m, dtype)

    vx = np.where(in_band, +0.5 * v0, -0.5 * v0)
    # interface-localised sinusoidal vy seed
    vy = amp * np.sin(2.0 * np.pi * kmode * pos[:, 0]) * (
        np.exp(-((pos[:, 1] - 0.25) ** 2) / (2 * sigma_pert**2))
        + np.exp(-((pos[:, 1] - 0.75) ** 2) / (2 * sigma_pert**2)))
    vel = np.stack([vx, vy], axis=-1)

    u = P0 / ((GAMMA - 1.0) * rho)
    h = eta * np.sqrt(m / rho)  # 2D: h = eta (m/rho)^(1/2)
    return dict(pos=pos, vel=vel, mass=mass, u=u.astype(dtype),
                h=h.astype(dtype), box=np.ones(2, dtype))


def mode_amplitude(pos, vel, mass, kmode: int = 2):
    """Mass-weighted amplitude of the seeded vy Fourier mode (growth metric).

    s = |sum_i m_i vy_i exp(2 pi i k x_i) w(y_i)| with the same interface
    window used for seeding; normalised by total mass.
    """
    w = (np.exp(-((pos[:, 1] - 0.25) ** 2) / (2 * 0.05**2))
         + np.exp(-((pos[:, 1] - 0.75) ** 2) / (2 * 0.05**2)))
    phase = np.exp(2j * np.pi * kmode * pos[:, 0])
    s = np.sum(mass * vel[:, 1] * w * phase)
    return np.abs(s) / np.sum(mass)
