"""Evrard adiabatic collapse ICs (NumPy copy of ``sphax.ics.evrard``).

Standard Evrard (1988) test: gas sphere of mass M=1, radius R=1 with density
profile rho(r) = M / (2 pi R^2 r), cold start u = 0.05 (in G=M=R=1 units),
self-gravity on (configs.EVRARD). The sphere collapses, bounces, and a shock
propagates outward; total energy must be conserved (SURVEY.md §4.2.3 gate).

Particle placement: deterministic radial stretching of a quasi-uniform unit
sphere sample — M(<r) ∝ r^2 for this profile, so r = R * sqrt(xi) with xi
uniform in (0, 1]; directions from a Fibonacci sphere (deterministic, low
discrepancy).
"""
from __future__ import annotations

import numpy as np


def fibonacci_sphere(n, dtype=np.float64):
    """n quasi-uniform unit vectors (golden-angle spiral)."""
    i = np.arange(n, dtype=dtype) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=-1)


def build(n: int = 4096, M: float = 1.0, R: float = 1.0, u0: float = 0.05,
          eta: float = 1.3, box_half: float = 5.0, dtype=np.float64):
    """Return dict(pos, vel, mass, u, h, box=None-style open domain info)."""
    xi = (np.arange(n, dtype=dtype) + 0.5) / n
    r = R * np.sqrt(xi)
    dirs = fibonacci_sphere(n, dtype)
    # decorrelate radius from spiral latitude by a deterministic shuffle
    rng = np.random.default_rng(12345)
    dirs = dirs[rng.permutation(n)]
    pos = r[:, None] * dirs

    mass = np.full(n, M / n, dtype)
    rho = M / (2.0 * np.pi * R**2 * np.maximum(r, R / n))
    h = eta * (mass / rho) ** (1.0 / 3.0)
    u = np.full(n, u0, dtype)
    vel = np.zeros_like(pos)
    return dict(pos=pos, vel=vel, mass=mass, u=u.astype(dtype), h=h,
                lo=np.full(3, -box_half, dtype), hi=np.full(3, box_half, dtype))


def total_energy(pos, vel, mass, u, G=1.0, eps=0.02):
    """E = kinetic + internal + gravitational (direct sum, softened)."""
    ekin = 0.5 * np.sum(mass * np.sum(vel**2, axis=-1))
    eint = np.sum(mass * u)
    dx = pos[:, None, :] - pos[None, :, :]
    r2 = np.sum(dx * dx, axis=-1) + eps**2
    inv_r = 1.0 / np.sqrt(r2)
    np.fill_diagonal(inv_r, 0.0)
    egrav = -0.5 * G * np.sum(mass[:, None] * mass[None, :] * inv_r)
    return ekin + eint + egrav, ekin, eint, egrav
