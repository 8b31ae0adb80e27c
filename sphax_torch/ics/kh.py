"""2D Kelvin-Helmholtz shear instability ICs.

``build`` is a NumPy copy of ``sphax.ics.kh``: density contrast 2:1,
equal-mass particles, the dense central band doubling the lattice
resolution along x, opposing shear flow +/- v0/2 across sharp interfaces,
seeded with a small sinusoidal vy perturbation localised at the two
interfaces.

``build_mcnally`` is the well-posed test of McNally, Lyra & Passy 2012
(ApJS 201, 18) on the same layout: rho and vx smoothed across each
interface by exponentials of width L, and vy = 0.01 sin(4 pi x) everywhere.
Only y moves: the rows of each region are stretched so that they carry its
mass under the smooth profile.

Run either with configs.KH (grad-h terms on, per BASELINE.json:9).
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


# the regions of McNally's profile: below the band, the band, above it
_EDGES = (0.0, 0.25, 0.5, 0.75, 1.0)


def mcnally_profile(y, rho1: float = 1.0, rho2: float = 2.0, u1: float = 0.5,
                    u2: float = -0.5, L: float = 0.025):
    """(rho, vx) at heights ``y`` of McNally et al.'s smoothed profile: rho1
    and vx = u1 outside the band 1/4 <= y < 3/4, rho2 and u2 inside, each
    interface smoothed by exponentials of width L so that both are
    continuous (rho = rho1 - rho_m e^((y - 1/4)/L) below 1/4, rho2 + rho_m
    e^((1/4 - y)/L) above it, mirrored about y = 1/2; rho_m = (rho1 -
    rho2)/2, likewise vx)."""
    y = np.asarray(y, np.float64)
    # distance into the band from the nearer interface (negative outside)
    d = np.where(y < 0.5, y - 0.25, 0.75 - y)
    e = np.exp(-np.abs(d) / L)
    inside = d >= 0.0
    rm, um = 0.5 * (rho1 - rho2), 0.5 * (u1 - u2)
    return (np.where(inside, rho2 + rm * e, rho1 - rm * e),
            np.where(inside, u2 + um * e, u1 - um * e))


def mcnally_mass(y, rho1: float = 1.0, rho2: float = 2.0, L: float = 0.025):
    """Mass of the profile's column below ``y`` over unit x: the integral of
    ``mcnally_profile``'s rho from 0, in closed form a region at a time."""
    y = np.asarray(y, np.float64)
    rm = 0.5 * (rho1 - rho2)
    # an antiderivative of rho on each region
    prims = (lambda t: rho1 * t - rm * L * np.exp((t - 0.25) / L),
             lambda t: rho2 * t - rm * L * np.exp((0.25 - t) / L),
             lambda t: rho2 * t + rm * L * np.exp((t - 0.75) / L),
             lambda t: rho1 * t + rm * L * np.exp((0.75 - t) / L))
    out = np.zeros_like(y)
    for k, prim in enumerate(prims):
        a, b = _EDGES[k], _EDGES[k + 1]
        out += prim(np.clip(y, a, b)) - prim(a)
    return out


def _stretched_rows(lo: float, hi: float, rows: int, **prof):
    """Heights of ``rows`` rows in [lo, hi): row k where the region's
    cumulative mass reaches (k + 1/2) / rows of it (bisection on the
    monotone mass)."""
    m_lo, m_hi = mcnally_mass(lo, **prof), mcnally_mass(hi, **prof)
    target = m_lo + (np.arange(rows) + 0.5) / rows * (m_hi - m_lo)
    a, b = np.full(rows, lo), np.full(rows, hi)
    for _ in range(64):
        mid = 0.5 * (a + b)
        below = mcnally_mass(mid, **prof) < target
        a, b = np.where(below, mid, a), np.where(below, b, mid)
    return 0.5 * (a + b)


def build_mcnally(n: int = 64, rho1: float = 1.0, rho2: float = 2.0,
                  u1: float = 0.5, u2: float = -0.5, L: float = 0.025,
                  P0: float = 2.5, amp: float = 0.01, eta: float = 1.3,
                  dtype=np.float64):
    """Return dict(pos, vel, mass, u, h, box) of McNally et al.'s test on
    ``build``'s layout: ``n`` columns outside the band and ``2 n`` inside
    it, equal masses m = 1/n^2 (N = 1.5 n^2, the profile's total mass
    1.5). Each region below and above the band takes round(its mass n)
    rows, the band the other 3 n / 4 (a row outside carries 1/n, a row of
    the band 2/n), and its rows sit where its cumulative mass reaches
    (k + 1/2) / rows of it. u from P0 and h = eta (m / rho)^(1/2) at each
    row's rho(y); vx from the profile, vy = amp sin(4 pi x)."""
    assert n % 4 == 0
    prof = dict(rho1=rho1, rho2=rho2, L=L)
    edge = (mcnally_mass(0.25, **prof), mcnally_mass(0.75, **prof))
    out_rows = int(round(float(edge[0]) * n))
    band_rows = 3 * n // 4 - out_rows
    parts = []
    for (lo, hi), cols, rows in (((0.0, 0.25), n, out_rows),
                                 ((0.25, 0.75), 2 * n, band_rows),
                                 ((0.75, 1.0), n, out_rows)):
        x = (np.arange(cols, dtype=np.float64) + 0.5) / cols
        y = _stretched_rows(lo, hi, rows, **prof)
        gx, gy = np.meshgrid(x, y, indexing="ij")
        parts.append(np.stack([gx.ravel(), gy.ravel()], axis=-1))
    pos = np.concatenate(parts, axis=0)
    count = len(pos)
    m = 1.0 / (n * n)
    rho, vx = mcnally_profile(pos[:, 1], rho1, rho2, u1, u2, L)
    vy = amp * np.sin(4.0 * np.pi * pos[:, 0])
    vel = np.stack([vx, vy], axis=-1)
    u = P0 / ((GAMMA - 1.0) * rho)
    h = eta * np.sqrt(m / rho)
    return dict(pos=pos.astype(dtype), vel=vel.astype(dtype),
                mass=np.full(count, m, dtype), u=u.astype(dtype),
                h=h.astype(dtype), box=np.ones(2, dtype))
