"""The well-posed Kelvin-Helmholtz test of McNally, Lyra & Passy 2012 (ApJS
201, 18) on the port's layout of ``kh``: the periodic unit square, rho1 and
vx = u1 outside the band 1/4 <= y < 3/4, rho2 and u2 inside, both smoothed
across each interface by exponentials of width L; vy = amp sin(4 pi x),
P = P0, gamma.

Equal masses m = 1/n^2 on ``n_side`` = n columns outside the band and 2 n
inside it (N = 1.5 n^2): each region below and above the band takes
round(its mass n) rows and the band the other 3 n / 4, and a region's row k
sits where its cumulative mass reaches (k + 1/2) / rows of it. u from P0
and h = eta (m / rho)^(1/2) at each row's rho(y). ``jitter_max`` moves each
position by up to that many lattice spacings (1 / n) per axis, drawn from
the seed after the stretch.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.ics import on_device

_EDGES = (0.0, 0.25, 0.5, 0.75, 1.0)


def profile(y, ic):
    """(rho, vx) at heights ``y``."""
    d = np.where(y < 0.5, y - 0.25, 0.75 - y)
    e = np.exp(-np.abs(d) / float(ic["L"]))
    inside = d >= 0.0
    rho1, rho2 = float(ic["rho1"]), float(ic["rho2"])
    u1, u2 = float(ic["u1"]), float(ic["u2"])
    rm, um = 0.5 * (rho1 - rho2), 0.5 * (u1 - u2)
    return (np.where(inside, rho2 + rm * e, rho1 - rm * e),
            np.where(inside, u2 + um * e, u1 - um * e))


def column_mass(y, ic):
    """The integral of rho from 0 to ``y``, in closed form a region at a
    time."""
    y = np.asarray(y, np.float64)
    rho1, rho2, L = float(ic["rho1"]), float(ic["rho2"]), float(ic["L"])
    rm = 0.5 * (rho1 - rho2)
    prims = (lambda t: rho1 * t - rm * L * np.exp((t - 0.25) / L),
             lambda t: rho2 * t - rm * L * np.exp((0.25 - t) / L),
             lambda t: rho2 * t + rm * L * np.exp((t - 0.75) / L),
             lambda t: rho1 * t + rm * L * np.exp((0.75 - t) / L))
    out = np.zeros_like(y)
    for k, prim in enumerate(prims):
        a, b = _EDGES[k], _EDGES[k + 1]
        out += prim(np.clip(y, a, b)) - prim(a)
    return out


def rows_at(lo: float, hi: float, rows: int, ic):
    """Heights of a region's rows: bisection on its cumulative mass."""
    m_lo, m_hi = column_mass(lo, ic), column_mass(hi, ic)
    target = m_lo + (np.arange(rows) + 0.5) / rows * (m_hi - m_lo)
    a, b = np.full(rows, lo), np.full(rows, hi)
    for _ in range(64):
        mid = 0.5 * (a + b)
        below = column_mass(mid, ic) < target
        a, b = np.where(below, mid, a), np.where(below, b, mid)
    return 0.5 * (a + b)


def build(ic: dict, gen, dtype, device) -> dict:
    n = int(ic["n_side"])
    out_rows = int(round(float(column_mass(0.25, ic)) * n))
    parts = []
    for (lo, hi), cols, rows in (((0.0, 0.25), n, out_rows),
                                 ((0.25, 0.75), 2 * n, 3 * n // 4 - out_rows),
                                 ((0.75, 1.0), n, out_rows)):
        x = (np.arange(cols, dtype=np.float64) + 0.5) / cols
        gx, gy = np.meshgrid(x, rows_at(lo, hi, rows, ic), indexing="ij")
        parts.append(np.stack([gx.ravel(), gy.ravel()], axis=-1))
    pos = np.concatenate(parts, axis=0)
    m = 1.0 / (n * n)
    rho, vx = profile(pos[:, 1], ic)
    vy = float(ic["amp"]) * np.sin(4.0 * np.pi * pos[:, 0])
    out = on_device(dict(
        pos=pos, vel=np.stack([vx, vy], axis=-1),
        mass=np.full(len(pos), m),
        u=float(ic["P0"]) / ((float(ic["gamma"]) - 1.0) * rho),
        h=float(ic["eta"]) * np.sqrt(m / rho)), dtype, device)
    amp = float(ic["jitter_max"]) / n
    if amp > 0.0:
        step = (2.0 * torch.rand(out["pos"].shape, generator=gen,
                                 dtype=dtype, device=device) - 1.0) * amp
        out["pos"] = torch.remainder(out["pos"] + step, 1.0)
    return out
