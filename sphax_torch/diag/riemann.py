"""Exact Riemann solver for the Sod problem (NumPy copy of ``sphax.diag.riemann``).

Standard Toro (1999) exact solver for an ideal-gas Riemann problem; used to
compute the L1 density error metric from BASELINE.json:2. Pure NumPy.
"""
from __future__ import annotations

import numpy as np


def _f_K(p, rho_K, p_K, gamma):
    """Toro's f_K(p) and its derivative for one side."""
    a_K = np.sqrt(gamma * p_K / rho_K)
    if p > p_K:  # shock
        A = 2.0 / ((gamma + 1.0) * rho_K)
        B = (gamma - 1.0) / (gamma + 1.0) * p_K
        f = (p - p_K) * np.sqrt(A / (p + B))
        df = np.sqrt(A / (B + p)) * (1.0 - (p - p_K) / (2.0 * (B + p)))
    else:  # rarefaction
        f = (2.0 * a_K / (gamma - 1.0)) * (
            (p / p_K) ** ((gamma - 1.0) / (2.0 * gamma)) - 1.0
        )
        df = 1.0 / (rho_K * a_K) * (p / p_K) ** (-(gamma + 1.0) / (2.0 * gamma))
    return f, df


def solve_star(rho_l, u_l, p_l, rho_r, u_r, p_r, gamma, tol=1e-12):
    """Newton for p* in the star region; returns (p_star, u_star)."""
    p = 0.5 * (p_l + p_r)
    for _ in range(100):
        f_l, df_l = _f_K(p, rho_l, p_l, gamma)
        f_r, df_r = _f_K(p, rho_r, p_r, gamma)
        g = f_l + f_r + (u_r - u_l)
        dp = -g / (df_l + df_r)
        p = max(p + dp, 1e-14)
        if abs(dp) < tol * p:
            break
    f_l, _ = _f_K(p, rho_l, p_l, gamma)
    f_r, _ = _f_K(p, rho_r, p_r, gamma)
    u = 0.5 * (u_l + u_r) + 0.5 * (f_r - f_l)
    return p, u


def sample(xi, rho_l, u_l, p_l, rho_r, u_r, p_r, gamma):
    """Sample the self-similar solution at xi = x/t. Returns (rho, u, p).

    Vectorised over xi.
    """
    xi = np.asarray(xi, dtype=np.float64)
    p_s, u_s = solve_star(rho_l, u_l, p_l, rho_r, u_r, p_r, gamma)
    a_l = np.sqrt(gamma * p_l / rho_l)
    a_r = np.sqrt(gamma * p_r / rho_r)
    gm1, gp1 = gamma - 1.0, gamma + 1.0

    rho = np.empty_like(xi)
    u = np.empty_like(xi)
    p = np.empty_like(xi)

    left = xi <= u_s
    # --- left of contact ---
    if p_s > p_l:  # left shock
        rho_sl = rho_l * ((p_s / p_l + gm1 / gp1) / (gm1 / gp1 * p_s / p_l + 1.0))
        S_l = u_l - a_l * np.sqrt((gp1 * p_s / p_l + gm1) / (2.0 * gamma))
        m = left & (xi < S_l)
        rho[m], u[m], p[m] = rho_l, u_l, p_l
        m = left & (xi >= S_l)
        rho[m], u[m], p[m] = rho_sl, u_s, p_s
    else:  # left rarefaction
        a_sl = a_l * (p_s / p_l) ** (gm1 / (2.0 * gamma))
        head, tail = u_l - a_l, u_s - a_sl
        m = left & (xi < head)
        rho[m], u[m], p[m] = rho_l, u_l, p_l
        m = left & (xi >= head) & (xi <= tail)
        fac = 2.0 / gp1 + gm1 / (gp1 * a_l) * (u_l - xi[m])
        rho[m] = rho_l * fac ** (2.0 / gm1)
        u[m] = 2.0 / gp1 * (a_l + gm1 / 2.0 * u_l + xi[m])
        p[m] = p_l * fac ** (2.0 * gamma / gm1)
        m = left & (xi > tail)
        rho[m] = rho_l * (p_s / p_l) ** (1.0 / gamma)
        u[m], p[m] = u_s, p_s

    right = ~left
    # --- right of contact ---
    if p_s > p_r:  # right shock
        rho_sr = rho_r * ((p_s / p_r + gm1 / gp1) / (gm1 / gp1 * p_s / p_r + 1.0))
        S_r = u_r + a_r * np.sqrt((gp1 * p_s / p_r + gm1) / (2.0 * gamma))
        m = right & (xi > S_r)
        rho[m], u[m], p[m] = rho_r, u_r, p_r
        m = right & (xi <= S_r)
        rho[m], u[m], p[m] = rho_sr, u_s, p_s
    else:  # right rarefaction
        a_sr = a_r * (p_s / p_r) ** (gm1 / (2.0 * gamma))
        head, tail = u_r + a_r, u_s + a_sr
        m = right & (xi > head)
        rho[m], u[m], p[m] = rho_r, u_r, p_r
        m = right & (xi >= tail) & (xi <= head)
        fac = 2.0 / gp1 - gm1 / (gp1 * a_r) * (u_r - xi[m])
        rho[m] = rho_r * fac ** (2.0 / gm1)
        u[m] = 2.0 / gp1 * (-a_r + gm1 / 2.0 * u_r + xi[m])
        p[m] = p_r * fac ** (2.0 * gamma / gm1)
        m = right & (xi < tail)
        rho[m] = rho_r * (p_s / p_r) ** (1.0 / gamma)
        u[m], p[m] = u_s, p_s

    return rho, u, p


def sod_solution(x, t, x0=0.5, rho_l=1.0, p_l=1.0, rho_r=0.125, p_r=0.1,
                 gamma=1.4):
    """Density/velocity/pressure of the standard Sod problem at (x, t)."""
    if t <= 0:
        x = np.asarray(x)
        leftside = x < x0
        return (np.where(leftside, rho_l, rho_r),
                np.zeros_like(x),
                np.where(leftside, p_l, p_r))
    return sample((np.asarray(x) - x0) / t, rho_l, 0.0, p_l, rho_r, 0.0, p_r,
                  gamma)
