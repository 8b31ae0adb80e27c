"""Sedov-Taylor analytic shock radius (NumPy copy of ``sphax.diag.sedov``).

R(t) = xi0 * (E t^2 / rho0)^(1/5). The dimensionless constant xi0 depends on
gamma; for gamma = 5/3 in 3D, xi0 ~= 1.152 (standard tabulated value from the
self-similar Sedov solution; e.g. Landau & Lifshitz, Fluid Mechanics §106).
"""
from __future__ import annotations

import numpy as np

XI0 = {5.0 / 3.0: 1.152, 1.4: 1.033}


def shock_radius(t, E, rho0, gamma=5.0 / 3.0):
    xi = XI0.get(gamma, 1.15)
    return xi * (E * t**2 / rho0) ** 0.2


def measured_shock_radius(pos, rho, centre, rho0):
    """Estimate the shock radius as the density-peak radius.

    Robust estimator for particle data: radius of the peak of the radially
    binned mean density.
    """
    r = np.sqrt(np.sum((pos - centre) ** 2, axis=-1))
    nb = 40
    rmax = r.max()
    bins = np.linspace(0, rmax, nb + 1)
    idx = np.clip(np.digitize(r, bins) - 1, 0, nb - 1)
    prof = np.zeros(nb)
    cnt = np.zeros(nb)
    np.add.at(prof, idx, rho)
    np.add.at(cnt, idx, 1)
    prof = np.where(cnt > 0, prof / np.maximum(cnt, 1), 0.0)
    mid = 0.5 * (bins[:-1] + bins[1:])
    return mid[np.argmax(prof)]
