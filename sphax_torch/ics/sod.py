"""3D Sod shock tube initial conditions (NumPy copy of ``sphax.ics.sod``).

Periodic setup: left state (rho=1, P=1) fills x in [0, 0.5), right state
(rho=0.125, P=0.1) fills [0.5, 1); gamma = 1.4. Equal-mass particles: the
left lattice spacing is half the right one in each axis (8x number density =
8x mass density). Periodic wrap puts a second (mirrored) discontinuity at
x = 0; the analytic comparison window around x = 0.5 stays causally clean for
t < ~0.2.
"""
from __future__ import annotations

import numpy as np

from sphax_torch.ics.lattice import cubic_lattice

RHO_L, P_L = 1.0, 1.0
RHO_R, P_R = 0.125, 0.1
GAMMA = 1.4


def build(nx_left: int = 32, n_trans: int = 8, eta: float = 1.3,
          dtype=np.float64):
    """Return dict(pos, vel, mass, u, h, box). Host-side NumPy, deterministic.

    nx_left: lattice count along x for the left half (must be even);
    n_trans: transverse lattice count for the left half (must be even).
    N_total = nx_left*n_trans^2 + (nx_left*n_trans^2)//8.
    """
    assert nx_left % 2 == 0 and n_trans % 2 == 0
    dl = 0.5 / nx_left                      # left lattice spacing
    ly = n_trans * dl                       # transverse box size
    box = np.array([1.0, ly, ly], dtype)

    pos_l = cubic_lattice((nx_left, n_trans, n_trans),
                          [0.0, 0.0, 0.0], [0.5, ly, ly], dtype)
    pos_r = cubic_lattice((nx_left // 2, n_trans // 2, n_trans // 2),
                          [0.5, 0.0, 0.0], [1.0, ly, ly], dtype)
    pos = np.concatenate([pos_l, pos_r], axis=0)

    n_l, n_r = len(pos_l), len(pos_r)
    m = RHO_L * (0.5 * ly * ly) / n_l       # == RHO_R * vol_R / n_r
    mass = np.full(n_l + n_r, m, dtype)

    u_l = P_L / ((GAMMA - 1.0) * RHO_L)
    u_r = P_R / ((GAMMA - 1.0) * RHO_R)
    u = np.concatenate([np.full(n_l, u_l, dtype), np.full(n_r, u_r, dtype)])

    h = np.concatenate([
        np.full(n_l, eta * dl, dtype),
        np.full(n_r, eta * 2.0 * dl, dtype),
    ])
    vel = np.zeros_like(pos)
    return dict(pos=pos, vel=vel, mass=mass, u=u, h=h, box=box)
