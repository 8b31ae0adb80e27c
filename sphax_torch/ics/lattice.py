"""Lattice particle placement (NumPy copy of ``sphax.ics.lattice``)."""
from __future__ import annotations

import numpy as np


def cubic_lattice(n_per_axis, lo, hi, dtype=np.float64):
    """Cell-centred cubic lattice: n_per_axis = (nx, ny, ...) counts.

    Returns [prod(n), D] positions (NumPy; ICs are built on the host once,
    deterministically, then moved to the device).
    """
    lo = np.asarray(lo, dtype)
    hi = np.asarray(hi, dtype)
    axes = [
        lo[d] + (hi[d] - lo[d]) * (np.arange(n, dtype=dtype) + 0.5) / n
        for d, n in enumerate(n_per_axis)
    ]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)
